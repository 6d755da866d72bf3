"""DG-in-time discrete adjoint march, Radau reconstruction, and the
per-element adjoint-weighted residual error contributions (eager torch).

Counterpart of the JAX package's ``adjoint/dg_time.py``. Reference parity:
``matlab/adj_march.m`` (backward element sweep at order n_primal+1,
linearised weighted mass M_v, per-element err(k) = vᵀ(primal residual at
adjoint order)), ``matlab/adj_rec.m`` (solve the adjoint at the primal's
order, reconstruct to order+1 through Radau collocation points + the known
inflow endpoint), and ``matlab/err_contribution.m`` (continuous-adjoint
error contributions with an exact adjoint).

Derivation note (clean form — documented deviation): for a'(t) =
−f'(u)a − g_u with a(T)=0, upwind DG marching backward gives per element

    (−Sᵀ − e_L e_Lᵀ + M_w) v = −M·g_u_vec − e_R·v_inflow

with M_w = h/2·Φᵀdiag(w⊙f'(u_q))Φ and all quadrature *inside* the element.
The reference reaches the same system through a negative-h parameterisation
(adj_march.m:72), but anchors its interpolation points at the wrong element
end (adj_march.m:78: ``tk(1) + (1+r)·hk/2`` with hk<0 spans [t_L−h, t_L],
i.e. the *neighbouring* interval) — an O(h) extrapolation artifact that is
not reproduced. The form is verified by the effectivity identity to 1e-10 on
linear problems (the matlab/MAIN.m:55-76 check).

Error contributions: err_k = v_kᵀ R_k(u_H), the primal slab residual
(march/dg_time.py weak form) evaluated at the adjoint's order with the
interpolated primal — the adjoint-weighted residual localisation. The
element-local parts (interpolation, quadrature, assembly) are batched over
the K elements; only the adjoint solve runs element by element, carried by
the inflow value.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.dg_time import DGTimeOperators, elementwise_f_u
from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl, radau_points
from adjoint_ode_adaptivity_tpu_torch.ops.operators import (
    dmatrix_1d,
    interp_matrix_1d,
    vandermonde_1d,
)

__all__ = [
    "DGAdjointResult",
    "dg_adjoint_march",
    "dg_element_functional",
    "dg_adjoint_reconstruct",
    "dg_awr_from_adjoint",
    "continuous_err_contribution",
]


class DGAdjointResult(NamedTuple):
    v: torch.Tensor  # (K, Np_adj) adjoint nodal values
    t: torch.Tensor  # (K, Np_adj) node times
    err: torch.Tensor  # (K,) adjoint-weighted residual contributions


def _interp_ops(n_primal: int, ops_adj: DGTimeOperators):
    """Primal-nodal → (adjoint nodes, adjoint quadrature) interp matrices."""
    r_p = jacobi_gl(0.0, 0.0, n_primal)
    to_nodes = interp_matrix_1d(n_primal, r_p, ops_adj.r)
    to_quad = interp_matrix_1d(n_primal, r_p, ops_adj.rq)
    return to_nodes, to_quad


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _slabs(times: torch.Tensor):
    return times[:-1], times[1:] - times[:-1]


def _inflows(y0, u_primal: torch.Tensor) -> torch.Tensor:
    """Each element's inflow value: y0, then the previous element's last node."""
    y0 = torch.as_tensor(y0, dtype=u_primal.dtype, device=u_primal.device).reshape(1)
    return torch.cat([y0, u_primal[:-1, -1]])


def _awr_residual(ops_adj, f, u_h, u_q, t_q, h, u_prev):
    """The primal residual at the adjoint's order, per element (K, Np_adj):
    Sᵀu_h − e_R u_h[−1] + h/2·Φᵀ(w ⊙ f(u_q)) + e_L u_prev."""
    phi, wq = _as(ops_adj.phi, u_h), _as(ops_adj.wq, u_h)
    m_tilde = h[:, None] / 2.0 * ((wq * f(u_q, t_q)) @ phi)
    res = u_h @ _as(ops_adj.stiff, u_h) + m_tilde  # (Sᵀ u_h)_i = Σ_j S_ji u_h,j
    res[:, -1] = res[:, -1] - u_h[:, -1]
    res[:, 0] = res[:, 0] + u_prev
    return res


def dg_adjoint_march(
    ops_adj: DGTimeOperators,
    f: Callable,
    u_primal: torch.Tensor,  # (K, Np_primal) nodal primal from dg_march
    times: torch.Tensor,  # (K+1,) partition
    y0,
    *,
    f_u: Callable | None = None,
    g_u: Callable | None = None,
    v_terminal: float = 0.0,
) -> DGAdjointResult:
    """Backward adjoint sweep at order ``ops_adj.n`` (primal order + 1) with
    per-element error contributions.

    ``g_u`` is ∂(functional integrand)/∂u (default: J = ∫u ⇒ 1); ``f_u``
    as in :func:`~adjoint_ode_adaptivity_tpu_torch.march.dg_time.dg_march`.
    """
    times = torch.as_tensor(times, device=u_primal.device)
    f_u = f_u or elementwise_f_u(f)
    np_a = ops_adj.np_
    to_nodes, to_quad = (_as(x, times) for x in _interp_ops(u_primal.shape[1] - 1, ops_adj))
    phi, wq = _as(ops_adj.phi, times), _as(ops_adj.wq, times)
    m_ref = _as(ops_adj.mass, times)
    t_left, hs = _slabs(times)
    u_primal = u_primal.to(times.dtype)

    u_q = u_primal @ to_quad.T  # (K, Nq): the primal at adjoint quadrature (in-element)
    t_q = t_left[:, None] + (1.0 + _as(ops_adj.rq, times))[None, :] * hs[:, None] / 2.0
    t_n = t_left[:, None] + (1.0 + _as(ops_adj.r, times))[None, :] * hs[:, None] / 2.0
    u_h = u_primal @ to_nodes.T  # (K, Np_adj)
    m_w = hs[:, None, None] / 2.0 * torch.einsum("qi,kq,qj->kij", phi, wq * f_u(u_q, t_q), phi)
    base = -_as(ops_adj.stiff, times).T
    base[0, 0] = base[0, 0] - 1.0
    a_mat = base + m_w  # (K, Np_adj, Np_adj)
    g_vals = torch.ones_like(u_h) if g_u is None else g_u(u_h, t_n)
    rhs0 = -((hs[:, None] / 2.0 * g_vals) @ m_ref.T)  # −(h/2·M) g_u per element

    v = torch.empty_like(u_h)
    v_in = torch.as_tensor(v_terminal, dtype=times.dtype, device=times.device)
    for k in range(u_h.shape[0] - 1, -1, -1):
        rhs = rhs0[k].clone()
        rhs[-1] = rhs[-1] - v_in
        v[k] = torch.linalg.solve(a_mat[k], rhs)
        v_in = v[k, 0]

    res = _awr_residual(ops_adj, f, u_h, u_q, t_q, hs, _inflows(y0, u_primal))
    return DGAdjointResult(v=v, t=t_n, err=torch.sum(v * res, dim=1))


def dg_element_functional(
    ops: DGTimeOperators, u: torch.Tensor, times: torch.Tensor, g: Callable | None = None
) -> torch.Tensor:
    """J = Σ_k ∫_k g(u_h) dt by element-wise Gauss quadrature (the
    matlab/MAIN.m:55-73 ``integral(polyfit)`` functional evaluations);
    ``g`` defaults to J = ∫u."""
    times = torch.as_tensor(times, device=u.device)
    t_left, hs = _slabs(times)
    phi, wq, rq = _as(ops.phi, u), _as(ops.wq, u), _as(ops.rq, u)
    u_q = u @ phi.T
    vals = u_q
    if g is not None:
        vals = g(u_q, t_left[:, None] + (1.0 + rq)[None, :] * hs[:, None] / 2.0)
    return torch.sum(hs / 2.0 * torch.sum(wq * vals, dim=1))


def dg_awr_from_adjoint(
    ops_adj: DGTimeOperators,
    f: Callable,
    u_primal: torch.Tensor,
    times: torch.Tensor,
    y0,
    v_hi: torch.Tensor,  # (K, Np_adj) adjoint at ops_adj order (solved or reconstructed)
) -> torch.Tensor:
    """Per-element adjoint-weighted residual err_k = v_kᵀ R_k(u_H) for a
    *given* higher-order adjoint — used by the reconstruction path
    (adj_rec.m), where v comes from a low-order solve lifted through Radau
    collocation instead of a direct higher-order solve."""
    times = torch.as_tensor(times, device=u_primal.device)
    u_primal = u_primal.to(times.dtype)
    to_nodes, to_quad = (_as(x, times) for x in _interp_ops(u_primal.shape[1] - 1, ops_adj))
    t_left, hs = _slabs(times)
    u_q = u_primal @ to_quad.T
    t_q = t_left[:, None] + (1.0 + _as(ops_adj.rq, times))[None, :] * hs[:, None] / 2.0
    u_h = u_primal @ to_nodes.T
    res = _awr_residual(ops_adj, f, u_h, u_q, t_q, hs, _inflows(y0, u_primal))
    return torch.sum(v_hi * res, dim=1)


def dg_adjoint_reconstruct(
    ops_primal: DGTimeOperators,
    v_low: torch.Tensor,  # (K, Np_primal) adjoint solved at the primal's order
    times: torch.Tensor,
    v_terminal: float = 0.0,
) -> torch.Tensor:
    """Reconstruct a low-order adjoint to order n+1 through left-Radau
    collocation + the known right-endpoint inflow value (adj_rec.m:34-47).

    Returns the (K, Np_primal+1) NODAL values of the reconstructed
    polynomial at the (n+1)-order GL nodes of each element. ``times`` only
    fixes the device (the reconstruction is element-local)."""
    n = ops_primal.n
    m = n + 1  # reconstruction order
    rad = radau_points(m)  # m left-Radau points on [-1, 1]
    eval_rad = _as(interp_matrix_1d(n, np.asarray(ops_primal.r), rad), v_low)
    # fit a degree-m polynomial through (Radau points, right endpoint)
    v_fit = np.linalg.inv(vandermonde_1d(m, np.concatenate([rad, [1.0]])))
    r_hi = jacobi_gl(0.0, 0.0, m)
    to_hi = _as(vandermonde_1d(m, r_hi) @ v_fit, v_low)  # values at fit pts -> GL(m) nodes
    # inflow at each element's right end = the next element's v[0]; the last
    # element's is the terminal condition (that of the paired low-order solve)
    v_right_in = torch.cat([v_low[1:, 0], torch.full((1,), v_terminal, dtype=v_low.dtype,
                                                     device=v_low.device)])
    vals = torch.cat([v_low @ eval_rad.T, v_right_in[:, None]], dim=1)
    return vals @ to_hi.T


def continuous_err_contribution(
    ops: DGTimeOperators,
    u: torch.Tensor,  # (K, Np) primal nodal values
    times: torch.Tensor,
    adj_fn: Callable,  # exact continuous adjoint a(t)
    f: Callable,  # ODE rhs
    y0: float,
    include_jumps: str = "all",
) -> torch.Tensor:
    """Per-element ∫ a(t)·(f(u_h) − u_h') dt plus jump terms
    a(t_k)·(u_h(t_k⁺) − u_h(t_k⁻)) at element inflows.

    The complete continuous-adjoint error representation for DG-in-time
    requires the jump term at *every* element interface (the DG solution is
    discontinuous there); ``err_contribution.m:21-46`` keeps only the
    initial-condition jump (``include_jumps="first"`` reproduces that;
    commented-out lines :42-44 show the full version was intended)."""
    if include_jumps not in ("all", "first"):
        raise ValueError(f"include_jumps must be 'all' or 'first', got {include_jumps!r}")
    times = torch.as_tensor(times, device=u.device)
    t_left, hs = _slabs(times)
    phi, wq, rq = _as(ops.phi, times), _as(ops.wq, times), _as(ops.rq, times)
    dr = _as(dmatrix_1d(ops.n, np.asarray(ops.r), np.asarray(ops.v)), times)
    u = u.to(times.dtype)
    u_q = u @ phi.T
    du_q = (u @ dr.T) @ phi.T * (2.0 / hs[:, None])
    t_q = t_left[:, None] + (1.0 + rq)[None, :] * hs[:, None] / 2.0
    integrand = adj_fn(t_q) * (f(u_q, t_q) - du_q)
    err = hs / 2.0 * torch.sum(wq * integrand, dim=1)
    # J(u) − J(u_h) = Σ_k [ ∫_k a·R dt − a(t_k⁻)·jump_k ], jump_k = u_h(t_k⁺) − u_h(t_k⁻)
    jumps = adj_fn(t_left) * (u[:, 0] - _inflows(y0, u))
    if include_jumps == "all":
        return err - jumps
    return torch.cat([err[:1] - jumps[:1], err[1:]])
