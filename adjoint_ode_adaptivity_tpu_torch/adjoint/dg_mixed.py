"""Mixed per-element-order DG-in-time adjoint march, Radau reconstruction
and adjoint-weighted residual (eager torch, batched over members).

Counterpart of the JAX package's ``adjoint/dg_mixed.py`` (reference:
``matlab/adj_march.m`` called as ``adj_march(Ns+1, Ks, times)``, MAIN.m:34;
``matlab/adj_rec.m`` as ``adj_rec(Ns, ...)``, MAIN.m:35). Every element
gathers its order-(ns[k]+1) tables from one
:class:`~adjoint_ode_adaptivity_tpu_torch.march.dg_mixed.MixedDGTimeOperators`
stack built with ``n_max_stack = n_max_primal + fine_offset``, so the coarse
march (orders ``ns``), the fine march (``ns + fine_offset``) and this
adjoint (``ns + 1``) share one padding.

Shapes follow :func:`~adjoint_ode_adaptivity_tpu_torch.march.dg_mixed.dg_march_mixed`:
``u_primal`` (B, K, np_max), ``times`` (B, K+1), ``ns`` (B, K) primal
orders, ``y0`` (B,). The element-local parts (interpolation, quadrature,
assembly) are batched over members and elements; only the backward solves
run element by element, carried by the inflow value. ``g_u`` is
∂(integrand)/∂u, default 1 (J = ∫u dt); it is evaluated on the live nodes
only, so a g_u singular at 0 (e.g. 1/u) stays finite on the padding.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_time import DGAdjointResult
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import (
    MixedDGTimeOperators,
    _batch,
    _check_orders,
    _one_hot,
    _tab,
    dg_march_mixed,
    gauss_solve,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import elementwise_f_u
from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl, radau_points
from adjoint_ode_adaptivity_tpu_torch.ops.operators import interp_matrix_1d, vandermonde_1d

__all__ = [
    "MixedAdjointInterp",
    "MixedRadauInterp",
    "dg_adjoint_interp_mixed",
    "dg_adjoint_march_mixed",
    "dg_adjoint_reconstruct_mixed",
    "dg_adjoint_solve_low_mixed",
    "dg_awr_from_adjoint_mixed",
    "dg_element_functional_mixed",
    "dg_estimate_mixed",
    "dg_radau_interp_mixed",
]


class MixedAdjointInterp(NamedTuple):
    """Primal (order n) -> adjoint (order n+1) interpolation stacks, indexed
    by the primal order − 1 (n in 1..n_max_stack−1), zero-padded to np_max."""

    to_nodes: np.ndarray  # (L, np_max, np_max) primal nodes -> adjoint nodes
    to_quad: np.ndarray  # (L, Q, np_max) primal nodes -> shared quadrature


def dg_adjoint_interp_mixed(mops: MixedDGTimeOperators) -> MixedAdjointInterp:
    np_m, q, n_l = mops.np_max, mops.rq.shape[0], mops.n_max - 1
    to_nodes = np.zeros((n_l, np_m, np_m))
    to_quad = np.zeros((n_l, q, np_m))
    for n in range(1, mops.n_max):
        r_p = jacobi_gl(0.0, 0.0, n)
        r_a = jacobi_gl(0.0, 0.0, n + 1)
        to_nodes[n - 1, : n + 2, : n + 1] = interp_matrix_1d(n, r_p, r_a)
        to_quad[n - 1, :, : n + 1] = interp_matrix_1d(n, r_p, mops.rq)
    return MixedAdjointInterp(to_nodes=to_nodes, to_quad=to_quad)


class MixedRadauInterp(NamedTuple):
    """Per-primal-order Radau reconstruction tables, indexed by the primal
    order − 1 (n in 1..n_max_stack−1), zero-padded to np_max."""

    eval_rad: np.ndarray  # (L, np_max, np_max) order-n nodes -> the n+1 Radau points
    to_hi: np.ndarray  # (L, np_max, np_max) [Radau values, right endpoint] -> order-(n+1) GL nodes


def dg_radau_interp_mixed(mops: MixedDGTimeOperators) -> MixedRadauInterp:
    np_m, n_l = mops.np_max, mops.n_max - 1
    eval_rad = np.zeros((n_l, np_m, np_m))
    to_hi = np.zeros((n_l, np_m, np_m))
    for n in range(1, mops.n_max):
        m = n + 1
        rad = radau_points(m)
        eval_rad[n - 1, :m, : n + 1] = interp_matrix_1d(n, jacobi_gl(0.0, 0.0, n), rad)
        v_fit = np.linalg.inv(vandermonde_1d(m, np.concatenate([rad, [1.0]])))
        to_hi[n - 1, : m + 1, : m + 1] = vandermonde_1d(m, jacobi_gl(0.0, 0.0, m)) @ v_fit
    return MixedRadauInterp(eval_rad=eval_rad, to_hi=to_hi)


def _geometry(times: torch.Tensor, rq: torch.Tensor):
    """(B, K) left edges and widths, (B, K, Q) quadrature times."""
    tl, h = times[:, :-1], times[:, 1:] - times[:, :-1]
    return tl, h, tl[..., None] + (1.0 + rq) * h[..., None] / 2.0


def _inflows(u_primal: torch.Tensor, ns: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """(B, K) inflow values: y0, then each previous element's right endpoint
    u[ns_k] (a dynamic node)."""
    ends = torch.gather(u_primal, 2, ns[..., None])[..., 0]
    return torch.cat([y0[:, None], ends[:, :-1]], dim=1)


def _live_g(g_u, u_nodes, t_nodes, live):
    """g_u on the live nodes, exactly 0 on the padding (a g_u singular at 0
    never meets a padded node)."""
    if g_u is None:
        return live.to(u_nodes.dtype)
    return torch.where(live, g_u(u_nodes, t_nodes), torch.zeros_like(u_nodes))


def _backward_sweep(a_mat, rhs0, e_in, v_terminal):
    """Solve the (B, K) element systems backward: element k's right-endpoint
    inflow (selected by ``e_in``) is element k+1's left value v[0]."""
    v = torch.empty_like(rhs0)
    v_in = torch.full_like(rhs0[:, 0, 0], v_terminal)
    for k in range(rhs0.shape[1] - 1, -1, -1):
        v[:, k] = gauss_solve(a_mat[:, k], rhs0[:, k] - e_in[:, k] * v_in[:, None])
        v_in = v[:, k, 0]
    return v


def _adjoint_system(mops, f_u, u_q, t_q, h, i_ord):
    """−Sᵀ − e_L e_Lᵀ + h/2·Φᵀ diag(w ⊙ f_u(u_q)) Φ + pad_eye at the stack
    index ``i_ord`` (B, K), and the order's mass matrix."""
    stiff, mass, pad_eye, phi = (_tab(x, u_q) for x in (
        mops.stiff_pad, mops.mass_pad, mops.pad_eye, mops.phi_pad))
    wq = _tab(mops.wq, u_q)
    phi_a = phi[i_ord]  # (B, K, Q, np)
    m_w = h[..., None, None] / 2.0 * torch.einsum("bkqi,bkq,bkqj->bkij", phi_a, wq * f_u(u_q, t_q),
                                                   phi_a)
    base = -stiff[i_ord].transpose(-1, -2)
    base[..., 0, 0] = base[..., 0, 0] - 1.0
    return base + m_w + pad_eye[i_ord], mass[i_ord]


def _awr(mops, interp, f, u_primal, times, ns, y0, v_hi):
    """err_k = v_kᵀ R_k(u_H): the primal residual at order ns+1 with the
    interpolated primal, weighted by the order-(ns+1) adjoint."""
    rq, wq = _tab(mops.rq, times), _tab(mops.wq, times)
    stiff, phi = _tab(mops.stiff_pad, times), _tab(mops.phi_pad, times)
    to_nodes, to_quad = _tab(interp.to_nodes, times), _tab(interp.to_quad, times)
    _, h, t_q = _geometry(times, rq)
    u_q = torch.einsum("bkqj,bkj->bkq", to_quad[ns - 1], u_primal)
    u_h = torch.einsum("bkij,bkj->bki", to_nodes[ns - 1], u_primal)
    e_end = _one_hot(ns + 1, mops.np_max, times.dtype)
    m_tilde = h[..., None] / 2.0 * torch.einsum("bkqi,bkq->bki", phi[ns], wq * f(u_q, t_q))
    res = (torch.einsum("bkji,bkj->bki", stiff[ns], u_h)
           - e_end * torch.sum(e_end * u_h, dim=-1, keepdim=True) + m_tilde)
    res[..., 0] = res[..., 0] + _inflows(u_primal, ns, y0)
    return torch.sum(v_hi * res, dim=-1)


def dg_adjoint_march_mixed(
    mops: MixedDGTimeOperators,
    interp: MixedAdjointInterp,
    f: Callable,
    u_primal: torch.Tensor,  # (B, K, np_max) from dg_march_mixed
    times: torch.Tensor,  # (B, K+1)
    ns: torch.Tensor,  # (B, K) primal orders; the adjoint solves at ns+1
    y0: torch.Tensor,  # (B,)
    *,
    f_u: Callable | None = None,
    g_u: Callable | None = None,
    v_terminal: float = 0.0,
) -> DGAdjointResult:
    """Backward adjoint sweep at per-element order ``ns + 1`` with the
    per-element adjoint-weighted residual contributions; requires
    ``ns + 1 <= mops.n_max``. Returns v and node times (B, K, np_max) and
    err (B, K)."""
    times, ns, y0 = _batch(times, ns, y0)
    _check_orders(ns, mops.n_max - 1, what="ns (adjoint solves at ns+1)")
    f_u = f_u or elementwise_f_u(f)
    u_primal = u_primal.to(times.dtype)
    rq, r_p = _tab(mops.rq, times), _tab(mops.r_pad, times)
    to_nodes, to_quad = _tab(interp.to_nodes, times), _tab(interp.to_quad, times)
    tl, h, t_q = _geometry(times, rq)
    u_q = torch.einsum("bkqj,bkj->bkq", to_quad[ns - 1], u_primal)  # primal at quadrature
    u_h = torch.einsum("bkij,bkj->bki", to_nodes[ns - 1], u_primal)  # primal at adjoint nodes
    a_mat, m_ref = _adjoint_system(mops, f_u, u_q, t_q, h, ns)
    t_n = tl[..., None] + (1.0 + r_p[ns]) * h[..., None] / 2.0
    live = torch.arange(mops.np_max, device=times.device) <= (ns + 1)[..., None]
    g_vals = _live_g(g_u, u_h, t_n, live)
    rhs0 = -(h[..., None] / 2.0 * torch.einsum("bkij,bkj->bki", m_ref, g_vals))
    v = _backward_sweep(a_mat, rhs0, _one_hot(ns + 1, mops.np_max, times.dtype), v_terminal)
    return DGAdjointResult(v=v, t=t_n, err=_awr(mops, interp, f, u_primal, times, ns, y0, v))


def dg_element_functional_mixed(
    mops: MixedDGTimeOperators,
    u: torch.Tensor,  # (B, K, np_max)
    times: torch.Tensor,  # (B, K+1)
    ns: torch.Tensor,  # (B, K) the orders ``u`` was solved at
    g: Callable | None = None,
) -> torch.Tensor:
    """J_b = Σ_k ∫_k g(u_h) dt per member with per-element orders; ``g``
    defaults to J = ∫u. Returns (B,)."""
    times = torch.as_tensor(times, device=u.device).to(u.dtype)
    ns = torch.as_tensor(ns, device=u.device).to(torch.int64)
    _check_orders(ns, mops.n_max)
    return _functional(_functional_tables(mops, u), u, times, ns, g)


def _functional_tables(mops: MixedDGTimeOperators, like: torch.Tensor):
    """The functional's tables (r_q, w_q, Φ) in ``like``'s dtype, on its device."""
    return _tab(mops.rq, like), _tab(mops.wq, like), _tab(mops.phi_pad, like)


def _functional(tables, u, times, ns, g):
    """:func:`dg_element_functional_mixed` on prebuilt ``tables`` and without
    the order check: no host read or copy, for the adaptive loops (they keep
    their orders in range)."""
    rq, wq, phi = tables
    _, h, t_q = _geometry(times.to(u.dtype), rq)
    u_q = torch.einsum("bkqi,bki->bkq", phi[ns - 1], u)
    vals = u_q if g is None else g(u_q, t_q)
    return torch.sum(h / 2.0 * torch.sum(wq * vals, dim=-1), dim=1)


def dg_adjoint_solve_low_mixed(
    mops: MixedDGTimeOperators,
    f: Callable,
    u_primal: torch.Tensor,  # (B, K, np_max)
    times: torch.Tensor,
    ns: torch.Tensor,
    y0: torch.Tensor,
    *,
    f_u: Callable | None = None,
    g_u: Callable | None = None,
    v_terminal: float = 0.0,
) -> torch.Tensor:
    """Backward adjoint sweep AT the primal's per-element orders (the
    low-order solve that feeds :func:`dg_adjoint_reconstruct_mixed`): the
    inflow chains on the low solution's left value and enters at node
    ``ns_k``. Returns (B, K, np_max) padded nodal values."""
    times, ns, y0 = _batch(times, ns, y0)
    _check_orders(ns, mops.n_max)
    f_u = f_u or elementwise_f_u(f)
    u_primal = u_primal.to(times.dtype)
    rq, r_p, phi = _tab(mops.rq, times), _tab(mops.r_pad, times), _tab(mops.phi_pad, times)
    tl, h, t_q = _geometry(times, rq)
    u_q = torch.einsum("bkqj,bkj->bkq", phi[ns - 1], u_primal)
    a_mat, m_ref = _adjoint_system(mops, f_u, u_q, t_q, h, ns - 1)
    t_n = tl[..., None] + (1.0 + r_p[ns - 1]) * h[..., None] / 2.0
    live = torch.arange(mops.np_max, device=times.device) <= ns[..., None]
    g_vals = _live_g(g_u, u_primal, t_n, live)
    rhs0 = -(h[..., None] / 2.0 * torch.einsum("bkij,bkj->bki", m_ref, g_vals))
    return _backward_sweep(a_mat, rhs0, _one_hot(ns, mops.np_max, times.dtype), v_terminal)


def dg_adjoint_reconstruct_mixed(
    mops: MixedDGTimeOperators,
    rad: MixedRadauInterp,
    v_low: torch.Tensor,  # (B, K, np_max) adjoint solved at the primal orders
    ns: torch.Tensor,  # (B, K)
    v_terminal: float = 0.0,
) -> torch.Tensor:
    """Lift the per-element low-order adjoint to order ``ns + 1`` through
    Radau collocation and the known right-endpoint inflow (adj_rec.m:34-47,
    per element). ``v_terminal`` is the paired low solve's. Returns the
    (B, K, np_max) padded values at the order-(ns+1) GL nodes."""
    ns = torch.as_tensor(ns, device=v_low.device).to(torch.int64)
    _check_orders(ns, mops.n_max - 1, what="ns (reconstructs to ns+1)")
    eval_rad, to_hi = _tab(rad.eval_rad, v_low), _tab(rad.to_hi, v_low)
    # the inflow at each element's right end is the next element's v[0]; the
    # last element's is the terminal condition
    v_right_in = torch.cat([v_low[:, 1:, 0], torch.full_like(v_low[:, :1, 0], v_terminal)], dim=1)
    vals = (torch.einsum("bkij,bkj->bki", eval_rad[ns - 1], v_low)
            + _one_hot(ns + 1, mops.np_max, v_low.dtype) * v_right_in[..., None])
    return torch.einsum("bkij,bkj->bki", to_hi[ns - 1], vals)


def dg_awr_from_adjoint_mixed(
    mops: MixedDGTimeOperators,
    interp: MixedAdjointInterp,
    f: Callable,
    u_primal: torch.Tensor,
    times: torch.Tensor,
    ns: torch.Tensor,
    y0: torch.Tensor,
    v_hi: torch.Tensor,  # (B, K, np_max) adjoint at order ns+1 (solved or reconstructed)
) -> torch.Tensor:
    """Per-element adjoint-weighted residual err_k = v_kᵀ R_k(u_H) for a
    given order-(ns+1) adjoint (the reconstruction path's weighting step).
    Returns (B, K)."""
    times, ns, y0 = _batch(times, ns, y0)
    _check_orders(ns, mops.n_max - 1, what="ns (residual at ns+1)")
    return _awr(mops, interp, f, u_primal.to(times.dtype), times, ns, y0, v_hi)


def dg_estimate_mixed(
    mops: MixedDGTimeOperators,
    interp: MixedAdjointInterp,
    f: Callable,
    times: torch.Tensor,  # (B, K+1)
    ns: torch.Tensor,  # (B, K) primal orders
    y0: torch.Tensor,  # (B,)
    *,
    fine_offset: int = 2,
    adjoint_mode: str = "solve",
    rad: MixedRadauInterp | None = None,
    f_u: Callable | None = None,
    g_u: Callable | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    newton_iters: int | None = None,
):
    """The per-member hp pipeline: coarse march at ``ns``, fine march at
    ``ns + fine_offset``, the adjoint at ``ns + 1`` (solved, or
    'reconstruct': solved at ``ns`` and lifted through ``rad``) and the
    per-element AWR. Returns ``(u_c, u_f, v, err)``: (B, K, np_max) padded
    nodal values and (B, K) contributions. With ``newton_iters`` in float32
    and g_u ≡ 1 it is the plain version of the CUDA kernel
    ``dg_estimate_hp_per_member``."""
    if adjoint_mode not in ("solve", "reconstruct"):
        raise ValueError(f"unknown adjoint_mode {adjoint_mode!r}")
    times, ns, y0 = _batch(times, ns, y0)
    newton = dict(f_u=f_u, newton_tol=newton_tol, newton_maxit=newton_maxit,
                  newton_iters=newton_iters)
    u_c = dg_march_mixed(mops, f, times, ns, y0, **newton).u
    u_f = dg_march_mixed(mops, f, times, ns + fine_offset, y0, **newton).u
    if adjoint_mode == "reconstruct":
        v_low = dg_adjoint_solve_low_mixed(mops, f, u_c, times, ns, y0, f_u=f_u, g_u=g_u)
        v = dg_adjoint_reconstruct_mixed(mops, rad, v_low, ns)
        return u_c, u_f, v, dg_awr_from_adjoint_mixed(mops, interp, f, u_c, times, ns, y0, v)
    adj = dg_adjoint_march_mixed(mops, interp, f, u_c, times, ns, y0, f_u=f_u, g_u=g_u)
    return u_c, u_f, adj.v, adj.err
