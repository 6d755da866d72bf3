"""Mixed per-element-order DG-in-time march (p/hp-adaptivity support), eager
torch, batched over members.

Counterpart of the JAX package's ``march/dg_mixed.py``. Reference parity:
``matlab/dg_march.m:1`` takes a per-element order vector ``Ns`` and rebuilds
``fem_setup(Ns(k), ...)`` inside the element loop (dg_march.m:29); this
module makes that capability real.

- One shared Gauss rule (``3·n_max + 6`` points by default) and per-order
  operator tables padded to ``np_max = n_max + 1``
  (:class:`MixedDGTimeOperators`, host float64 NumPy, equal to the JAX
  package's): the padded rows and columns of every residual are zero,
  ``pad_eye`` pins the padded unknowns of each system to zero, padded node
  times sit at the element's right endpoint.
- Each element gathers its tables by its order at run time, so any order
  assignment runs the same code; the right-endpoint (outflow) value is the
  dynamic node ``u[ns_k]``.
- Members are the batch: ``times`` (B, K+1), ``ns`` (B, K), ``y0`` (B,);
  B = 1 is a single run. The padded systems are solved by the unrolled
  no-pivot elimination :func:`gauss_solve`.
- Newton runs a fixed count (``newton_iters``) or to the tolerance
  (tol 1e-7, maxit 500, dg_march.m:34-36). In tolerance mode each member
  stops updating at its own convergence, as the JAX package's vmapped
  ``while_loop`` does (the batch loop reads the active count on the host
  once per Newton step).

A zero-width slab (h = 0) reduces to ``S u + e_0 u_prev = 0`` whose
solution is the constant ``u_prev`` at every order, the Newton initial
guess, so padded partitions compose with mixed orders.

The implicit-function-theorem march (``make_dg_slab_solver_mixed``,
``dg_march_mixed_differentiable``) is not ported yet (ROADMAP queue 1 item
[8a]).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.dg_time import DGMarchResult, elementwise_f_u
from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl, jacobi_gq
from adjoint_ode_adaptivity_tpu_torch.ops.operators import (
    dmatrix_1d,
    interp_matrix_1d,
    mass_matrix,
    stiffness_matrix,
    vandermonde_1d,
)

__all__ = [
    "MixedDGTimeOperators",
    "dg_time_operators_mixed",
    "gauss_solve",
    "dg_march_mixed",
]


def gauss_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled no-pivot Gaussian elimination of the tiny padded slab
    systems: ``a`` (..., n, n), ``b`` (..., n) -> x, batched over the leading
    axes. Pivoting is safe to omit here: the padding identity keeps padded
    pivots exactly 1 and the live pivots of these slab systems stay well
    away from zero (the JAX package's tests pin the result to the pivoted
    solve)."""
    n = a.shape[-1]
    a, b = a.clone(), b.clone()
    for k in range(n - 1):
        inv = 1.0 / a[..., k, k]
        factor = a[..., k + 1:, k] * inv[..., None]
        a[..., k + 1:, :] = a[..., k + 1:, :] - factor[..., None] * a[..., k:k + 1, :]
        b[..., k + 1:] = b[..., k + 1:] - factor * b[..., k:k + 1]
    x = torch.zeros_like(b)
    for k in range(n - 1, -1, -1):
        rhs = b[..., k] - torch.sum(a[..., k, k + 1:] * x[..., k + 1:], dim=-1)
        x[..., k] = rhs / a[..., k, k]
    return x


class MixedDGTimeOperators(NamedTuple):
    """Per-order operator tables padded to ``np_max``, indexed by
    ``order - 1`` (orders 1..n_max); host float64 NumPy."""

    n_max: int
    np_max: int  # n_max + 1
    rq: np.ndarray  # (Q,) shared Gauss points
    wq: np.ndarray  # (Q,) shared Gauss weights
    r_pad: np.ndarray  # (n_max, np_max) GL nodes, padded with +1.0
    stiff_pad: np.ndarray  # (n_max, np_max, np_max) S_n, zero-padded
    mass_pad: np.ndarray  # (n_max, np_max, np_max) (V Vᵀ)⁻¹, zero-padded
    phi_pad: np.ndarray  # (n_max, Q, np_max) nodal -> quadrature, zero-padded
    pad_eye: np.ndarray  # (n_max, np_max, np_max) identity on the padding diagonal


def dg_time_operators_mixed(n_max: int, n_gq: int | None = None) -> MixedDGTimeOperators:
    """Stacked padded tables for orders ``1..n_max`` sharing one
    ``(n_gq+1)``-point Gauss rule (default ``3·n_max + 6``; the reference
    uses ``30·Ns(k)`` points, dg_march.m:29)."""
    if n_gq is None:
        n_gq = 3 * n_max + 6
    np_max = n_max + 1
    rq, wq = jacobi_gq(0.0, 0.0, n_gq)
    q = rq.shape[0]
    r_pad = np.ones((n_max, np_max))
    stiff_pad = np.zeros((n_max, np_max, np_max))
    mass_pad = np.zeros((n_max, np_max, np_max))
    phi_pad = np.zeros((n_max, q, np_max))
    pad_eye = np.zeros((n_max, np_max, np_max))
    for n in range(1, n_max + 1):
        np_n = n + 1
        r = jacobi_gl(0.0, 0.0, n)
        v = vandermonde_1d(n, r)
        dr = dmatrix_1d(n, r, v)
        r_pad[n - 1, :np_n] = r
        stiff_pad[n - 1, :np_n, :np_n] = stiffness_matrix(v, dr)
        mass_pad[n - 1, :np_n, :np_n] = mass_matrix(v)
        phi_pad[n - 1, :, :np_n] = interp_matrix_1d(n, r, rq)
        pad_eye[n - 1, np_n:, np_n:] = np.eye(np_max - np_n)
    return MixedDGTimeOperators(n_max=n_max, np_max=np_max, rq=rq, wq=wq, r_pad=r_pad,
                                stiff_pad=stiff_pad, mass_pad=mass_pad, phi_pad=phi_pad,
                                pad_eye=pad_eye)


def _one_hot(idx: torch.Tensor, length: int, dtype) -> torch.Tensor:
    """(..., length) rows with a 1 at ``idx`` (all zero where idx is out of range)."""
    return (torch.arange(length, device=idx.device) == idx[..., None]).to(dtype)


def _check_orders(ns: torch.Tensor, n_max: int, what: str = "ns") -> None:
    """Orders outside the stack would otherwise fail silently (a clamped
    table index, an all-zero right-endpoint selector); one host read."""
    if ns.numel():
        lo, hi = int(ns.min()), int(ns.max())
        if lo < 1 or hi > n_max:
            raise ValueError(f"{what} must lie in [1, {n_max}] (operator stack range); got "
                             f"[{lo}, {hi}]")


def _batch(times, ns, y0):
    """(B, K+1) partitions, (B, K) int64 orders and (B,) initial values,
    in the partitions' dtype and on their device."""
    times = torch.as_tensor(times)
    ns = torch.as_tensor(ns, device=times.device).to(torch.int64)
    y0 = torch.as_tensor(y0, dtype=times.dtype, device=times.device)
    if times.dim() != 2 or ns.dim() != 2 or y0.dim() != 1:
        raise ValueError(f"expected times (B, K+1), ns (B, K), y0 (B,); got {tuple(times.shape)}, "
                         f"{tuple(ns.shape)}, {tuple(y0.shape)}")
    b, k1 = times.shape
    if ns.shape != (b, k1 - 1) or y0.shape != (b,):
        raise ValueError(f"shape mismatch: times {tuple(times.shape)}, ns {tuple(ns.shape)}, "
                         f"y0 {tuple(y0.shape)}")
    return times, ns, y0


def _tab(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _a_fwd(mops: MixedDGTimeOperators) -> np.ndarray:
    """A_n = S_nᵀ − e_n e_nᵀ + pad_eye_n per order (the slab residual's
    linear part; e_n is node n, the order-n right endpoint)."""
    a = mops.stiff_pad.transpose(0, 2, 1).copy()
    for i in range(mops.n_max):
        a[i, i + 1, i + 1] -= 1.0
    return a + mops.pad_eye


def _a_adj(mops: MixedDGTimeOperators) -> np.ndarray:
    """A_n = −S_nᵀ − e_0 e_0ᵀ + pad_eye_n per order (the adjoint slab
    system's linear part; e_0 is the left node)."""
    a = -mops.stiff_pad.transpose(0, 2, 1) + mops.pad_eye
    a[:, 0, 0] -= 1.0
    return a


def dg_march_mixed(
    mops: MixedDGTimeOperators,
    f: Callable,
    times: torch.Tensor,  # (B, K+1) partitions
    ns: torch.Tensor,  # (B, K) orders in 1..n_max
    y0: torch.Tensor,  # (B,)
    *,
    f_u: Callable | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    newton_iters: int | None = None,
) -> DGMarchResult:
    """March B DG-in-time solutions with per-member, per-element orders.

    Same weak form and Newton semantics as
    :func:`~adjoint_ode_adaptivity_tpu_torch.march.dg_time.dg_march`
    (dg_march.m:26-78). ``f`` is elementwise; ``f_u`` its u-derivative
    (derived from ``f`` when ``None``). ``newton_iters`` runs that fixed
    count instead of the tolerance loop. Returns (B, K, np_max) padded nodal
    values (zero beyond node ``ns[k]``) and node times (the right endpoint
    there), and (B, K) Newton counts and final residual norms.
    """
    times, ns, y0 = _batch(times, ns, y0)
    _check_orders(ns, mops.n_max)
    f_u = f_u or elementwise_f_u(f)
    b, k_el = ns.shape
    np_m = mops.np_max
    a_fwd, phi, r_p = (_tab(x, times) for x in (_a_fwd(mops), mops.phi_pad, mops.r_pad))
    rq, wq = _tab(mops.rq, times), _tab(mops.wq, times)
    nodes = torch.arange(np_m, device=times.device)

    us, ts, iters, resn = [], [], [], []
    u_prev = y0
    for k in range(k_el):
        n_k = ns[:, k]
        a_mat, phi_k = a_fwd[n_k - 1], phi[n_k - 1]  # (B, np, np), (B, Q, np)
        tl, h = times[:, k], times[:, k + 1] - times[:, k]
        t_q = tl[:, None] + (1.0 + rq)[None, :] * h[:, None] / 2.0  # (B, Q)
        hh = (h / 2.0)[:, None]

        def residual(u, a_mat=a_mat, phi_k=phi_k, t_q=t_q, hh=hh, u_prev=u_prev):
            u_q = torch.einsum("bqi,bi->bq", phi_k, u)
            res = torch.einsum("bij,bj->bi", a_mat, u) + hh * torch.einsum(
                "bqi,bq->bi", phi_k, wq * f(u_q, t_q))
            res[:, 0] = res[:, 0] + u_prev
            return res

        def jacobian(u, a_mat=a_mat, phi_k=phi_k, t_q=t_q, hh=hh):
            u_q = torch.einsum("bqi,bi->bq", phi_k, u)
            dmt = torch.einsum("bqi,bq,bqj->bij", phi_k, wq * f_u(u_q, t_q), phi_k)
            return a_mat + hh[:, :, None] * dmt

        u = u_prev[:, None] * (nodes[None, :] <= n_k[:, None]).to(times.dtype)
        if newton_iters is not None:
            for _ in range(newton_iters):
                u = u - gauss_solve(jacobian(u), residual(u))
            cnt = torch.full((b,), newton_iters, dtype=torch.int32, device=times.device)
        else:
            # each member updates until its own update norm is at most the
            # tolerance (or after newton_maxit + 1 updates)
            du = torch.full((b,), torch.inf, dtype=times.dtype, device=times.device)
            cnt = torch.zeros((b,), dtype=torch.int32, device=times.device)
            active = du > newton_tol
            while bool(active.any()):
                delta = gauss_solve(jacobian(u), residual(u))
                u = torch.where(active[:, None], u - delta, u)
                du = torch.where(active, torch.linalg.vector_norm(delta, dim=1), du)
                cnt = cnt + active.to(torch.int32)
                active = (cnt <= newton_maxit) & (du > newton_tol)
        res = residual(u)
        us.append(u)
        ts.append(tl[:, None] + (1.0 + r_p[n_k - 1]) * h[:, None] / 2.0)
        iters.append(cnt)
        resn.append(torch.linalg.vector_norm(res, dim=1))
        u_prev = torch.gather(u, 1, n_k[:, None])[:, 0]
    return DGMarchResult(u=torch.stack(us, dim=1), t=torch.stack(ts, dim=1),
                         newton_iters=torch.stack(iters, dim=1),
                         newton_resnorm=torch.stack(resn, dim=1))
