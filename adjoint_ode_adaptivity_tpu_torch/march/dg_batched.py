"""Batched (ensemble) DG-in-time slab march, adjoint sweep and estimate
(eager torch).

Counterpart of the JAX package's ``march/dg_batched.py`` (the Newton element
solve of ``matlab/dg_march.m:26-78``, driven at ``MAIN.m:29-166`` scale):
B initial conditions and/or time partitions are marched together.

- Inside, states are ``(Np, B)``: every Newton operation is a short chain of
  (B,)-wide tensor operations. The public contract is ``(B, K, Np)``.
- The Np×Np systems are solved in closed form (:func:`solve_small`): Cramer
  cofactor expansion for Np ≤ 4, unrolled Gaussian elimination with
  branch-free partial pivoting (:func:`ge_solve_rows`) for 4 < Np ≤ 8, and
  ``torch.linalg.solve`` above. The same arithmetic is what the CUDA kernel
  (csrc/dg_slab.cu) runs per thread, so this module is also the kernel's
  plain version (ops/cuda/dg_slab.py).
- Newton runs either to the batch max-norm tolerance (reference semantics:
  tol 1e-7 / maxit 500, dg_march.m:34-36; the stopping test reads the norm
  on the host once per Newton step) or a fixed count (``newton_iters=``,
  no host read).

The right-hand side ``f(u, t)`` must be elementwise; ``f_u`` is its
u-derivative (derived from ``f`` when ``None``). The implicit-function-
theorem marches (``make_dg_slab_solver_batched``,
``dg_march_batched_differentiable``) are not ported yet (ROADMAP queue 1
item [8a]).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_time import _interp_ops
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import DGTimeOperators, _as, elementwise_f_u

__all__ = [
    "solve_small",
    "ge_solve_rows",
    "DGBatchedResult",
    "DGBatchedAdjointResult",
    "dg_march_batched",
    "dg_adjoint_march_batched",
    "dg_element_functional_batched",
    "dg_estimate_batched",
]


# ------------------------------------------------------------ small solves
def _det(rows):
    """Determinant of a tiny matrix given as nested lists of (B,)-tensors,
    by first-row cofactor expansion — unrolls to a fixed multiply-add chain."""
    n = len(rows)
    if n == 1:
        return rows[0][0]
    if n == 2:
        return rows[0][0] * rows[1][1] - rows[0][1] * rows[1][0]
    det = None
    for j in range(n):
        minor = [r[:j] + r[j + 1 :] for r in rows[1:]]
        term = rows[0][j] * _det(minor)
        if j % 2:
            term = -term
        det = term if det is None else det + term
    return det


def ge_solve_rows(jac, res):
    """Solve the n×n systems given as nested lists of same-shaped batch
    tensors by unrolled Gaussian elimination with branch-free partial
    pivoting: each batch member picks its own pivot through elementwise
    compare-and-``where`` row swaps, so the factorisation is a fixed chain
    of tensor operations.

    ``jac``: n lists of n entries; ``res``: n entries (the augmented
    column). Returns the list of n solution entries."""
    n = len(res)
    rows = [list(jac[i]) + [res[i]] for i in range(n)]
    for k in range(n):
        # bubble the largest |pivot| (per batch member) into row k; only the
        # live columns k..n swap (columns < k are already eliminated)
        for i in range(k + 1, n):
            take = torch.abs(rows[i][k]) > torch.abs(rows[k][k])
            swapped = [(torch.where(take, bi, ai), torch.where(take, ai, bi))
                       for ai, bi in zip(rows[k][k:], rows[i][k:])]
            rows[k] = rows[k][:k] + [s[0] for s in swapped]
            rows[i] = rows[i][:k] + [s[1] for s in swapped]
        for i in range(k + 1, n):
            m = rows[i][k] / rows[k][k]
            rows[i] = [None] * (k + 1) + [rows[i][j] - m * rows[k][j] for j in range(k + 1, n + 1)]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = rows[i][n]
        for j in range(i + 1, n):
            acc = acc - rows[i][j] * x[j]
        x[i] = acc / rows[i][i]
    return x


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for a batch of tiny systems in closed form.

    ``a`` has shape ``(n, n, ...)`` (trailing batch axes broadcast against
    ``b``'s ``(n, ...)``). n ≤ 4: Cramer's rule by cofactor expansion;
    4 < n ≤ 8: :func:`ge_solve_rows`; n > 8: ``torch.linalg.solve`` on the
    batch moved to the front."""
    n = a.shape[0]
    if a.shape[1] != n or b.shape[0] != n:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if n > 8:
        a_b = torch.movedim(a, (0, 1), (-2, -1))
        b_b = torch.movedim(b, 0, -1)[..., None]
        a_b = a_b.expand(b_b.shape[:-2] + (n, n))
        return torch.movedim(torch.linalg.solve(a_b, b_b)[..., 0], -1, 0)
    if n > 4:
        # widen every entry to the common batch shape first: the where-swaps
        # mix matrix and right-hand-side entries
        shp = torch.broadcast_shapes(a.shape[2:], b.shape[1:])
        dt = torch.promote_types(a.dtype, b.dtype)
        jac = [[a[i, j].to(dt).expand(shp) for j in range(n)] for i in range(n)]
        rhs = [b[i].to(dt).expand(shp) for i in range(n)]
        return torch.stack(ge_solve_rows(jac, rhs))
    rows = [[a[i, j] for j in range(n)] for i in range(n)]
    d = _det(rows)
    cols = []
    for i in range(n):
        rows_i = [[b[r] if c == i else a[r, c] for c in range(n)] for r in range(n)]
        cols.append(_det(rows_i) / d)
    return torch.stack(torch.broadcast_tensors(*cols))


# ------------------------------------------------------------ forward march
class DGBatchedResult(NamedTuple):
    u: torch.Tensor  # (B, K, Np) nodal solution
    newton_iters: torch.Tensor  # (B, K) Newton updates until converged
    newton_resnorm: torch.Tensor  # (B, K) final residual norm


def _norm_times(times, y0):
    """(B, K+1) partitions and (B,) initial values from shared or per-member
    partitions and a scalar or per-member y0."""
    times = torch.as_tensor(times)
    # a Python number takes the partition's dtype (JAX's weak typing)
    y0 = torch.atleast_1d(torch.as_tensor(
        y0, dtype=times.dtype if isinstance(y0, (int, float)) else None, device=times.device))
    if times.dim() == 1:
        times = times[None, :].expand(y0.shape[0], times.shape[0])
    if y0.shape[0] == 1 and times.shape[0] > 1:
        y0 = y0.expand(times.shape[0])
    if times.shape[0] != y0.shape[0]:
        raise ValueError(f"batch mismatch: times {tuple(times.shape)}, y0 {tuple(y0.shape)}")
    return times, y0


def _slab_geometry(times: torch.Tensor):
    """(K, B) left edges and widths of (B, K+1) partitions."""
    return times[:, :-1].T, (times[:, 1:] - times[:, :-1]).T


def dg_march_batched(
    ops: DGTimeOperators,
    f: Callable,
    times: torch.Tensor,  # (K+1,) shared or (B, K+1) per-member partitions
    y0,  # scalar or (B,)
    *,
    f_u: Callable | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    newton_iters: int | None = None,
) -> DGBatchedResult:
    """March B independent DG-in-time solves together.

    Same weak form and Newton semantics as
    :func:`~adjoint_ode_adaptivity_tpu_torch.march.dg_time.dg_march`
    (dg_march.m:44-68), batched over initial conditions and (optionally)
    per-member partitions. With ``newton_iters`` set, runs exactly that many
    Newton updates per element instead of the max-norm tolerance loop, whose
    per-member count counts the updates a member took while it was still
    above tolerance.
    """
    times, y0 = _norm_times(times, y0)
    dtype = torch.promote_types(times.dtype, y0.dtype)
    times, y0 = times.to(dtype), y0.to(dtype)
    dev = times.device
    f_u = f_u or elementwise_f_u(f)
    b, np_ = y0.shape[0], ops.np_
    phi, wq, rq = (_as(x, dtype, dev) for x in (ops.phi, ops.wq, ops.rq))
    a_np = ops.stiff.T.copy()
    a_np[-1, -1] += -1.0
    a_mat = _as(a_np, dtype, dev)
    t_lefts, hs = _slab_geometry(times)

    def residual(u, u_prev, h, fq):
        res = a_mat @ u + (h / 2.0) * (phi.T @ (wq[:, None] * fq))
        res[0] = res[0] + u_prev
        return res

    def newton_update(u, u_prev, h, t_q):
        u_q = phi @ u
        res = residual(u, u_prev, h, f(u_q, t_q))
        # jac[i, j, b] = a_mat[i, j] + h/2 Σ_q φ_qi (w_q f_u,q) φ_qj
        jac = a_mat[:, :, None] + (h / 2.0) * torch.einsum(
            "qi,qb,qj->ijb", phi, wq[:, None] * f_u(u_q, t_q), phi)
        delta = solve_small(jac, res)
        return u - delta, torch.sqrt(torch.sum(delta * delta, dim=0))

    us, iters, resnorms = [], [], []
    u_prev = y0
    for k in range(t_lefts.shape[0]):
        tl, h = t_lefts[k], hs[k]
        t_q = tl[None, :] + (1.0 + rq)[:, None] * h[None, :] / 2.0  # (Nq, B)
        u = u_prev[None, :].expand(np_, b).clone()
        if newton_iters is not None:
            for _ in range(newton_iters):
                u, _ = newton_update(u, u_prev, h, t_q)
            cnt = torch.full((b,), newton_iters, dtype=torch.int32, device=dev)
        else:
            norm = torch.full((b,), torch.inf, dtype=dtype, device=dev)
            cnt = torch.zeros((b,), dtype=torch.int32, device=dev)
            it = 0
            while it <= newton_maxit and float(torch.max(norm)) > newton_tol:
                u, new_norm = newton_update(u, u_prev, h, t_q)
                # this update "worked" for the members above tolerance before it
                cnt = cnt + (norm > newton_tol).to(torch.int32)
                norm, it = new_norm, it + 1
        res = residual(u, u_prev, h, f(phi @ u, t_q))
        us.append(u)
        iters.append(cnt)
        resnorms.append(torch.sqrt(torch.sum(res * res, dim=0)))
        u_prev = u[-1]
    return DGBatchedResult(
        u=torch.stack(us).permute(2, 0, 1),  # (K, Np, B) -> (B, K, Np)
        newton_iters=torch.stack(iters).T,
        newton_resnorm=torch.stack(resnorms).T,
    )


# ------------------------------------------------------------ adjoint march
class DGBatchedAdjointResult(NamedTuple):
    v: torch.Tensor  # (B, K, Np_adj)
    err: torch.Tensor  # (B, K) adjoint-weighted residual contributions


def dg_adjoint_march_batched(
    ops_adj: DGTimeOperators,
    f: Callable,
    u_primal: torch.Tensor,  # (B, K, Np_primal) from dg_march_batched
    times: torch.Tensor,  # (K+1,) or (B, K+1)
    y0,
    *,
    f_u: Callable | None = None,
    g_u: Callable | None = None,
    v_terminal: float = 0.0,
) -> DGBatchedAdjointResult:
    """Batched backward adjoint sweep and per-element error contributions —
    the batched :func:`~adjoint_ode_adaptivity_tpu_torch.adjoint.dg_time.dg_adjoint_march`
    (adj_march.m:65-120, in-element quadrature form). ``g_u`` defaults to
    J = ∫u (g_u ≡ 1). One closed-form Np×Np solve per element."""
    b = u_primal.shape[0]
    dtype, dev = u_primal.dtype, u_primal.device
    times, y0 = _norm_times(torch.as_tensor(times, device=dev),
                            torch.as_tensor(y0, dtype=dtype, device=dev).expand(b))
    times, y0 = times.to(dtype), y0.to(dtype)
    f_u = f_u or elementwise_f_u(f)
    np_a = ops_adj.np_
    to_nodes, to_quad = (_as(x, dtype, dev) for x in _interp_ops(u_primal.shape[2] - 1, ops_adj))
    s, m_ref, phi, wq, rq, r_adj = (
        _as(x, dtype, dev)
        for x in (ops_adj.stiff, ops_adj.mass, ops_adj.phi, ops_adj.wq, ops_adj.rq, ops_adj.r))
    base = -s.T
    base[0, 0] = base[0, 0] - 1.0
    t_lefts, hs = _slab_geometry(times)
    u_elems = u_primal.permute(1, 2, 0)  # (K, Np_p, B)
    u_prevs = torch.cat([y0[None, :], u_primal[:, :-1, -1].T], dim=0)  # (K, B)

    vs, errs = [None] * hs.shape[0], [None] * hs.shape[0]
    v_in = torch.full((b,), v_terminal, dtype=dtype, device=dev)
    for k in range(hs.shape[0] - 1, -1, -1):
        u_el, tl, h = u_elems[k], t_lefts[k], hs[k]
        u_q = to_quad @ u_el  # (Nq, B)
        t_q = tl[None, :] + (1.0 + rq)[:, None] * h[None, :] / 2.0
        fq, dfq = f(u_q, t_q), f_u(u_q, t_q)
        m_w = torch.einsum("qi,qb,qj->ijb", phi, wq[:, None] * dfq, phi) * (h / 2.0)
        a_mat = base[:, :, None] + m_w  # (Np_a, Np_a, B)
        u_h = to_nodes @ u_el  # (Np_a, B)
        if g_u is None:
            g_vals = torch.ones_like(u_h)
        else:
            g_vals = g_u(u_h, tl[None, :] + (1.0 + r_adj)[:, None] * h[None, :] / 2.0)
        rhs = -((h / 2.0) * (m_ref @ g_vals))
        rhs[-1] = rhs[-1] - v_in
        v_el = solve_small(a_mat, rhs)  # (Np_a, B)

        res = s.T @ u_h + (h / 2.0) * (phi.T @ (wq[:, None] * fq))
        res[-1] = res[-1] - u_h[-1]
        res[0] = res[0] + u_prevs[k]
        vs[k], errs[k] = v_el, torch.sum(v_el * res, dim=0)
        v_in = v_el[0]
    return DGBatchedAdjointResult(v=torch.stack(vs).permute(2, 0, 1), err=torch.stack(errs).T)


def dg_element_functional_batched(
    ops: DGTimeOperators,
    u: torch.Tensor,  # (B, K, Np)
    times: torch.Tensor,  # (K+1,) or (B, K+1)
    g: Callable | None = None,
) -> torch.Tensor:
    """J_b = Σ_k ∫_k g(u_h) dt per ensemble member (MAIN.m:55-73); ``g``
    defaults to J = ∫u."""
    b = u.shape[0]
    times, _ = _norm_times(torch.as_tensor(times, device=u.device),
                           torch.zeros((b,), dtype=u.dtype, device=u.device))
    hs = times[:, 1:] - times[:, :-1]  # (B, K)
    phi, wq, rq = (_as(x, u.dtype, u.device) for x in (ops.phi, ops.wq, ops.rq))
    u_q = torch.einsum("qi,bki->bkq", phi, u)
    vals = u_q
    if g is not None:
        vals = g(u_q, times[:, :-1, None] + (1.0 + rq)[None, None, :] * hs[:, :, None] / 2.0)
    return torch.sum(hs / 2.0 * torch.einsum("q,bkq->bk", wq, vals), dim=1)


def dg_estimate_batched(
    ops_p: DGTimeOperators,
    ops_a: DGTimeOperators,
    f: Callable,
    times: torch.Tensor,
    y0,
    *,
    f_u: Callable | None = None,
    g_u: Callable | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    newton_iters: int | None = None,
):
    """The batched fwd(n) + adjoint(n+1) + per-element AWR pipeline.

    Returns ``(u (B,K,Np), v (B,K,Np+1), err (B,K))`` — the whole-ensemble
    refinement signal (Main_variable_params.py:330-341's ensemble, for the
    DG-in-time strand). With ``newton_iters`` in float32 and g_u ≡ 1 it is
    the plain version of the CUDA kernel ``dg_estimate_ensemble``."""
    fwd = dg_march_batched(ops_p, f, times, y0, f_u=f_u, newton_tol=newton_tol,
                           newton_maxit=newton_maxit, newton_iters=newton_iters)
    adj = dg_adjoint_march_batched(ops_a, f, fwd.u, times, y0, f_u=f_u, g_u=g_u)
    return fwd.u, adj.v, adj.err
