"""Discontinuous-Galerkin-in-time ODE solver: element-by-element slab march
with Newton iteration (eager torch).

Counterpart of the JAX package's ``march/dg_time.py``. Reference parity:
``matlab/dg_march.m`` (weak form, upwind inter-element flux, Newton with
residual R = A·U + M̃(U) + F, A = Sᵀ + B, B[end,end] = −1, F[0] = u_prev,
M̃ = h/2·Φᵀ(w ⊙ f(u_q)), dR/dU = A + h/2·Φᵀdiag(w⊙f'(u_q))Φ) and
``matlab/fem_setup.m`` (per-slab operators).

- All elements share one operator set (order n, quadrature n_gq), built once
  on the host in float64; only the slab size h_k varies.
- The element march is a Python loop (the carry is the inflow value
  u_prev). Newton runs to tolerance (tol 1e-7, maxit 500, dg_march.m:34-36)
  with ``torch.linalg.solve``; its stopping test reads the update's norm on
  the host once per Newton step, which is a device synchronisation per step
  on the card. That is acceptable for the single run (tens of elements);
  the ensemble paths (march/dg_batched.py, the CUDA kernel) run a fixed
  Newton count instead.
- ``f(u, t)`` is the scalar right-hand side and ``f_u(u, t)`` its
  u-derivative: the registry's closed form (``odes.ODEProblem.f_u``), or,
  when ``None``, the forward-mode derivative of an elementwise ``f`` with a
  ones tangent (:func:`elementwise_f_u`), as the JAX package's ``jvp``.
- The JAX package's ``f32_matmuls`` (HIGHEST matmul precision on the TPU)
  has no counterpart: these products run in full float32 on the card, as
  the port's CUDA tests assert (TF32 off).

- ``dg_march_differentiable`` is the march that autograd differentiates:
  each slab is a ``torch.autograd.Function`` whose backward is the implicit
  function theorem (one transposed solve at the converged slab plus one
  residual VJP), never the Newton iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl, jacobi_gq
from adjoint_ode_adaptivity_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from adjoint_ode_adaptivity_tpu_torch.ops.operators import (
    dmatrix_1d,
    interp_matrix_1d,
    mass_matrix,
    stiffness_matrix,
    vandermonde_1d,
)

__all__ = [
    "DGTimeOperators",
    "dg_time_operators",
    "dg_march",
    "DGMarchResult",
    "elementwise_f_u",
    "make_dg_slab_solver",
    "dg_march_differentiable",
]


class DGTimeOperators(NamedTuple):
    """Static reference-element operators for order-n DG-in-time slabs."""

    n: int
    np_: int
    r: np.ndarray  # (Np,) GL nodes
    v: np.ndarray  # (Np, Np)
    mass: np.ndarray  # (Np, Np) reference mass (V Vᵀ)^{-1}
    stiff: np.ndarray  # (Np, Np) S = mass @ Dr
    rq: np.ndarray  # (Nq,) Gauss quadrature points
    wq: np.ndarray  # (Nq,)
    phi: np.ndarray  # (Nq, Np) nodal -> quadrature interpolation


def dg_time_operators(n: int, n_gq: int | None = None) -> DGTimeOperators:
    """Order-n operators with an (n_gq+1)-point Gauss rule.

    Default n_gq = 3n+6: enough oversampling that quadrature error of a
    smooth nonlinearity on O(1)-sized slabs sits below the 1e-10 effectivity
    floor (the reference uses 30·n, dg_march.m:29 — available by passing it
    explicitly; 2n+2 is NOT enough for sin(u) on h≈1 elements).
    """
    if n_gq is None:
        n_gq = 3 * n + 6
    r = jacobi_gl(0.0, 0.0, n)
    v = vandermonde_1d(n, r)
    dr = dmatrix_1d(n, r, v)
    rq, wq = jacobi_gq(0.0, 0.0, n_gq)
    return DGTimeOperators(
        n=n,
        np_=n + 1,
        r=r,
        v=v,
        mass=mass_matrix(v),
        stiff=stiffness_matrix(v, dr),
        rq=rq,
        wq=wq,
        phi=interp_matrix_1d(n, r, rq),
    )


def elementwise_f_u(f: Callable) -> Callable:
    """∂f/∂u of an elementwise ``f(u, t)``: one forward-mode derivative with
    a ones tangent (valid because each output depends on its own input
    only)."""

    def f_u(u, t):
        return torch.func.jvp(lambda uu: f(uu, t), (u,), (torch.ones_like(u),))[1]

    return f_u


class DGMarchResult(NamedTuple):
    u: torch.Tensor  # (K, Np) nodal solution per element
    t: torch.Tensor  # (K, Np) node times per element
    newton_iters: torch.Tensor  # (K,) iterations used
    newton_resnorm: torch.Tensor  # (K,) final residual norm


def _as(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _a_mat(ops: DGTimeOperators, dtype, device) -> torch.Tensor:
    """A = Sᵀ + B with B[−1, −1] = −1 (the upwind outflow term)."""
    a = ops.stiff.T.copy()
    a[-1, -1] += -1.0
    return _as(a, dtype, device)


def _slab_residual(ops: DGTimeOperators, f: Callable, u, u_prev, h, t_left, dtype):
    """R(U) = A·U + M̃(U) + F on one slab (dg_march.m:44-62 weak form)."""
    dev = u.device
    phi, wq = _as(ops.phi, dtype, dev), _as(ops.wq, dtype, dev)
    u_q = phi @ u
    t_q = t_left + (1.0 + _as(ops.rq, dtype, dev)) * h / 2.0
    m_tilde = h / 2.0 * (phi.T @ (wq * f(u_q, t_q)))
    f_vec = torch.zeros((ops.np_,), dtype=dtype, device=dev)
    f_vec[0] = u_prev
    return _a_mat(ops, dtype, dev) @ u + m_tilde + f_vec


def _slab_jacobian(ops: DGTimeOperators, f_u: Callable, u, h, t_left, dtype):
    """dR/dU = A + h/2·Φᵀ diag(w ⊙ f_u(u_q)) Φ."""
    dev = u.device
    phi, wq = _as(ops.phi, dtype, dev), _as(ops.wq, dtype, dev)
    u_q = phi @ u
    t_q = t_left + (1.0 + _as(ops.rq, dtype, dev)) * h / 2.0
    df = f_u(u_q, t_q)
    dmt = h / 2.0 * (phi.T @ (wq[:, None] * df[:, None] * phi))
    return _a_mat(ops, dtype, dev) + dmt


def dg_march(
    ops: DGTimeOperators,
    f: Callable,
    times: torch.Tensor,
    y0,
    *,
    f_u: Callable | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
) -> DGMarchResult:
    """March the DG-in-time solution over the partition ``times`` (K+1,).

    ``f(u, t)`` is the scalar right-hand side, ``f_u`` its u-derivative
    (derived from ``f`` when ``None``). The dtype and device are the
    partition's. Returns per-element nodal values, node times, and the
    Newton telemetry (dg_march.m:69-73 prints). Newton stops when the
    update's norm is at most ``newton_tol`` or after ``newton_maxit + 1``
    updates (a host read per update, see the module docstring).
    """
    times = torch.as_tensor(times)
    dtype, dev = times.dtype, times.device
    f_u = f_u or elementwise_f_u(f)
    r = _as(ops.r, dtype, dev)
    t_left = times[:-1]
    hs = times[1:] - times[:-1]
    u_prev = torch.as_tensor(y0, dtype=dtype, device=dev).reshape(())
    ones = torch.ones((ops.np_,), dtype=dtype, device=dev)
    us, ts, iters, resn = [], [], [], []
    for k in range(t_left.shape[0]):
        tl, h = t_left[k], hs[k]
        u = u_prev * ones
        it, du_norm = 0, float("inf")
        while it <= newton_maxit and du_norm > newton_tol:
            res = _slab_residual(ops, f, u, u_prev, h, tl, dtype)
            jac = _slab_jacobian(ops, f_u, u, h, tl, dtype)
            delta = torch.linalg.solve(jac, res)
            u = u - delta
            du_norm = float(torch.linalg.norm(delta))
            it += 1
        resn.append(torch.linalg.norm(_slab_residual(ops, f, u, u_prev, h, tl, dtype)))
        us.append(u)
        ts.append(tl + (1.0 + r) * h / 2.0)
        iters.append(it)
        u_prev = u[-1]
    return DGMarchResult(
        u=torch.stack(us),
        t=torch.stack(ts),
        newton_iters=torch.tensor(iters, dtype=torch.int32, device=dev),
        newton_resnorm=torch.stack(resn),
    )


# ------------------------------------------------------- differentiable march
#
# autograd cannot usefully flow through the Newton loop above. The right
# adjoint of an implicit solve is the implicit function theorem, not
# differentiating the iteration: at the solved slab R(u*) = 0,
# du*/dθ = −J⁻¹ ∂R/∂θ, so the vjp is one linear solve with Jᵀ plus one VJP
# of the residual, independent of how many Newton steps ran.


def _slab_residual_p(ops, f, u, u_prev, h, t_left, params, dtype):
    """R(U) with an explicit parameter pytree threaded to ``f(u, t, params)``
    (e.g. a neural right-hand side trained through the solver); the weak
    form is :func:`_slab_residual`'s."""
    return _slab_residual(ops, lambda uu, tt: f(uu, tt, params), u, u_prev, h, t_left, dtype)


def _leaf_tensors(params, dtype, device) -> tuple:
    """``params`` with every Python number as a 0-d tensor of ``dtype`` (a
    weakly typed number, as in JAX), and its leaves."""
    params = tree_map(lambda x: x if isinstance(x, torch.Tensor)
                      else torch.as_tensor(x, dtype=dtype, device=device), params)
    return params, tuple(tree_leaves(params))


def _residual_vjp(residual: Callable, primals, cot) -> tuple:
    """The cotangents ``cotᵀ ∂R/∂(primals)`` of ``residual(*primals)``, on
    detached copies (None for an input R does not use or that is not
    floating point)."""
    with torch.enable_grad():
        ins = [p.detach().requires_grad_(p.is_floating_point()) for p in primals]
        live = [x for x in ins if x.requires_grad]
        grads = iter(torch.autograd.grad(residual(*ins), live, grad_outputs=cot,
                                         allow_unused=True))
        return tuple(next(grads) if x.requires_grad else None for x in ins)


def _ift_solve(jac: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w with Jᵀ w = g: the adjoint of the converged slab's linearisation."""
    return torch.linalg.solve(jac.T, g)


class _ImplicitSlab(torch.autograd.Function):
    """A converged slab ``u`` (solved by the caller, outside autograd) as a
    function of the slab's inputs: the backward is the implicit function
    theorem at ``u``, one solve of Jᵀ w = g and one VJP of the residual at
    −w. ``spec`` is (residual, jacobian, ift_solve, residual_vjp), the first
    two called as f(u, u_prev, h, t_left, params); ``tree`` is the structure
    of ``params``, whose leaves follow as inputs."""

    @staticmethod
    def forward(ctx, spec, tree, u, u_prev, h, t_left, *leaves):
        ctx.spec, ctx.tree = spec, tree
        ctx.save_for_backward(u, u_prev, h, t_left, *leaves)
        return u.clone()

    @staticmethod
    def backward(ctx, g):
        u, *primals = ctx.saved_tensors
        residual, jacobian, ift_solve, residual_vjp = ctx.spec
        tree = ctx.tree
        w = ift_solve(jacobian(u, *primals[:3], tree_unflatten(tree, primals[3:])), g)
        bars = residual_vjp(
            lambda up, hh, tl, *lv: residual(u, up, hh, tl, tree_unflatten(tree, lv)), primals, -w)
        return (None, None, None, *bars)


def make_dg_slab_solver(
    ops: DGTimeOperators,
    f: Callable,
    *,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
):
    """Returns ``solve(u_prev, h, t_left, params) -> u``: one DG time slab
    solved by Newton (the residual's full Jacobian by forward-mode AD, so
    any ``f(u, t, params)`` works), whose gradient autograd takes by the
    implicit function theorem. It is exact with respect to ``u_prev``,
    ``h``, ``t_left`` and every leaf of ``params`` (a dict or sequence of
    tensors, a tensor, or None): the backward solves ``Jᵀ w = g`` at the
    converged state and pulls ``−w`` back through one residual VJP.
    """

    def residual(u, u_prev, h, t_left, params):
        dtype = torch.promote_types(u_prev.dtype, h.dtype)
        return _slab_residual_p(ops, f, u, u_prev, h, t_left, params, dtype)

    def jacobian(u, u_prev, h, t_left, params):
        return torch.func.jacfwd(lambda uu: residual(uu, u_prev, h, t_left, params))(u)

    def solve(u_prev, h, t_left, params=None):
        h = torch.as_tensor(h)
        dtype, dev = h.dtype, h.device
        u_prev = torch.as_tensor(u_prev, dtype=dtype, device=dev)
        t_left = torch.as_tensor(t_left, dtype=dtype, device=dev)
        params, leaves = _leaf_tensors(params, dtype, dev)
        with torch.no_grad():
            u = u_prev * torch.ones((ops.np_,), dtype=dtype, device=dev)
            it, du_norm = 0, float("inf")
            while it <= newton_maxit and du_norm > newton_tol:
                delta = torch.linalg.solve(jacobian(u, u_prev, h, t_left, params),
                                           residual(u, u_prev, h, t_left, params))
                u = u - delta
                du_norm = float(torch.linalg.norm(delta))
                it += 1
        return _ImplicitSlab.apply((residual, jacobian, _ift_solve, _residual_vjp), params, u,
                                   u_prev, h, t_left, *leaves)

    return solve


def dg_march_differentiable(
    ops: DGTimeOperators,
    f: Callable,
    times: torch.Tensor,
    y0,
    params=None,
    *,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
) -> torch.Tensor:
    """DG-in-time march that autograd differentiates: a loop of IFT slab
    solves (:func:`make_dg_slab_solver`). ``f(u, t, params)`` takes the
    parameter pytree explicitly (pass ``params=None`` and ignore it for
    plain ODEs). Returns the (K, Np) nodal solution, :func:`dg_march`'s
    values to Newton tolerance.

    Gradients flow to ``y0``, ``times`` (through the slab sizes and the
    quadrature times, outside the slab solves) and ``params``: a neural
    right-hand side trains *through* the implicit solver (the reference's
    Main_kk1d.py intent) without unrolling Newton into the graph.
    """
    times = torch.as_tensor(times)
    dtype, dev = times.dtype, times.device
    solve = make_dg_slab_solver(ops, f, newton_tol=newton_tol, newton_maxit=newton_maxit)
    params, _ = _leaf_tensors(params, dtype, dev)
    t_left = times[:-1]
    hs = times[1:] - times[:-1]
    u_prev = torch.as_tensor(y0, dtype=dtype, device=dev).reshape(())
    us = []
    for k in range(hs.shape[0]):
        u = solve(u_prev, hs[k], t_left[k], params)
        us.append(u)
        u_prev = u[-1]
    return torch.stack(us)
