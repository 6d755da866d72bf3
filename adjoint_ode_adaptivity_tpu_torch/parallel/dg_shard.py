"""Element-sharded DG advection in plain torch: the K axis distributed over
the ranks of a :class:`~.mesh.RankGrid` axis, the face traces exchanged
between neighbouring ranks at every RHS evaluation.

Counterpart of the JAX package's ``parallel/dg_shard.py``. Each rank runs
on its own contiguous (Np, K/D) slice (:func:`~.mesh.shard_along`). 1D DG
couples neighbouring elements through one trace value per face, so an RHS
evaluation sends this rank's first left trace to the previous rank and its
last right trace to the next (one float each way); the global inflow and
outflow conditions apply on the first and last rank. The local RHS is the
single-device ``march.advec.advec_rhs`` with the neighbour traces of the
shard's edge elements taken from the exchange, so at world 1 the march is
the single-device march, operation for operation.

The adjoint: JAX gets it from ``jax.linear_transpose``, which turns each
``ppermute`` into the inverse permutation. Here the exchange is a
``torch.autograd.Function`` whose backward is the reverse exchange (the
cotangent of what a rank received goes back to the rank that sent it), and
the transpose of one homogeneous half step is ``torch.autograd.grad`` of the
step (as adjoint/revolve_vjp.py takes a per-step VJP). Every rank makes the
same sequence of exchanges, forward and backward.
"""
from __future__ import annotations

import math

import torch

from adjoint_ode_adaptivity_tpu_torch.march.advec import AdvecOperators
from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import (
    RankGrid,
    all_reduce_sum,
    exchange,
    shard_along,
)

__all__ = [
    "local_operators",
    "advec_rhs_local",
    "advec_march_sharded",
    "advec_fwd_adj_estimate_sharded",
]


class _TraceExchange(torch.autograd.Function):
    """(to_prev, to_next) -> (from_prev, from_next) along ``axis``; zeros
    where a rank has no neighbour. Backward sends each received block's
    cotangent back to its sender."""

    @staticmethod
    def forward(ctx, to_prev, to_next, grid, axis):
        ctx.grid, ctx.axis = grid, axis
        from_prev, from_next = exchange(to_prev, to_next, grid, axis)
        return (torch.zeros_like(to_next) if from_prev is None else from_prev,
                torch.zeros_like(to_prev) if from_next is None else from_next)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # the previous rank's to_next arrived here as from_prev: its
        # cotangent g_prev goes back to the previous rank, and so on
        grad_prev, grad_next = exchange(g_prev.contiguous(), g_next.contiguous(),
                                        ctx.grid, ctx.axis)
        return (torch.zeros_like(g_next) if grad_prev is None else grad_prev,
                torch.zeros_like(g_prev) if grad_next is None else grad_next, None, None)


def local_operators(ops: AdvecOperators, grid: RankGrid, axis: str = "space") -> AdvecOperators:
    """The operator bundle of this rank's element slice (the per-element
    fields rx, fscale, nx and the flux factor along K)."""
    return ops._replace(**{name: shard_along(getattr(ops, name), grid, axis, dim=1)
                           for name in ("rx", "fscale", "nx", "flux_fac")})


def advec_rhs_local(ops_local: AdvecOperators, u: torch.Tensor, t: float, grid: RankGrid,
                    axis: str = "space", inflow: bool = True) -> torch.Tensor:
    """du/dt on this rank's (Np, K/D) block: ``march.advec.advec_rhs`` with
    the previous rank's last right trace and the next rank's first left
    trace; the inflow BC −sin(a·t) on the first rank, no outflow face on the
    last. ``inflow=False`` freezes the BC at zero (the homogeneous operator)."""
    ff = ops_local.flux_fac
    u_left, u_right = u[0], u[-1]
    prev_right, next_left = _TraceExchange.apply(u_left[:1], u_right[-1:], grid, axis)
    index, n_ranks = grid.axis_index(axis), grid.axis_size(axis)
    if index == 0:
        uin = -math.sin(ops_local.a * t) if inflow else 0.0
        left = (u_left[:1] - uin) * ff[0, :1]
    else:
        left = (u_left[:1] - prev_right) * ff[0, :1]
    du_left = torch.cat([left, (u_left[1:] - u_right[:-1]) * ff[0, 1:]])
    right = (torch.zeros_like(u_right[:1]) if index == n_ranks - 1
             else (u_right[-1:] - next_left) * ff[1, -1:])
    du_right = torch.cat([(u_right[:-1] - u_left[1:]) * ff[1, :-1], right])
    du = torch.stack([du_left, du_right])
    vol = -ops_local.a * ops_local.rx * (ops_local.dr @ u)
    return vol + ops_local.lift @ (ops_local.fscale * du)


def _lsrk_step_local(ops_local, u, t: float, dt: float, grid, axis, inflow=True):
    """One LSRK4(5) step on the local block (``march.advec.lsrk_stages``)."""
    resu = torch.zeros_like(u)
    for s in range(5):
        rhs = advec_rhs_local(ops_local, u, t + float(RK4C[s]) * dt, grid, axis, inflow)
        resu = float(RK4A[s]) * resu + dt * rhs
        u = u + float(RK4B[s]) * resu
    return u


def advec_march_sharded(ops: AdvecOperators, grid: RankGrid, u0: torch.Tensor, dt: float,
                        n_steps: int, axis: str = "space", t0: float = 0.0) -> torch.Tensor:
    """LSRK4(5) march of this rank's slice ``u0`` (Np, K/D) of the global
    state, ``ops`` the global bundle. Returns this rank's final slice."""
    ops_local = local_operators(ops, grid, axis)
    u = u0
    for n in range(n_steps):
        u = _lsrk_step_local(ops_local, u, t0 + n * dt, dt, grid, axis)
    return u


def advec_fwd_adj_estimate_sharded(
    ops: AdvecOperators, grid: RankGrid, u0: torch.Tensor, lam_end: torch.Tensor, dt: float,
    n_steps: int, segment: int = 32, axis: str = "space", t0: float = 0.0,
):
    """Forward march, fine (half-step-squared) adjoint sweep and per-element
    adjoint-weighted step-doubling estimate, with two-level checkpointing,
    on this rank's slices ``u0``, ``lam_end`` (Np, K/D) —
    ``adjoint.advec.advec_fwd_adj_estimate``'s structure with the halos
    exchanged and their transposes taken by autograd.

    Returns ``(u_final, lam0, eta, j_value)``: this rank's slices and the
    global J = Σ λ·u(T) (the same on every rank)."""
    if n_steps % segment != 0:
        raise ValueError(f"n_steps={n_steps} not a multiple of segment={segment}")
    n_seg = n_steps // segment
    dt = float(dt)
    ops_local = local_operators(ops, grid, axis)

    def step(u, t):
        return _lsrk_step_local(ops_local, u, t, dt, grid, axis)

    def half_t(lam):
        v = torch.zeros_like(lam, requires_grad=True)
        with torch.enable_grad():
            out = _lsrk_step_local(ops_local, v, 0.0, dt / 2, grid, axis, inflow=False)
            (g,) = torch.autograd.grad(out, v, lam)
        return g

    seg_starts = []
    u = u0
    for si in range(n_seg):
        seg_starts.append(u)
        for i in range(segment):
            u = step(u, t0 + (si * segment + i) * dt)
    u_final = u
    j_value = all_reduce_sum(torch.sum(lam_end * u_final), grid)

    lam = lam_end
    eta = torch.zeros(u0.shape[1], dtype=u0.dtype, device=u0.device)
    for si in reversed(range(n_seg)):
        us = []
        u = seg_starts[si]
        for i in range(segment):
            us.append(u)
            u = step(u, t0 + (si * segment + i) * dt)
        u_np1 = u
        for i in reversed(range(segment)):
            t_n = t0 + (si * segment + i) * dt
            half = _lsrk_step_local(ops_local, us[i], t_n, dt / 2, grid, axis)
            half2 = _lsrk_step_local(ops_local, half, t_n + dt / 2, dt / 2, grid, axis)
            eta = eta + torch.sum(lam * (u_np1 - half2), dim=0)
            lam = half_t(half_t(lam))
            u_np1 = us[i]
    return u_final, lam, eta, j_value
