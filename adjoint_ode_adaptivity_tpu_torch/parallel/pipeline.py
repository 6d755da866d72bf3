"""Pipeline-parallel time march over a ``pipe`` rank axis (GPipe).

Counterpart of the JAX package's ``parallel/pipeline.py``. The per-step
parameter ResNetODE (one residual block per time step,
python/Main_variable_params.py:46-65) is a chain of S stages. Rank d of a
D-rank ``pipe`` axis owns the parameters of the steps [d·S/D, (d+1)·S/D).
Microbatches of initial conditions pass round the ring: at each tick every
rank advances the microbatch it holds through its steps and hands the
state on with :func:`~.mesh.ring_shift`. After M + D − 1 ticks all M
microbatches have left the last stage (a bubble of (D−1)/(M+D−1) of the
ticks, the GPipe schedule).

There is no separate backward schedule: autograd runs back through the
stages and the shifts, and each shift's backward sends the cotangent one
rank back (:class:`~.mesh.RingShift`), as ``jax.grad`` transposes the
``ppermute``. A rank's parameters are S/D blocks' worth of the gradient.
"""
from __future__ import annotations

from typing import Callable

import torch

from adjoint_ode_adaptivity_tpu_torch.march.fd import times_from_dt
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import (
    RankGrid,
    all_gather,
    ring_shift,
    shard_along,
)
from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

__all__ = ["pipeline_march"]


class _FromLast(torch.autograd.Function):
    """Every rank of the line along ``axis`` gets the last rank's ``x``:
    JAX's ``psum`` of ``where(d == D−1, x, 0)``. The backward hands each
    rank its own cotangent, masked to the last rank: every rank computes
    the same loss from the result, so the last rank's own cotangent is the
    whole of it (an all-reduce here would count it D times)."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        d = grid.axis_size(axis)
        ctx.last = grid.axis_index(axis) == d - 1
        return all_gather(x[None], grid, axis)[d - 1]

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None, None


class _Gather(torch.autograd.Function):
    """:func:`~.mesh.all_gather` along ``dim``; the backward keeps this
    rank's block of the cotangent (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, x, grid, axis, dim):
        ctx.grid, ctx.axis, ctx.dim = grid, axis, dim
        return all_gather(x, grid, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return shard_along(grad, ctx.grid, ctx.axis, ctx.dim).contiguous(), None, None, None


def pipeline_march(step_fn: Callable, grid: RankGrid, axis: str = "pipe",
                   data_axis: str | None = None) -> Callable:
    """A pipeline-parallel march over ``grid``'s axis ``axis``.

    ``step_fn(u, t, dt, params_n) -> u'`` is ``march.fd.forward_march_per_step``'s
    step. Returns ``fn(params_stacked, dt, u0s, t0=0.0) -> finals``:
    ``params_stacked`` a dict (or tensor) of global tensors stacked over the
    S steps (leading axis S), of which this rank uses its contiguous S/D
    slice; ``dt`` (S,); ``u0s`` (M, *state), M microbatches; ``finals``
    (M, *state), every microbatch after all S steps, the same on every rank
    and equal to marching each microbatch through
    ``forward_march_per_step``. D must divide S (``ValueError``); take
    M ≥ a few × D to amortise the bubble.

    With ``data_axis`` (a second axis of the grid) each microbatch's members
    (``u0s`` dim 1) shard over that axis as well: the shifts ride ``axis``
    within each line of the grid, each stage runs its ``data_axis`` block
    of the members, and ``finals`` gathers the blocks back in member order.

    Gradients: every rank computes the same loss from ``finals`` and runs
    its backward. A rank's gradient of ``params_stacked`` is nonzero on its
    own slice of the steps only (join the slices with
    :func:`~.mesh.all_reduce_sum` over ``axis``); under ``data_axis`` it
    covers its block of the members (sum it over ``data_axis`` too)."""
    d_size = grid.axis_size(axis)
    here = grid.axis_index(axis)

    def stage(params_local, t_local, dt_local, u):
        """Advance ``u`` through this rank's S/D steps."""
        for n in range(dt_local.shape[0]):
            u = step_fn(u, t_local[n], dt_local[n], tree_map(lambda p, n=n: p[n], params_local))
        return u

    def fn(params_stacked, dt, u0s, t0: float = 0.0):
        dt = torch.as_tensor(dt)
        n_steps = dt.shape[0]
        if n_steps % d_size:
            raise ValueError(f"n_steps={n_steps} not divisible by pipe axis size {d_size}")
        t_starts = times_from_dt(dt, t0)[:-1]
        params_local = tree_map(lambda p: shard_along(p, grid, axis), params_stacked)
        t_local, dt_local = shard_along(t_starts, grid, axis), shard_along(dt, grid, axis)
        u0s = torch.as_tensor(u0s)
        if data_axis is not None:
            u0s = shard_along(u0s, grid, data_axis, dim=1)
        m = u0s.shape[0]
        first = torch.tensor(here == 0, device=u0s.device)
        buf = torch.zeros_like(u0s[0])
        outs = []
        for t in range(m + d_size - 1):
            # rank 0 feeds microbatch t; the others take what the previous
            # stage sent at the end of the last tick. A where, not a branch:
            # every rank's graph holds every shift, so each shift's backward
            # runs on every rank
            inp = torch.where(first, u0s[min(t, m - 1)], buf)
            out = stage(params_local, t_local, dt_local, inp)
            outs.append(out)
            if t < m + d_size - 2:
                buf = ring_shift(out, grid, axis)
        # the last rank's outputs at ticks D−1 … M+D−2 are the exits of
        # microbatches 0 … M−1
        finals = torch.stack(outs[d_size - 1:])
        if d_size > 1:
            finals = _FromLast.apply(finals, grid, axis)
        if data_axis is not None and grid.axis_size(data_axis) > 1:
            finals = _Gather.apply(finals, grid, data_axis, 1)
        return finals

    return fn
