"""Data-parallel IC and seed ensembles over the ranks of a :class:`~.mesh.RankGrid`.

Counterpart of the JAX package's ``parallel/ensemble.py``. There each device
of a mesh runs its shard of the members under ``shard_map`` and means reduce
with ``psum``; here each rank of a process group runs its shard and means
reduce with :func:`~.mesh.all_reduce_sum`, with no gather of the members.

Every wrapper takes the global arrays, the same on every rank (as a JAX
caller passes global arrays): ``u0s`` (the members along the leading axis)
and the extras, replicated, except those listed in ``shard_extras``, which
shard along their leading axis with the members. Each rank runs the
contiguous block of members that :func:`~.mesh.shard_along` gives it (the
block ``P(axis)`` gives the device at its place), so B must divide over the
axis. Per-member outputs stay sharded, this rank's block
(``out_specs=P(axis)``); :func:`~.mesh.all_gather` joins them in member
order. Means and the refinement signal are global and the same on every
rank. At world 1 every wrapper is its function on all members.
"""
from __future__ import annotations

from typing import Callable

import torch

from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import RankGrid, all_reduce_sum, shard_along
from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

__all__ = [
    "ensemble_vmap",
    "ensemble_mean",
    "ensemble_refinement_signal",
    "ensemble_batched",
]


def _per_member(fn: Callable, vectorize: bool) -> Callable:
    """``fn`` (one member, then the extras) over a leading member axis:
    ``torch.func.vmap``, or a loop stacking each member's outputs where
    ``fn`` is not vmappable (a kernel call, a data-dependent branch)."""

    def run(u0s, *extras):
        if vectorize:
            return torch.func.vmap(lambda u0: fn(u0, *extras))(u0s)
        outs = [fn(u0, *extras) for u0 in u0s]
        return tree_map(lambda *xs: torch.stack(xs), *outs)

    return run


def ensemble_vmap(fn: Callable, grid: RankGrid, axis: str = "data",
                  vectorize: bool = True) -> Callable:
    """``fn`` (one IC and the replicated extras to a tree of tensors) over
    this rank's members: ``wrapper(u0s, *extras)`` returns the rank's
    per-member outputs. ``vectorize=False`` loops over the members."""
    run = _per_member(fn, vectorize)

    def wrapper(u0s, *extras):
        return run(shard_along(u0s, grid, axis), *extras)

    return wrapper


def ensemble_batched(batched_fn: Callable, grid: RankGrid, axis: str = "data",
                     shard_extras: frozenset | set = frozenset()) -> Callable:
    """A natively batched ensemble function (a leading member axis: the
    CUDA factories' ``run``, the batched torch marches) run unchanged on
    this rank's members. Extras at the positions in ``shard_extras`` are
    per-member data and shard with the members (e.g. the (B, K+1)
    per-member partitions); the others are replicated. Members are
    independent, so no collective runs; the outputs are the rank's block.
    A per-shard constraint of ``batched_fn`` applies to B / ranks."""

    def wrapper(u0s, *extras):
        local = [shard_along(x, grid, axis) if i in shard_extras else x
                 for i, x in enumerate(extras)]
        return batched_fn(shard_along(u0s, grid, axis), *local)

    return wrapper


def ensemble_mean(fn: Callable, grid: RankGrid, axis: str = "data",
                  vectorize: bool = True) -> Callable:
    """Like :func:`ensemble_vmap`, but returns the mean of ``fn``'s outputs
    over all members: each rank sums its block, :func:`all_reduce_sum`
    adds the ranks' sums, and the sum is divided by the global count. The
    same on every rank."""
    run = _per_member(fn, vectorize)

    def wrapper(u0s, *extras):
        local = run(shard_along(u0s, grid, axis), *extras)
        n = u0s.shape[0]
        return tree_map(lambda x: all_reduce_sum(torch.sum(x, dim=0), grid, axis) / n, local)

    return wrapper


def ensemble_refinement_signal(solve_err: Callable, grid: RankGrid, axis: str = "data",
                               vectorize: bool = True) -> Callable:
    """The ensemble-averaged refinement signal: the mean over all ICs of
    ``solve_err``'s per-step indicator and its argmax (Main_variable_params.py
    :330-341's signal), ``(mean_err_steps, argmax_idx)``, the same on
    every rank."""
    mean_fn = ensemble_mean(solve_err, grid, axis, vectorize)

    def wrapper(u0s, *extras):
        mean_err = mean_fn(u0s, *extras)
        return mean_err, torch.argmax(mean_err)

    return wrapper
