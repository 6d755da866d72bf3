"""Rank grids: the process-group counterpart of the JAX package's device
meshes (``parallel/mesh.py``: ``make_mesh``, ``shard_along``,
``replicate``).

A JAX mesh lays devices out along named axes and ``shard_map`` runs one
program per device; here each process is one rank of a
``torch.distributed`` process group, and a :class:`RankGrid` names the
group's ranks along axes (row-major, as ``make_mesh`` reshapes its device
list). The axes keep the JAX package's names: ``data`` (the IC/seed
ensemble), ``model`` (hidden width) and ``space`` (the DG element axis,
parallel/dg_shard.py and ops/cuda/dg_sharded.py).

- :func:`shard_along` is this rank's contiguous slice of an array, the
  block that ``P(..., axis)`` gives the device at this rank's position.
- :func:`replicate` broadcasts tensors from one rank (the identity at
  world 1).
- :func:`exchange` sends a block to each neighbour along an axis and
  receives theirs: the non-periodic form of ``lax.ppermute`` over the ring
  that the DG halos use (the global boundary ranks have no neighbour
  outside and receive nothing).
- :func:`ring_shift` is ``lax.ppermute`` over the periodic ring
  i → (i + shift) mod D along an axis; it is differentiable
  (:class:`RingShift`: the backward shifts the cotangent the other way),
  so autograd through it gives the reverse transfer, as ``jax.grad``
  transposes a ``ppermute``.
- :func:`all_reduce_sum` is ``lax.psum``, over every rank or along one axis.
- :func:`all_gather` joins the ranks' blocks along an axis in rank order
  (the global array of ``P(axis)``'s blocks), so gathered members keep
  :func:`shard_along`'s order.
- :func:`barrier` waits for every rank (after rank 0 writes a file that
  the others read).
- :func:`init_dp_grid` is the drivers' ``--dp``: it joins the default
  process group from torchrun's environment and lays its ranks out along
  named axes.

Backends: ``nccl`` where each rank has a card of its own; ``gloo``
otherwise (NCCL refuses two ranks on one device, and a host with one card
runs its ranks on it together). Under gloo, CUDA tensors are staged through
host memory (the DG halos are Np·W floats). Without a process group the
grid has one rank and every exchange and reduction is the identity, as a
1-device mesh makes ``ppermute`` the identity.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "RankGrid",
    "make_rank_grid",
    "shard_along",
    "replicate",
    "exchange",
    "all_reduce_sum",
    "all_gather",
    "barrier",
    "ring_shift",
    "RingShift",
    "init_dp_grid",
]


class RankGrid(NamedTuple):
    """This process's place in a process group laid out along named axes."""

    names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int  # this process's rank in ``group``
    group: Any  # a torch.distributed ProcessGroup, or None at world 1
    backend: str | None

    @property
    def world(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))

    def axis_size(self, axis: str) -> int:
        return self.sizes[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return int(np.unravel_index(self.rank, self.sizes)[self._axis(axis)])

    def neighbour(self, axis: str, offset: int, periodic: bool = False) -> int | None:
        """The group rank ``offset`` steps along ``axis``: None past the
        grid's edge, or round the ring with ``periodic``."""
        coords = list(np.unravel_index(self.rank, self.sizes))
        i = self._axis(axis)
        coords[i] += offset
        if periodic:
            coords[i] %= self.sizes[i]
        elif not 0 <= coords[i] < self.sizes[i]:
            return None
        return int(np.ravel_multi_index(coords, self.sizes))

    def _axis(self, axis: str) -> int:
        if axis not in self.names:
            raise KeyError(f"axis {axis!r} not in the grid's axes {self.names}")
        return self.names.index(axis)


def make_rank_grid(axes: dict[str, int] | None = None, group=None) -> RankGrid:
    """The grid of ``group`` (default: the default process group, or one
    rank when none is initialised) along ``axes`` {name: size}; one size may
    be −1 (inferred). Default: every rank on one ``space`` axis. The sizes
    must multiply to the group's size: every rank has a place."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        backend = dist.get_backend(group)
    else:
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not initialised")
        world, rank, backend = 1, 0, None
    if axes is None:
        axes = {"space": world}
    names, sizes = tuple(axes), list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one axis size may be -1: {axes}")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world or min(sizes) < 1:
        raise ValueError(f"grid {dict(zip(names, sizes))} needs {int(np.prod(sizes))} ranks, "
                         f"the group has {world}")
    return RankGrid(names, tuple(int(s) for s in sizes), rank, group, backend)


def shard_along(x: torch.Tensor, grid: RankGrid, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (a view)."""
    d = grid.axis_size(axis)
    if x.shape[dim] % d:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {d} ranks")
    share = x.shape[dim] // d
    return x.narrow(dim, grid.axis_index(axis) * share, share)


def _staged(x: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """The tensor that the backend takes: host memory under gloo."""
    return x.detach().cpu() if grid.backend == "gloo" else x.detach()


def _global(grid: RankGrid, group_rank: int) -> int:
    return group_rank if grid.group is None else dist.get_global_rank(grid.group, group_rank)


def replicate(x, grid: RankGrid, src: int = 0):
    """Every rank gets rank ``src``'s tensors: a tensor, or a list, tuple or
    dict of tensors (the identity at world 1)."""
    if grid.world == 1:
        return x
    if isinstance(x, dict):
        return {k: replicate(v, grid, src) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(v, grid, src) for v in x)
    buf = _staged(x, grid).contiguous().clone()
    dist.broadcast(buf, _global(grid, src), group=grid.group)
    return buf.to(x.device)


def exchange(to_prev: torch.Tensor, to_next: torch.Tensor, grid: RankGrid, axis: str):
    """Send ``to_prev`` to the previous rank along ``axis`` and ``to_next``
    to the next; return ``(from_prev, from_next)``, what the previous rank
    sent as its ``to_next`` and the next as its ``to_prev`` (same shapes),
    None where there is no neighbour. Every rank of the grid must call it."""
    prev, nxt = grid.neighbour(axis, -1), grid.neighbour(axis, +1)
    if prev is None and nxt is None:
        return None, None
    ops, recvs = [], {}
    for peer, out, key, like in ((prev, to_prev, "prev", to_next), (nxt, to_next, "next", to_prev)):
        if peer is None:
            continue
        recvs[key] = torch.empty_like(_staged(like, grid), memory_format=torch.contiguous_format)
        peer = _global(grid, peer)
        ops.append(dist.P2POp(dist.isend, _staged(out, grid).contiguous(), peer, grid.group))
        ops.append(dist.P2POp(dist.irecv, recvs[key], peer, grid.group))
    # one batch: under NCCL, sends and receives posted one by one would wait
    # on each other across the ranks
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    device = to_prev.device
    return tuple(recvs[key].to(device) if key in recvs else None for key in ("prev", "next"))


def all_reduce_sum(x: torch.Tensor, grid: RankGrid, axis: str | None = None) -> torch.Tensor:
    """Σ of ``x`` over every rank of the grid (``lax.psum``), or over the
    ranks of this rank's line along ``axis`` (their blocks gathered and
    added in rank order). Every rank gets the same bits."""
    if axis is not None and grid.axis_size(axis) < grid.world:
        d = grid.axis_size(axis)
        return torch.sum(all_gather(x[None], grid, axis), dim=0) if d > 1 else x
    if grid.world == 1:
        return x
    buf = _staged(x, grid).contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=grid.group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, grid: RankGrid, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks ``x`` (one shape on every rank) of this rank's line along
    ``axis`` joined along ``dim`` in rank order: the inverse of
    :func:`shard_along`. Every rank of the grid must call it."""
    d = grid.axis_size(axis)
    if d == 1:
        return x
    buf = _staged(x, grid).contiguous()
    parts = [torch.empty_like(buf) for _ in range(grid.world)]
    dist.all_gather(parts, buf, group=grid.group)
    here = grid.axis_index(axis)
    line = [grid.neighbour(axis, k - here) for k in range(d)]
    return torch.cat([parts[r] for r in line], dim=dim).to(x.device)


def barrier(grid: RankGrid) -> None:
    """Return once every rank of the grid has called it (nothing at world 1)."""
    if grid.world > 1:
        dist.barrier(group=grid.group)


def _shift(x: torch.Tensor, grid: RankGrid, axis: str, shift: int) -> torch.Tensor:
    buf = _staged(x, grid).contiguous()
    recv = torch.empty_like(buf)
    to = _global(grid, grid.neighbour(axis, shift, periodic=True))
    frm = _global(grid, grid.neighbour(axis, -shift, periodic=True))
    # posted together, so that a ring of ranks each sending before it
    # receives cannot wait on itself
    ops = [dist.P2POp(dist.isend, buf, to, grid.group),
           dist.P2POp(dist.irecv, recv, frm, grid.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device)


class RingShift(torch.autograd.Function):
    """:func:`ring_shift` as an autograd function: the forward sends ``x``
    ``shift`` ranks on round the ring along ``axis`` and returns what
    arrived; the backward sends the cotangent ``shift`` ranks back (the
    transpose of a permutation is its inverse). Every rank of the grid
    must run both, in the same order: the same program on every rank
    does."""

    @staticmethod
    def forward(ctx, x, grid, axis, shift):
        ctx.grid, ctx.axis, ctx.shift = grid, axis, shift
        return _shift(x, grid, axis, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.grid, ctx.axis, -ctx.shift), None, None, None


def ring_shift(x: torch.Tensor, grid: RankGrid, axis: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over the periodic ring i → (i + shift) mod D along
    ``axis``: this rank sends ``x`` to the rank ``shift`` steps on and
    returns the block (same shape) of the rank ``shift`` steps back. The
    identity at D = 1. Differentiable (:class:`RingShift`). Every rank of
    the grid must call it."""
    if shift % grid.axis_size(axis) == 0:
        return x
    return RingShift.apply(x, grid, axis, shift)


def init_dp_grid(axes: dict[str, int], device="cuda") -> tuple[RankGrid, torch.device]:
    """The drivers' ``--dp``: ``(grid, device)``, the default process group
    laid out along ``axes`` (as :func:`make_rank_grid`; one size may be −1)
    and this rank's device.

    Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment) it joins the default
    group, once, through ``env://``: with ``nccl`` where each rank of the
    host has a card of its own, else with ``gloo`` (ranks sharing a card,
    or CPU ranks). A CUDA ``device`` becomes ``cuda:LOCAL_RANK mod
    device_count``, made current. Without that environment the grid has one
    rank and ``device`` is returned as given."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device

    device = require_device(device)
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    if "RANK" in env and world > 1:
        local = int(env.get("LOCAL_RANK", env["RANK"]))
        backend = "gloo"
        if device.type == "cuda":
            n_cards = torch.cuda.device_count()
            device = torch.device("cuda", local % n_cards)
            torch.cuda.set_device(device)
            if n_cards >= int(env.get("LOCAL_WORLD_SIZE", world)):
                backend = "nccl"
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                                    world_size=world)
    return make_rank_grid(axes), device
