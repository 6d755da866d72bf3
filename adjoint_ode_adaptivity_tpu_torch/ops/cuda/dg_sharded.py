"""The element-sharded DG-advection pipeline over KT1/KT2: the K elements
split contiguously over the ranks of a :class:`~..parallel.mesh.RankGrid`
axis, each rank running the tiled kernels on its share with a ghost ring
exchanged every segment.

Counterpart of the JAX package's ``ops/pallas/dg_sharded.py``
(``make_pallas_fwd_adj_estimate_sharded_blocked`` :165) and
``ops/pallas/dg_tiled_sharded.py``
(``make_pallas_fwd_adj_estimate_tiled_grid_sharded`` :67). Both become
factories over ONE rank-local composition: the TPU's blocked (8, m) layout
and chunk-major grid layout have no Hopper counterpart (ROADMAP), and the
kernels are KT1/KT2 (ops/cuda/dg_tiled.py: K1's and K2's fused kernels of
csrc/dg_rhs.cu at B = 1, from the global step offset). There is no new
kernel: the composition is plain PyTorch around them.

Rank r holds the elements [r·L, (r+1)·L), L = K/D. Each segment s it
1. extends its block with W elements from each neighbour
   (:func:`~..parallel.mesh.exchange`), not periodically: rank 0's block
   starts at the inflow element and rank D−1's ends at the outflow element,
   as a tile window of ops/cuda/dg_tiled.py is clipped to the domain;
2. runs KT1 for one segment on the extended block, a mesh of its own whose
   first element takes the inflow value and whose last has no right face:
   its edges degrade 5 elements a step, ghosts that never reach the local
   elements within a segment (W ≥ 10·seg + 10, dg_sharded.py:18-25),
   storing the extended trajectory;
3. keeps its local slice.
The reverse sweep takes the boundary state of segment s from segment s+1's
ghost-fresh entry state (the final extended state for the last segment,
dg_sharded.py:265-271) and runs KT2 per segment in reverse, λ's ring
refreshed each segment and η carried through the kernel's in-place sum.
Every stage time is t0 + n·dt of the global step n (KT1/KT2's
``first_segment``), so every local element gets the single-process tiled
pipeline's bits (and so K1/K2's).

The ring is Np·W floats each way per segment and sweep; under gloo it is
staged through host memory. ``j_value`` is the all-reduced Σ λ·u(T).
"""
from __future__ import annotations

import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import KernelOps, _check_uniform, kernel_ops
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_tiled import (
    ghost_width,
    tile_plan,
    tiled_fwd_seg,
    tiled_rev_seg,
)
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import RankGrid, all_reduce_sum, exchange

__all__ = [
    "make_cuda_fwd_adj_estimate_sharded_blocked",
    "make_cuda_fwd_adj_estimate_tiled_grid_sharded",
]


def _slice_ops(ops: KernelOps, e0: int, e1: int) -> KernelOps:
    """The kernel operands of the elements [e0, e1) as a mesh of their own."""
    geom = tuple(g[e0:e1].contiguous() for g in ops.geom32)
    return ops._replace(k=e1 - e0, rx=ops.rx[e0:e1], fsl=ops.fsl[e0:e1], fsr=ops.fsr[e0:e1],
                        geom32=geom)


def _shard_share(k: int, grid: RankGrid, axis: str) -> int:
    d = grid.axis_size(axis)
    if k % d:
        raise ValueError(f"K={k} not divisible by {d} devices")
    return k // d


def _rank_pipeline(disc: Discretization1D, a: float, dt: float, grid: RankGrid, axis: str,
                   segment: int, n_segments: int, ghost: int, chunk: int, device):
    """``run(u_loc, t0, lam_loc) -> (u_final, lam0, eta, j_value)`` on this
    rank's (Np, L) share, ghost ring ``ghost``, CTA tiles cut from ``chunk``
    elements."""
    if n_segments < 1:
        raise ValueError(f"n_segments={n_segments} must be >= 1")
    k, np_ = disc.k, disc.np_
    share = _shard_share(k, grid, axis)
    lo = grid.axis_index(axis) * share
    e0, e1 = max(lo - ghost, 0), min(lo + share + ghost, k)
    off = lo - e0
    ops = _slice_ops(kernel_ops(disc, a, dt, device), e0, e1)
    plan = tile_plan(e1 - e0, np_, segment, ghost, chunk)
    local = slice(off, off + share)

    def extended(x):
        """This rank's share with the neighbours' W-element rings."""
        from_prev, from_next = exchange(x[:, :ghost], x[:, -ghost:], grid, axis)
        parts = [p for p in (from_prev, x, from_next) if p is not None]
        return torch.cat(parts, dim=1).contiguous()

    def run(u_loc, t0, lam_loc):
        for name, x in (("u0", u_loc), ("lam_end", lam_loc)):
            if tuple(x.shape) != (np_, share):
                raise ValueError(f"{name}: shape {tuple(x.shape)}, expected this rank's "
                                 f"share {(np_, share)}")
        trajs, u = [], u_loc
        for s in range(n_segments):
            traj, u_ext = tiled_fwd_seg(extended(u), t0, 1, plan, ops, first_segment=s)
            trajs.append(traj)
            u = u_ext[:, local]
        u_final = u.contiguous()
        j_value = all_reduce_sum(torch.sum(lam_loc * u_final), grid)
        lam, bound = lam_loc, u_ext
        eta = torch.zeros((share,), dtype=u_loc.dtype, device=u_loc.device)
        for s in reversed(range(n_segments)):
            traj, trajs[s] = trajs[s], None
            eta_ext = torch.zeros((e1 - e0,), dtype=eta.dtype, device=eta.device)
            eta_ext[local] = eta
            lam_ext, eta_ext = tiled_rev_seg(traj, bound, extended(lam), t0, plan, ops,
                                             first_segment=s, eta=eta_ext)
            lam, eta = lam_ext[:, local], eta_ext[local]
            bound = traj[0].clone()  # segment s − 1 ends at segment s's entry state
        return u_final, lam.contiguous(), eta.contiguous(), j_value

    run.n_steps = segment * n_segments
    run.ghost = ghost
    run.plan = plan
    return run


def make_cuda_fwd_adj_estimate_sharded_blocked(
    disc: Discretization1D, a: float, dt: float, grid: RankGrid, *, segment: int = 8,
    n_segments: int = 256, axis: str = "space", device="cuda",
):
    """Element-sharded fwd + stored-trajectory reverse + estimate over
    ``grid[axis]``: ``run(u0, t0, lam_end) -> (u_final, lam0, eta, j_value)``
    with ``u0``, ``lam_end`` and the outputs this rank's (Np, K/D) share
    (eta (K/D,)), ``j_value`` the global Σ λ·u(T) on every rank. Every rank
    calls ``run`` together.

    Validation as ``make_pallas_fwd_adj_estimate_sharded_blocked``: K
    divisible by the ranks, an even share L, the ghost width
    ``ghost_width(segment, L)`` ≤ L, a uniform mesh; and the card's limits
    (:func:`~.dg_tiled.tile_plan`: segment ≤ ``MAX_SEGMENT``, a tile window
    within ``SMEM_BUDGET``). Each rank's share is the unit its CTA tiles
    split."""
    share = _shard_share(disc.k, grid, axis)
    if share % 2:
        raise ValueError(f"local share L={share} must be even (8-sublane tiling)")
    w = ghost_width(segment, share)
    if w > share:
        raise ValueError(f"ghost width {w} exceeds local share {share} — use fewer devices "
                         f"or a smaller segment")
    _check_uniform(disc)
    return _rank_pipeline(disc, a, dt, grid, axis, segment, n_segments, w, share, device)


def make_cuda_fwd_adj_estimate_tiled_grid_sharded(
    disc: Discretization1D, a: float, dt: float, grid: RankGrid, *, segment: int = 8,
    n_segments: int = 64, chunks: int = 8, axis: str = "space", device="cuda",
):
    """The element-sharded, chunk-streamed variant:
    ``run(u0, t0, lam_end) -> (u_final, lam0, eta)`` on this rank's share,
    as :func:`make_cuda_fwd_adj_estimate_sharded_blocked` (the same
    composition; ``chunks`` sets the unit that the CTA tiles split, K/(8·D·
    chunks) elements, as the single-device ``_tiled_grid`` factory's).

    Validation as ``make_pallas_fwd_adj_estimate_tiled_grid_sharded``: K
    divisible by the ranks, L % 8 == 0, (L/8) % chunks == 0, W = 10·segment
    + 10 ≤ L/(8·chunks), a uniform mesh; and the card's limits of
    :func:`~.dg_tiled.tile_plan`."""
    share = _shard_share(disc.k, grid, axis)
    if share % 8:
        raise ValueError(f"local share L={share} must be divisible by 8 (blocked layout)")
    m_loc = share // 8
    if m_loc % chunks:
        raise ValueError(f"local lane count M={m_loc} not divisible by chunks={chunks}")
    lm = m_loc // chunks
    w = 10 * segment + 10
    if w > lm:
        raise ValueError(f"ghost width {w} exceeds chunk lane width {lm} — use fewer "
                         f"chunks/devices or a smaller segment")
    _check_uniform(disc)
    inner = _rank_pipeline(disc, a, dt, grid, axis, segment, n_segments, w, lm, device)

    def run(u0, t0, lam_end):
        return inner(u0, t0, lam_end)[:3]

    run.n_steps, run.ghost, run.plan = inner.n_steps, inner.ghost, inner.plan
    return run
