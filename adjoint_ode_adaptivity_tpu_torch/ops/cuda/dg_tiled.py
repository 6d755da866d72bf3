"""The element-tiled DG-advection pipeline on hand-written CUDA: K1's and
K2's fused kernels at B = 1, each a call from the global step offset.

Counterpart of the JAX package's ``ops/pallas/dg_tiled.py``
(``make_pallas_fwd_adj_estimate_tiled`` and ``_tiled_grid``) with the
per-segment kernels of ``ops/pallas/dg_sharded.py``. Two kernels:

- **KT1** :func:`tiled_fwd_seg` — the forward over the call's segments,
  every entry state stored into an (n_steps, Np, K) trajectory (K2's
  layout) and the exit state. Replaces ``_fwd_seg_kernel``
  (dg_sharded.py:83) and ``_fwd_seg_grid_kernel`` (dg_tiled.py:282). It
  runs K1's fused kernel (csrc/dg_rhs.cu ``fwd_fused``) at B = 1 on
  :func:`~.dg_rhs.forward_plan`'s windows (W = 5·s_f, none where one tile
  holds the mesh), storing every step, from the global step
  first_segment·segment: one thread a window element, the state in
  registers, one barrier a stage, ⌈n_steps/s_f⌉ CUDA launches a call.
- **KT2** :func:`tiled_rev_seg` — the reverse sweep over the call's
  segments: per step the dt/2·dt/2 step doubling from the stored u_n, η +=
  Σ_nodes λ·(u_{n+1} − half2) on the local elements, and two dt/2
  transposes. Replaces ``_rev_seg_kernel`` (dg_sharded.py:107) and
  ``_rev_seg_grid_kernel`` (dg_tiled.py:314). It runs K2's fused kernel
  (csrc/dg_rhs.cu ``rev_fused``) at B = 1 on
  :func:`~.dg_rhs.stored_plan`'s windows (W = 10·s_f + 10), from the global
  step first_segment·segment with η carried in: ⌈n_steps/s_f⌉ CUDA launches
  a call.

The tiled trajectory is exact everywhere and in K2's layout, and every
stage time is t0 + n·dt of the global step n, so a segment is only an API
boundary: both kernels take their own s_f and windows whatever the
segment, each local element computes what K1 and K2 compute with the same
arithmetic (csrc/dg_stage.cuh), and the tiled pipelines give the stored
pipeline's bits.

The API's rules, kept from the JAX factories: a segment of 1 to
:data:`MAX_SEGMENT` steps; the ghost rule (dg_sharded.py:18-25, copied
with :func:`ghost_width`) W ≥ 10·seg + 10, which keeps every local element
of a segment exact (the flux couples ±1 element per stage: the forward
loses 5·seg elements a segment, λ 10 a step); and :func:`tile_plan`, which
splits each chunk (K/chunks elements;
K/(8·chunks) lanes of the grid variant) into equal tiles whose window of
(4·Np + 3)·(L + 2W) floats fits :data:`SMEM_BUDGET`, refusing a ghost width
that leaves no tile. The tile plan sets the plain versions' windows and the
segment length; the card's kernels take their own. The grid variant's
chunk-major layout and sublane-rolled ghosts (dg_tiled.py:224-258,
:534-557) exist for the TPU's (8, M) blocked layout and have no Hopper
counterpart: both factories run KT1/KT2 on the (Np, K) state, and differ
only in the validation they keep from their JAX factories.

A CUDA float32 tensor launches the kernel or raises; a CPU tensor takes the
plain version (:func:`tiled_fwd_seg_plain`, :func:`tiled_rev_seg_plain`,
:func:`tiled_plain`): the tile plan's tiles and windows with explicit ghost
rings, so the halo logic is tested on the CPU, in float32 or float64; K1's
and K2's emulations (``dg_rhs._fwd_fused_plain``, ``dg_rhs._rev_fused_plain``)
give their bits on the kernels' own windows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import (
    FusedPlan,
    KernelOps,
    _check,
    _check_uniform,
    _k1_launch,
    _k2_launch,
    _sm_count,
    _step_plain,
    _step_t_plain,
    _window,
    forward_plan,
    kernel_ops,
    stored_plan,
)
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "SMEM_BUDGET",
    "MAX_SEGMENT",
    "ghost_width",
    "TilePlan",
    "tile_plan",
    "tiled_fwd_seg",
    "tiled_fwd_seg_plain",
    "tiled_rev_seg",
    "tiled_rev_seg_plain",
    "tiled_plain",
    "reset_launch_counts",
    "make_cuda_fwd_adj_estimate_tiled",
    "make_cuda_fwd_adj_estimate_tiled_grid",
]

# the tile plan's budget for a window of (4·Np + 3)·(L + 2W) floats: it sets
# the plain versions' tiles and refuses ghost rings that leave no tile
SMEM_BUDGET = 96 * 1024
MAX_SEGMENT = 64  # the API's longest segment (the JAX factories' and chip_smoke.py's rows)


def ghost_width(segment: int, l_local: int) -> int:
    """Required ghost width for ``segment`` steps between exchanges, rounded
    up so the extended local block (L + 2W) tiles 8 sublanes (the JAX
    package's dg_sharded.py ``ghost_width``, whose rounding the TPU layout
    needs; any W ≥ 10·seg + 10 is exact here)."""
    w = 10 * segment + 10
    while (l_local + 2 * w) % 8:
        w += 1
    return w


class TilePlan(NamedTuple):
    segment: int
    ghost: int  # W, elements on each side of a tile
    tile: int  # L, local elements per CTA (the last tile may be shorter)
    n_tiles: int


def tile_plan(k: int, np_: int, segment: int, ghost: int, chunk: int,
              tile: int | None = None) -> TilePlan:
    """The CTA tiling of K elements: each ``chunk`` split into the fewest
    equal tiles whose window, counted as (4·Np + 3)·(L + 2W) floats, fits
    :data:`SMEM_BUDGET` (``tile`` forces L)."""
    if not 1 <= segment <= MAX_SEGMENT:
        raise ValueError(f"segment={segment}: the tiled kernels take 1..{MAX_SEGMENT}")
    if tile is None:
        l_max = SMEM_BUDGET // ((4 * np_ + 3) * 4) - 2 * ghost
        if l_max < 1:
            raise ValueError(
                f"ghost width {ghost} at Np={np_}: a window passes the "
                f"{SMEM_BUDGET}-byte shared-memory budget — use a smaller segment"
            )
        per_chunk = -(-chunk // l_max)
        tile = -(-chunk // per_chunk)
    if tile < 1:
        raise ValueError(f"tile={tile} must be >= 1")
    return TilePlan(segment, ghost, tile, -(-k // tile))


# ------------------------------------------------------------ plain versions


def tiled_fwd_seg_plain(u0, t0: float, n_segments: int, plan: TilePlan, ops: KernelOps,
                        first_segment: int = 0):
    """KT1's plain version: ``(traj, u_final)`` with traj (n_steps, Np, K)."""
    seg = plan.segment
    traj = torch.empty((n_segments * seg, *u0.shape), dtype=u0.dtype, device=u0.device)
    u = u0
    for si in range(n_segments):
        u_next = torch.empty_like(u)
        n0 = (first_segment + si) * seg
        for t in range(plan.n_tiles):
            lo, hi, w0, w1, wops = _window(plan, ops, t)
            uw = u[:, None, w0:w1]
            for n in range(seg):
                traj[si * seg + n, :, lo:hi] = uw[:, 0, lo - w0:hi - w0]
                uw = _step_plain(uw, t0 + (n0 + n) * ops.dt, ops.full, wops)
            u_next[:, lo:hi] = uw[:, 0, lo - w0:hi - w0]
        u = u_next
    return traj, u


def tiled_rev_seg_plain(traj, u_final, lam_end, t0: float, plan: TilePlan, ops: KernelOps,
                        first_segment: int = 0, eta=None):
    """KT2's plain version: ``(lam0, eta)`` with eta (K,), accumulated onto
    a copy of ``eta`` (default zeros)."""
    seg, n_steps = plan.segment, traj.shape[0]
    h = ops.dt / 2.0
    lam = lam_end
    eta = (torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
           if eta is None else eta.clone())
    n_first = first_segment * seg
    for si in reversed(range(n_steps // seg)):
        lam_next = torch.empty_like(lam)
        for t in range(plan.n_tiles):
            lo, hi, w0, w1, wops = _window(plan, ops, t)
            loc = slice(lo - w0, hi - w0)
            lw = lam[:, None, w0:w1]
            e_loc = eta[lo:hi]
            for n in reversed(range(si * seg, (si + 1) * seg)):
                t_n = t0 + (n_first + n) * ops.dt
                u_np1 = u_final if n == n_steps - 1 else traj[n + 1]
                half = _step_plain(traj[n][:, None, w0:w1], t_n, ops.half, wops)
                half2 = _step_plain(half, t_n + h, ops.half, wops)
                e_loc = e_loc + torch.sum(lw[:, 0, loc] * (u_np1[:, lo:hi] - half2[:, 0, loc]), dim=0)
                lw = _step_t_plain(_step_t_plain(lw, ops.half, wops), ops.half, wops)
            lam_next[:, lo:hi] = lw[:, 0, loc]
            eta[lo:hi] = e_loc
        lam = lam_next
    return lam, eta


def tiled_plain(u0, t0: float, lam_end, n_segments: int, plan: TilePlan, ops: KernelOps):
    """The whole tiled pipeline in plain PyTorch: ``(u_final, lam0, eta)``."""
    traj, u_final = tiled_fwd_seg_plain(u0, t0, n_segments, plan, ops)
    lam0, eta = tiled_rev_seg_plain(traj, u_final, lam_end, t0, plan, ops)
    return u_final, lam0, eta


# ------------------------------------------------------------------ wrappers


def tiled_fwd_seg(u0: torch.Tensor, t0: float, n_segments: int, plan: TilePlan,
                  ops: KernelOps, first_segment: int = 0):
    """KT1 over n_segments segments from the (Np, K) state ``u0``. Returns
    ``(traj, u_final)``, traj (n_segments·segment, Np, K). The call's
    segments are the march's ``first_segment`` onwards: step n of its
    segment si starts at t0 + ((first_segment + si)·segment + n)·dt. On the
    card it runs K1's fused kernel at B = 1 on :func:`~.dg_rhs.forward_plan`'s
    windows for the card's SM count, storing every step (``plan`` sets only
    the segment length): ⌈n_steps/s_f⌉ CUDA launches."""
    if n_segments < 1 or first_segment < 0:
        raise ValueError(f"n_segments={n_segments} must be >= 1, first_segment="
                         f"{first_segment} >= 0")
    if not _check("u0", u0, (ops.np_, ops.k), ops):
        return tiled_fwd_seg_plain(u0, float(t0), n_segments, plan, ops, first_segment)
    n_steps = n_segments * plan.segment
    fused = forward_plan(ops.k, 1, ops.np_, n_steps, 1, _sm_count(u0.device))
    traj, u_final, tiled_fwd_seg.cuda_launches = _kt1_launch(
        u0, t0, n_steps, ops, fused, first_segment * plan.segment)
    tiled_fwd_seg.launches += 1
    return traj, u_final


def _kt1_launch(u0, t0, n_steps: int, ops: KernelOps, fused: FusedPlan, n_first: int = 0):
    """One K1 call at B = 1 on ``fused`` over the global steps n_first …
    n_first + n_steps − 1 from the (Np, K) ``u0``, storing every entry state:
    ``(traj (n_steps, Np, K), u_final, CUDA launches)``. The wrapper counts
    its launches; this does not."""
    traj = torch.empty((n_steps, *u0.shape), dtype=torch.float32, device=u0.device)
    u_final, n = _k1_launch(load_library(), u0[:, None], t0, n_steps, traj[:, :, None], 1, ops,
                            fused, n_first)
    return traj, u_final[:, 0], n


def tiled_rev_seg(traj: torch.Tensor, u_final: torch.Tensor, lam_end: torch.Tensor,
                  t0: float, plan: TilePlan, ops: KernelOps, first_segment: int = 0,
                  eta: torch.Tensor | None = None):
    """KT2 over the segments of ``traj`` in reverse, the march's segments
    ``first_segment`` onwards (as :func:`tiled_fwd_seg`). Returns ``(lam0,
    eta)``, eta (K,): the η carried in (``eta``, default zeros) plus this
    sweep's, summed in place as a whole sweep sums it. On the card it runs
    K2's fused kernel at B = 1 on :func:`~.dg_rhs.stored_plan`'s windows
    for the card's SM count (``plan`` sets only the segment length):
    ⌈n_steps/s_f⌉ CUDA launches."""
    state = (ops.np_, ops.k)
    if traj.dim() != 3 or traj.shape[0] % plan.segment or traj.shape[0] == 0:
        raise ValueError(f"traj must be (n_segments·{plan.segment}, Np, K), got "
                         f"{tuple(traj.shape)}")
    if first_segment < 0:
        raise ValueError(f"first_segment={first_segment} must be >= 0")
    on_cuda = _check("traj", traj, (traj.shape[0], *state), ops)
    _check("u_final", u_final, state, ops)
    _check("lam_end", lam_end, state, ops)
    if eta is not None:
        _check("eta", eta, (ops.k,), ops)
    if not on_cuda:
        return tiled_rev_seg_plain(traj, u_final, lam_end, float(t0), plan, ops,
                                   first_segment, eta)
    fused = stored_plan(ops.k, 1, ops.np_, traj.shape[0], _sm_count(traj.device))
    lam0, eta, tiled_rev_seg.cuda_launches = _kt2_launch(
        traj, u_final, lam_end, t0, ops, fused, first_segment * plan.segment, eta)
    tiled_rev_seg.launches += 1
    return lam0, eta


def _kt2_launch(traj, u_final, lam_end, t0, ops: KernelOps, fused: FusedPlan, n_first: int = 0,
                eta=None):
    """One K2 call at B = 1 on ``fused`` over the global steps n_first …
    n_first + n_steps − 1 of the (n_steps, Np, K) ``traj``, η (K,) carried
    in: ``(lam0, eta, CUDA launches)``. The wrapper counts its launches;
    this does not."""
    lam0, eta, n = _k2_launch(traj[:, :, None], u_final[:, None], lam_end[:, None], t0, ops,
                              fused, n_first, None if eta is None else eta[None])
    return lam0[:, 0], eta[0], n


def reset_launch_counts() -> None:
    tiled_fwd_seg.launches = 0
    tiled_fwd_seg.cuda_launches = 0
    tiled_rev_seg.launches = 0
    tiled_rev_seg.cuda_launches = 0


reset_launch_counts()


# -------------------------------------------------------------- entry points


def _pipeline(disc, a, dt, plan: TilePlan, n_segments: int, device):
    ops = kernel_ops(disc, a, dt, device)

    def run(u0, t0, lam_end):
        traj, u_final = tiled_fwd_seg(u0, t0, n_segments, plan, ops)
        lam0, eta = tiled_rev_seg(traj, u_final, lam_end, t0, plan, ops)
        return u_final, lam0, eta

    run.n_steps = plan.segment * n_segments
    run.ghost = plan.ghost
    run.plan = plan
    return run


def make_cuda_fwd_adj_estimate_tiled(
    disc: Discretization1D, a: float, dt: float, *, segment: int = 8,
    n_segments: int = 64, chunks: int = 8, device="cuda",
):
    """Element-tiled fwd + stored-trajectory reverse + estimate for a single
    state: ``run(u0, t0, lam_end) -> (u_final, lam0, eta)`` on (Np, K), eta
    (K,), with ``run.n_steps``, ``run.ghost`` (W) and ``run.plan``. The
    validation is ``make_pallas_fwd_adj_estimate_tiled``'s: K divisible by
    ``chunks``, an even chunk width of at least the ghost width, a uniform
    mesh. Each chunk is split into CTA tiles by :func:`tile_plan`."""
    k = disc.k
    if k % chunks:
        raise ValueError(f"K={k} not divisible by chunks={chunks}")
    l_loc = k // chunks
    if l_loc % 2:
        raise ValueError(f"chunk width {l_loc} must be even (8-sublane tiling)")
    w = ghost_width(segment, l_loc)
    if w > l_loc:
        raise ValueError(
            f"ghost width {w} exceeds chunk width {l_loc} — use fewer chunks "
            f"or a smaller segment"
        )
    _check_uniform(disc)
    plan = tile_plan(k, disc.np_, segment, w, l_loc)
    return _pipeline(disc, a, dt, plan, n_segments, device)


def make_cuda_fwd_adj_estimate_tiled_grid(
    disc: Discretization1D, a: float, dt: float, *, segment: int = 8,
    n_segments: int = 64, chunks: int = 8, device="cuda",
):
    """The grid-streamed variant's contract
    (``make_pallas_fwd_adj_estimate_tiled_grid``): K % 8 == 0, (K/8) %
    chunks == 0, W = 10·segment + 10 ≤ the chunk's lane count K/(8·chunks);
    uniform meshes. It runs the same KT1/KT2 as
    :func:`make_cuda_fwd_adj_estimate_tiled`, each lane-chunk's K/(8·chunks)
    elements the unit that :func:`tile_plan` splits."""
    k = disc.k
    if k % 8:
        raise ValueError(f"K={k} must be divisible by 8 (blocked layout)")
    m = k // 8
    if m % chunks:
        raise ValueError(f"lane count M={m} not divisible by chunks={chunks}")
    lm = m // chunks
    w = 10 * segment + 10
    if w > lm:
        raise ValueError(
            f"ghost width {w} exceeds chunk lane width {lm} — use fewer "
            f"chunks or a smaller segment"
        )
    _check_uniform(disc)
    plan = tile_plan(k, disc.np_, segment, w, lm)
    return _pipeline(disc, a, dt, plan, n_segments, device)
