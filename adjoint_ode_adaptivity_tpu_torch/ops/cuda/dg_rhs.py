"""The DG-advection fwd + adjoint + estimate pipelines on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/dg_rhs.py``: the
stored-trajectory pipeline (``_make_stored_run``), the recompute pipeline
(``make_pallas_fwd_adj_estimate_grid_batched(store_trajectory=False)``) and
the unbatched uniform-mesh entry points. Four kernels (csrc/dg_rhs.cu):

- **K1** :func:`fwd_march` — n_steps LSRK4(5) steps from ``u0`` at ``t0``;
  optionally stores every entry state u_n in ``traj[n]``. Replaces
  ``_fwd_traj_grid_kernel_b`` (dg_rhs.py:981), and with no trajectory
  ``_fwd_grid_kernel_b`` (:1017) and ``_forward_kernel`` (:270).
  :func:`fwd_march_ckpt` is K1 storing only every ``segment``-th entry
  state, the checkpoints: ``_fwd_ckpt_grid_kernel_b`` (:880) and, at B = 1,
  ``_fwd_ckpt_grid_kernel`` (:510). Fused over s_f steps a launch in every
  mode (:func:`forward_plan`): one CTA per (tile, member), a window of L
  local elements and W = 5·s_f ghosts a side (none where one tile holds the
  mesh), the state in registers, one barrier a stage; ⌈n_steps/s_f⌉ CUDA
  launches.
- **K2** :func:`adj_est_stored` — for n = n_steps−1 … 0: two dt/2 steps from
  u_n, η += Σ_nodes λ·(u_{n+1} − half2), then two dt/2 transpose steps.
  Replaces ``_adj_est_grid_kernel_b_stored`` (dg_rhs.py:1108). Fused over
  s_f steps a launch (:func:`stored_plan`): one CTA per (tile, member), a
  window of L local elements and W = 10·s_f + 10 ghosts a side, the state in
  registers, one barrier a stage; ⌈n_steps/s_f⌉ CUDA launches.
- **K2r** :func:`adj_est_recompute` — per checkpoint segment in reverse,
  recompute the segment's states from its checkpoint into a (segment +
  1)-state scratch with K1's kernel, s_f steps a launch on K2's windows,
  then K2's fused sweep over it. Replaces ``_adj_est_grid_kernel_b`` (:908)
  and, at B = 1, ``_adj_est_grid_kernel`` (:538) and
  ``_adj_estimate_kernel`` (:384). 2·⌈segment/s_f⌉ CUDA launches a segment
  (:func:`recompute_plan`), for n_steps/segment + segment + 1 states of
  memory against the stored pipeline's n_steps.
- **KA** :func:`adj_march` — the pure transpose march λ0 = (Lᵀ)ⁿ λN with the
  full-dt tables, no residual, no estimate. Replaces ``_adjoint_kernel``
  (:335). Fused over s_f steps a launch on K1's windows (:func:`adjoint_plan`:
  W = 5·s_f, none where one tile holds the mesh): ⌈n_steps/s_f⌉ CUDA
  launches.

Each wrapper takes (Np, B, K) states. A CUDA float32 tensor launches the
kernel or raises; a CPU tensor takes the kernel's plain PyTorch version
(:func:`fwd_march_plain`, :func:`adj_est_stored_plain`,
:func:`adj_est_recompute_plain`, :func:`adj_march_plain`), which accepts
float32 and float64. Nothing falls back from the kernel to the plain
version. Each wrapper counts its kernel launches in ``.launches`` and keeps
the CUDA launches of its last call in ``.cuda_launches``.
:func:`fwd_march_fused_plain`, :func:`adj_est_stored_fused_plain`,
:func:`adj_est_recompute_fused_plain` and :func:`adj_march_fused_plain`
emulate K1's, K2's, K2r's and KA's launch schedules (tiles, ghost windows, s_f,
remainders) in plain PyTorch, so the halo logic is tested on the CPU.

Every step's time is t0 + n·dt with n the global step, in the kernels and in
the plain versions alike, so the recompute pipeline reproduces the stored
one bit for bit: the recomputed states are K1's trajectory and K2r's sweep
is K2's.

Geometry is always per element (rx, fscale_left, fscale_right), so graded
meshes need no special path; the unbatched entry points keep the JAX
package's uniform-mesh contract (``_check_uniform``). The step size is
folded into the coefficient tables on the host (see :class:`StepTables`),
separately for dt and dt/2.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, pick_chunk, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "StepTables",
    "KernelOps",
    "kernel_ops",
    "fwd_march",
    "fwd_march_plain",
    "fwd_march_ckpt",
    "fwd_march_fused_plain",
    "FusedPlan",
    "fused_plan",
    "fwd_fused_plan",
    "forward_plan",
    "stored_plan",
    "recompute_plan",
    "adj_est_stored",
    "adj_est_stored_plain",
    "adj_est_stored_fused_plain",
    "adj_est_recompute",
    "adj_est_recompute_plain",
    "adj_est_recompute_fused_plain",
    "adjoint_plan",
    "adj_march",
    "adj_march_plain",
    "adj_march_fused_plain",
    "reset_launch_counts",
    "make_cuda_fwd_adj_estimate_grid_batched",
    "make_cuda_fwd_adj_estimate_single",
    "make_cuda_advec_march",
    "make_cuda_advec_adjoint",
    "make_cuda_fwd_adj_estimate",
    "make_cuda_fwd_adj_estimate_grid",
]

MIN_NP, MAX_NP = 2, 8
_RK = np.ascontiguousarray(np.concatenate([RK4A, RK4B, RK4C]), dtype=np.float64)
MAX_FUSED = 16  # csrc/dg_rhs.cu's kMaxFused: the inflow table rides the launch
MAX_FWD_FUSED = 32  # its kMaxFwdFused: 5 inflow values a forward step in the same table
FUSED_STEPS = 4  # s_f the wrappers aim for
FUSED_THREADS = (512, 1024)  # the CTA sizes K1/K2/K2r/KA are built for


class StepTables(NamedTuple):
    """Coefficient tables of one step size, folded on the host:
    ``drc = −a·dt·Dr``, ``ll = −a/2·dt·LIFT[:,0]``, ``lr = +a/2·dt·LIFT[:,1]``
    (float64 tensors on the device for the plain versions), and ``packed``,
    the same values rounded to float32 for the kernel's argument."""

    dt: float
    drc: torch.Tensor  # (Np, Np)
    ll: torch.Tensor  # (Np,)
    lr: torch.Tensor  # (Np,)
    packed: np.ndarray  # float32 [drc row-major, ll, lr]


class KernelOps(NamedTuple):
    """Everything the kernels need for one mesh and step size, on one
    device: per-element geometry (float64, and float32 copies for the
    kernels) and the tables for dt and dt/2."""

    np_: int
    k: int
    a: float
    dt: float
    rx: torch.Tensor  # (K,) float64
    fsl: torch.Tensor  # (K,) float64, 1/J at the left face
    fsr: torch.Tensor  # (K,) float64, 1/J at the right face
    geom32: tuple  # (rx, fsl, fsr) float32, contiguous
    full: StepTables  # step dt
    half: StepTables  # step dt/2


def _step_tables(disc: Discretization1D, a: float, dt: float, device) -> StepTables:
    drc = -a * dt * np.asarray(disc.dr, dtype=np.float64)
    ll = -a / 2.0 * dt * np.asarray(disc.lift[:, 0], dtype=np.float64)
    lr = a / 2.0 * dt * np.asarray(disc.lift[:, 1], dtype=np.float64)
    packed = np.concatenate([drc.ravel(), ll, lr]).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    return StepTables(float(dt), t(drc), t(ll), t(lr), np.ascontiguousarray(packed))


def kernel_ops(disc: Discretization1D, a: float, dt: float, device) -> KernelOps:
    """Kernel operands for ``disc`` at step ``dt`` on ``device`` (upwind
    flux, alpha = 1, inflow BC −sin(a·t), as the TPU kernels)."""
    if not MIN_NP <= disc.np_ <= MAX_NP:
        raise ValueError(f"Np={disc.np_}: the kernels take {MIN_NP} <= Np <= {MAX_NP}")
    device = require_device(device)
    geom = [
        torch.as_tensor(np.ascontiguousarray(g), dtype=torch.float64, device=device)
        for g in (disc.rx[0, :], disc.fscale[0, :], disc.fscale[1, :])
    ]
    return KernelOps(
        np_=disc.np_,
        k=disc.k,
        a=float(a),
        dt=float(dt),
        rx=geom[0],
        fsl=geom[1],
        fsr=geom[2],
        geom32=tuple(g.to(torch.float32).contiguous() for g in geom),
        full=_step_tables(disc, a, dt, device),
        half=_step_tables(disc, a, dt / 2.0, device),
    )


# ------------------------------------------------------------ plain versions


def _rhs_plain(u, uin: float, tab: StepTables, ops: KernelOps):
    """dt·RHS on (Np, B, K) with the folded tables (inflow ``uin``)."""
    dtype = u.dtype
    drc, ll, lr = (x.to(dtype) for x in (tab.drc, tab.ll, tab.lr))
    rx, fsl, fsr = (x.to(dtype) for x in (ops.rx, ops.fsl, ops.fsr))
    u_l, u_r = u[0], u[-1]  # (B, K)
    left = torch.cat([torch.full_like(u_r[:, :1], uin), u_r[:, :-1]], dim=1)
    du_l = fsl * (u_l - left)
    du_r = torch.cat(
        [fsr[:-1] * (u_r[:, :-1] - u_l[:, 1:]), torch.zeros_like(u_r[:, :1])], dim=1
    )
    vol = (drc @ u.reshape(u.shape[0], -1)).reshape(u.shape) * rx
    return vol + ll[:, None, None] * du_l + lr[:, None, None] * du_r


def _rhs_t_plain(w, tab: StepTables, ops: KernelOps):
    """Transpose of the homogeneous dt·RHS on (Np, B, K)."""
    dtype = w.dtype
    drc, ll, lr = (x.to(dtype) for x in (tab.drc, tab.ll, tab.lr))
    rx, fsl, fsr = (x.to(dtype) for x in (ops.rx, ops.fsl, ops.fsr))
    zero = torch.zeros_like(w[0, :, :1])
    s0 = fsl * torch.tensordot(ll, w, dims=1)  # (B, K)
    s1 = fsr * torch.tensordot(lr, w, dims=1)
    s1 = torch.cat([s1[:, :-1], zero], dim=1)  # outflow element: no flux
    p0 = torch.cat([s0[:, 1:], zero], dim=1)  # from element k+1
    p1 = torch.cat([zero, s1[:, :-1]], dim=1)  # from element k−1
    out = (drc.T @ w.reshape(w.shape[0], -1)).reshape(w.shape) * rx
    out[0] += s0 - p1
    out[-1] += s1 - p0
    return out


def _step_plain(u, t: float, tab: StepTables, ops: KernelOps):
    resu = None
    for s in range(5):
        uin = -math.sin(ops.a * (t + float(RK4C[s]) * tab.dt))
        rhs = _rhs_plain(u, uin, tab, ops)
        resu = rhs if s == 0 else float(RK4A[s]) * resu + rhs
        u = u + float(RK4B[s]) * resu
    return u


def _step_t_plain(lu, tab: StepTables, ops: KernelOps):
    lr = None
    for s in (4, 3, 2, 1, 0):
        w = float(RK4B[s]) * lu if lr is None else float(RK4B[s]) * lu + lr
        lr = float(RK4A[s]) * w
        lu = lu + _rhs_t_plain(w, tab, ops)
    return lu


def _new_store(u0, n_count: int, store_every: int | None):
    """Room for the entry state of every store_every-th of n_count steps,
    ⌈n_count/store_every⌉ states like ``u0`` (None: no store)."""
    if not store_every:
        return None
    return torch.empty((-(-n_count // store_every), *u0.shape), dtype=u0.dtype, device=u0.device)


def _fwd_steps_plain(u0, t0: float, n_first: int, n_count: int, ops: KernelOps,
                     store_every: int | None):
    """Steps n_first … n_first + n_count − 1 from ``u0``: ``(store, u)``, store
    holding the entry state of every store_every-th step (None: nothing)."""
    store = _new_store(u0, n_count, store_every)
    u = u0
    for n in range(n_count):
        if store is not None and n % store_every == 0:
            store[n // store_every] = u
        u = _step_plain(u, t0 + (n_first + n) * ops.dt, ops.full, ops)
    return store, u


def _rev_steps_plain(traj, u_end, lu, eta, t0: float, n_first: int, ops: KernelOps):
    """K2's sweep over the steps of ``traj`` (global indices from n_first;
    u_end the state after the last): ``(lu, eta)``."""
    n_count = traj.shape[0]
    h = ops.dt / 2.0
    for n in reversed(range(n_count)):
        t_n = t0 + (n_first + n) * ops.dt
        u_np1 = u_end if n == n_count - 1 else traj[n + 1]
        half = _step_plain(traj[n], t_n, ops.half, ops)
        half2 = _step_plain(half, t_n + h, ops.half, ops)
        eta = eta + torch.sum(lu * (u_np1 - half2), dim=0)
        lu = _step_t_plain(_step_t_plain(lu, ops.half, ops), ops.half, ops)
    return lu, eta


def fwd_march_plain(u0, t0: float, n_steps: int, ops: KernelOps,
                    store_trajectory: bool = False, checkpoint_every: int | None = None):
    """K1's plain version: ``(traj or None, u_final)``; with
    ``checkpoint_every`` the first slot holds the checkpoints, the entry
    state of every checkpoint_every-th step (K1's checkpoint mode)."""
    every = checkpoint_every or (1 if store_trajectory else None)
    return _fwd_steps_plain(u0, t0, 0, n_steps, ops, every)


def adj_est_stored_plain(traj, u_final, lam_end, t0: float, ops: KernelOps):
    """K2's plain version: ``(lam0, eta)`` with eta (B, K)."""
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    return _rev_steps_plain(traj, u_final, lam_end, eta, t0, 0, ops)


def adj_est_recompute_plain(ckpts, lam_end, t0: float, segment: int, ops: KernelOps):
    """K2r's plain version: ``(lam0, eta)`` from the checkpoints (n_seg, Np,
    B, K); each segment recomputed, then swept, as K2 sweeps the stored
    trajectory."""
    lu = lam_end
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    for si in reversed(range(ckpts.shape[0])):
        traj, u_end = _fwd_steps_plain(ckpts[si], t0, si * segment, segment, ops, 1)
        lu, eta = _rev_steps_plain(traj, u_end, lu, eta, t0, si * segment, ops)
    return lu, eta


def adj_march_plain(lam_end, n_steps: int, ops: KernelOps):
    """KA's plain version: λ0 = (Lᵀ)^n_steps λ_end with the full-dt tables."""
    lu = lam_end
    for _ in range(n_steps):
        lu = _step_t_plain(lu, ops.full, ops)
    return lu


# ------------------------------------------------ K1/K2/K2r's launch plans


class FusedPlan(NamedTuple):
    """K1's, K2's, K2r's and KA's launch schedule: ``segment`` (s_f) steps a
    launch; CTA tiles of ``tile`` (L) local elements, the last ragged, each
    with a window of ``ghost`` (W) elements a side clipped to [0, K); CTAs
    built for ``threads``, one thread a window element."""

    segment: int
    ghost: int
    tile: int
    n_tiles: int
    threads: int


def _check_threads(threads: int) -> None:
    if threads not in FUSED_THREADS:
        raise ValueError(f"threads={threads}: the fused kernels are built for {FUSED_THREADS}")


def fused_plan(k: int, steps: int = FUSED_STEPS, threads: int = 512) -> FusedPlan:
    """K2's and K2r's plan of ``steps`` steps a launch on CTAs of ``threads``
    (512 or 1024) for K elements: W = 10·steps + 10 (the ghost rule of the
    JAX package's dg_sharded.py:18-25, which keeps every local element
    exact), L = threads − 2W."""
    if not 1 <= steps <= MAX_FUSED:
        raise ValueError(f"steps={steps}: K2/K2r fuse 1..{MAX_FUSED} steps a launch")
    _check_threads(threads)
    ghost = 10 * steps + 10
    tile = threads - 2 * ghost
    if tile < 1:
        raise ValueError(f"{steps} steps need {2 * ghost} ghost elements, past a "
                         f"{threads}-thread window")
    return FusedPlan(steps, ghost, tile, -(-k // tile), threads)


def fwd_fused_plan(k: int, steps: int, threads: int = 512) -> FusedPlan:
    """K1's (and KA's) widest plan of ``steps`` steps a launch on CTAs of
    ``threads``: W = 5·steps (a forward step runs 5 stages, each coupling ±1
    element, so the window's wrong ends reach 5·steps elements in; KA's 5
    transposed stages a step likewise), L = threads − 2W.
    :func:`forward_plan` and :func:`adjoint_plan` also take a single tile
    with no ghosts where the mesh fits one CTA."""
    if not 1 <= steps <= MAX_FWD_FUSED:
        raise ValueError(f"steps={steps}: K1 fuses 1..{MAX_FWD_FUSED} steps a launch")
    _check_threads(threads)
    ghost = 5 * steps
    tile = threads - 2 * ghost
    return FusedPlan(steps, ghost, tile, -(-k // tile), threads)


# The plans' cost model, fitted to chip_smoke.py phase 29's four headline
# plans on an NVIDIA H100 (700 W): a stage issues ~60 instructions a warp, so
# a launch lasts as long as its busiest SM needs to issue its warps' stages
# (0.139 µs a step for each warp the SM holds over the launch, at Np = 3),
# plus ~3.74 µs a launch of start, window loads and wave tail. Below 16 warps
# an SM (one 512-thread CTA, the least occupancy measured) the stage's
# dependent chain and barrier are taken to set the pace instead of issue.
# K1's step, 5 stages against the reverse's 20, costs FWD_STEP_WARP_US:
# fitted to chip_smoke.py phase 30's first run (20 plans at the four rows
# K1 serves, 0.038-0.050 µs; the trajectory's stores cost the most). KA's
# step, 5 transposed stages, costs ADJ_STEP_WARP_US: fitted to chip_smoke.py
# phase 31's first run (five plans at K = 10⁴, B = 1, 2048 steps, 0.030-0.038
# µs, their mean).
STEP_WARP_US = 0.139
FWD_STEP_WARP_US = 0.044
ADJ_STEP_WARP_US = 0.034
LAUNCH_US = 3.74
MIN_WARPS = 16
H100_SMS = 132
FUSED_CANDIDATE_STEPS = (4, 8)
FWD_CANDIDATE_STEPS = (4, 8, 16, 32)


def _fused_cost(k: int, b: int, n_steps: int, launches: int, plan: FusedPlan, sms: int,
                step_warp_us: float = STEP_WARP_US) -> float:
    """Modelled µs of ``launches`` launches over n_steps steps: the warps of
    the busiest SM (CTAs dealt round-robin; at least MIN_WARPS) times the
    steps, plus the launches."""
    warps = -(-plan.n_tiles * b // sms) * -(-min(plan.tile + 2 * plan.ghost, k) // 32)
    return n_steps * max(warps, MIN_WARPS) * step_warp_us + launches * LAUNCH_US


def _tilings(k: int, b: int, sms: int, widest: FusedPlan):
    """``widest`` cut into every tile count from the fewest a CTA holds to
    one more CTA per SM (each tile count's L = ⌈K/tiles⌉)."""
    n_min = -(-k // widest.tile)
    for n_t in range(n_min, n_min + -(-sms // b) + 1):
        tile = -(-k // n_t)
        yield widest._replace(tile=tile, n_tiles=-(-k // tile))


def _cheapest(plans, cost_of) -> FusedPlan:
    """The plan of least modelled cost; a tie goes to the plan found first."""
    best = None
    for plan in plans:
        cost = cost_of(plan)
        if best is None or cost < best[0]:
            best = (cost, plan)
    return best[1]


def _balanced_plan(k: int, b: int, np_: int, n_steps: int, sms: int, steps_options,
                   launches_of, step_warp_us: float = STEP_WARP_US) -> FusedPlan:
    """K2's, K2r's or KM2's cheapest plan under :func:`_fused_cost` at
    ``step_warp_us`` over s_f in ``steps_options``, 512- or 1024-thread CTAs
    (1024 only where the reverse kernel holds its registers at 64 a thread
    without spilling: Np ≤ 6, per nvcc -Xptxas -v) and every tiling
    (:func:`_tilings`); a tie goes to the fewest tiles and s_f = 4."""
    plans = (plan for steps in steps_options
             for threads in (FUSED_THREADS if np_ <= 6 else FUSED_THREADS[:1])
             for plan in _tilings(k, b, sms, fused_plan(k, steps, threads)))
    return _cheapest(plans, lambda plan: _fused_cost(k, b, n_steps, launches_of(plan.segment),
                                                     plan, sms, step_warp_us))


def _fwd_cost(k: int, b: int, np_: int, n_steps: int, store_every: int | None,
              plan: FusedPlan, sms: int) -> float:
    """K1's modelled µs on ``plan``: the issue time of :func:`_fused_cost`
    at FWD_STEP_WARP_US a step, or the bytes K1 must move (u0, u_final and
    the stored states) at 3.35 TB/s where those take longer, plus the
    launches."""
    launches = -(-n_steps // plan.segment)
    issue = _fused_cost(k, b, n_steps, 0, plan, sms, FWD_STEP_WARP_US)
    states = 2 + (-(-n_steps // store_every) if store_every else 0)
    return max(issue, states * np_ * b * k * 4 / 3.35e6) + launches * LAUNCH_US


def _window_plans(k: int, b: int, n_steps: int, sms: int):
    """K1's and KA's candidate plans: s_f ∈ {4, 8, 16, 32} (at most
    n_steps), 512- or 1024-thread CTAs and, for each, one tile with no
    ghosts where the mesh fits the CTA and every tiling of W = 5·s_f
    (:func:`_tilings`), in that order."""
    for steps in sorted({min(s, n_steps) for s in FWD_CANDIDATE_STEPS}):
        for threads in FUSED_THREADS:
            if k <= threads:
                yield FusedPlan(steps, 0, k, 1, threads)
            yield from _tilings(k, b, sms, fwd_fused_plan(k, steps, threads))


# the search costs ~1 ms of host time at B = 1: once per shape
@functools.lru_cache(maxsize=256)
def forward_plan(k: int, b: int, np_: int, n_steps: int, store_every: int | None = None,
                 sms: int = H100_SMS) -> FusedPlan:
    """K1's plan for K elements, B members, Np nodes and n_steps steps,
    storing every store_every-th entry state (None: none), on a card of
    ``sms`` SMs: of :func:`_window_plans` (the forward kernel holds its
    registers at 64 a thread at every Np, so 1024 threads serve every Np),
    whichever minimises :func:`_fwd_cost`: ⌈n_steps/s_f⌉ launches. A tie
    goes to the first found: the fewest steps, 512 threads, one tile."""
    return _cheapest(_window_plans(k, b, n_steps, sms),
                     lambda plan: _fwd_cost(k, b, np_, n_steps, store_every, plan, sms))


@functools.lru_cache(maxsize=256)
def adjoint_plan(k: int, b: int, np_: int, n_steps: int, sms: int = H100_SMS) -> FusedPlan:
    """KA's plan: :func:`forward_plan`'s search over :func:`_window_plans`
    (5 transposed stages a step couple ±1 element each, so W = 5·s_f as
    K1's), under :func:`_fused_cost` at :data:`ADJ_STEP_WARP_US` a step with
    ⌈n_steps/s_f⌉ launches; KA stores nothing. A thread holds λu, λr and its
    geometry, 2·Np + 3 values, so 1024 threads serve every Np. A tie goes to
    the first found."""
    return _cheapest(_window_plans(k, b, n_steps, sms),
                     lambda plan: _fused_cost(k, b, n_steps, -(-n_steps // plan.segment), plan,
                                              sms, ADJ_STEP_WARP_US))


# the search costs ~1 ms of host time at B = 1: once per shape
@functools.lru_cache(maxsize=256)
def stored_plan(k: int, b: int, np_: int, n_steps: int, sms: int = H100_SMS) -> FusedPlan:
    """K2's plan for K elements, B members, Np nodes and n_steps steps on a
    card of ``sms`` SMs: s_f ∈ {4, 8} (at most n_steps), 512- or 1024-thread
    CTAs and the tile count that minimise the modelled time (see
    :data:`STEP_WARP_US`): ⌈n_steps/s_f⌉ launches. A thread holds its
    element's ~9·Np + 20 values in registers (42 at Np = 3 and 512 threads,
    103 at Np = 8) and posts 16 bytes of traces a stage, 8 or 16 KB of shared
    memory a CTA: registers, not shared memory, limit the CTA. At the
    headline (K = 10⁴, B = 8, Np = 3, 2048 steps) it takes s_f = 8 on 16
    tiles of 625 + 2·90 ghosts, 128 CTAs of 1024 threads, one an SM."""
    options = sorted({min(s, n_steps) for s in FUSED_CANDIDATE_STEPS})
    return _balanced_plan(k, b, np_, n_steps, sms, options, lambda s: -(-n_steps // s))


@functools.lru_cache(maxsize=256)
def recompute_plan(k: int, b: int, np_: int, segment: int, n_steps: int,
                   sms: int = H100_SMS) -> FusedPlan:
    """K2r's plan: a checkpoint segment in ⌈segment/c⌉ launches of equal
    length for c ∈ {4, 8} each way, s_f = ⌈segment/⌈segment/c⌉⌉ (segment 1:
    1; 4: 4; 13: 4, 4, 4, 1 or 7, 6; 64: 4 or 8), 2·⌈segment/s_f⌉ launches a
    segment; the rest as :func:`stored_plan`, the recompute's 5 stages a step
    counted as a quarter of the reverse's 20."""
    options = sorted({-(-segment // -(-segment // c)) for c in FUSED_CANDIDATE_STEPS})
    n_seg = n_steps // segment
    return _balanced_plan(k, b, np_, n_steps + n_steps // 4, sms, options,
                          lambda s: 2 * n_seg * -(-segment // s))


def _window(plan, ops: KernelOps, t: int):
    """Tile t's local range [lo, hi), window [w0, w1), and the window's
    geometry as a mesh of its own (first element inflow, last outflow: the
    domain's ends, or a ghost edge that never reaches [lo, hi))."""
    lo = t * plan.tile
    hi = min(lo + plan.tile, ops.k)
    w0, w1 = max(lo - plan.ghost, 0), min(hi + plan.ghost, ops.k)
    wops = ops._replace(k=w1 - w0, rx=ops.rx[w0:w1], fsl=ops.fsl[w0:w1], fsr=ops.fsr[w0:w1])
    return lo, hi, w0, w1, wops


def _rev_fused_plain(traj, u_end, lam, eta, t0: float, n_first: int, ops: KernelOps,
                     plan: FusedPlan):
    """K2's launches over the steps of ``traj`` (global indices from
    n_first; u_end the state after the last), s_f steps each from the top,
    every tile on its own window: ``(lam, eta)``."""
    n_count = traj.shape[0]
    h = ops.dt / 2.0
    eta = eta.clone()
    for hi_n in range(n_count, 0, -plan.segment):
        lo_n = max(hi_n - plan.segment, 0)
        lam_next = torch.empty_like(lam)
        for t in range(plan.n_tiles):
            lo, hi, w0, w1, wops = _window(plan, ops, t)
            loc = slice(lo - w0, hi - w0)
            lw = lam[:, :, w0:w1]
            e_loc = eta[:, lo:hi]
            for n in reversed(range(lo_n, hi_n)):
                t_n = t0 + (n_first + n) * ops.dt
                u_np1 = u_end if n == n_count - 1 else traj[n + 1]
                half = _step_plain(traj[n][:, :, w0:w1], t_n, ops.half, wops)
                half2 = _step_plain(half, t_n + h, ops.half, wops)
                e_loc = e_loc + torch.sum(lw[:, :, loc] * (u_np1[:, :, lo:hi] - half2[:, :, loc]),
                                          dim=0)
                lw = _step_t_plain(_step_t_plain(lw, ops.half, wops), ops.half, wops)
            lam_next[:, :, lo:hi] = lw[:, :, loc]
            eta[:, lo:hi] = e_loc
        lam = lam_next
    return lam, eta


def adj_est_stored_fused_plain(traj, u_final, lam_end, t0: float, ops: KernelOps,
                               plan: FusedPlan):
    """K2's launch schedule in plain PyTorch (any ghost width, so a narrow
    one can be shown to reach the local elements): ``(lam0, eta)``."""
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    return _rev_fused_plain(traj, u_final, lam_end, eta, float(t0), 0, ops, plan)


def _fwd_fused_plain(u0, t0: float, n_first: int, n_count: int, ops: KernelOps,
                     plan: FusedPlan, store_every: int | None):
    """K1's launches over steps n_first … n_first + n_count − 1 from ``u0``,
    s_f steps each, every tile on its own window: ``(store, u)`` as
    :func:`_fwd_steps_plain`, the store index counted from n_first."""
    store = _new_store(u0, n_count, store_every)
    u = u0
    for lo_n in range(0, n_count, plan.segment):
        nxt = torch.empty_like(u)
        for t in range(plan.n_tiles):
            lo, hi, w0, w1, wops = _window(plan, ops, t)
            loc = slice(lo - w0, hi - w0)
            uw = u[:, :, w0:w1]
            for n in range(lo_n, min(lo_n + plan.segment, n_count)):
                if store is not None and n % store_every == 0:
                    store[n // store_every][:, :, lo:hi] = uw[:, :, loc]
                uw = _step_plain(uw, t0 + (n_first + n) * ops.dt, ops.full, wops)
            nxt[:, :, lo:hi] = uw[:, :, loc]
        u = nxt
    return store, u


def fwd_march_fused_plain(u0, t0: float, n_steps: int, ops: KernelOps, plan: FusedPlan,
                          store_every: int | None = None):
    """K1's launch schedule in plain PyTorch (any ghost width, so a narrow
    one can be shown to reach the local elements): ``(store or None,
    u_final)``, store holding the entry state of every store_every-th step,
    ⌈n_steps/store_every⌉ of them."""
    return _fwd_fused_plain(u0, float(t0), 0, n_steps, ops, plan, store_every)


def adj_march_fused_plain(lam_end, n_steps: int, ops: KernelOps, plan: FusedPlan):
    """KA's launch schedule in plain PyTorch: s_f steps a launch (the last
    takes the remainder), every tile on its own window (any ghost width, so
    a narrow one can be shown to reach the local elements): λ0."""
    lam = lam_end
    for lo_n in range(0, n_steps, plan.segment):
        nxt = torch.empty_like(lam)
        for t in range(plan.n_tiles):
            lo, hi, w0, w1, wops = _window(plan, ops, t)
            lw = lam[:, :, w0:w1]
            for _ in range(lo_n, min(lo_n + plan.segment, n_steps)):
                lw = _step_t_plain(lw, ops.full, wops)
            nxt[:, :, lo:hi] = lw[:, :, lo - w0:hi - w0]
        lam = nxt
    return lam


def adj_est_recompute_fused_plain(ckpts, lam_end, t0: float, segment: int, ops: KernelOps,
                                  plan: FusedPlan):
    """K2r's launch schedule in plain PyTorch: per checkpoint segment in
    reverse, K1's launches write each tile's local states into the scratch,
    then K2's launches sweep it."""
    lam = lam_end
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    for si in reversed(range(ckpts.shape[0])):
        traj, u_end = _fwd_fused_plain(ckpts[si], float(t0), si * segment, segment, ops, plan, 1)
        lam, eta = _rev_fused_plain(traj, u_end, lam, eta, float(t0), si * segment, ops, plan)
    return lam, eta


# ------------------------------------------------------------------ wrappers


def _check(name: str, x: torch.Tensor, shape, ops: KernelOps) -> bool:
    """Validate an operand; True when it lies on a CUDA device (kernel
    path), False on the CPU (plain path). Raises on anything else."""
    return _check_on(name, x, shape, ops.rx.device)


def _check_on(name: str, x: torch.Tensor, shape, device: torch.device) -> bool:
    """:func:`_check` against the device of the kernel operands."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, kernel operands on {device}")
    if x.device.type == "cpu":
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {x.dtype}; plain path takes float32/64")
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: device {x.device} is neither cuda nor cpu")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return True


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def fwd_march(u0: torch.Tensor, t0: float, n_steps: int, ops: KernelOps,
              store_trajectory: bool = False):
    """K1: march (Np, B, K) ``u0`` n_steps steps from ``t0``.
    Returns ``(traj, u_final)``; traj is (n_steps, Np, B, K) or None. On the
    card it runs :func:`forward_plan`'s schedule for the card's SM count:
    ⌈n_steps/s_f⌉ launches of the fused kernel."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if u0.dim() != 3:
        raise ValueError(f"u0 must be (Np, B, K), got {tuple(u0.shape)}")
    b = u0.shape[1]
    if not _check("u0", u0, (ops.np_, b, ops.k), ops):
        return fwd_march_plain(u0, float(t0), n_steps, ops, store_trajectory)
    lib = load_library()
    size = u0.numel()
    traj = None
    if store_trajectory:
        need = n_steps * size * 4
        free, total = torch.cuda.mem_get_info(u0.device)
        if need > free:
            raise MemoryError(
                f"stored trajectory needs {need / 2**30:.2f} GiB "
                f"({n_steps}x{ops.np_}x{b}x{ops.k} float32); {free / 2**30:.2f} "
                f"of {total / 2**30:.2f} GiB free on {u0.device}"
            )
        traj = torch.empty((n_steps, *u0.shape), dtype=torch.float32, device=u0.device)
    u_final, fwd_march.cuda_launches = _k1_launch(lib, u0, t0, n_steps, traj, 1, ops)
    fwd_march.launches += 1
    return traj, u_final


def _k1_launch(lib, u0, t0, n_steps: int, store, store_every: int, ops: KernelOps,
               plan: FusedPlan | None = None):
    """One dg_fwd_march call with ``plan`` (default :func:`forward_plan`'s):
    ``(u_final, CUDA launches)``. The wrapper counts its launches; this does
    not."""
    b = u0.shape[1]
    _check_grid(b)
    if plan is None:
        plan = forward_plan(ops.k, b, ops.np_, n_steps, store_every if store is not None else None,
                            _sm_count(u0.device))
    u_final = torch.empty_like(u0)
    ubuf = torch.empty((2, u0.numel()), dtype=torch.float32, device=u0.device)
    launches = ctypes.c_int(0)
    rx, fsl, fsr = ops.geom32
    code = lib.lib.dg_fwd_march(
        ops.np_, b, ops.k, n_steps, store_every, plan.segment, plan.tile, plan.ghost,
        plan.threads, float(t0), ops.dt, ops.a, _RK.ctypes.data, ops.full.packed.ctypes.data,
        _ptr(rx), _ptr(fsl), _ptr(fsr), _ptr(u0), _ptr(store), _ptr(u_final), _ptr(ubuf[0]),
        ctypes.addressof(launches), _stream(u0.device),
    )
    lib.check(code, "dg_fwd_march")
    return u_final, launches.value


def _check_segment(n_steps: int, segment: int) -> None:
    if segment < 1 or n_steps % segment:
        raise ValueError(f"n_steps={n_steps} not a multiple of segment={segment}")


def fwd_march_ckpt(u0: torch.Tensor, t0: float, n_steps: int, segment: int,
                   ops: KernelOps):
    """K1 in checkpoint mode: march n_steps steps storing the entry state of
    every ``segment``-th step. Returns ``(ckpts, u_final)``, ckpts
    (n_steps/segment, Np, B, K). On the card :func:`forward_plan`'s schedule,
    as :func:`fwd_march`; any s_f serves any segment."""
    _check_segment(n_steps, segment)
    if u0.dim() != 3:
        raise ValueError(f"u0 must be (Np, B, K), got {tuple(u0.shape)}")
    if not _check("u0", u0, (ops.np_, u0.shape[1], ops.k), ops):
        return fwd_march_plain(u0, float(t0), n_steps, ops, checkpoint_every=segment)
    lib = load_library()
    ckpts = torch.empty((n_steps // segment, *u0.shape), dtype=torch.float32, device=u0.device)
    u_final, fwd_march_ckpt.cuda_launches = _k1_launch(lib, u0, t0, n_steps, ckpts, segment, ops)
    fwd_march_ckpt.launches += 1
    return ckpts, u_final


def adj_est_stored(traj: torch.Tensor, u_final: torch.Tensor, lam_end: torch.Tensor,
                   t0: float, ops: KernelOps):
    """K2: reverse sweep over a stored trajectory with the fine (dt/2)²
    transpose. Returns ``(lam0, eta)``, eta (B, K). On the card it runs
    :func:`stored_plan`'s schedule for the card's SM count: ⌈n_steps/s_f⌉
    launches of the fused kernel."""
    if traj.dim() != 4:
        raise ValueError(f"traj must be (n_steps, Np, B, K), got {tuple(traj.shape)}")
    n_steps, _, b, _ = traj.shape
    state = (ops.np_, b, ops.k)
    # all three lie on ops' device (checked), so they agree on the path
    on_cuda = _check("traj", traj, (n_steps, *state), ops)
    _check("u_final", u_final, state, ops)
    _check("lam_end", lam_end, state, ops)
    if not on_cuda:
        return adj_est_stored_plain(traj, u_final, lam_end, float(t0), ops)
    adj_est_stored.launches += 1
    plan = stored_plan(ops.k, b, ops.np_, n_steps, _sm_count(traj.device))
    lam0, eta, adj_est_stored.cuda_launches = _k2_launch(traj, u_final, lam_end, t0, ops, plan)
    return lam0, eta


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_grid(b: int) -> None:
    if not 1 <= b <= 65_535:
        raise ValueError(f"B={b}: the fused kernels take 1 <= B <= 65535 (grid y)")


def _k2_launch(traj, u_final, lam_end, t0, ops: KernelOps, plan: FusedPlan):
    """One dg_adj_est_stored call with ``plan``: ``(lam0, eta, CUDA
    launches)``. The wrapper counts its launches; this does not."""
    n_steps, _, b, _ = traj.shape
    _check_grid(b)
    lib = load_library()
    lam0 = torch.empty_like(lam_end)
    eta = torch.zeros((b, ops.k), dtype=torch.float32, device=traj.device)
    lbuf = torch.empty((2, lam_end.numel()), dtype=torch.float32, device=traj.device)
    launches = ctypes.c_int(0)
    rx, fsl, fsr = ops.geom32
    code = lib.lib.dg_adj_est_stored(
        ops.np_, b, ops.k, n_steps, plan.segment, plan.tile, plan.ghost, plan.threads,
        float(t0), ops.dt, ops.a, _RK.ctypes.data, ops.half.packed.ctypes.data,
        _ptr(rx), _ptr(fsl), _ptr(fsr), _ptr(traj), _ptr(u_final), _ptr(lam_end),
        _ptr(lam0), _ptr(eta), _ptr(lbuf[0]), ctypes.addressof(launches),
        _stream(traj.device),
    )
    lib.check(code, "dg_adj_est_stored")
    return lam0, eta, launches.value


def adj_est_recompute(ckpts: torch.Tensor, lam_end: torch.Tensor, t0: float,
                      segment: int, ops: KernelOps):
    """K2r: the reverse sweep from K1's checkpoints, each segment recomputed
    into a (segment + 1)-state scratch first. Returns ``(lam0, eta)``, eta
    (B, K). On the card it runs :func:`recompute_plan`'s schedule for the
    card's SM count: 2·⌈segment/s_f⌉ launches of the fused kernels a
    checkpoint segment."""
    if ckpts.dim() != 4:
        raise ValueError(f"ckpts must be (n_segments, Np, B, K), got {tuple(ckpts.shape)}")
    n_seg, _, b, _ = ckpts.shape
    state = (ops.np_, b, ops.k)
    on_cuda = _check("ckpts", ckpts, (n_seg, *state), ops)
    _check("lam_end", lam_end, state, ops)
    if segment < 1:
        raise ValueError(f"segment={segment} must be >= 1")
    if not on_cuda:
        return adj_est_recompute_plain(ckpts, lam_end, float(t0), segment, ops)
    adj_est_recompute.launches += 1
    plan = recompute_plan(ops.k, b, ops.np_, segment, n_seg * segment,
                          _sm_count(ckpts.device))
    lam0, eta, adj_est_recompute.cuda_launches = _k2r_launch(
        ckpts, lam_end, t0, segment, ops, plan)
    return lam0, eta


def _k2r_launch(ckpts, lam_end, t0, segment: int, ops: KernelOps, plan: FusedPlan):
    """One dg_adj_est_recompute call with ``plan``: ``(lam0, eta, CUDA
    launches)``. The wrapper counts its launches; this does not."""
    n_seg, _, b, _ = ckpts.shape
    _check_grid(b)
    lib = load_library()
    size = lam_end.numel()
    lam0 = torch.empty_like(lam_end)
    eta = torch.zeros((b, ops.k), dtype=torch.float32, device=ckpts.device)
    scratch = torch.empty((segment + 1, size), dtype=torch.float32, device=ckpts.device)
    lbuf = torch.empty((2, size), dtype=torch.float32, device=ckpts.device)
    launches = ctypes.c_int(0)
    rx, fsl, fsr = ops.geom32
    code = lib.lib.dg_adj_est_recompute(
        ops.np_, b, ops.k, n_seg * segment, segment, plan.segment, plan.tile, plan.ghost,
        plan.threads, float(t0), ops.dt, ops.a, _RK.ctypes.data,
        ops.full.packed.ctypes.data, ops.half.packed.ctypes.data, _ptr(rx), _ptr(fsl),
        _ptr(fsr), _ptr(ckpts), _ptr(lam_end), _ptr(lam0), _ptr(eta), _ptr(scratch),
        _ptr(lbuf[0]), ctypes.addressof(launches), _stream(ckpts.device),
    )
    lib.check(code, "dg_adj_est_recompute")
    return lam0, eta, launches.value


def adj_march(lam_end: torch.Tensor, n_steps: int, ops: KernelOps):
    """KA: λ0 = (Lᵀ)^n_steps λ_end on (Np, B, K), the coarse (step-dt)
    transpose with no residual. On the card it runs :func:`adjoint_plan`'s
    schedule for the card's SM count: ⌈n_steps/s_f⌉ launches of the fused
    kernel."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if lam_end.dim() != 3:
        raise ValueError(f"lam_end must be (Np, B, K), got {tuple(lam_end.shape)}")
    b = lam_end.shape[1]
    if not _check("lam_end", lam_end, (ops.np_, b, ops.k), ops):
        return adj_march_plain(lam_end, n_steps, ops)
    plan = adjoint_plan(ops.k, b, ops.np_, n_steps, _sm_count(lam_end.device))
    lam0, adj_march.cuda_launches = _ka_launch(lam_end, n_steps, ops, plan)
    adj_march.launches += 1
    return lam0


def _ka_launch(lam_end, n_steps: int, ops: KernelOps, plan: FusedPlan):
    """One dg_adj_march call with ``plan``: ``(lam0, CUDA launches)``. The
    wrapper counts its launches; this does not."""
    b = lam_end.shape[1]
    _check_grid(b)
    lib = load_library()
    lam0 = torch.empty_like(lam_end)
    lbuf = torch.empty((2, lam_end.numel()), dtype=torch.float32, device=lam_end.device)
    launches = ctypes.c_int(0)
    rx, fsl, fsr = ops.geom32
    code = lib.lib.dg_adj_march(
        ops.np_, b, ops.k, n_steps, plan.segment, plan.tile, plan.ghost, plan.threads,
        _RK.ctypes.data, ops.full.packed.ctypes.data, _ptr(rx), _ptr(fsl), _ptr(fsr),
        _ptr(lam_end), _ptr(lam0), _ptr(lbuf[0]), ctypes.addressof(launches),
        _stream(lam_end.device),
    )
    lib.check(code, "dg_adj_march")
    return lam0, launches.value


_WRAPPERS = (fwd_march, fwd_march_ckpt, adj_est_stored, adj_est_recompute, adj_march)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.cuda_launches = 0


reset_launch_counts()


# -------------------------------------------------------------- entry points


def _check_uniform(disc: Discretization1D) -> None:
    """The unbatched entry points keep the JAX package's uniform-mesh
    contract (its dg_rhs.py ``_check_uniform``, the same 1e-7 relative
    test of every rx and fscale against element 0's)."""
    rx0 = float(disc.rx[0, 0])
    uniform = np.allclose(disc.rx, rx0, rtol=1e-7, atol=0.0) and np.allclose(
        disc.fscale, rx0, rtol=1e-7, atol=0.0
    )
    if not uniform:
        raise ValueError("the unbatched DG entry points require a uniform mesh")


def make_cuda_fwd_adj_estimate_grid_batched(
    disc: Discretization1D, a: float, dt: float, n_steps: int, batch: int = 8,
    device="cuda", *, store_trajectory: bool = False, segment: int | None = None,
):
    """Batched pipeline: ``run(u0, t0, lam_end) -> (u_final, lam0, eta)`` with
    ``u0/lam_end``: (Np, B, K), ``eta``: (B, K) — ``batch`` independent
    copies of the unbatched pipeline.

    ``store_trajectory=False`` (the JAX factory's default) keeps one
    checkpoint per ``segment`` steps (default ``pick_chunk(n_steps)``) and
    recomputes each segment in reverse (K1 checkpoints + K2r):
    (n_steps/segment + segment + 1)·Np·B·K·4 bytes. ``True`` stores every
    coarse state (K1 + K2): n_steps·Np·B·K·4 bytes of device memory, one
    LSRK step-equivalent less per step. The two give the same bits."""
    ops = kernel_ops(disc, a, dt, device)
    state = (disc.np_, batch, disc.k)
    segment = pick_chunk(n_steps) if segment is None else segment
    _check_segment(n_steps, segment)

    def run(u0, t0, lam_end):
        if tuple(u0.shape) != state or tuple(lam_end.shape) != state:
            raise ValueError(f"u0/lam_end must be {state}")
        if store_trajectory:
            traj, u_final = fwd_march(u0, t0, n_steps, ops, store_trajectory=True)
            lam0, eta = adj_est_stored(traj, u_final, lam_end, t0, ops)
        else:
            ckpts, u_final = fwd_march_ckpt(u0, t0, n_steps, segment, ops)
            lam0, eta = adj_est_recompute(ckpts, lam_end, t0, segment, ops)
        return u_final, lam0, eta

    return run


def _single(inner):
    """(Np, K) states through a B = 1 batched ``inner``."""

    def run(u0, t0, lam_end):
        uf, lam0, eta = inner(u0[:, None, :], t0, lam_end[:, None, :])
        return uf[:, 0, :], lam0[:, 0, :], eta[0]

    return run


def make_cuda_fwd_adj_estimate_single(
    disc: Discretization1D, a: float, dt: float, n_steps: int, device="cuda", *,
    store_trajectory: bool = True, segment: int | None = None,
):
    """Single-state pipeline, ``run(u0, t0, lam_end) -> (u_final, lam0, eta)``
    with ``u0/lam_end``: (Np, K) and ``eta``: (K,) — the batched pipeline
    at B = 1 (the TPU's blocked-sublane layout has no counterpart here),
    storing the trajectory unless ``store_trajectory=False``."""
    return _single(make_cuda_fwd_adj_estimate_grid_batched(
        disc, a, dt, n_steps, 1, device, store_trajectory=store_trajectory,
        segment=segment))


def make_cuda_advec_march(
    disc: Discretization1D, a: float, dt: float, n_steps: int, device="cuda"
):
    """Forward march ``march(u0, t0) -> u`` over n_steps steps on (Np, K)
    (K1 at B = 1, no trajectory)."""
    ops = kernel_ops(disc, a, dt, device)

    def march(u0, t0):
        _, u = fwd_march(u0[:, None, :], t0, n_steps, ops)
        return u[:, 0, :]

    return march


def make_cuda_advec_adjoint(
    disc: Discretization1D, a: float, dt: float, steps_per_call: int = 256, device="cuda"
):
    """``adjoint(lam_end, n_calls) -> lam0`` on (Np, K): the exact transpose
    of ``n_calls · steps_per_call`` homogeneous forward steps (KA at B = 1,
    one wrapper call for all of them). Uniform meshes, as
    ``make_pallas_advec_adjoint``."""
    _check_uniform(disc)
    ops = kernel_ops(disc, a, dt, device)

    def adjoint(lam_end, n_calls: int):
        lam = adj_march(lam_end[:, None, :].contiguous(), n_calls * steps_per_call, ops)
        return lam[:, 0, :]

    return adjoint


def make_cuda_fwd_adj_estimate(
    disc: Discretization1D, a: float, dt: float, segment: int = 32, device="cuda"
):
    """``run(u0, t0, n_segments, lam_end) -> (u_final, lam0, eta)`` on (Np, K),
    eta (K,): the recompute pipeline at B = 1 over n_segments·segment steps,
    one checkpoint per segment (``make_pallas_fwd_adj_estimate``). Uniform
    meshes."""
    _check_uniform(disc)
    ops = kernel_ops(disc, a, dt, device)

    def run(u0, t0, n_segments: int, lam_end):
        n_steps = n_segments * segment
        ckpts, uf = fwd_march_ckpt(u0[:, None, :].contiguous(), t0, n_steps, segment, ops)
        lam0, eta = adj_est_recompute(ckpts, lam_end[:, None, :].contiguous(), t0,
                                      segment, ops)
        return uf[:, 0, :], lam0[:, 0, :], eta[0]

    return run


def make_cuda_fwd_adj_estimate_grid(
    disc: Discretization1D, a: float, dt: float, segment: int = 32, n_segments: int = 64,
    device="cuda",
):
    """``run(u0, t0, lam_end) -> (u_final, lam0, eta)`` for exactly
    n_segments·segment steps (``make_pallas_fwd_adj_estimate_grid``): the
    recompute pipeline at B = 1. Uniform meshes."""
    _check_uniform(disc)
    return _single(make_cuda_fwd_adj_estimate_grid_batched(
        disc, a, dt, n_segments * segment, 1, device, store_trajectory=False,
        segment=segment))
