"""The DG-advection stored-trajectory pipeline in the MXU layout on
hand-written CUDA: the state is one (Np, B·K) array and the volume term a
tile product of the (Np, Np) table by (Np, columns) tiles of it.

Counterpart of the JAX package's ``ops/pallas/dg_mxu.py``
(``make_pallas_fwd_adj_estimate_grid_mxu``). Two kernels (csrc/dg_mxu.cu):

- **KM1** :func:`km_fwd_traj` — n_steps LSRK4(5) steps from ``u0``, every
  entry state stored in a (n_steps, Np, N) trajectory. Replaces
  ``_fwd_traj_kernel_m`` (dg_mxu.py:151).
- **KM2** :func:`km_adj_est` — for n = n_steps−1 … 0: two dt/2 steps from
  u_n, η += Σ_rows λ·(u_{n+1} − half2), two dt/2 transposed steps. Replaces
  ``_adj_est_kernel_m`` (dg_mxu.py:179).

Both are fused over s_f steps a launch, one CTA per (tile, member), one
thread a column, the state in registers, one barrier a stage. KM1
(``km_fwd_fused``) runs on K1's windows: L local columns and W = 5·s_f ghost
columns a side, or one tile with no ghosts where a member's K fits a CTA;
:func:`km_fwd_plan` picks s_f ≤ 32, the CTA size and the tiles. KM2
(``km_rev_fused``) runs on K2's windows, W = 10·s_f + 10;
:func:`km_rev_plan` picks s_f, the CTA size and the tiles. Each makes
⌈n_steps/s_f⌉ CUDA launches. :func:`km_fwd_traj_fused_plain` and
:func:`km_adj_est_fused_plain` run the same schedules in plain PyTorch.

Arithmetic. The tables fold rx and dt as ``_MxuCfg.tables`` does (dg_mxu.py:
74-82): the scalar −a·rx·dt is formed in double, rounded to float32, and
multiplied with the float32 Dr; the lift columns likewise with ∓a/2·rx·dt.
K1's ``StepTables`` round −a·dt·Dr once from double and keep rx apart, and
csrc/dg_stage.cuh's stage arithmetic contracts with fmaf and keeps the face
scales apart: nothing of it rounds as the TPU kernel does, so KM shares only
its table struct and Np switch. The stage times follow the TPU kernel
(dg_mxu.py:161, :195-196) in float32: t_n = (t0 + i·seg·dt) + m·dt for step m
of segment i, then + c_s·dt (each product formed in double and rounded,
each sum in float32), and the inflow is −sin(a·t_s) of the float32 argument
a·t_s. Every operation of the kernels is an explicit float32 rounding in a
fixed order, and the plain versions (:func:`km_fwd_traj_plain`,
:func:`km_adj_est_plain`) write the same operations in the same order, so
in float32 the two agree to the bit up to the device's and the host's
float32 arithmetic (both IEEE, round to nearest).

A CUDA float32 tensor launches the kernel or raises; a CPU tensor takes the
plain version (float32 or float64). Each wrapper counts its kernel calls in
``.launches``; ``km_fwd_traj.cuda_launches`` and
``km_adj_est.cuda_launches`` hold the last call's CUDA launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import (
    FUSED_CANDIDATE_STEPS,
    H100_SMS,
    LAUNCH_US,
    MIN_NP,
    _RK,
    FusedPlan,
    _balanced_plan,
    _cheapest,
    _check_grid,
    _check_on,
    _check_uniform,
    _ptr,
    _fused_cost,
    _sm_count,
    _stream,
    _window_plans,
)
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "MxuTables",
    "MxuOps",
    "mxu_ops",
    "km_fwd_traj",
    "km_fwd_traj_plain",
    "km_fwd_traj_fused_plain",
    "km_fwd_plan",
    "km_adj_est",
    "km_adj_est_plain",
    "km_adj_est_fused_plain",
    "km_rev_plan",
    "reset_launch_counts",
    "make_cuda_fwd_adj_estimate_grid_mxu",
]

MAX_NP = 8  # KM1/KM2 take Np 2-8, as the JAX package's dg_mxu.py


class MxuTables(NamedTuple):
    """The folded tables of one step size: float32 values, as tensors on the
    device (for the plain versions) and packed [drc row-major, liftl,
    liftr] for the kernels' argument."""

    drc: torch.Tensor  # (Np, Np)
    ll: torch.Tensor  # (Np,)
    lr: torch.Tensor  # (Np,)
    packed: np.ndarray  # float32


class MxuOps(NamedTuple):
    """Everything KM1/KM2 need for one mesh, step and shape, on one device:
    N = B·K columns, the dt and dt/2 tables, and the segment layout that the
    stage times follow."""

    np_: int
    b: int
    k: int
    n: int
    a: float
    dt: float
    segment: int
    n_segments: int
    full: MxuTables
    half: MxuTables
    device: torch.device


def _tables(dr32, lift32, a: float, rx: float, dt: float, device) -> MxuTables:
    # _MxuCfg.tables (dg_mxu.py:74-82): a Python float times a float32 array
    drc = np.float32(-a * rx * dt) * dr32
    ll = lift32[:, 0] * np.float32(-a / 2.0 * rx * dt)
    lr = lift32[:, 1] * np.float32(a / 2.0 * rx * dt)
    packed = np.ascontiguousarray(np.concatenate([drc.ravel(), ll, lr]), dtype=np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    return MxuTables(t(drc), t(ll), t(lr), packed)


def mxu_ops(disc: Discretization1D, a: float, dt: float, segment: int, n_segments: int,
            batch: int, device) -> MxuOps:
    """KM1/KM2 operands for ``disc`` (uniform, 2 ≤ Np ≤ 8) at step ``dt``."""
    if not MIN_NP <= disc.np_ <= MAX_NP:
        raise ValueError(f"Np={disc.np_} unsupported (need {MIN_NP} <= Np <= {MAX_NP})")
    if segment < 1 or n_segments < 1 or batch < 1:
        raise ValueError(f"segment={segment}, n_segments={n_segments}, batch={batch} "
                         "must be >= 1")
    device = require_device(device)
    rx = float(disc.rx[0, 0])
    dr32 = np.ascontiguousarray(disc.dr, dtype=np.float32)
    lift32 = np.ascontiguousarray(disc.lift, dtype=np.float32)
    a, dt = float(a), float(dt)
    full = _tables(dr32, lift32, a, rx, dt, device)
    return MxuOps(
        np_=disc.np_, b=batch, k=disc.k, n=batch * disc.k, a=a, dt=dt, segment=segment,
        n_segments=n_segments, full=full, half=_tables(dr32, lift32, a, rx, dt / 2, device),
        device=full.drc.device,  # cuda:0, as a tensor reports it, for "cuda"
    )


# ------------------------------------------------------------- stage times


def _step_times(t0: float, ops: MxuOps) -> np.ndarray:
    """t_n of every step, float32: (t0 + i·seg·dt) + m·dt for step m of
    segment i (dg_mxu.py:165, :169; :190, :201)."""
    f32 = np.float32
    steps = np.arange(ops.segment * ops.n_segments)
    i, m = steps // ops.segment, steps % ops.segment
    t_seg = f32(t0) + (i * ops.segment * ops.dt).astype(f32)
    return t_seg + (m * ops.dt).astype(f32)


def _inflow(ts: np.ndarray, a: float) -> np.ndarray:
    """−sin(a·t_s) of the float32 argument a·t_s, rounded to float32."""
    arg = np.float32(a) * ts
    return np.ascontiguousarray(-np.sin(arg.astype(np.float64)), dtype=np.float32)


def fwd_inflow(t0: float, ops: MxuOps) -> np.ndarray:
    """KM1's inflow table (n_steps, 5): stage s of step n at t_n + c_s·dt."""
    c = (np.asarray(RK4C, dtype=np.float64) * ops.dt).astype(np.float32)
    return _inflow(_step_times(t0, ops)[:, None] + c[None, :], ops.a)


def rev_inflow(t0: float, ops: MxuOps) -> np.ndarray:
    """KM2's inflow table (n_steps, 10): the two dt/2 residual steps of
    step n, from t_n and from t_n + dt/2 (dg_mxu.py:207-210)."""
    f32 = np.float32
    h = ops.dt / 2
    c = (np.asarray(RK4C, dtype=np.float64) * h).astype(f32)
    t_n = _step_times(t0, ops)
    ts = np.concatenate([t_n[:, None] + c[None, :], (t_n + f32(h))[:, None] + c[None, :]], axis=1)
    return _inflow(ts, ops.a)


# ------------------------------------------------------------ plain versions


def _coef(dtype, device):
    def t(x):
        return [torch.tensor(float(np.float32(v)), dtype=dtype, device=device) for v in x]

    return t(RK4A), t(RK4B)


def _masks(ops: MxuOps, device):
    col = torch.arange(ops.n, device=device) % ops.k
    return col == 0, col == ops.k - 1


def _tabs(tab: MxuTables, dtype):
    return tuple(x.to(dtype) for x in (tab.drc, tab.ll, tab.lr))


def _stage_plain(u, r, s: int, uin, tabs, coef, first, last):
    """One forward stage in the kernel's order of operations."""
    drc, ll, lr = tabs
    rk_a, rk_b = coef
    vol = drc[:, 0:1] * u[0:1]
    for m in range(1, u.shape[0]):
        vol = vol + drc[:, m:m + 1] * u[m:m + 1]
    u_l, u_r = u[0], u[-1]
    du_l = u_l - torch.where(first, uin, torch.roll(u_r, 1))
    du_r = torch.where(last, torch.zeros_like(u_r), u_r - torch.roll(u_l, -1))
    rhs = (vol + ll[:, None] * du_l) + lr[:, None] * du_r
    r = rhs if r is None else rk_a[s] * r + rhs
    return u + rk_b[s] * r, r


def _row_dot(coef, w):
    s = coef[0] * w[0]
    for i in range(1, w.shape[0]):
        s = s + coef[i] * w[i]
    return s


def _stage_t_plain(lu, lr, s: int, tabs, coef, first, last):
    """One transposed stage in the kernel's order of operations."""
    drc, ll, lrow = tabs
    rk_a, rk_b = coef
    w = rk_b[s] * lu if lr is None else rk_b[s] * lu + lr
    w0, w1 = _row_dot(ll, w), _row_dot(lrow, w)
    acc = drc[0][:, None] * w[0:1]
    for i in range(1, w.shape[0]):
        acc = acc + drc[i][:, None] * w[i:i + 1]
    zero = torch.zeros_like(w0)
    s1 = torch.where(last, zero, w1)
    p0 = torch.where(last, zero, torch.roll(w0, -1))
    p1 = torch.where(first, zero, torch.roll(w1, 1))
    out = lu + acc
    out[0] = out[0] + (w0 - p1)
    out[-1] = out[-1] + (s1 - p0)
    return out, rk_a[s] * w


def _march_plain(u, t_inflow, tabs, coef, first, last):
    r = None
    for s in range(5):
        u, r = _stage_plain(u, r, s, t_inflow[s], tabs, coef, first, last)
    return u


def km_fwd_traj_plain(u0, t0: float, ops: MxuOps):
    """KM1's plain version: ``(traj, u_final)``, traj (n_steps, Np, N)."""
    dtype, device = u0.dtype, u0.device
    inflow = torch.as_tensor(fwd_inflow(t0, ops), dtype=dtype, device=device)
    tabs, coef = _tabs(ops.full, dtype), _coef(dtype, device)
    first, last = _masks(ops, device)
    n_steps = inflow.shape[0]
    traj = torch.empty((n_steps, *u0.shape), dtype=dtype, device=device)
    u = u0
    for n in range(n_steps):
        traj[n] = u
        u = _march_plain(u, inflow[n], tabs, coef, first, last)
    return traj, u


def _rev_step_plain(u_n, u_np1, lu, eta, inflow_n, tabs, coef, first, last):
    """One reverse step of KM2 on (Np, columns): two dt/2 steps from u_n, η
    += Σ_rows λ·(u_{n+1} − half2), then two dt/2 transposed steps of λ.
    Returns ``(lu, eta)``."""
    half = _march_plain(u_n, inflow_n[:5], tabs, coef, first, last)
    half2 = _march_plain(half, inflow_n[5:], tabs, coef, first, last)
    eta = eta + _row_dot(lu, u_np1 - half2)
    for _ in range(2):
        lr = None
        for s in (4, 3, 2, 1, 0):
            lu, lr = _stage_t_plain(lu, lr, s, tabs, coef, first, last)
    return lu, eta


def _rev_operands(lam_end, t0: float, ops: MxuOps):
    dtype, device = lam_end.dtype, lam_end.device
    inflow = torch.as_tensor(rev_inflow(t0, ops), dtype=dtype, device=device)
    return inflow, _tabs(ops.half, dtype), _coef(dtype, device)


def km_adj_est_plain(traj, u_final, lam_end, t0: float, ops: MxuOps):
    """KM2's plain version: ``(lam0, eta)``, eta (N,)."""
    inflow, tabs, coef = _rev_operands(lam_end, t0, ops)
    first, last = _masks(ops, lam_end.device)
    n_steps = traj.shape[0]
    lu = lam_end
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    for n in reversed(range(n_steps)):
        u_np1 = u_final if n == n_steps - 1 else traj[n + 1]
        lu, eta = _rev_step_plain(traj[n], u_np1, lu, eta, inflow[n], tabs, coef, first, last)
    return lu, eta


# ------------------------------------------------------- KM1's and KM2's plans


# KM2's step, 20 stages of ~2·Np² + 9·Np + 4 un-contracted FP32 operations a
# column (no FMA: the bits), costs KM_STEP_WARP_US × (2·Np² + 9·Np + 4) µs for
# each warp an SM holds over a launch, under dg_rhs's model (_fused_cost;
# LAUNCH_US a launch, at least MIN_WARPS warps an SM). Fitted to
# chip_smoke.py phase 34's first run on an NVIDIA H100 80GB HBM3 at 700 W:
# the mean over the 13 plans it timed at the two MXU rows (Np = 8:
# 0.00309-0.00384; Np = 3: 0.00330-0.00377 a unit).
KM_STEP_WARP_US = 0.00355


def km_step_warp_us(np_: int) -> float:
    """µs a KM2 step costs each warp an SM holds, at Np rows."""
    return KM_STEP_WARP_US * (2 * np_ * np_ + 9 * np_ + 4)


# the search costs ~1 ms of host time: once per shape
@functools.lru_cache(maxsize=256)
def km_rev_plan(k: int, b: int, np_: int, n_steps: int, sms: int = H100_SMS) -> FusedPlan:
    """KM2's plan for K columns a member, B members, Np rows and n_steps
    steps on a card of ``sms`` SMs: K2's windows (dg_rhs.fused_plan, W =
    10·s_f + 10, one CTA per (tile, member)) and search (dg_rhs
    _balanced_plan: s_f ∈ {4, 8} at most n_steps, 512 threads at Np ≥ 7,
    1024 too below, every tiling) under :func:`km_step_warp_us`;
    ⌈n_steps/s_f⌉ launches."""
    options = sorted({min(s, n_steps) for s in FUSED_CANDIDATE_STEPS})
    return _balanced_plan(k, b, np_, n_steps, sms, options, lambda s: -(-n_steps // s),
                          km_step_warp_us(np_))


# KM1's step, 5 stages against KM2's 20, costs KM_FWD_STEP_WARP_US × (2·Np² +
# 9·Np + 4) µs for each warp an SM holds over a launch. Fitted to
# chip_smoke.py phase 36's first run on an NVIDIA H100 80GB HBM3 at 700 W:
# the mean over the 16 plans it timed at the two MXU rows (Np = 8:
# 0.00083-0.00105; Np = 3: 0.00097-0.00114 a unit), from the first guess of
# a quarter of KM2's (0.00089).
KM_FWD_STEP_WARP_US = 0.00100


def km_fwd_step_warp_us(np_: int) -> float:
    """µs a KM1 step costs each warp an SM holds, at Np rows."""
    return KM_FWD_STEP_WARP_US * (2 * np_ * np_ + 9 * np_ + 4)


def km_fwd_cost(k: int, b: int, np_: int, n_steps: int, plan: FusedPlan,
                sms: int = H100_SMS) -> float:
    """KM1's modelled µs on ``plan`` (dg_rhs._fwd_cost's form): the issue
    time of dg_rhs._fused_cost at :func:`km_fwd_step_warp_us`, or the bytes
    of the n_steps + 2 states KM1 moves (u0, the trajectory, u_final) at 3.35
    TB/s where those take longer, plus LAUNCH_US a launch."""
    issue = _fused_cost(k, b, n_steps, 0, plan, sms, km_fwd_step_warp_us(np_))
    return (max(issue, (n_steps + 2) * np_ * b * k * 4 / 3.35e6)
            + -(-n_steps // plan.segment) * LAUNCH_US)


# the search costs ~1 ms of host time: once per shape
@functools.lru_cache(maxsize=256)
def km_fwd_plan(k: int, b: int, np_: int, n_steps: int, sms: int = H100_SMS) -> FusedPlan:
    """KM1's plan for K columns a member, B members, Np rows and n_steps
    steps on a card of ``sms`` SMs: of dg_rhs._window_plans (s_f ∈ {4, 8,
    16, 32} at most n_steps; 512- or 1024-thread CTAs, the one 1024-thread
    instance serving both; one untiled CTA where K fits it, and every tiling
    of W = 5·s_f), whichever minimises :func:`km_fwd_cost`: ⌈n_steps/s_f⌉
    launches. A tie goes to the first found."""
    return _cheapest(_window_plans(k, b, n_steps, sms),
                     lambda plan: km_fwd_cost(k, b, np_, n_steps, plan, sms))


def _windows(ops: MxuOps, plan: FusedPlan, device):
    """Every (tile, member) window of ``plan`` over the N columns: the
    window's columns, the local columns (global and within the window), and
    the window's first/last masks (its ends)."""
    for c0 in range(0, ops.n, ops.k):
        for t in range(plan.n_tiles):
            lo, hi = t * plan.tile, min((t + 1) * plan.tile, ops.k)
            w0, w1 = max(lo - plan.ghost, 0), min(hi + plan.ghost, ops.k)
            first = torch.zeros(w1 - w0, dtype=torch.bool, device=device)
            last = first.clone()
            first[0] = last[-1] = True
            yield (slice(c0 + w0, c0 + w1), slice(c0 + lo, c0 + hi), slice(lo - w0, hi - w0),
                   first, last)


def km_fwd_traj_fused_plain(u0, t0: float, ops: MxuOps, plan: FusedPlan):
    """KM1's launch schedule in plain PyTorch: s_f steps a launch (the last
    takes the remainder), every (tile, member) on its own window, whose ends
    count as a member's first and last columns, the stage times of the
    global step. Any ghost width, so a narrow one can be shown to reach the
    local columns. Returns ``(traj, u_final)``."""
    dtype, device = u0.dtype, u0.device
    inflow = torch.as_tensor(fwd_inflow(t0, ops), dtype=dtype, device=device)
    tabs, coef = _tabs(ops.full, dtype), _coef(dtype, device)
    n_steps = inflow.shape[0]
    traj = torch.empty((n_steps, *u0.shape), dtype=dtype, device=device)
    u = u0
    for lo_n in range(0, n_steps, plan.segment):
        nxt = torch.empty_like(u)
        for win, glo, loc, first, last in _windows(ops, plan, device):
            uw = u[:, win]
            for n in range(lo_n, min(lo_n + plan.segment, n_steps)):
                traj[n][:, glo] = uw[:, loc]
                uw = _march_plain(uw, inflow[n], tabs, coef, first, last)
            nxt[:, glo] = uw[:, loc]
        u = nxt
    return traj, u


def km_adj_est_fused_plain(traj, u_final, lam_end, t0: float, ops: MxuOps, plan: FusedPlan):
    """KM2's launch schedule in plain PyTorch: s_f steps a launch from the
    top (the last takes the remainder), every (tile, member) on its own
    window, whose ends count as a member's first and last columns, λ carried
    across launches, η accumulated per column in the step order. Any ghost
    width, so a narrow one can be shown to reach the local columns. Returns
    ``(lam0, eta)``."""
    inflow, tabs, coef = _rev_operands(lam_end, t0, ops)
    n_steps = traj.shape[0]
    lam = lam_end
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    for hi_n in range(n_steps, 0, -plan.segment):
        lo_n = max(hi_n - plan.segment, 0)
        lam_next = torch.empty_like(lam)
        for win, glo, loc, first, last in _windows(ops, plan, lam.device):
            lw, e = lam[:, win], eta[win]
            for n in reversed(range(lo_n, hi_n)):
                u_np1 = u_final if n == n_steps - 1 else traj[n + 1]
                lw, e = _rev_step_plain(traj[n][:, win], u_np1[:, win], lw, e, inflow[n],
                                        tabs, coef, first, last)
            lam_next[:, glo] = lw[:, loc]
            eta[glo] = e[loc]
        lam = lam_next
    return lam, eta


# ------------------------------------------------------------------ wrappers


def km_fwd_traj(u0: torch.Tensor, t0: float, ops: MxuOps):
    """KM1: march the (Np, N) state ``u0`` n_steps steps from ``t0``,
    storing every entry state. Returns ``(traj, u_final)``. On the card it
    runs :func:`km_fwd_plan`'s schedule for the card's SM count:
    ⌈n_steps/s_f⌉ launches of the fused kernel."""
    n_steps = ops.segment * ops.n_segments
    if not _check_on("u0", u0, (ops.np_, ops.n), ops.device):
        return km_fwd_traj_plain(u0, float(t0), ops)
    plan = km_fwd_plan(ops.k, ops.b, ops.np_, n_steps, _sm_count(u0.device))
    km_fwd_traj.launches += 1
    traj, u_final, km_fwd_traj.cuda_launches = _km1_launch(u0, t0, ops, plan)
    return traj, u_final


def _km1_launch(u0, t0, ops: MxuOps, plan: FusedPlan):
    """One dg_mxu_fwd call with ``plan``: ``(traj, u_final, CUDA
    launches)``. The wrapper counts its launches; this does not."""
    _check_grid(ops.b)
    lib = load_library()
    inflow = fwd_inflow(float(t0), ops)
    n_steps = inflow.shape[0]
    try:  # no free-memory query up front: it costs host time on every call
        traj = torch.empty((n_steps, *u0.shape), dtype=torch.float32, device=u0.device)
    except torch.cuda.OutOfMemoryError as exc:
        free, total = torch.cuda.mem_get_info(u0.device)
        raise MemoryError(
            f"stored trajectory needs {n_steps * u0.numel() * 4 / 2**30:.2f} GiB ({n_steps}x"
            f"{ops.np_}x{ops.n} float32); {free / 2**30:.2f} of {total / 2**30:.2f} GiB free on "
            f"{u0.device}"
        ) from exc
    u_final = torch.empty_like(u0)
    ubuf = torch.empty((2, u0.numel()), dtype=torch.float32, device=u0.device)
    launches = ctypes.c_int(0)
    code = lib.lib.dg_mxu_fwd(
        ops.np_, ops.n, ops.k, n_steps, plan.segment, plan.tile, plan.ghost,
        plan.threads, _RK.ctypes.data, ops.full.packed.ctypes.data, inflow.ctypes.data,
        _ptr(u0), _ptr(traj), _ptr(u_final), _ptr(ubuf[0]), ctypes.addressof(launches),
        _stream(u0.device),
    )
    lib.check(code, "dg_mxu_fwd", lib.lib.dg_mxu_error_string)
    return traj, u_final, launches.value


def km_adj_est(traj: torch.Tensor, u_final: torch.Tensor, lam_end: torch.Tensor, t0: float,
               ops: MxuOps):
    """KM2: the reverse sweep over KM1's trajectory with the fine (dt/2)²
    transpose. Returns ``(lam0, eta)``, eta (N,). On the card it runs
    :func:`km_rev_plan`'s schedule for the card's SM count: ⌈n_steps/s_f⌉
    launches of the fused kernel."""
    state = (ops.np_, ops.n)
    n_steps = ops.segment * ops.n_segments
    on_cuda = _check_on("traj", traj, (n_steps, *state), ops.device)
    _check_on("u_final", u_final, state, ops.device)
    _check_on("lam_end", lam_end, state, ops.device)
    if not on_cuda:
        return km_adj_est_plain(traj, u_final, lam_end, float(t0), ops)
    plan = km_rev_plan(ops.k, ops.b, ops.np_, n_steps, _sm_count(traj.device))
    km_adj_est.launches += 1
    lam0, eta, km_adj_est.cuda_launches = _km2_launch(traj, u_final, lam_end, t0, ops, plan)
    return lam0, eta


def _km2_launch(traj, u_final, lam_end, t0, ops: MxuOps, plan: FusedPlan):
    """One dg_mxu_rev call with ``plan``: ``(lam0, eta, CUDA launches)``.
    The wrapper counts its launches; this does not."""
    lib = load_library()
    inflow = rev_inflow(float(t0), ops)
    lam0 = torch.empty_like(lam_end)
    eta = torch.zeros((ops.n,), dtype=torch.float32, device=traj.device)
    lbuf = torch.empty((2, lam_end.numel()), dtype=torch.float32, device=traj.device)
    launches = ctypes.c_int(0)
    code = lib.lib.dg_mxu_rev(
        ops.np_, ops.n, ops.k, traj.shape[0], plan.segment, plan.tile, plan.ghost, plan.threads,
        _RK.ctypes.data, ops.half.packed.ctypes.data, inflow.ctypes.data,
        _ptr(traj), _ptr(u_final), _ptr(lam_end), _ptr(lam0), _ptr(eta), _ptr(lbuf[0]),
        ctypes.addressof(launches), _stream(traj.device),
    )
    lib.check(code, "dg_mxu_rev", lib.lib.dg_mxu_error_string)
    return lam0, eta, launches.value


def reset_launch_counts() -> None:
    km_fwd_traj.launches = 0
    km_fwd_traj.cuda_launches = 0
    km_adj_est.launches = 0
    km_adj_est.cuda_launches = 0


reset_launch_counts()


# -------------------------------------------------------------- entry point


def make_cuda_fwd_adj_estimate_grid_mxu(
    disc: Discretization1D, a: float, dt: float, segment: int = 4, n_segments: int = 512,
    batch: int = 8, device="cuda",
):
    """Stored-trajectory pipeline in the MXU layout:
    ``run(u0, t0, lam_end) -> (u_final, lam0, eta)`` with ``u0/lam_end``
    (Np, B, K) and ``eta`` (B, K), ``segment·n_segments`` steps — the
    contract of ``make_pallas_fwd_adj_estimate_grid_mxu``: float32 on the
    card, uniform meshes, 2 ≤ Np ≤ 8 (the transpose's edge rows need distinct
    first and last rows). The TPU's scoped-VMEM guard has no counterpart:
    the state lives in device memory, and the trajectory's size is checked
    against the card's free memory at the call."""
    _check_uniform(disc)
    ops = mxu_ops(disc, a, dt, segment, n_segments, batch, device)
    shape = (ops.np_, batch, ops.k)

    def run(u0, t0, lam_end):
        if tuple(u0.shape) != shape or tuple(lam_end.shape) != shape:
            raise ValueError(f"u0/lam_end must be {shape}")
        flat = (ops.np_, ops.n)
        traj, u_final = km_fwd_traj(u0.reshape(flat), t0, ops)
        lam0, eta = km_adj_est(traj, u_final, lam_end.reshape(flat), t0, ops)
        return u_final.reshape(shape), lam0.reshape(shape), eta.reshape(batch, ops.k)

    run.n_steps = segment * n_segments
    run.ops = ops
    return run
