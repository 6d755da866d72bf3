"""The FD refinement signal on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/fd_ensemble.py``. Three
kernels (csrc/fd_ensemble.cu), each with the whole pipeline of an initial
condition (IC) or member — coarse Euler march, interpolation to the
rf-refined grid, the adjoint of J = ∫u² dt, the residual and the per-step
indicator — in G lanes of a warp per IC or member:

- **F1** :func:`fd_ensemble` — scalar state, block indicator
  ``(n_steps, n_ics)``. Replaces ``_kernel`` (fd_ensemble.py:61); with
  ``trig="fast"`` it evaluates sin/cos by the polynomials of
  :mod:`adjoint_ode_adaptivity_tpu_torch.ops.fast_trig` (fast_trig.py:62-77).
- **F2** :func:`fd_ensemble_vec` — d-vector state (2 ≤ d ≤ 15, JAX's own
  cap), the adjoint through (I + dt·J)ᵀ. Replaces ``_vec_kernel``
  (fd_ensemble.py:201). Two designs by the size of a fine node's table,
  2d + nnz floats (r, A and h·J's live entries; :func:`f2_plan`): up to
  :data:`F2_REG_ROW` F1's, a block of nodes a lane in registers (d ≤ 4:
  every ODE; Lorenz-96 to d = 8, a dense Jacobian to d = 6); above it a
  window of nodes in shared memory, G ≥ d lanes an IC, lane a owning
  v[a] and reading the others by shuffles (dense d ≥ 7, sparse d ≥ 9).
- **F3** :func:`fd_estimate_per_member` — per-member step widths (B, n_steps),
  strided or block indicator and J per member. Replaces ``_pm_kernel``
  (fd_ensemble.py:357); the engine of ``run_adaptive_fd_per_member(engine="cuda")``.

What bounds them, and what the design does about it: each IC's march and
sweep are serial chains (v_j needs v_{j+1}), so a kernel is latency- or
issue-bound, far above both the byte bound (one read of u0, one write per
step) and the FP32 bound. Only v's chain and the per-step sums are serial:
the interpolation, the (f, f_u) pair and the residual of every fine node
depend on the coarse trajectory alone. So each kernel runs G lanes of a
warp per IC or member (:func:`fd_ens_plan` for F1 and F2, :func:`fd_pm_plan`
for F3): the lanes split the fine nodes' interpolation, pairs and residuals
of a block of nodes ahead of the chain (F1 and F2 in registers, read across
the group by shuffles; F3 in shared-memory tables), and the chain
v_j = A_j + C_j·v_{j+1} (F2: v_j = A_j + (I + h_j·J_j)ᵀ·v_{j+1}) and the
per-step sums run in the plain version's order, their loads off the chain.
Small IC or member counts take many lanes (F3 at the per-member study's
B = 1024: one warp a member; F1 and F2 as many as put 8 warps on every SM);
102,400 ICs fill the card with one lane an IC, which keeps the fewest
instructions an IC. F3's widths are read as (B, n_steps), a member's row
contiguous, and its err written (B, n_steps); F1's and F2's err stay
(n_steps, n_ics), F2 reading its states (n_ics, d) as given. One CUDA
launch a call.

The ODE is a registry entry's functor of csrc/odes.cuh, or any elementwise
callable traced into a device functor (ops/cuda/functor.py), as the JAX
entry points take ``f``, ``f_u`` and ``f_comps``/``jac_comps``: a traced
ODE runs on a user library of csrc/fd_ensemble.cu alone, built once per
functor.

Each wrapper takes a plan made by its ``make_cuda_*`` entry point. A CUDA
float32 tensor launches the kernel or raises; a CPU tensor takes the
kernel's plain PyTorch version (``*_plain``, float32 or float64), which
repeats the kernel's arithmetic op for op (the TPU kernel's order) without
FMA contraction. Nothing falls back from the kernel to the plain version.
Each wrapper counts its kernel launches in ``.launches``.

The TPU tiling ((8, lane) carpets, ``lane_block``, the multiple-of-20480 IC
rule, the scoped-VMEM checks) is not ported: the entry points take any
``n_ics`` and any B; the step count is bounded by a block's shared memory,
which the kernel's launcher checks (a launch with too many steps raises;
F1's and F2's plan shrinks its CTA, F2's window design its window, and
F3's its CTA and its window of fine nodes to fit first). F2's entry point
refuses a step count past one IC a CTA (:func:`f2_max_steps`) before any
launch, and takes every (d, n_steps) that JAX's check admits.

Tolerance (:func:`fd_kernel_tolerance`, :func:`fd_j_tolerance`): kernel
and plain version run float32 in another order of roundings (FMA
contraction in the kernel, none in the plain version), so each fine node's
r·v differs by a few ulp of max|u|·max|v| and J by a few ulp of
max|u|²·T per step.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.ops import fast_trig
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import (
    KernelFunctors,
    scalar_functors,
    vector_functors,
)

__all__ = [
    "FdPlan",
    "FdEnsLaunch",
    "fd_ens_plan",
    "FdVecLaunch",
    "vec_window_plan",
    "f2_registers",
    "f2_plan",
    "f2_max_steps",
    "FdPmLaunch",
    "fd_pm_plan",
    "fd_kernel_tolerance",
    "fd_j_tolerance",
    "fine_grid",
    "fd_ensemble",
    "fd_ensemble_plain",
    "fd_ensemble_vec",
    "fd_ensemble_vec_plain",
    "fd_estimate_per_member",
    "fd_estimate_per_member_plain",
    "reset_launch_counts",
    "make_cuda_fd_ensemble",
    "make_cuda_fd_ensemble_vec",
    "make_cuda_fd_estimate_per_member",
]

MAX_MODES = 8  # gaussian-mixture slots per kind in the consts layout (csrc OdeConsts)
EPS32 = 2.0**-23
PM_LANES = (1, 2, 4, 8, 16, 32)  # the lanes an IC or member F1 and F3 take
PM_THREADS = (32, 64, 128, 256)  # their CTA sizes
PM_MAX_WARPS = 4096  # fd_pm_plan's most warps: ~31 an SM on 132 SMs
# fd_ens_plan's warps an SM: F1 is issue-bound once ~8 warps share an SM, and
# every lane past the first repeats the march and idles beside the chain
# (chip_smoke.py phase 37(c) on an H100: at 4,096 ICs G = 4-16 0.0101-0.0109 ms
# on the device, G = 32 0.0158-0.0164, G = 1 0.0150-0.0162; at 102,400 G = 1
# 0.0344-0.0372, G = 2 0.0393-0.0413)
ENS_WARPS_PER_SM = 8
MAX_SMEM = 232_448  # csrc kMaxSmem: the bytes a block may use on sm_90
# F2 runs its register design (U = 4 nodes a lane at d <= 4, 1 above) where
# a node's table, 2d + nnz floats, is at most F2_REG_ROW (csrc kVecRegRow:
# the largest that held with no spill on an H100, tools/torch_f2_designs.py),
# else its window design
F2_REG_ROW = 48
H100_SMS = 132
SOURCE = "fd_ensemble.cu"
SIN_ID = odes.KERNEL_IDS["du/dt=sin(u)"]


class FdPlan(NamedTuple):
    """Everything one entry point's kernel needs, on one device.

    ``grid`` is the float64 host fold [tc (n_steps), dts (n_steps),
    tf (n_fine), dtf (n_fine), q/rf (rf)] and ``grid32`` its float32 copy on
    the device
    (empty for the per-member kernel, whose widths are an operand);
    ``consts`` the 64 float32 constants passed by value (csrc OdeConsts);
    ``consts_ptr`` and ``grid_ptr`` their addresses, taken once a plan;
    ``functors`` what the kernel runs (its library, ids and d) and the
    plain versions' callables (``functors.ode``)."""

    n_steps: int
    rf: int
    trig: str  # "libm" or "fast"
    convention: str  # per-member only: "strided" or "block"
    t0: float  # per-member only: the time of every member's first node
    grid: np.ndarray
    grid32: torch.Tensor
    consts: np.ndarray
    n_modes: tuple  # (n_u, n_t) of the gaussian mixture, else (0, 0)
    consts_ptr: int
    grid_ptr: int
    functors: KernelFunctors


def fine_grid(n_steps: int, rf: int, dt) -> np.ndarray:
    """Coarse node times and widths, fine node times and widths, and the rf
    interpolation weights q/rf, folded in double as the TPU kernel folds
    them at trace time (t0 = 0; ``dt`` a scalar or ``n_steps`` widths)."""
    dts = [float(dt)] * n_steps if np.ndim(dt) == 0 else [float(d) for d in dt]
    if len(dts) != n_steps:
        raise ValueError(f"dt vector length {len(dts)} != n_steps={n_steps}")
    tc = [0.0]
    for d in dts:
        tc.append(tc[-1] + d)
    n_fine = n_steps * rf
    tf = [tc[j // rf] + ((j % rf) / rf) * dts[j // rf] for j in range(n_fine)]
    dtf = [dts[j // rf] / rf for j in range(n_fine)]
    return np.array(tc[:-1] + dts + tf + dtf + [q / rf for q in range(rf)], dtype=np.float64)


def _split(plan: FdPlan):
    s, nf = plan.n_steps, plan.n_steps * plan.rf
    g = plan.grid.tolist()
    return g[:s], g[s:2 * s], g[2 * s:2 * s + nf], g[2 * s + nf:2 * s + 2 * nf]


def _consts(ode: odes.ODEProblem) -> tuple[np.ndarray, tuple]:
    """The kernel's by-value constants: gaussian-mixture modes, then the
    fast-trig coefficients (ops/fast_trig.py)."""
    buf = np.zeros(64, dtype=np.float32)
    n_modes = (0, 0)
    if ode.kernel_id == odes.KERNEL_IDS["gaussian_mixture"]:
        um, us, tm, ts, c = ode.kernel_params
        n_modes = (len(um), len(tm))
        if max(n_modes) > MAX_MODES:
            raise ValueError(f"gaussian mixture: at most {MAX_MODES} modes per kind")
        for off, vals in ((0, um), (8, us), (16, tm), (24, ts)):
            buf[off:off + len(vals)] = vals
        buf[32:32 + len(c)] = c
    buf[48:48 + len(fast_trig.SIN_C)] = fast_trig.SIN_C
    buf[56:56 + len(fast_trig.COS_C)] = fast_trig.COS_C
    return buf, n_modes


def _plan(functors: KernelFunctors, n_steps, rf, *, trig="libm", convention="block", t0=0.0,
          dt=None, device="cuda") -> FdPlan:
    if trig not in ("libm", "fast"):
        raise ValueError(f"trig={trig!r}: 'libm' or 'fast'")
    if trig == "fast" and functors.ode_id != SIN_ID:
        raise ValueError("trig='fast' is implemented for du/dt=sin(u) only")
    if convention not in ("strided", "block"):
        raise ValueError(f"unknown convention {convention!r}")
    if n_steps is None or rf is None or n_steps < 1 or rf < 1:
        raise ValueError(f"n_steps={n_steps} and ref_factor={rf} must be >= 1")
    device = require_device(device)
    if functors.header is not None and device.type == "cuda":
        functors.library()  # build the user library now, not inside the first call
    grid = fine_grid(n_steps, rf, dt) if dt is not None else np.zeros(0)
    consts, n_modes = _consts(functors.ode)
    grid32 = torch.as_tensor(grid, dtype=torch.float32, device=device)
    return FdPlan(n_steps, rf, trig, convention, float(t0), grid, grid32,
                  consts, n_modes, consts.ctypes.data, grid32.data_ptr(), functors)


# ------------------------------------------------------------ plain versions


def _scalar_fns(plan: FdPlan) -> tuple[Callable, Callable]:
    if plan.trig == "fast":
        return (lambda u, t: fast_trig.fast_sin(u)), (lambda u, t: fast_trig.fast_cos(u))
    return plan.functors.ode.f, plan.functors.ode.f_u


def _fine(traj, j: int, rf: int):
    """u at fine node j: traj[i] + (q/rf)·(traj[i+1] − traj[i])."""
    i, q = divmod(j, rf)
    if q == 0:
        return traj[i]
    return traj[i] + (q / rf) * (traj[i + 1] - traj[i])


def _track(stats: dict | None, key: str, x: torch.Tensor) -> None:
    """Keep the running max|x| under ``stats[key]`` (a 0-dim tensor)."""
    if stats is not None:
        m = torch.max(torch.abs(x))
        stats[key] = m if key not in stats else torch.maximum(stats[key], m)


def fd_ensemble_plain(u0s: torch.Tensor, plan: FdPlan, stats: dict | None = None) -> torch.Tensor:
    """F1's plain version: the block indicator (n_steps, n_ics). ``stats``,
    when given, receives max|u| and max|v| (the scales of the kernel-vs-plain
    tolerance) under "u" and "v"."""
    f, f_u = _scalar_fns(plan)
    tc, dts, tf, dtf = _split(plan)
    rf, n_fine = plan.rf, plan.n_steps * plan.rf
    u = u0s
    traj = [u]
    for s in range(plan.n_steps):
        u = u + f(u, tc[s]) * dts[s]
        traj.append(u)
        _track(stats, "u", u)
    out = torch.empty((plan.n_steps, *u0s.shape), dtype=u0s.dtype, device=u0s.device)
    u_j, fu_j, v, blk = u, None, torch.zeros_like(u), None
    for j in range(n_fine, 0, -1):
        u_jm1 = _fine(traj, j - 1, rf)
        if j < n_fine:
            v = 2.0 * u_j * dtf[j] + (1.0 + fu_j * dtf[j]) * v
            _track(stats, "v", v)
        f_jm1, fu_jm1 = f(u_jm1, tf[j - 1]), f_u(u_jm1, tf[j - 1])
        e = (u_j - (u_jm1 + f_jm1 * dtf[j - 1])) * v
        blk = e if blk is None else blk + e
        if (j - 1) % rf == 0:
            out[(j - 1) // rf] = torch.abs(blk)
            blk = None
        u_j, fu_j = u_jm1, fu_jm1
    return out


def fd_ensemble_vec_plain(u0s: torch.Tensor, plan: FdPlan, stats: dict | None = None
                          ) -> torch.Tensor:
    """F2's plain version on (n_ics, d) states: the block indicator
    (n_steps, n_ics). The adjoint applies (I + dt_f·J)ᵀ with J[m, i] =
    ∂f_m/∂u_i from ``ode.f_u``. ``stats`` as for :func:`fd_ensemble_plain`."""
    f, jac_fn = plan.functors.ode.f, plan.functors.ode.f_u
    tc, dts, tf, dtf = _split(plan)
    rf, n_fine, d = plan.rf, plan.n_steps * plan.rf, u0s.shape[1]
    u = u0s
    traj = [u]
    for s in range(plan.n_steps):
        u = u + f(u, tc[s]) * dts[s]
        traj.append(u)
        _track(stats, "u", u)
    out = torch.empty((plan.n_steps, u0s.shape[0]), dtype=u0s.dtype, device=u0s.device)
    u_j, jac_j, blk = u, None, None
    v = [torch.zeros_like(u[:, 0]) for _ in range(d)]
    for j in range(n_fine, 0, -1):
        u_jm1 = _fine(traj, j - 1, rf)
        if j < n_fine:
            h = dtf[j]
            v = [
                sum((h * jac_j[..., m, a] * v[m] for m in range(d)), 2.0 * u_j[:, a] * h + v[a])
                for a in range(d)
            ]
            _track(stats, "v", torch.stack(v))
        fs, jac = f(u_jm1, tf[j - 1]), jac_fn(u_jm1, tf[j - 1])
        e = None
        for a in range(d):
            term = (u_j[:, a] - (u_jm1[:, a] + fs[:, a] * dtf[j - 1])) * v[a]
            e = term if e is None else e + term
        blk = e if blk is None else blk + e
        if (j - 1) % rf == 0:
            out[(j - 1) // rf] = torch.abs(blk)
            blk = None
        u_j, jac_j = u_jm1, jac
    return out


def fd_estimate_per_member_plain(dt_b: torch.Tensor, u0s: torch.Tensor, plan: FdPlan,
                                 stats: dict | None = None):
    """F3's plain version: ``(err (B, n_steps), j (B,))``, err contiguous,
    from per-member widths ``dt_b`` (B, n_steps); tc accumulates in the
    working type from ``plan.t0`` and dt_f = dts·(1/rf), as in the kernel.
    ``stats`` as for :func:`fd_ensemble_plain`."""
    f, f_u = plan.functors.ode.f, plan.functors.ode.f_u
    rf, n_steps = plan.rf, plan.n_steps
    dts = dt_b.T
    tc = [torch.full_like(u0s, plan.t0)]
    for s in range(n_steps):
        tc.append(tc[-1] + dts[s])
    u = u0s
    traj = [u]
    j_val = torch.zeros_like(u)
    for s in range(n_steps):
        j_val = j_val + u * u * dts[s]
        u = u + f(u, tc[s]) * dts[s]
        traj.append(u)
        _track(stats, "u", u)
    out = torch.empty((n_steps, *u0s.shape), dtype=u0s.dtype, device=u0s.device)
    u_j, fu_j, v, blk = u, None, torch.zeros_like(u), None
    block = plan.convention == "block"
    for j in range(n_steps * rf, 0, -1):
        i, q = divmod(j - 1, rf)
        u_jm1 = _fine(traj, j - 1, rf)
        if j < n_steps * rf:
            h = dts[j // rf] * (1.0 / rf)
            v = 2.0 * u_j * h + (1.0 + fu_j * h) * v
            _track(stats, "v", v)
        t_jm1 = tc[i] + (q / rf) * dts[i]
        f_jm1, fu_jm1 = f(u_jm1, t_jm1), f_u(u_jm1, t_jm1)
        e = (u_j - (u_jm1 + f_jm1 * (dts[i] * (1.0 / rf)))) * v
        if block:
            blk = e if blk is None else blk + e
        elif q != 0:  # strided: the first fine node of every step is dropped
            blk = torch.abs(e) if blk is None else blk + torch.abs(e)
        if q == 0:
            if blk is None:
                blk = torch.zeros_like(e)
            out[i] = torch.abs(blk) if block else blk
            blk = None
        u_j, fu_j = u_jm1, fu_jm1
    return out.T.contiguous(), j_val


def fd_kernel_tolerance(stats: dict, rf: int, d: int = 1) -> float:
    """The bound on |kernel − plain| of an F1, F2 or F3 indicator entry,
    from the plain version's ``stats`` (max|u|, max|v|): the residual
    r = u_j − (u_{j−1} + f·dt_f) is a difference of O(max|u|) values, so each
    fine node's r·v carries a few ulp of max|u|·max|v| (FMA contraction in
    the kernel, none in the plain version); a block sums rf nodes and d
    components. Entries of the plain version above it give the check its
    teeth (an err of 0 fails there)."""
    return 8 * rf * d * EPS32 * float(stats["u"]) * float(stats["v"])


def fd_j_tolerance(stats: dict, n_steps: int, t_max: float) -> float:
    """F3's bound on |kernel − plain| of J = Σ u_n²·dt_n: a few ulp of
    max|u|²·T per step."""
    return 8 * n_steps * EPS32 * float(stats["u"]) ** 2 * t_max


# ------------------------------------------------------------------ wrappers


def _on_cuda(name: str, x: torch.Tensor, shape, plan: FdPlan) -> bool:
    """Validate an operand; True on a CUDA device (kernel path), False on
    the CPU (plain path). Raises on anything else."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != plan.grid32.device:
        raise ValueError(f"{name} on {x.device}, the plan on {plan.grid32.device}")
    if x.device.type == "cpu":
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {x.dtype}; the plain path takes float32/64")
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: device {x.device} is neither cuda nor cpu")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return True


def _stream(device) -> int:
    """The current stream's raw handle without a Stream object (~0.3 µs, not
    ~5; a CUDA tensor's device always has an index)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class FdEnsLaunch(NamedTuple):
    """F1's launch: ``lanes`` (G) lanes of a warp an IC in CTAs of
    ``threads``."""

    lanes: int
    threads: int


def ens_stride(n_steps: int, d: int = 1) -> int:
    """F1's and F2's floats of shared memory an IC (csrc ens_stride): the d
    components' coarse trajectories, rounded up to odd."""
    return (d * (n_steps + 1)) | 1


def ens_smem(launch: FdEnsLaunch, n_steps: int, rf: int, d: int = 1) -> int:
    """F1's and F2's bytes of shared memory a CTA (csrc ensemble_smem): the
    rf interpolation weights, then its ICs' coarse trajectories of d
    components."""
    return 4 * (rf + launch.threads // launch.lanes * ens_stride(n_steps, d))


@functools.lru_cache(maxsize=256)
def fd_ens_plan(n_ics: int, n_steps: int, rf: int, sms: int = H100_SMS,
                d: int = 1) -> FdEnsLaunch:
    """F1's (d = 1) and F2's launch for n_ics ICs of d components, n_steps
    steps refined rf times, on a card of ``sms`` SMs: G the fewest of
    :data:`PM_LANES` that put :data:`ENS_WARPS_PER_SM` warps on every SM (32
    at most: 16 at 4,096 ICs, 1 from 33,792), in 128-thread CTAs, or the
    largest smaller CTA whose shared memory fits a block (:func:`ens_smem`;
    at G = 1 and d = 1, 453 steps take 64 threads; at d = 2, 226). Where
    none fits (one IC's trajectory past a block) it returns the 32-thread
    CTA, which the kernel refuses."""
    lanes = next((g for g in PM_LANES if n_ics * g >= 32 * ENS_WARPS_PER_SM * sms), 32)
    for threads in (128, 64, 32):
        launch = FdEnsLaunch(lanes, threads)
        if ens_smem(launch, n_steps, rf, d) <= MAX_SMEM:
            return launch
    return launch


def fd_ensemble(u0s: torch.Tensor, plan: FdPlan) -> torch.Tensor:
    """F1: the per-IC block indicator (n_steps, n_ics) of ``u0s`` (n_ics,).
    On the card one CUDA launch on :func:`fd_ens_plan`'s launch."""
    if u0s.dim() != 1:
        raise ValueError(f"u0s must be (n_ics,), got {tuple(u0s.shape)}")
    if not _on_cuda("u0s", u0s, u0s.shape, plan):
        return fd_ensemble_plain(u0s, plan)
    fd_ensemble.launches += 1
    return _f1_launch(u0s, plan, fd_ens_plan(u0s.shape[0], plan.n_steps, plan.rf,
                                             _sm_count(u0s.device)))


def _f1_launch(u0s, plan: FdPlan, launch: FdEnsLaunch) -> torch.Tensor:
    """One fd_ensemble call on ``launch``: err (n_steps, n_ics). The
    wrapper counts its launches; this does not."""
    lib = plan.functors.library()
    n = u0s.shape[0]
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0s.device)
    code = lib.lib.fd_ensemble(
        plan.functors.ode_id, int(plan.trig == "fast"), *plan.n_modes, plan.consts_ptr, n,
        plan.n_steps, plan.rf, launch.lanes, launch.threads, plan.grid_ptr,
        u0s.data_ptr(), err.data_ptr(), _stream(u0s.device),
    )
    lib.check(code, "fd_ensemble", lib.lib.fd_error_string)
    return err


class FdVecLaunch(NamedTuple):
    """F2's window design: ``lanes`` (G ≥ d) lanes of a warp an IC in CTAs
    of ``threads``, the fine nodes swept ``window`` (W) at a time."""

    lanes: int
    threads: int
    window: int


VEC_LEAST = FdVecLaunch(32, 32, 1)  # the window design's least footprint: one IC a CTA
REG_LEAST = FdEnsLaunch(32, 32)  # the register design's


def vec_row(d: int, nnz: int) -> int:
    """The floats of a window row (csrc vec_row): r and A (d each) and
    h·J's live entries, rounded up to odd."""
    return (2 * d + nnz) | 1


def vec_window_smem(launch: FdVecLaunch, n_steps: int, rf: int, d: int, nnz: int) -> int:
    """The window design's bytes of shared memory a CTA (csrc
    vec_window_smem): the rf weights, then each IC's coarse trajectories
    (:func:`ens_stride`) and W + 1 rows of :func:`vec_row` floats."""
    per_ic = ens_stride(n_steps, d) + (launch.window + 1) * vec_row(d, nnz)
    return 4 * (rf + launch.threads // launch.lanes * per_ic)


@functools.lru_cache(maxsize=256)
def vec_window_plan(n_steps: int, rf: int, d: int, nnz: int) -> FdVecLaunch:
    """F2's window launch for d components with nnz live Jacobian
    entries: G the smallest of :data:`PM_LANES` that is at least d and 8
    (8 for d ≤ 8, 16 up to 15), W = 8 fine nodes, in 64-thread CTAs, or the
    smaller CTA and then the largest smaller W whose shared memory fits a
    block (:func:`vec_window_smem`), and last one IC a CTA
    (:data:`VEC_LEAST`), which the kernel refuses where even that does not
    fit (:func:`f2_max_steps`). tools/torch_f2_designs.py on an H100 at
    102,400 ICs: G = 8 at d = 6 and 8 and 16 at d = 15, W = 8 and 64
    threads the fastest or within 15 % of it (at d = 15 W = 16 and 128
    threads took 1.74x as long)."""
    lanes = next(g for g in PM_LANES if g >= max(d, 8))
    for window in (8, 4, 2, 1):
        for threads in (64, 32):
            launch = FdVecLaunch(lanes, threads, window)
            if vec_window_smem(launch, n_steps, rf, d, nnz) <= MAX_SMEM:
                return launch
    return VEC_LEAST


def f2_registers(d: int, nnz: int) -> bool:
    """True where F2 runs its register design: a node's table, 2d + nnz
    floats, at most :data:`F2_REG_ROW`."""
    return 2 * d + nnz <= F2_REG_ROW


def f2_smem(launch, n_steps: int, rf: int, d: int, nnz: int) -> int:
    """A CTA's bytes of shared memory in either design."""
    if isinstance(launch, FdVecLaunch):
        return vec_window_smem(launch, n_steps, rf, d, nnz)
    return ens_smem(launch, n_steps, rf, d)


def f2_plan(n_ics: int, n_steps: int, rf: int, sms: int, d: int, nnz: int):
    """F2's launch: the register design's :func:`fd_ens_plan` (or one IC a
    CTA, :data:`REG_LEAST`, where a long trajectory passes its launch's
    block) where :func:`f2_registers`, else :func:`vec_window_plan`."""
    if not f2_registers(d, nnz):
        return vec_window_plan(n_steps, rf, d, nnz)
    launch = fd_ens_plan(n_ics, n_steps, rf, sms, d)
    return launch if ens_smem(launch, n_steps, rf, d) <= MAX_SMEM else REG_LEAST


def f2_max_steps(rf: int, d: int, nnz: int) -> int:
    """The most steps F2 takes at d with nnz live Jacobian entries (its
    design's least footprint, one IC a CTA): past them the entry point
    refuses before any launch."""
    least = REG_LEAST if f2_registers(d, nnz) else VEC_LEAST
    lo, hi = 0, MAX_SMEM // 4
    while lo < hi:
        mid = (lo + hi + 1) // 2
        fits = f2_smem(least, mid, rf, d, nnz) <= MAX_SMEM
        lo, hi = (mid, hi) if fits else (lo, mid - 1)
    return lo


def fd_ensemble_vec(u0s: torch.Tensor, plan: FdPlan) -> torch.Tensor:
    """F2: the per-IC block indicator (n_steps, n_ics) of ``u0s`` (n_ics, d),
    read as given (IC-major). On the card one CUDA launch on
    :func:`f2_plan`'s launch for d components."""
    d = plan.functors.d
    if u0s.dim() != 2 or u0s.shape[1] != d:
        raise ValueError(f"u0s must be (n_ics, {d}), got {tuple(u0s.shape)}")
    if not _on_cuda("u0s", u0s, u0s.shape, plan):
        return fd_ensemble_vec_plain(u0s, plan)
    fd_ensemble_vec.launches += 1
    return _f2_launch(u0s, plan, f2_plan(u0s.shape[0], plan.n_steps, plan.rf,
                                         _sm_count(u0s.device), d, plan.functors.nnz))


def _f2_launch(u0s, plan: FdPlan, launch) -> torch.Tensor:
    """One fd_ensemble_vec call on ``launch`` (an :class:`FdEnsLaunch`:
    the register design; an :class:`FdVecLaunch`: the window design):
    err (n_steps, n_ics). The wrapper counts its launches; this does not."""
    lib = plan.functors.library()
    n = u0s.shape[0]
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0s.device)
    code = lib.lib.fd_ensemble_vec(
        plan.functors.ode_id, n, plan.n_steps, plan.rf, launch.lanes, launch.threads,
        getattr(launch, "window", 0), plan.grid_ptr, u0s.data_ptr(), err.data_ptr(),
        _stream(u0s.device),
    )
    lib.check(code, "fd_ensemble_vec", lib.lib.fd_error_string)
    return err


class FdPmLaunch(NamedTuple):
    """F3's launch: ``lanes`` (G) lanes of a warp a member in CTAs of
    ``threads``."""

    lanes: int
    threads: int


def pm_window(launch: FdPmLaunch, n_steps: int, rf: int) -> int:
    """The fine nodes F3 sweeps a window: all n_steps·rf where the CTA's
    members' shared memory, 4·(3·n_steps + 2 + 3·window) bytes each, holds
    them, else the most that fits (0: not even the coarse tables fit)."""
    members = launch.threads // launch.lanes
    room = MAX_SMEM // (4 * members) - (3 * n_steps + 2)
    return max(min(n_steps * rf, room // 3), 0)


@functools.lru_cache(maxsize=256)
def fd_pm_plan(b: int, n_steps: int, rf: int) -> FdPmLaunch:
    """F3's launch for B members of n_steps steps refined rf times: G the
    most of :data:`PM_LANES` with B·G/32 ≤ :data:`PM_MAX_WARPS` warps (32 at
    B ≤ 4096: one warp a member; 1 at B ≥ 131,072), in 128-thread CTAs, or
    the largest smaller CTA whose members' coarse tables and a window of at
    least one fine node fit a block's shared memory (:func:`pm_window`; at
    G = 1, 226 steps take 64 threads)."""
    lanes = max(g for g in PM_LANES if g == 1 or b * g <= 32 * PM_MAX_WARPS)
    for threads in (128, 64, 32):
        launch = FdPmLaunch(lanes, threads)
        if pm_window(launch, n_steps, rf) >= 1:
            return launch
    return launch


def fd_estimate_per_member(dt_b: torch.Tensor, u0s: torch.Tensor, plan: FdPlan):
    """F3: ``(err (B, n_steps), j (B,))`` from per-member coarse widths
    ``dt_b`` (B, n_steps) and ``u0s`` (B,). Zero-width (padding) steps are
    exact identities and contribute exactly 0. On the card one CUDA launch
    on :func:`fd_pm_plan`'s launch."""
    if u0s.dim() != 1:
        raise ValueError(f"u0s must be (B,), got {tuple(u0s.shape)}")
    b = u0s.shape[0]
    on_cuda = _on_cuda("u0s", u0s, (b,), plan)
    if dt_b.dim() != 2 or tuple(dt_b.shape) != (b, plan.n_steps):
        raise ValueError(f"per-member dt {tuple(dt_b.shape)} != (B={b}, n_steps={plan.n_steps})")
    if dt_b.device != u0s.device or dt_b.dtype != u0s.dtype:
        raise ValueError(f"dt_b ({dt_b.dtype} on {dt_b.device}) must match u0s "
                         f"({u0s.dtype} on {u0s.device})")
    if not on_cuda:
        return fd_estimate_per_member_plain(dt_b, u0s, plan)
    if not dt_b.is_contiguous():
        raise ValueError("dt_b must be contiguous")
    fd_estimate_per_member.launches += 1
    return _f3_launch(dt_b, u0s, plan, fd_pm_plan(b, plan.n_steps, plan.rf))


def _f3_launch(dt_b, u0s, plan: FdPlan, launch: FdPmLaunch):
    """One fd_estimate_per_member call on ``launch``: ``(err (B, n_steps),
    j (B,))``. The wrapper counts its launches; this does not."""
    lib = plan.functors.library()
    b, n_steps = u0s.shape[0], plan.n_steps
    out = torch.empty(b * (n_steps + 1), dtype=torch.float32, device=u0s.device)  # one allocation
    err, j_val = out[: b * n_steps].view(b, n_steps), out[b * n_steps:]
    code = lib.lib.fd_estimate_per_member(
        plan.functors.ode_id, *plan.n_modes, plan.consts_ptr, b, plan.n_steps,
        plan.rf, int(plan.convention == "block"), plan.t0, launch.lanes, launch.threads,
        pm_window(launch, plan.n_steps, plan.rf), dt_b.data_ptr(), u0s.data_ptr(),
        err.data_ptr(), j_val.data_ptr(), _stream(u0s.device),
    )
    lib.check(code, "fd_estimate_per_member", lib.lib.fd_error_string)
    return err, j_val


fd_ensemble.launches = 0
fd_ensemble_vec.launches = 0
fd_estimate_per_member.launches = 0


def reset_launch_counts() -> None:
    fd_ensemble.launches = 0
    fd_ensemble_vec.launches = 0
    fd_estimate_per_member.launches = 0


# -------------------------------------------------------------- entry points


def _with_plan(run, plan: FdPlan):
    """``run`` with its plan attached as ``run.plan`` (for the plain versions)."""
    run.plan = plan
    return run


def make_cuda_fd_ensemble(ode=None, n_steps: int | None = None, ref_factor: int | None = None,
                          dt=None, trig: str = "libm", device="cuda", *, f=None, f_u=None):
    """``run(u0s) -> err_steps``: the per-IC block indicator (n_steps, n_ics)
    of the FD pipeline (u' = f(u, t), J = ∫u² dt) in one launch; its mean
    over axis 1 is the ensemble refinement signal. The ODE is ``ode`` (a
    registry entry, its name, or an ``ODEProblem``, traced where it has no
    ``kernel_id``) or, as JAX's ``make_pallas_fd_ensemble(f, f_u, …)``
    takes it, an elementwise callable ``f`` (or ``ode``) with its ``f_u``
    (required), both traced into a device functor; ``dt`` a scalar or
    n_steps widths; ``trig="fast"`` (sin(u) only, |u| ≤ 4) evaluates
    sin/cos by the shared-x² polynomials."""
    functors = scalar_functors(ode, f, f_u, source=SOURCE, trig=trig, goal=False, need_f_u=True)
    if dt is None:
        raise ValueError("dt is required: a scalar or n_steps widths")
    plan = _plan(functors, n_steps, ref_factor, trig=trig, dt=dt, device=device)
    return _with_plan(lambda u0s: fd_ensemble(u0s, plan), plan)


def make_cuda_fd_ensemble_vec(ode=None, n_steps: int | None = None,
                              ref_factor: int | None = None, dt=None, device="cuda", *,
                              f_comps=None, jac_comps=None, d: int | None = None):
    """Vector-state variant: ``run(u0s) -> err_steps`` with ``u0s`` (n_ics, d)
    and the block indicator (n_steps, n_ics) (r·v contracted over
    components). The ODE is ``ode`` (a vector registry entry or its name)
    or, as JAX's ``make_pallas_fd_ensemble_vec(f_comps, jac_comps, d, …)``
    takes it, ``f_comps(us, t) -> d-tuple`` and ``jac_comps(us, t) -> d×d
    nested tuple`` (entry [m][i] = ∂f_m/∂u_i; literal zeros are skipped)
    on a d-tuple of components, traced for 2 ≤ d ≤ ``functor.MAX_VECTOR_D``
    (15, JAX's own cap; d = 16 raises naming it). On the card a node's
    table of 2d + nnz floats (nnz the live Jacobian entries) sits in
    registers where :func:`f2_registers`, else in a shared-memory window
    (:func:`f2_plan`); every step count JAX's VMEM check admits fits, and
    for the card one past a block's shared memory (:func:`f2_max_steps`)
    raises a ValueError naming the limit before any build or launch (the
    plain version on the CPU takes it)."""
    functors = vector_functors(ode, f_comps, jac_comps, d, source=SOURCE)
    if dt is None:
        raise ValueError("dt is required: a scalar or n_steps widths")
    if torch.device(device).type == "cuda" and n_steps and ref_factor and ref_factor >= 1:
        most = f2_max_steps(ref_factor, functors.d, functors.nnz)
        if n_steps > most:
            raise ValueError(f"n_steps={n_steps} at d={functors.d} (rf {ref_factor}, "
                             f"{functors.nnz} live Jacobian entries): one IC's shared memory "
                             f"passes a block's {MAX_SMEM} bytes; F2 takes at most {most} steps "
                             "there")
    plan = _plan(functors, n_steps, ref_factor, dt=dt, device=device)
    return _with_plan(lambda u0s: fd_ensemble_vec(u0s, plan), plan)


def make_cuda_fd_estimate_per_member(ode=None, n_steps: int | None = None,
                                     ref_factor: int | None = None,
                                     convention: str = "strided", t0: float = 0.0,
                                     device="cuda", *, f=None, f_u=None):
    """Fused per-member FD estimate: ``run(dt_b, u0s) -> (err_steps, j)``
    with per-member (B, n_steps) coarse widths, ``err_steps`` (B, n_steps)
    in ``convention`` and ``j`` = Σ u_n² dt_n (B,) — one launch per call,
    the engine of ``run_adaptive_fd_per_member(engine="cuda")``. The ODE as
    for :func:`make_cuda_fd_ensemble` (``f`` and its required ``f_u``, as
    JAX's ``make_pallas_fd_estimate_per_member(f, f_u, …)``)."""
    functors = scalar_functors(ode, f, f_u, source=SOURCE, goal=False, need_f_u=True)
    plan = _plan(functors, n_steps, ref_factor, convention=convention, t0=t0, device=device)
    return _with_plan(lambda dt_b, u0s: fd_estimate_per_member(dt_b, u0s, plan), plan)
