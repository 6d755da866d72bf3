"""The FD refinement signal on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/fd_ensemble.py``. Three
kernels (csrc/fd_ensemble.cu), each with the whole pipeline of an initial
condition (IC) or member — coarse Euler march, interpolation to the
rf-refined grid, the adjoint of J = ∫u² dt, the residual and the per-step
indicator — F1 and F2 in one thread per IC, F3 in G lanes of a warp per
member:

- **F1** :func:`fd_ensemble` — scalar state, block indicator
  ``(n_steps, n_ics)``. Replaces ``_kernel`` (fd_ensemble.py:61); with
  ``trig="fast"`` it evaluates sin/cos by the polynomials of
  :mod:`adjoint_ode_adaptivity_tpu_torch.ops.fast_trig` (fast_trig.py:62-77).
- **F2** :func:`fd_ensemble_vec` — d-vector state, the adjoint through
  (I + dt·J)ᵀ. Replaces ``_vec_kernel`` (fd_ensemble.py:201).
- **F3** :func:`fd_estimate_per_member` — per-member step widths (B, n_steps),
  strided or block indicator and J per member. Replaces ``_pm_kernel``
  (fd_ensemble.py:357); the engine of ``run_adaptive_fd_per_member(engine="cuda")``.

What bounds them, and what the design does about it: each IC's march and
sweep are serial chains (v_j needs v_{j+1}), so a kernel is latency-bound,
far above both the byte bound (one read of u0, one write per step) and the
FP32 bound. F1 and F2 run one thread per IC, every chain independent and
every access coalesced. F3 serves the per-member study's B = 1024, where one
thread a member filled 8 of 132 SMs: its G lanes (:func:`fd_pm_plan`) split
the fine nodes' interpolation, (f, f_u) pairs and residuals, and one lane
runs only the chain v_j = A_j + C_j·v_{j+1} and the per-step sums in the
plain version's order; the member's widths are read as (B, n_steps), its
row contiguous, and err is written (B, n_steps): one CUDA launch a call.

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
F3's plan shrinks its CTA and its window of fine nodes to fit first).

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
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device

__all__ = [
    "FdPlan",
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
PM_LANES = (1, 2, 4, 8, 16, 32)  # the lanes a member F3 takes
PM_THREADS = (32, 64, 128, 256)  # its CTA sizes
PM_MAX_WARPS = 4096  # fd_pm_plan's most warps: ~31 an SM on 132 SMs
MAX_SMEM = 232_448  # csrc kMaxSmem: the bytes a block may use on sm_90
VECTOR_KERNEL_IDS = {odes.KERNEL_IDS["harmonic_oscillator"]: 2}  # id -> d
SIN_ID = odes.KERNEL_IDS["du/dt=sin(u)"]


class FdPlan(NamedTuple):
    """Everything one entry point's kernel needs, on one device.

    ``grid`` is the float64 host fold [tc (n_steps), dts (n_steps),
    tf (n_fine), dtf (n_fine)] and ``grid32`` its float32 copy on the device
    (empty for the per-member kernel, whose widths are an operand);
    ``consts`` the 64 float32 constants passed by value (csrc OdeConsts)."""

    ode: odes.ODEProblem
    n_steps: int
    rf: int
    trig: str  # "libm" or "fast"
    convention: str  # per-member only: "strided" or "block"
    t0: float  # per-member only: the time of every member's first node
    grid: np.ndarray
    grid32: torch.Tensor
    consts: np.ndarray
    n_modes: tuple  # (n_u, n_t) of the gaussian mixture, else (0, 0)


def fine_grid(n_steps: int, rf: int, dt) -> np.ndarray:
    """Coarse node times and widths and fine node times and widths, folded
    in double as the TPU kernel folds them at trace time (t0 = 0; ``dt`` a
    scalar or ``n_steps`` widths)."""
    dts = [float(dt)] * n_steps if np.ndim(dt) == 0 else [float(d) for d in dt]
    if len(dts) != n_steps:
        raise ValueError(f"dt vector length {len(dts)} != n_steps={n_steps}")
    tc = [0.0]
    for d in dts:
        tc.append(tc[-1] + d)
    n_fine = n_steps * rf
    tf = [tc[j // rf] + ((j % rf) / rf) * dts[j // rf] for j in range(n_fine)]
    dtf = [dts[j // rf] / rf for j in range(n_fine)]
    return np.array(tc[:-1] + dts + tf + dtf, dtype=np.float64)


def _split(plan: FdPlan):
    s, nf = plan.n_steps, plan.n_steps * plan.rf
    g = plan.grid.tolist()
    return g[:s], g[s:2 * s], g[2 * s:2 * s + nf], g[2 * s + nf:]


def _resolve(ode) -> odes.ODEProblem:
    return odes.get_ode(ode) if isinstance(ode, str) else ode


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


def _plan(ode, n_steps, rf, *, vector, trig="libm", convention="block", t0=0.0,
          dt=None, device="cuda") -> FdPlan:
    ode = _resolve(ode)
    if ode.kernel_id is None:
        raise ValueError(f"ODE {ode.name!r} has no kernel_id: the FD kernels cannot run it")
    if (ode.kernel_id in VECTOR_KERNEL_IDS) != vector:
        kind = "a vector" if vector else "a scalar"
        raise ValueError(f"ODE {ode.name!r}: this entry point takes {kind} ODE")
    if trig not in ("libm", "fast"):
        raise ValueError(f"trig={trig!r}: 'libm' or 'fast'")
    if trig == "fast" and ode.kernel_id != SIN_ID:
        raise ValueError("trig='fast' is implemented for du/dt=sin(u) only")
    if convention not in ("strided", "block"):
        raise ValueError(f"unknown convention {convention!r}")
    if n_steps < 1 or rf < 1:
        raise ValueError(f"n_steps={n_steps} and ref_factor={rf} must be >= 1")
    grid = fine_grid(n_steps, rf, dt) if dt is not None else np.zeros(0)
    consts, n_modes = _consts(ode)
    grid32 = torch.as_tensor(grid, dtype=torch.float32, device=require_device(device))
    return FdPlan(ode, n_steps, rf, trig, convention, float(t0), grid, grid32,
                  consts, n_modes)


# ------------------------------------------------------------ plain versions


def _scalar_fns(plan: FdPlan) -> tuple[Callable, Callable]:
    if plan.trig == "fast":
        return (lambda u, t: fast_trig.fast_sin(u)), (lambda u, t: fast_trig.fast_cos(u))
    return plan.ode.f, plan.ode.f_u


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
    f, jac_fn = plan.ode.f, plan.ode.f_u
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
    f, f_u = plan.ode.f, plan.ode.f_u
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
    return torch.cuda.current_stream(device).cuda_stream


def fd_ensemble(u0s: torch.Tensor, plan: FdPlan) -> torch.Tensor:
    """F1: the per-IC block indicator (n_steps, n_ics) of ``u0s`` (n_ics,)."""
    if u0s.dim() != 1:
        raise ValueError(f"u0s must be (n_ics,), got {tuple(u0s.shape)}")
    if not _on_cuda("u0s", u0s, u0s.shape, plan):
        return fd_ensemble_plain(u0s, plan)
    lib = load_library()
    n = u0s.shape[0]
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0s.device)
    code = lib.lib.fd_ensemble(
        plan.ode.kernel_id, int(plan.trig == "fast"), *plan.n_modes,
        plan.consts.ctypes.data, n, plan.n_steps, plan.rf, plan.grid32.data_ptr(),
        u0s.data_ptr(), err.data_ptr(), _stream(u0s.device),
    )
    fd_ensemble.launches += 1
    lib.check(code, "fd_ensemble", lib.lib.fd_error_string)
    return err


def fd_ensemble_vec(u0s: torch.Tensor, plan: FdPlan) -> torch.Tensor:
    """F2: the per-IC block indicator (n_steps, n_ics) of ``u0s`` (n_ics, d).
    The kernel reads the states component-major; the wrapper transposes."""
    d = VECTOR_KERNEL_IDS[plan.ode.kernel_id]
    if u0s.dim() != 2 or u0s.shape[1] != d:
        raise ValueError(f"u0s must be (n_ics, {d}), got {tuple(u0s.shape)}")
    if not _on_cuda("u0s", u0s, u0s.shape, plan):
        return fd_ensemble_vec_plain(u0s, plan)
    lib = load_library()
    n = u0s.shape[0]
    u0t = u0s.T.contiguous()  # (d, n_ics): neighbouring threads, neighbouring ICs
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0s.device)
    code = lib.lib.fd_ensemble_vec(
        plan.ode.kernel_id, n, plan.n_steps, plan.rf, plan.grid32.data_ptr(),
        u0t.data_ptr(), err.data_ptr(), _stream(u0s.device),
    )
    fd_ensemble_vec.launches += 1
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
    lib = load_library()
    b, n_steps = u0s.shape[0], plan.n_steps
    out = torch.empty(b * (n_steps + 1), dtype=torch.float32, device=u0s.device)  # one allocation
    err, j_val = out[: b * n_steps].view(b, n_steps), out[b * n_steps:]
    code = lib.lib.fd_estimate_per_member(
        plan.ode.kernel_id, *plan.n_modes, plan.consts.ctypes.data, b, plan.n_steps,
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


def make_cuda_fd_ensemble(ode, n_steps: int, ref_factor: int, dt, trig: str = "libm",
                          device="cuda"):
    """``run(u0s) -> err_steps``: the per-IC block indicator (n_steps, n_ics)
    of the FD pipeline (u' = f(u, t), J = ∫u² dt) in one launch; its mean
    over axis 1 is the ensemble refinement signal. ``ode`` is a registry
    entry (or its name) with a ``kernel_id``; ``dt`` a scalar or n_steps
    widths; ``trig="fast"`` (sin(u) only, |u| ≤ 4) evaluates sin/cos by the
    shared-x² polynomials."""
    plan = _plan(ode, n_steps, ref_factor, vector=False, trig=trig, dt=dt, device=device)
    return _with_plan(lambda u0s: fd_ensemble(u0s, plan), plan)


def make_cuda_fd_ensemble_vec(ode, n_steps: int, ref_factor: int, dt, device="cuda"):
    """Vector-state variant: ``run(u0s) -> err_steps`` with ``u0s`` (n_ics, d)
    and the block indicator (n_steps, n_ics) (r·v contracted over
    components)."""
    plan = _plan(ode, n_steps, ref_factor, vector=True, dt=dt, device=device)
    return _with_plan(lambda u0s: fd_ensemble_vec(u0s, plan), plan)


def make_cuda_fd_estimate_per_member(ode, n_steps: int, ref_factor: int,
                                     convention: str = "strided", t0: float = 0.0,
                                     device="cuda"):
    """Fused per-member FD estimate: ``run(dt_b, u0s) -> (err_steps, j)``
    with per-member (B, n_steps) coarse widths, ``err_steps`` (B, n_steps)
    in ``convention`` and ``j`` = Σ u_n² dt_n (B,) — one launch per call,
    the engine of ``run_adaptive_fd_per_member(engine="cuda")``."""
    plan = _plan(ode, n_steps, ref_factor, vector=False, convention=convention, t0=t0,
                 device=device)
    return _with_plan(lambda dt_b, u0s: fd_estimate_per_member(dt_b, u0s, plan), plan)
