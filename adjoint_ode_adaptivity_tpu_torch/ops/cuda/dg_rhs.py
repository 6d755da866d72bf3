"""The DG-advection fwd + adjoint + estimate pipeline on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/dg_rhs.py`` stored-trajectory
pipeline (``_make_stored_run``). Two kernels (csrc/dg_rhs.cu):

- **K1** :func:`fwd_march` — n_steps LSRK4(5) steps from ``u0`` at ``t0``;
  optionally stores every entry state u_n in ``traj[n]``. Replaces
  ``_fwd_traj_grid_kernel_b`` (dg_rhs.py:981), and with no trajectory
  ``_fwd_grid_kernel_b`` (:1017) and ``_forward_kernel`` (:270).
- **K2** :func:`adj_est_stored` — for n = n_steps−1 … 0: two dt/2 steps from
  u_n, η += Σ_nodes λ·(u_{n+1} − half2), then two dt/2 transpose steps.
  Replaces ``_adj_est_grid_kernel_b_stored`` (dg_rhs.py:1108).

Each wrapper takes (Np, B, K) states. A CUDA float32 tensor launches the
kernel or raises; a CPU tensor takes the kernel's plain PyTorch version
(:func:`fwd_march_plain`, :func:`adj_est_stored_plain`), which accepts
float32 and float64. Nothing falls back from the kernel to the plain
version. Each wrapper counts its kernel launches in ``.launches``.

Geometry is always per element (rx, fscale_left, fscale_right), so graded
meshes need no special path. The step size is folded into the coefficient
tables on the host (see :class:`StepTables`), separately for dt and dt/2.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "StepTables",
    "KernelOps",
    "kernel_ops",
    "fwd_march",
    "fwd_march_plain",
    "adj_est_stored",
    "adj_est_stored_plain",
    "reset_launch_counts",
    "make_cuda_fwd_adj_estimate_grid_batched",
    "make_cuda_fwd_adj_estimate_single",
    "make_cuda_advec_march",
]

MIN_NP, MAX_NP = 2, 8
_RK = np.ascontiguousarray(np.concatenate([RK4A, RK4B, RK4C]), dtype=np.float64)


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


def fwd_march_plain(u0, t0: float, n_steps: int, ops: KernelOps,
                    store_trajectory: bool = False):
    """K1's plain version: ``(traj or None, u_final)``."""
    traj = (
        torch.empty((n_steps, *u0.shape), dtype=u0.dtype, device=u0.device)
        if store_trajectory
        else None
    )
    u = u0
    for n in range(n_steps):
        if traj is not None:
            traj[n] = u
        u = _step_plain(u, t0 + n * ops.dt, ops.full, ops)
    return traj, u


def adj_est_stored_plain(traj, u_final, lam_end, t0: float, ops: KernelOps):
    """K2's plain version: ``(lam0, eta)`` with eta (B, K)."""
    n_steps = traj.shape[0]
    h = ops.dt / 2.0
    lu = lam_end
    eta = torch.zeros(lam_end.shape[1:], dtype=lam_end.dtype, device=lam_end.device)
    for n in reversed(range(n_steps)):
        t_n = t0 + n * ops.dt
        u_np1 = u_final if n == n_steps - 1 else traj[n + 1]
        half = _step_plain(traj[n], t_n, ops.half, ops)
        half2 = _step_plain(half, t_n + h, ops.half, ops)
        eta = eta + torch.sum(lu * (u_np1 - half2), dim=0)
        lu = _step_t_plain(_step_t_plain(lu, ops.half, ops), ops.half, ops)
    return lu, eta


# ------------------------------------------------------------------ wrappers


def _check(name: str, x: torch.Tensor, shape, ops: KernelOps) -> bool:
    """Validate an operand; True when it lies on a CUDA device (kernel
    path), False on the CPU (plain path). Raises on anything else."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != ops.rx.device:
        raise ValueError(f"{name} on {x.device}, kernel operands on {ops.rx.device}")
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
    Returns ``(traj, u_final)``; traj is (n_steps, Np, B, K) or None."""
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
    u_final = torch.empty_like(u0)
    work = torch.empty((4, size), dtype=torch.float32, device=u0.device)
    rx, fsl, fsr = ops.geom32
    code = lib.lib.dg_fwd_march(
        ops.np_, b, ops.k, n_steps, float(t0), ops.dt, ops.a,
        _RK.ctypes.data, ops.full.packed.ctypes.data,
        _ptr(rx), _ptr(fsl), _ptr(fsr), _ptr(u0), _ptr(traj), _ptr(u_final),
        _ptr(work[0]), _ptr(work[2]), _stream(u0.device),
    )
    fwd_march.launches += 1
    lib.check(code, "dg_fwd_march")
    return traj, u_final


def adj_est_stored(traj: torch.Tensor, u_final: torch.Tensor, lam_end: torch.Tensor,
                   t0: float, ops: KernelOps):
    """K2: reverse sweep over a stored trajectory with the fine (dt/2)²
    transpose. Returns ``(lam0, eta)``, eta (B, K)."""
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
    lib = load_library()
    size = u_final.numel()
    lam0 = torch.empty_like(lam_end)
    eta = torch.zeros((b, ops.k), dtype=torch.float32, device=traj.device)
    work = torch.empty((8, size), dtype=torch.float32, device=traj.device)
    rx, fsl, fsr = ops.geom32
    code = lib.lib.dg_adj_est_stored(
        ops.np_, b, ops.k, n_steps, float(t0), ops.dt, ops.a,
        _RK.ctypes.data, ops.half.packed.ctypes.data,
        _ptr(rx), _ptr(fsl), _ptr(fsr), _ptr(traj), _ptr(u_final), _ptr(lam_end),
        _ptr(lam0), _ptr(eta), _ptr(work[0]), _ptr(work[2]), _ptr(work[4]),
        _ptr(work[6]), _stream(traj.device),
    )
    adj_est_stored.launches += 1
    lib.check(code, "dg_adj_est_stored")
    return lam0, eta


fwd_march.launches = 0
adj_est_stored.launches = 0


def reset_launch_counts() -> None:
    fwd_march.launches = 0
    adj_est_stored.launches = 0


# -------------------------------------------------------------- entry points


def make_cuda_fwd_adj_estimate_grid_batched(
    disc: Discretization1D, a: float, dt: float, n_steps: int, batch: int = 8,
    device="cuda",
):
    """Batched stored-trajectory pipeline: ``run(u0, t0, lam_end) ->
    (u_final, lam0, eta)`` with ``u0/lam_end``: (Np, B, K), ``eta``: (B, K) —
    ``batch`` independent copies of the unbatched pipeline. The trajectory
    (n_steps·Np·B·K·4 bytes) lives in device memory."""
    ops = kernel_ops(disc, a, dt, device)
    state = (disc.np_, batch, disc.k)

    def run(u0, t0, lam_end):
        if tuple(u0.shape) != state or tuple(lam_end.shape) != state:
            raise ValueError(f"u0/lam_end must be {state}")
        traj, u_final = fwd_march(u0, t0, n_steps, ops, store_trajectory=True)
        lam0, eta = adj_est_stored(traj, u_final, lam_end, t0, ops)
        return u_final, lam0, eta

    return run


def make_cuda_fwd_adj_estimate_single(
    disc: Discretization1D, a: float, dt: float, n_steps: int, device="cuda"
):
    """Single-state pipeline, ``run(u0, t0, lam_end) -> (u_final, lam0, eta)``
    with ``u0/lam_end``: (Np, K) and ``eta``: (K,) — the batched pipeline
    at B = 1 (the TPU's blocked-sublane layout has no counterpart here)."""
    inner = make_cuda_fwd_adj_estimate_grid_batched(disc, a, dt, n_steps, 1, device)

    def run(u0, t0, lam_end):
        uf, lam0, eta = inner(u0[:, None, :], t0, lam_end[:, None, :])
        return uf[:, 0, :], lam0[:, 0, :], eta[0]

    return run


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
