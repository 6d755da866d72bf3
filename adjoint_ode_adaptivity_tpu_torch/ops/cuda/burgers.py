"""The limited Burgers march on hand-written CUDA (B1, csrc/burgers.cu).

Counterpart of the JAX package's ``ops/pallas/burgers.py``:
:func:`make_cuda_burgers_march` on (Np, B, K) batches replaces
``make_pallas_burgers_march`` and :func:`make_cuda_burgers_march_single` on
(Np, K) states replaces ``make_pallas_burgers_march_single_blocked``; one
kernel serves both (the TPU's blocked-sublane layout has no counterpart).

The wrapper :func:`burgers_march` launches B1 for a CUDA float32 or float64
tensor and raises on anything the kernel does not take; a CPU tensor takes
the kernel's plain PyTorch version :func:`burgers_march_plain`, which does
the same arithmetic with the same folded tables. Nothing falls back from
the kernel to the plain version. The wrapper counts its launches in
``burgers_march.launches`` (one per call: the whole march is one launch).

The plain version equals ``march/burgers.py::burgers_march`` per batch
member up to the order of operations (the step size is folded into the
tables here, and the cell average and the limited slope are single
coefficient rows, as in the Pallas kernel's ``_host_tables``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "BurgersTables",
    "burgers_tables",
    "burgers_march",
    "burgers_march_plain",
    "reset_launch_counts",
    "make_cuda_burgers_march",
    "make_cuda_burgers_march_single",
]

MIN_NP, MAX_NP = 2, 8
LIMITER_IDS = {"n": 0, "1": 1, "none": 2}
EPS0 = 1.0e-8  # the troubled-cell threshold of utils/SlopeLimitN.m


class BurgersTables(NamedTuple):
    """Everything B1 needs for one mesh, step size and limiter, on one
    device: the folded coefficient rows (float64 tensors for the plain
    version), the per-element geometry rows, and the packed host copies
    that the kernel takes by value."""

    np_: int
    k: int
    dt: float
    limiter: str
    drc: torch.Tensor  # (Np, Np) −dt·Dr
    ll: torch.Tensor  # (Np,) dt·LIFT[:, 0]
    lr: torch.Tensor  # (Np,) dt·LIFT[:, 1]
    cavg: torch.Tensor  # (Np,) V[0,0]·invV[0, :]
    drux: torch.Tensor  # (Np,) (Dr·Π¹)[0, :]
    geom: torch.Tensor  # (4 + Np, K) [rx, fscale_l, fscale_r, 1/h, ξ_0..ξ_{Np−1}]
    packed: np.ndarray  # float64 [drc, ll, lr, cavg, drux, RK4A, RK4B]


def burgers_tables(disc: Discretization1D, dt: float, limiter: str = "n",
                   device="cuda") -> BurgersTables:
    """Fold B1's tables for ``disc`` at step ``dt`` on ``device`` (the
    counterpart of the Pallas kernel's ``_host_tables``, always with the
    per-element geometry)."""
    if limiter not in LIMITER_IDS:
        raise ValueError(f"limiter {limiter!r}: expected one of {tuple(LIMITER_IDS)}")
    if not MIN_NP <= disc.np_ <= MAX_NP:
        raise ValueError(f"Np={disc.np_}: the kernel takes {MIN_NP} <= Np <= {MAX_NP}")
    device = require_device(device)
    v, inv_v, dr = (np.asarray(m, dtype=np.float64) for m in (disc.v, disc.inv_v, disc.dr))
    n_lin = min(2, disc.np_)
    p_lin = v[:, :n_lin] @ inv_v[:n_lin, :]
    drc = -dt * dr
    ll = dt * np.asarray(disc.lift[:, 0], dtype=np.float64)
    lr = dt * np.asarray(disc.lift[:, 1], dtype=np.float64)
    cavg = v[0, 0] * inv_v[0, :]
    drux = dr[0, :] @ p_lin
    x = np.asarray(disc.x, dtype=np.float64)
    h = x[-1, :] - x[0, :]
    geom = np.concatenate([
        np.asarray(disc.rx[0, :])[None], np.asarray(disc.fscale[0, :])[None],
        np.asarray(disc.fscale[1, :])[None], (1.0 / h)[None], x - (x[0, :] + h / 2)[None, :],
    ])
    packed = np.concatenate([drc.ravel(), ll, lr, cavg, drux, RK4A, RK4B])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    return BurgersTables(disc.np_, disc.k, float(dt), limiter, t(drc), t(ll), t(lr), t(cavg),
                         t(drux), t(geom), np.ascontiguousarray(packed))


# ------------------------------------------------------------ plain version


def _minmod3(a, b, c):
    s = (torch.sign(a) + torch.sign(b) + torch.sign(c)) / 3.0
    mag = torch.minimum(torch.abs(a), torch.minimum(torch.abs(b), torch.abs(c)))
    return torch.where(torch.abs(s) == 1.0, s * mag, torch.zeros_like(s))


def plain_operands(tab: BurgersTables, dtype):
    names = ("drc", "ll", "lr", "cavg", "drux", "geom")
    return dict(zip(names, (getattr(tab, n).to(dtype) for n in names)))


def _rhs_dt_plain(u, p):
    """dt·rhs on (Np, B, K): LLF flux (periodic traces), volume and lift."""
    rx, fsl, fsr = p["geom"][0], p["geom"][1], p["geom"][2]
    f = 0.5 * u * u
    u_l, u_r = u[0], u[-1]  # (B, K)
    u_l_ext = torch.roll(u_r, 1, dims=-1)
    u_r_ext = torch.roll(u_l, -1, dims=-1)
    c_l = torch.maximum(torch.abs(u_l), torch.abs(u_l_ext))
    c_r = torch.maximum(torch.abs(u_r), torch.abs(u_r_ext))
    fstar_l = 0.5 * (0.5 * u_l * u_l + 0.5 * u_l_ext * u_l_ext) + 0.5 * c_l * (u_l_ext - u_l)
    fstar_r = 0.5 * (0.5 * u_r * u_r + 0.5 * u_r_ext * u_r_ext) - 0.5 * c_r * (u_r_ext - u_r)
    df_l = (-(0.5 * u_l * u_l) + fstar_l) * fsl
    df_r = (0.5 * u_r * u_r - fstar_r) * fsr
    vol = (p["drc"] @ f.reshape(u.shape[0], -1)).reshape(f.shape) * rx
    return vol + p["ll"][:, None, None] * df_l + p["lr"][:, None, None] * df_r


def limited_and_margin(u, p):
    """The Π¹-limited candidate of every element of (Np, B, K) ``u`` and
    ΠN's troubled-cell margin (B, K), max(|ve1 − u_0|, |ve2 − u_{Np−1}|):
    a cell is troubled where it exceeds ε₀. Copied-endpoint neighbour
    averages; ``p`` from :func:`plain_operands`."""
    ih, xi = p["geom"][3], p["geom"][4:, None, :]
    vk = torch.tensordot(p["cavg"], u, dims=1)  # (B, K)
    vkm1 = torch.cat([vk[:, :1], vk[:, :-1]], dim=1)
    vkp1 = torch.cat([vk[:, 1:], vk[:, -1:]], dim=1)
    dm, dp = vk - vkm1, vkp1 - vk
    ux = 2.0 * torch.tensordot(p["drux"], u, dims=1) * ih
    limited = vk + xi * _minmod3(ux, dp * ih, dm * ih)
    ve1 = vk - _minmod3(vk - u[0], dm, dp)
    ve2 = vk + _minmod3(u[-1] - vk, dm, dp)
    return limited, torch.maximum(torch.abs(ve1 - u[0]), torch.abs(ve2 - u[-1]))


def burgers_march_plain(u0: torch.Tensor, n_steps: int, tab: BurgersTables,
                        observe=None) -> torch.Tensor:
    """B1's plain version on (Np, B, K): ``n_steps`` LSRK4(5) steps with the
    LLF flux (periodic) and the limiter after every stage. ``observe(v,
    limited, margin)``, when given, sees every limited stage's updated
    state, its Π¹ candidate and ΠN's margin (for checks of the kernel)."""
    p = plain_operands(tab, u0.dtype)

    def limit(u):
        if tab.limiter == "none":
            return u
        limited, margin = limited_and_margin(u, p)
        if observe is not None:
            observe(u, limited, margin)
        return limited if tab.limiter == "1" else torch.where(margin > EPS0, limited, u)

    u, resu = u0, None
    for _ in range(n_steps):
        for s in range(5):
            r = _rhs_dt_plain(u, p)
            resu = r if s == 0 else float(RK4A[s]) * resu + r
            u = limit(u + float(RK4B[s]) * resu)
    return u


# ------------------------------------------------------------------ wrapper


def burgers_march(u0: torch.Tensor, n_steps: int, tab: BurgersTables) -> torch.Tensor:
    """B1: march (Np, B, K) ``u0`` n_steps limited LSRK4(5) steps. A CUDA
    float32/float64 tensor launches the kernel; a CPU tensor takes the plain
    version."""
    if n_steps < 0:
        raise ValueError(f"n_steps={n_steps} must be >= 0")
    if u0.dim() != 3 or u0.shape[0] != tab.np_ or u0.shape[2] != tab.k:
        raise ValueError(f"u0: shape {tuple(u0.shape)}, expected ({tab.np_}, B, {tab.k})")
    if u0.device != tab.geom.device:
        raise ValueError(f"u0 on {u0.device}, kernel operands on {tab.geom.device}")
    if u0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"u0: dtype {u0.dtype}; B1 takes float32/float64")
    if u0.device.type == "cpu":
        return burgers_march_plain(u0, n_steps, tab)
    if u0.device.type != "cuda":
        raise ValueError(f"u0: device {u0.device} is neither cuda nor cpu")
    if not u0.is_contiguous():
        raise ValueError("u0 must be contiguous")
    lib = load_library()
    f64 = u0.dtype == torch.float64
    packed = tab.packed if f64 else tab.packed.astype(np.float32)
    geom = tab.geom.to(u0.dtype).contiguous()
    u_out = torch.empty_like(u0)
    ubuf = torch.empty_like(u0)
    rbuf = torch.empty_like(u0)
    avg = torch.empty(u0.shape[1:], dtype=u0.dtype, device=u0.device)
    entry = lib.lib.burgers_march_f64 if f64 else lib.lib.burgers_march_f32
    code = entry(
        tab.np_, u0.shape[1], tab.k, n_steps, LIMITER_IDS[tab.limiter],
        packed.ctypes.data_as(ctypes.c_void_p), geom.data_ptr(), u0.data_ptr(),
        u_out.data_ptr(), ubuf.data_ptr(), rbuf.data_ptr(), avg.data_ptr(),
        torch.cuda.current_stream(u0.device).cuda_stream,
    )
    burgers_march.launches += 1
    lib.check(code, "burgers_march", lib.lib.burgers_error_string)
    return u_out


burgers_march.launches = 0


def reset_launch_counts() -> None:
    burgers_march.launches = 0


# -------------------------------------------------------------- entry points


def make_cuda_burgers_march(disc: Discretization1D, dt: float, n_steps: int, batch: int = 8,
                            limiter: str = "n", device="cuda"):
    """Returns ``run(u0) -> u_final`` for batched states (Np, B, K):
    ``n_steps`` limited LSRK4(5) Burgers steps in one B1 launch."""
    tab = burgers_tables(disc, dt, limiter, device)

    def run(u0):
        if u0.dim() != 3 or u0.shape[1] != batch:
            raise ValueError(f"u0: shape {tuple(u0.shape)}, expected ({disc.np_}, {batch}, {disc.k})")
        return burgers_march(u0, n_steps, tab)

    return run


def make_cuda_burgers_march_single(disc: Discretization1D, dt: float, n_steps: int,
                                   limiter: str = "n", device="cuda"):
    """Limited Burgers march of one (Np, K) state: B1 at B = 1. Same
    contract as ``march/burgers.py::burgers_march``."""
    tab = burgers_tables(disc, dt, limiter, device)

    def run(u0):
        if u0.dim() != 2:
            raise ValueError(f"u0: shape {tuple(u0.shape)}, expected ({disc.np_}, {disc.k})")
        return burgers_march(u0[:, None, :].contiguous(), n_steps, tab)[:, 0, :]

    return run
