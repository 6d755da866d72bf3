"""1D advection DG semidiscretization and LSRK4(5) time march (eager torch).

Reference parity: ``utils/AdvecRHS1D.m`` (upwind face flux, inflow BC
``uin = −sin(a·t)``, volume term ``−a·rx·(Dr u)`` + surface lift) and the
``Advec1D`` time loop of ``utils/One_code.mlx`` (CFL-based dt, five
low-storage stages per step). Counterpart of the JAX package's
``march/advec.py``; the tests hold the two to ~1e-12 in float64.

- State layout ``(Np, K)``; ``Dr @ u`` and ``LIFT @ flux`` are small
  (Np×Np)·(Np×K) products. On a CUDA device they must run in full float32:
  the entry points switch TF32 off (``torch.backends.cuda.matmul.allow_tf32``
  and ``torch.backends.cudnn.allow_tf32``).
- The face gather through ``vmapM/vmapP`` degenerates on a 1D mesh to a
  shift along K: element k's left-face neighbour is element k−1's last node.
- Times are Python floats (``t0 + n·dt``, stage time ``t + c_s·dt``); the
  inflow value is evaluated on the host in float64.

This module is the eager engine (``engine="torch"``) and the oracle of the
CUDA kernels' plain versions (ops/cuda/dg_rhs.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "AdvecOperators",
    "advec_operators",
    "advec_operators_from_numpy",
    "advec_rhs",
    "advec_march",
    "cfl_dt",
    "lsrk_stages",
]


class AdvecOperators(NamedTuple):
    """Static operator bundle for the advection RHS, on one device and dtype."""

    dr: torch.Tensor  # (Np, Np)
    lift: torch.Tensor  # (Np, 2)
    rx: torch.Tensor  # (Np, K)
    fscale: torch.Tensor  # (2, K)
    nx: torch.Tensor  # (2, K)
    flux_fac: torch.Tensor  # (2, K) upwind factor (a·nx − (1−alpha)|a·nx|)/2
    a: float  # advection speed
    alpha: float  # upwinding parameter (1 = pure upwind)


def advec_operators_from_numpy(dr, lift, rx, fscale, nx, a, alpha, device, dtype):
    """Operator bundle from host arrays on ``device`` in ``dtype`` — the one
    constructor, re-exported by ``interop`` for bundles built by the JAX
    package."""

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    nx_t = t(nx)
    return AdvecOperators(
        dr=t(dr),
        lift=t(lift),
        rx=t(rx),
        fscale=t(fscale),
        nx=nx_t,
        flux_fac=(a * nx_t - (1 - alpha) * torch.abs(a * nx_t)) / 2.0,
        a=float(a),
        alpha=float(alpha),
    )


def advec_operators(
    disc: Discretization1D,
    a: float = 2 * np.pi,
    alpha: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> AdvecOperators:
    """The operator bundle of ``disc`` on ``device`` (the card unless the
    caller asks for the CPU; a CUDA device that is not there raises)."""
    return advec_operators_from_numpy(
        disc.dr, disc.lift, disc.rx, disc.fscale, disc.nx, a, alpha, require_device(device), dtype
    )


def advec_rhs(
    ops: AdvecOperators, u: torch.Tensor, t: float, inflow: bool = True
) -> torch.Tensor:
    """du/dt of the DG-discretised advection equation u_t + a u_x = 0.

    ``u`` is (Np, K), ``t`` a Python float. Upwind flux factor per face;
    inflow Dirichlet BC u(x=0,t) = −sin(a·t) at the left boundary, zero flux
    difference at the outflow. ``inflow=False`` freezes the BC at zero —
    the homogeneous (linear-in-u) operator whose transpose is the adjoint
    step (adjoint/advec.py::advec_rhs_t).
    """
    ff = ops.flux_fac
    u_left, u_right = u[0], u[-1]
    uin = -math.sin(ops.a * t) if inflow else 0.0
    du_left = torch.cat(
        [(u_left[:1] - uin) * ff[0, :1], (u_left[1:] - u_right[:-1]) * ff[0, 1:]]
    )
    du_right = torch.cat(
        [(u_right[:-1] - u_left[1:]) * ff[1, :-1], torch.zeros_like(u_right[:1])]
    )
    du = torch.stack([du_left, du_right])  # (2, K)
    return -ops.a * ops.rx * (ops.dr @ u) + ops.lift @ (ops.fscale * du)


def cfl_dt(disc: Discretization1D, a: float, cfl: float = 0.75, final_time: float = 2.0):
    """CFL time step exactly as the One_code.mlx driver: dt from the minimum
    node spacing, halved, then truncated so Nsteps·dt = FinalTime."""
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = 0.5 * (cfl / a) * xmin
    n_steps = int(np.ceil(final_time / dt))
    return final_time / n_steps, n_steps


def lsrk_stages(ops: AdvecOperators, u, t: float, dt: float, inflow: bool = True):
    """One full 5-stage LSRK4(5) step from time ``t`` with step ``dt``."""
    resu = torch.zeros_like(u)
    for s in range(5):
        rhs = advec_rhs(ops, u, t + float(RK4C[s]) * dt, inflow=inflow)
        resu = float(RK4A[s]) * resu + dt * rhs
        u = u + float(RK4B[s]) * resu
    return u


def advec_march(
    ops: AdvecOperators, u0: torch.Tensor, dt: float, n_steps: int, t0: float = 0.0,
    *, post_stage=None,
) -> torch.Tensor:
    """March ``n_steps`` LSRK4(5) steps from ``t0``; returns the final state.

    ``post_stage`` (e.g. a slope limiter ``u -> u``) is applied after each
    full RK step, as the JAX march applies it. (The JAX march's
    ``save_every`` stack has no caller.)"""
    u = u0
    for n in range(n_steps):
        u = lsrk_stages(ops, u, t0 + n * dt, dt)
        if post_stage is not None:
            u = post_stage(u)
    return u
