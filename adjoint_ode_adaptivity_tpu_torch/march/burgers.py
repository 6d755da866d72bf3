"""Nonlinear conservation law (Burgers) DG march with slope limiting (eager).

u_t + (u²/2)_x = 0 discretised with nodal DG and a local Lax–Friedrichs
numerical flux, periodic boundary conditions, marched with LSRK4(5), with
the ΠN/Π¹ minmod limiters (ops/limiters.py) applied after every RK STAGE
(the Hesthaven–Warburton pattern for nonlinear solvers). Counterpart of the
JAX package's ``march/burgers.py``; the tests hold the two to 1e-12 in
float64.

The state is (Np, K). On a CUDA device the (Np,Np)·(Np,K) products must run
in full float32: the entry points switch TF32 off. The hand-written kernel
B1 (ops/cuda/burgers.py) marches (Np, B, K) batches the same way.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.limiters import slope_limit_1, slope_limit_n
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = ["BurgersOperators", "burgers_operators", "burgers_rhs", "burgers_march", "limiter_fn"]

LIMITERS = ("n", "1", "none")


class BurgersOperators(NamedTuple):
    dr: torch.Tensor  # (Np, Np)
    lift: torch.Tensor  # (Np, 2)
    rx: torch.Tensor  # (Np, K)
    fscale: torch.Tensor  # (2, K)
    x: torch.Tensor  # (Np, K)
    v: torch.Tensor  # (Np, Np)
    inv_v: torch.Tensor  # (Np, Np)


def burgers_operators(disc: Discretization1D, dtype=torch.float64, device="cuda") -> BurgersOperators:
    """The operator bundle of ``disc`` on ``device`` (the card unless the
    caller asks for the CPU; a CUDA device that is not there raises)."""
    device = require_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return BurgersOperators(
        dr=t(disc.dr), lift=t(disc.lift), rx=t(disc.rx), fscale=t(disc.fscale),
        x=t(disc.x), v=t(disc.v), inv_v=t(disc.inv_v),
    )


def burgers_rhs(ops: BurgersOperators, u: torch.Tensor) -> torch.Tensor:
    """du/dt for u_t + (u²/2)_x = 0: DG volume term + local Lax–Friedrichs
    flux at faces, periodic BCs."""
    f = 0.5 * u * u
    u_l, u_r = u[0, :], u[-1, :]
    u_l_ext = torch.roll(u_r, 1)  # exterior traces (periodic)
    u_r_ext = torch.roll(u_l, -1)

    def llf(u_in, u_ext, nx):
        # f* = {f} − C/2·[u]·n with C = max|u| at the face
        c = torch.maximum(torch.abs(u_in), torch.abs(u_ext))
        return 0.5 * (0.5 * u_in**2 + 0.5 * u_ext**2) - 0.5 * c * (u_ext - u_in) * nx

    df_l = -(0.5 * u_l**2) + llf(u_l, u_l_ext, -1.0)  # n = −1 at the left face
    df_r = (0.5 * u_r**2) - llf(u_r, u_r_ext, 1.0)  # n = +1 at the right face
    du = torch.stack([df_l, df_r])
    return -ops.rx * (ops.dr @ f) + ops.lift @ (ops.fscale * du)


def limiter_fn(ops, limiter: str):
    """``u -> limited u`` for ``limiter`` in n | 1 | none, on (Np, K)
    states; ``ops`` is any bundle with ``x``, ``v``, ``inv_v``, ``dr``."""
    if limiter == "n":
        return lambda u: slope_limit_n(u, ops.x, ops.v, ops.inv_v, ops.dr)
    if limiter == "1":
        return lambda u: slope_limit_1(u, ops.x, ops.v, ops.inv_v, ops.dr)
    if limiter == "none":
        return lambda u: u
    raise ValueError(f"limiter {limiter!r}: expected one of {LIMITERS}")


def burgers_march(ops: BurgersOperators, u0: torch.Tensor, dt: float, n_steps: int, *,
                  limiter: str = "n") -> torch.Tensor:
    """LSRK4(5) march with the minmod limiter applied after every stage
    (H-W applies ΠN after each stage in the nonlinear solvers)."""
    limit = limiter_fn(ops, limiter)
    u, resu = u0, torch.zeros_like(u0)
    for _ in range(n_steps):
        for s in range(5):
            resu = float(RK4A[s]) * resu + dt * burgers_rhs(ops, u)
            u = limit(u + float(RK4B[s]) * resu)
    return u
