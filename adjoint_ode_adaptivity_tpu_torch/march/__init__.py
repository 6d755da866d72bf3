"""Time marching (L1): one-step FD rules and marches, LSRK4(5)
coefficients and the eager DG advection march."""

from adjoint_ode_adaptivity_tpu_torch.march.advec import (
    AdvecOperators,
    advec_march,
    advec_operators,
    advec_rhs,
    cfl_dt,
)
from adjoint_ode_adaptivity_tpu_torch.march.fd import (
    euler_step,
    forward_march,
    forward_march_per_step,
    heun_step,
    rk4_step,
    times_from_dt,
)
from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C

__all__ = [
    "euler_step",
    "heun_step",
    "rk4_step",
    "forward_march",
    "forward_march_per_step",
    "times_from_dt",
    "RK4A",
    "RK4B",
    "RK4C",
    "AdvecOperators",
    "advec_operators",
    "advec_rhs",
    "advec_march",
    "cfl_dt",
]
