"""Time marching (L1): one-step FD rules and marches, LSRK4(5)
coefficients, the eager DG advection march, and the DG-in-time slab
marches (single, batched and mixed-order) with their implicit-function-
theorem counterparts that autograd differentiates."""

from adjoint_ode_adaptivity_tpu_torch.march.advec import (
    AdvecOperators,
    advec_march,
    advec_operators,
    advec_rhs,
    cfl_dt,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import (
    DGBatchedAdjointResult,
    DGBatchedResult,
    dg_adjoint_march_batched,
    dg_element_functional_batched,
    dg_estimate_batched,
    dg_march_batched,
    dg_march_batched_differentiable,
    ge_solve_rows,
    make_dg_slab_solver_batched,
    solve_small,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import (
    MixedDGTimeOperators,
    dg_march_mixed,
    dg_march_mixed_differentiable,
    dg_time_operators_mixed,
    gauss_solve,
    make_dg_slab_solver_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import (
    DGMarchResult,
    DGTimeOperators,
    dg_march,
    dg_march_differentiable,
    dg_time_operators,
    elementwise_f_u,
    make_dg_slab_solver,
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
    "DGTimeOperators",
    "dg_time_operators",
    "DGMarchResult",
    "dg_march",
    "elementwise_f_u",
    "make_dg_slab_solver",
    "dg_march_differentiable",
    "solve_small",
    "ge_solve_rows",
    "DGBatchedResult",
    "DGBatchedAdjointResult",
    "dg_march_batched",
    "dg_adjoint_march_batched",
    "dg_element_functional_batched",
    "dg_estimate_batched",
    "make_dg_slab_solver_batched",
    "dg_march_batched_differentiable",
    "MixedDGTimeOperators",
    "dg_time_operators_mixed",
    "dg_march_mixed",
    "gauss_solve",
    "make_dg_slab_solver_mixed",
    "dg_march_mixed_differentiable",
]
