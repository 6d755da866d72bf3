"""Discrete adjoint of the DG advection march and the adjoint-weighted
step-doubling error estimate (L2, eager torch)."""

from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import (
    AdvecAdjointResult,
    advec_adjoint_march,
    advec_fwd_adj_estimate,
    advec_rhs_t,
    lsrk_step,
    lsrk_step_homogeneous,
    lsrk_step_homogeneous_t,
    terminal_integral_cotangent,
)

__all__ = [
    "AdvecAdjointResult",
    "advec_adjoint_march",
    "advec_fwd_adj_estimate",
    "advec_rhs_t",
    "lsrk_step",
    "lsrk_step_homogeneous",
    "lsrk_step_homogeneous_t",
    "terminal_integral_cotangent",
]
