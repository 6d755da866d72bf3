"""Discrete adjoints and adjoint-weighted error estimates (L2, eager torch):
the one-step FD marches, the DG advection march and the DG-in-time slabs
(uniform and mixed per-element orders), and revolve (binomial
checkpointing behind autograd)."""

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
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_time import (
    DGAdjointResult,
    continuous_err_contribution,
    dg_adjoint_march,
    dg_adjoint_reconstruct,
    dg_awr_from_adjoint,
    dg_element_functional,
)
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    MixedAdjointInterp,
    MixedRadauInterp,
    dg_adjoint_interp_mixed,
    dg_adjoint_march_mixed,
    dg_adjoint_reconstruct_mixed,
    dg_adjoint_solve_low_mixed,
    dg_awr_from_adjoint_mixed,
    dg_element_functional_mixed,
    dg_estimate_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.adjoint.discrete import (
    adjoint_dense_oracle,
    adjoint_march,
    adjoint_march_linearized,
    adjoint_march_per_step,
)
from adjoint_ode_adaptivity_tpu_torch.adjoint.revolve_vjp import (
    checkpointed_advec_march,
    checkpointed_march,
    execute_revolve,
)
from adjoint_ode_adaptivity_tpu_torch.adjoint.estimate import (
    coarse_indicator,
    error_estimate,
    interp,
    interp_to_fine,
    refine_all,
    residual,
)

__all__ = [
    "adjoint_march",
    "adjoint_march_per_step",
    "adjoint_march_linearized",
    "adjoint_dense_oracle",
    "interp",
    "refine_all",
    "interp_to_fine",
    "residual",
    "error_estimate",
    "coarse_indicator",
    "checkpointed_march",
    "checkpointed_advec_march",
    "execute_revolve",
    "AdvecAdjointResult",
    "advec_adjoint_march",
    "advec_fwd_adj_estimate",
    "advec_rhs_t",
    "lsrk_step",
    "lsrk_step_homogeneous",
    "lsrk_step_homogeneous_t",
    "terminal_integral_cotangent",
    "DGAdjointResult",
    "dg_adjoint_march",
    "dg_element_functional",
    "dg_adjoint_reconstruct",
    "dg_awr_from_adjoint",
    "continuous_err_contribution",
    "MixedAdjointInterp",
    "MixedRadauInterp",
    "dg_adjoint_interp_mixed",
    "dg_adjoint_march_mixed",
    "dg_adjoint_reconstruct_mixed",
    "dg_adjoint_solve_low_mixed",
    "dg_awr_from_adjoint_mixed",
    "dg_element_functional_mixed",
    "dg_estimate_mixed",
    "dg_radau_interp_mixed",
]
