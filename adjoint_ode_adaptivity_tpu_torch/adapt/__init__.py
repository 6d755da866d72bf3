"""Adaptive refinement loops and policies (L3)."""

from adjoint_ode_adaptivity_tpu_torch.adapt.advec_loop import (
    AdvecAdaptResult,
    run_adaptive_advec,
)
from adjoint_ode_adaptivity_tpu_torch.adapt.dg_loop import (
    DGAdaptResult,
    DGEnsembleAdaptResult,
    DGPerMemberAdaptResult,
    run_adaptive_dg,
    run_adaptive_dg_ensemble,
    run_adaptive_dg_per_member,
)
from adjoint_ode_adaptivity_tpu_torch.adapt.fd_loop import (
    AdaptResult,
    AdaptState,
    FDPerMemberAdaptResult,
    adapt_iteration,
    backtrack_iteration,
    run_adaptive_fd,
    run_adaptive_fd_backtrack,
    run_adaptive_fd_backtrack_padded,
    run_adaptive_fd_per_member,
)
from adjoint_ode_adaptivity_tpu_torch.adapt.hp_loop import (
    HPAdaptResult,
    HPPerMemberAdaptResult,
    run_adaptive_dg_hp,
    run_adaptive_dg_hp_per_member,
)
from adjoint_ode_adaptivity_tpu_torch.adapt.policy import (
    bisect_refine,
    bisect_refine_masked,
    bisect_refine_padded,
    bisect_refine_padded_masked,
    coarsen_merge,
    coarsen_merge_padded,
    pad_times,
)

__all__ = [
    "AdvecAdaptResult",
    "run_adaptive_advec",
    "DGAdaptResult",
    "DGEnsembleAdaptResult",
    "DGPerMemberAdaptResult",
    "run_adaptive_dg",
    "run_adaptive_dg_ensemble",
    "run_adaptive_dg_per_member",
    "HPAdaptResult",
    "HPPerMemberAdaptResult",
    "run_adaptive_dg_hp",
    "run_adaptive_dg_hp_per_member",
    "AdaptState",
    "AdaptResult",
    "FDPerMemberAdaptResult",
    "adapt_iteration",
    "backtrack_iteration",
    "run_adaptive_fd",
    "run_adaptive_fd_backtrack",
    "run_adaptive_fd_backtrack_padded",
    "run_adaptive_fd_per_member",
    "bisect_refine",
    "bisect_refine_masked",
    "bisect_refine_padded",
    "bisect_refine_padded_masked",
    "coarsen_merge",
    "coarsen_merge_padded",
    "pad_times",
]
