"""Adaptive refinement loops (L3)."""

from adjoint_ode_adaptivity_tpu_torch.adapt.advec_loop import (
    AdvecAdaptResult,
    run_adaptive_advec,
)

__all__ = ["AdvecAdaptResult", "run_adaptive_advec"]
