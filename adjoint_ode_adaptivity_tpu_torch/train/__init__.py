"""Training through the differentiable solver (L4/L5)."""

from adjoint_ode_adaptivity_tpu_torch.train.adaptive import (
    PaddedAdaptiveState,
    ensemble_refinement_signal,
    make_padded_adaptive_trainer,
)
from adjoint_ode_adaptivity_tpu_torch.train.data import make_batches, rk4_truth, train_test_split
from adjoint_ode_adaptivity_tpu_torch.train.loop import (
    Adam,
    AdamState,
    TrainState,
    create_train_state,
    evaluate,
    evaluate_masked,
    make_mixed_loss_train_step,
    make_mixed_loss_train_step_fused,
    make_per_step_masked_train_step,
    make_per_step_masked_train_step_fused,
    make_per_step_train_step,
    make_per_step_train_step_fused,
    make_shared_train_step,
    make_shared_train_step_fused,
    value_and_grad,
)
from adjoint_ode_adaptivity_tpu_torch.train.losses import (
    mixed_ramp_weight,
    terminal_mse,
    trajectory_mse,
    trajectory_trapezoid,
)
from adjoint_ode_adaptivity_tpu_torch.train.metrics import MetricsLogger, StepTimer

__all__ = [
    "Adam",
    "AdamState",
    "TrainState",
    "PaddedAdaptiveState",
    "make_padded_adaptive_trainer",
    "ensemble_refinement_signal",
    "create_train_state",
    "value_and_grad",
    "make_shared_train_step",
    "make_shared_train_step_fused",
    "make_per_step_train_step",
    "make_per_step_train_step_fused",
    "make_per_step_masked_train_step_fused",
    "make_per_step_masked_train_step",
    "make_mixed_loss_train_step",
    "make_mixed_loss_train_step_fused",
    "evaluate",
    "evaluate_masked",
    "rk4_truth",
    "make_batches",
    "train_test_split",
    "terminal_mse",
    "trajectory_trapezoid",
    "trajectory_mse",
    "mixed_ramp_weight",
    "MetricsLogger",
    "StepTimer",
]
