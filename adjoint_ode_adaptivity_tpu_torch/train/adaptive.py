"""Adaptive training at a fixed padded depth, and the ensemble refinement
signal it (and the ``train_resnet_ode`` driver) refines by.

Counterpart of the JAX package's ``train/adaptive.py``. The stacked
parameters and the time grid are allocated at ``max_depth`` up front:
padded steps have dt = 0, so they are exact identities whose parameters get
exactly zero gradients and which Adam leaves untouched; a depth insertion is
the static-shape shift of ``models.surgery.insert_step_params_padded`` on
the parameters (copy-left) and on the Adam moments (zeros: fresh state).
Both engines compose with the padding: ``train_engine="torch"`` (autograd)
and ``"cuda"`` (T1, ops/cuda/train_fused.py).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch.adapt.policy import bisect_refine_padded, pad_times
from adjoint_ode_adaptivity_tpu_torch.adjoint.discrete import adjoint_march_per_step
from adjoint_ode_adaptivity_tpu_torch.adjoint.estimate import (
    coarse_indicator,
    interp_to_fine,
    refine_all,
    residual,
)
from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march_per_step
from adjoint_ode_adaptivity_tpu_torch.models.surgery import insert_step_params_padded
from adjoint_ode_adaptivity_tpu_torch.train.loop import (
    Adam,
    TrainState,
    create_train_state,
    make_per_step_train_step,
    make_per_step_train_step_fused,
)
from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

__all__ = ["PaddedAdaptiveState", "make_padded_adaptive_trainer", "ensemble_refinement_signal"]


def ensemble_refinement_signal(step_fn: Callable, params_stacked, dt: torch.Tensor, rf: int,
                               u0s: torch.Tensor, trues: torch.Tensor) -> torch.Tensor:
    """Mean per-coarse-step error indicator over the IC ensemble
    (Main_variable_params.py:330-341): per member, the forward march on
    ``dt``, its linear interpolation to the rf-refined grid, the discrete
    adjoint there for J = |u_N − true| (cotangent sign(u_N − true) at the last
    node), the fine one-step residual, and the block indicator |Σ res·v|
    per coarse step; then the mean over members. ``step_fn(u, t, dt, p_n)``
    with ``params_stacked`` a tree of leaves with the step axis first (for
    the masked net, the pair (params, n_active)). Members are the batch
    axis throughout."""
    dt_f = refine_all(dt, rf)
    fine = tree_map(lambda l: torch.repeat_interleave(l, rf, dim=0), params_stacked)
    u = forward_march_per_step(step_fn, u0s[:, None], dt, params_stacked)[..., 0]
    u_f = interp_to_fine(u, dt, dt_f)  # (N·rf + 1, B)
    k_vec = torch.zeros_like(u_f)
    d = u_f[-1] - trues
    # d|d|/dd is +1 at a tie, as jax.grad(jnp.abs) gives (torch.sign gives 0)
    k_vec[-1] = torch.where(d >= 0, 1.0, -1.0).to(u_f.dtype)
    v = adjoint_march_per_step(step_fn, u_f[..., None], dt_f, k_vec[..., None], fine)
    res = residual(step_fn, u_f[..., None], dt_f, params_stacked=fine)
    return torch.mean(coarse_indicator((res * v)[..., 0], rf, "block"), dim=1)


class PaddedAdaptiveState(NamedTuple):
    train: TrainState
    times: torch.Tensor  # (max_depth+1,) padded node times
    n_active: torch.Tensor  # active steps


def make_padded_adaptive_trainer(net, tx: Adam, *, max_depth: int, ref_factor: int = 4,
                                 train_engine: str = "torch", device="cuda"):
    """Returns (init, train_step, refine), every shape fixed over the run:

    init(params_one_step, times0) -> PaddedAdaptiveState
    train_step(state, u0_batch, true_batch) -> (state, loss)
    refine(state, u0_sig, true_sig) -> (state, err_steps, err_total)

    ``train_engine="cuda"`` (ResBlockSimple nets) runs each epoch through T1
    on ``device``; ``"torch"`` through autograd."""
    if train_engine == "cuda":
        base_step = make_per_step_train_step_fused(tx, max_depth, net.features, device=device)
    elif train_engine == "torch":
        base_step = make_per_step_train_step(net, tx)
    else:
        raise ValueError(f"unknown train_engine {train_engine!r}")

    def net_step(u, t, d, p):
        return net(p, u, t, d)

    def init(params_one_step, times0) -> PaddedAdaptiveState:
        times, n_active = pad_times(torch.as_tensor(times0), max_depth + 1)
        stacked = tree_map(lambda l: torch.stack([l] * max_depth), params_one_step)
        return PaddedAdaptiveState(create_train_state(stacked, tx), times, n_active)

    def train_step(state: PaddedAdaptiveState, u0_batch, true_batch):
        tr, loss = base_step(state.train, torch.diff(state.times), u0_batch, true_batch)
        return state._replace(train=tr), loss

    def refine(state: PaddedAdaptiveState, u0_sig, true_sig):
        dt = torch.diff(state.times)
        with torch.no_grad():
            err_steps = ensemble_refinement_signal(net_step, state.train.params, dt, ref_factor,
                                                   u0_sig, true_sig)
        times_new, n_active_new = bisect_refine_padded(state.times, state.n_active, err_steps)
        idx = torch.argmax(err_steps) + 1
        params = insert_step_params_padded(state.train.params, state.n_active, idx,
                                           depth=max_depth)
        opt = state.train.opt_state
        moments = [insert_step_params_padded(m, state.n_active, idx, depth=max_depth,
                                             fill="zero") for m in (opt.exp_avg, opt.exp_avg_sq)]
        new = PaddedAdaptiveState(TrainState(params, opt._replace(exp_avg=moments[0],
                                                                  exp_avg_sq=moments[1]),
                                             state.train.step), times_new, n_active_new)
        return new, err_steps, torch.sum(err_steps)

    return init, train_step, refine
