"""Training steps and states for nets trained through the differentiable
solver.

Counterpart of the JAX package's ``train/loop.py``. A step takes a
:class:`TrainState` and a batch and returns the next state and the loss:

- the **torch engine** (``make_*_train_step``): the loss over the batched
  march (march/fd.py), its gradient by autograd, one Adam update;
- the **cuda engine** (``make_*_train_step_fused``): the epoch's value and
  gradient in one call of a hand-written kernel, T1 (per-step
  ResBlockSimple, plain, masked or mixed loss; ops/cuda/train_fused.py) or
  T2 (the shared-parameter Dense chain; ops/cuda/train_dense_fused.py), then
  the same Adam update outside the kernel.

:class:`Adam` is ``optax.adam``'s update written out over tensors, in its
order of operations: m ← (1−b1)·g + b1·m, v ← (1−b2)·g² + b2·v, the count
up by one, m̂ = m / (1 − b1^count), v̂ = v / (1 − b2^count) (the corrections
formed in double and rounded to the moments' dtype), u = −lr · m̂ /
(√v̂ + eps) (eps outside the root), p ← p + u. The parameters are a dict of
tensors (the flax pytree) with the steps stacked first; so are the moments,
which width surgery zeroes slice by slice (models.surgery.zero_step_moments).

``mesh=`` on the four fused steps: a :class:`~..parallel.mesh.RankGrid`
whose ``mesh_axis`` (default ``"data"``) shards the members over ranks, as
the JAX package's ``mesh=`` shards them over devices under ``shard_map``.
The step takes the global batch, the same on every rank; each rank runs its
kernel on its contiguous block of members (B must divide over the axis),
then the loss and the gradient leaves, concatenated into one flat vector,
are summed over the ranks and divided by the rank count d: equal blocks
make the mean of the blocks' means the batch mean. The sum runs in rank
order, ((v₀ + v₁) + v₂) + …, on every rank (the blocks gathered, then
added), so every rank gets the same bits, and Adam then runs on every rank
on the same inputs: the parameters stay bit-identical across the ranks.
At one rank it is the unsharded step's bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march, forward_march_per_step
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import RankGrid, all_gather, shard_along
from adjoint_ode_adaptivity_tpu_torch.train.losses import mixed_ramp_weight
from adjoint_ode_adaptivity_tpu_torch.tree import tree_leaves, tree_map

__all__ = [
    "Adam",
    "AdamState",
    "TrainState",
    "create_train_state",
    "make_shared_train_step",
    "make_shared_train_step_fused",
    "make_per_step_train_step",
    "make_per_step_train_step_fused",
    "make_per_step_masked_train_step",
    "make_per_step_masked_train_step_fused",
    "make_mixed_loss_train_step",
    "make_mixed_loss_train_step_fused",
    "evaluate",
    "evaluate_masked",
    "value_and_grad",
]


class AdamState(NamedTuple):
    step: int  # optax's count
    exp_avg: Any  # first moments, a tree like the parameters
    exp_avg_sq: Any  # second moments


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` over trees of tensors (no eps_root,
    no Nesterov)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))

    def update(self, grads, state: AdamState, params):
        """(new_params, new_state)."""
        b1, b2 = self.b1, self.b2
        count = state.step + 1
        m = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state.exp_avg)
        v = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, state.exp_avg_sq)
        c1, c2 = 1 - b1**count, 1 - b2**count

        def step(p, mt, vt):
            upd = (mt / c1) / (torch.sqrt(vt / c2) + self.eps)
            return (p + (-self.lr) * upd).to(p.dtype)

        return tree_map(step, params, m, v), AdamState(count, m, v)


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: int


def create_train_state(params, tx: Adam) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def value_and_grad(loss_fn: Callable, params):
    """(loss, grads) of ``loss_fn(params)`` by autograd; gradients take
    each leaf's dtype, as in JAX."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def _update(tx: Adam, state: TrainState, grads) -> TrainState:
    params, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(params, opt_state, state.step + 1)


def _per_step_fn(net) -> Callable:
    return lambda u, t, dt, p: net(p, u, t, dt)


def _masked_step_fn(net) -> Callable:
    """Per-step fn of ResBlockSimpleMasked: the stacked pair is (params, n_active)."""
    return lambda u, t, dt, pm: net(pm[0], u, t, dt, pm[1])


def _traj(step_fn, u0s, dt, stacked):
    """Trajectories (S+1, B) of scalar-state members ``u0s`` (B,)."""
    return forward_march_per_step(step_fn, u0s[:, None], dt, stacked)[..., 0]


def _terminal_losses(traj, trues):
    return torch.square(traj[-1] - trues)


def make_shared_train_step(net, tx: Adam, dt: torch.Tensor):
    """Terminal-MSE step with one parameter set shared by every step:
    ``train_step(state, u0_batch, true_batch) -> (state, loss)``."""
    def loss_fn(params, u0s, trues):
        traj = forward_march(lambda u, t, d: net(params, u, t, d), u0s[:, None], dt)[..., 0]
        return torch.mean(_terminal_losses(traj, trues))

    def train_step(state: TrainState, u0_batch, true_batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, u0_batch, true_batch), state.params)
        return _update(tx, state, grads), loss

    return train_step


def make_per_step_train_step(net, tx: Adam):
    """Terminal-MSE step with per-step stacked parameters:
    ``train_step(state, dt, u0_batch, true_batch)``."""
    step_fn = _per_step_fn(net)

    def train_step(state: TrainState, dt, u0_batch, true_batch):
        loss, grads = value_and_grad(
            lambda p: torch.mean(_terminal_losses(_traj(step_fn, u0_batch, dt, p), true_batch)),
            state.params)
        return _update(tx, state, grads), loss

    return train_step


def make_per_step_masked_train_step(net, tx: Adam):
    """Per-step step of a padded-capacity masked net:
    ``train_step(state, dt, n_active, u0_batch, true_batch)``; inactive
    slots get exactly zero gradients through the mask."""
    step_fn = _masked_step_fn(net)

    def train_step(state: TrainState, dt, n_active, u0_batch, true_batch):
        loss, grads = value_and_grad(
            lambda p: torch.mean(_terminal_losses(
                _traj(step_fn, u0_batch, dt, (p, n_active)), true_batch)),
            state.params)
        return _update(tx, state, grads), loss

    return train_step


def _mixed_loss(traj, true_traj, dt, w):
    """mean_m Σ_n dt_n·(e²_n + e²_{n+1})/2 + w·mean_m e²_S, with
    ``true_traj`` (B, S+1) (Main_new_loss.py:153-168)."""
    e2 = torch.square(traj - true_traj.T)
    new_l = torch.tensordot(dt.to(e2.dtype), (e2[:-1] + e2[1:]) / 2.0, dims=([0], [0]))
    return torch.mean(new_l) + w * torch.mean(e2[-1])


def make_mixed_loss_train_step(net, tx: Adam):
    """Trajectory (trapezoid) loss plus the ramped terminal loss:
    ``train_step(state, dt, u0_batch, true_traj_batch (B, S+1), it)``."""
    step_fn = _per_step_fn(net)

    def train_step(state: TrainState, dt, u0_batch, true_traj_batch, it):
        w = mixed_ramp_weight(it)
        loss, grads = value_and_grad(
            lambda p: _mixed_loss(_traj(step_fn, u0_batch, dt, p), true_traj_batch, dt, w),
            state.params)
        return _update(tx, state, grads), loss

    return train_step


def _data_parallel(grad_fn: Callable, mesh: RankGrid | None, mesh_axis: str,
                   members: tuple[int, ...], member_dims: tuple[int, ...] | None = None):
    """``grad_fn(params, *args, **kw) -> (loss, grads)`` over this rank's
    members (module docstring): the arguments at the positions ``members``
    (counted after ``params``) shard along ``member_dims`` (default 0),
    the loss and the gradients are summed over the ranks in rank order and
    divided by the rank count. ``grad_fn`` itself at ``mesh=None``."""
    if mesh is None:
        return grad_fn
    if not isinstance(mesh, RankGrid):
        raise TypeError(f"mesh= takes a RankGrid (parallel.make_rank_grid), not {type(mesh)}")
    d = mesh.axis_size(mesh_axis)
    dims = dict(zip(members, member_dims or (0,) * len(members)))

    def run(params, *args, **kw):
        local = [shard_along(a, mesh, mesh_axis, dims[i]) if i in dims else a
                 for i, a in enumerate(args)]
        loss, grads = grad_fn(params, *local, **kw)
        leaves = tree_leaves(grads)
        flat = torch.cat([loss.reshape(1).to(leaves[0].dtype)]
                         + [g.reshape(-1) for g in leaves])
        parts = all_gather(flat[None], mesh, mesh_axis)
        total = parts[0]
        for part in parts[1:]:  # rank order, the same bits on every rank
            total = total + part
        total = total / d
        it, off = iter(leaves), 1

        def take(_):
            nonlocal off
            g = next(it)
            out = total[off:off + g.numel()].reshape(g.shape)
            off += g.numel()
            return out

        return total[0].to(loss.dtype), tree_map(take, grads)

    return run


def make_per_step_train_step_fused(tx: Adam, n_steps: int, features: int, device="cuda",
                                   mesh: RankGrid | None = None, mesh_axis: str = "data"):
    """:func:`make_per_step_train_step` for ResBlockSimple with the epoch's
    value and gradient in one call of T1 (float32); same signature.
    ``mesh`` shards the members over ranks (module docstring)."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.train_fused import (
        make_cuda_resblock_epoch_grad,
    )

    grad_fn = _data_parallel(make_cuda_resblock_epoch_grad(n_steps, features, device=device),
                             mesh, mesh_axis, members=(1, 2))

    def train_step(state: TrainState, dt, u0_batch, true_batch):
        loss, grads = grad_fn(state.params, dt, u0_batch, true_batch)
        return _update(tx, state, grads), loss

    return train_step


def make_per_step_masked_train_step_fused(tx: Adam, n_steps: int, capacity: int, device="cuda",
                                          mesh: RankGrid | None = None,
                                          mesh_axis: str = "data"):
    """:func:`make_per_step_masked_train_step` through T1 with the per-step
    ``n_active`` gating the neurons in the kernel; same signature.
    ``mesh`` shards the members over ranks (module docstring)."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.train_fused import (
        make_cuda_resblock_epoch_grad,
    )

    grad_fn = _data_parallel(
        make_cuda_resblock_epoch_grad(n_steps, capacity, masked=True, device=device),
        mesh, mesh_axis, members=(1, 2))

    def train_step(state: TrainState, dt, n_active, u0_batch, true_batch):
        loss, grads = grad_fn(state.params, dt, u0_batch, true_batch, n_active=n_active)
        return _update(tx, state, grads), loss

    return train_step


def make_mixed_loss_train_step_fused(tx: Adam, n_steps: int, features: int, device="cuda",
                                     mesh: RankGrid | None = None, mesh_axis: str = "data"):
    """:func:`make_mixed_loss_train_step` through T1's mixed variant (the
    trajectory targets go in as (S+1, B), the ramp weight as a scalar);
    same signature. ``mesh`` shards the members over ranks (module
    docstring)."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.train_fused import (
        make_cuda_resblock_epoch_grad,
    )

    grad_fn = _data_parallel(
        make_cuda_resblock_epoch_grad(n_steps, features, mixed=True, device=device),
        mesh, mesh_axis, members=(1, 2), member_dims=(0, 1))

    def train_step(state: TrainState, dt, u0_batch, true_traj_batch, it):
        loss, grads = grad_fn(state.params, dt, u0_batch, true_traj_batch.T,
                              ramp_weight=mixed_ramp_weight(it))
        return _update(tx, state, grads), loss

    return train_step


def make_shared_train_step_fused(tx: Adam, dt: torch.Tensor, sizes, device="cuda",
                                 mxu_dtype=torch.float32, mesh: RankGrid | None = None,
                                 mesh_axis: str = "data"):
    """:func:`make_shared_train_step` for ``ResNetBlock(sizes)`` with the
    epoch's value and gradient in one call of T2; same signature.
    ``mxu_dtype=torch.bfloat16`` selects the opt-in mixed-precision mode
    (bf16 hidden-product inputs on the tensor cores, f32 everything else),
    as the JAX package's (train/loop.py:113-145). ``mesh`` shards the
    members over ranks (module docstring)."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.train_dense_fused import (
        make_cuda_dense_epoch_grad,
    )

    grad_fn = _data_parallel(
        make_cuda_dense_epoch_grad(dt.shape[0], sizes, device=device, mxu_dtype=mxu_dtype),
        mesh, mesh_axis, members=(1, 2))

    def train_step(state: TrainState, u0_batch, true_batch):
        loss, grads = grad_fn(state.params, dt, u0_batch, true_batch)
        return _update(tx, state, grads), loss

    return train_step


@torch.no_grad()
def evaluate(net, params, dt, u0s, trues, per_step: bool = True):
    """Mean terminal MSE over an IC set, the reference's 'Error' metric
    (``metricCalc``, Main_no_matrix_detect_complex.py:176-182)."""
    if per_step:
        traj = _traj(_per_step_fn(net), u0s, dt, params)
    else:
        traj = forward_march(lambda u, t, d: net(params, u, t, d), u0s[:, None], dt)[..., 0]
    return torch.mean(_terminal_losses(traj, trues))


@torch.no_grad()
def evaluate_masked(net, params, n_active, dt, u0s, trues):
    """``evaluate`` for padded-capacity masked nets."""
    return torch.mean(_terminal_losses(_traj(_masked_step_fn(net), u0s, dt, (params, n_active)),
                                       trues))
