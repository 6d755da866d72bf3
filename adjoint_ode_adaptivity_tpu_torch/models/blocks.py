"""Residual blocks used as ODE update rules (one block ≡ one time step).

Counterpart of the JAX package's ``models/blocks.py`` (reference
python/models.py). Each module holds its hyperparameters; its parameters are
a plain dict of tensors with the flax names and shapes, passed to
``forward(params, u, t, dt)``, so per-step parameters stack along a leading
axis and depth and width surgery (models/surgery.py) are tensor scatters:

- ``ResBlockSimple(F)``: ``u + W2 @ relu(W1 ⊙ (u − b))·dt`` with ``bias``
  (F, d), ``weights1`` (F, d), ``weights2`` (d, F); the biases are sorted
  knots in u (models.py:38-65).
- ``ResBlockSimpleMasked(capacity)``: the same at a fixed neuron capacity
  with a per-call active count; inactive slots contribute nothing and get
  exactly zero gradients.
- ``ResBlock``, ``ResNetBlock`` (the Dense chain ``{'Dense_i': {'kernel',
  'bias'}}``), ``ResNetODE``, ``SingleNeuronLayers``.

Initialisation draws from an explicit ``torch.Generator``: flax's
``lecun_normal`` (a normal truncated at ±2σ, variance 1/fan_in with fan_in
the second-to-last axis) and zero Dense biases. The values differ from
JAX's for the same seed; tests carry JAX's parameters across
(interop.py). Mixed dtypes promote as in JAX: float32 parameters applied to
a float64 state compute in float64.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march_per_step

__all__ = [
    "lecun_normal",
    "sorted_bias_init",
    "SingleNeuronLayers",
    "ResBlockSimple",
    "ResBlockSimpleMasked",
    "masked_params_from_simple",
    "ResBlock",
    "ResNetBlock",
    "ResNetODE",
    "resnet_ode_apply",
]

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at ±2


def lecun_normal(shape, generator: torch.Generator | None = None, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in, fan_in =
    ``shape[-2]`` times the receptive field (leading axes)."""
    fan_in = shape[-2] * math.prod(shape[:-2]) if len(shape) >= 2 else shape[0]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    out = torch.empty(shape, dtype=dtype)  # drawn on the host: a CPU generator
    return nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator).to(device)


def sorted_bias_init(shape, generator=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """Lecun-normal knots sorted ascending over the whole array (models.py:15-16)."""
    return torch.sort(lecun_normal(shape, generator, dtype, device).reshape(-1)).values.reshape(shape)


def _state(u):
    """(u_in, u): ``u`` at least 1-d, as ``jnp.atleast_1d``."""
    u_in = torch.as_tensor(u)
    return u_in, (u_in if u_in.dim() >= 1 else u_in.reshape(1))


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """flax ``Dense``: ``x @ kernel + bias`` in the promoted dtype."""
    dt = torch.promote_types(x.dtype, p["kernel"].dtype)
    return x.to(dt) @ p["kernel"].to(dt) + p["bias"].to(dt)


def _knots(params: dict, u: torch.Tensor, mask=None) -> torch.Tensor:
    """``W2 @ (mask ⊙ relu(W1 ⊙ (u − b)))`` for u (..., d)."""
    f = torch.relu(params["weights1"] * (u[..., None, :] - params["bias"]))  # (..., F, d)
    if mask is not None:
        f = mask.to(f.dtype)[:, None] * f
    return torch.einsum("df,...fd->...d", params["weights2"].to(f.dtype), f)


class SingleNeuronLayers(nn.Module):
    """A chain of scalar residual layers f ← f + act(w·f + b), returning the
    value after every layer."""

    def __init__(self, layers: int = 1, activation: Callable = torch.relu):
        super().__init__()
        self.layers, self.activation = layers, activation

    def init_params(self, generator=None, dtype=torch.float32, device=None) -> dict:
        return {"weight": lecun_normal((self.layers, 1, 1), generator, dtype, device),
                "bias": torch.zeros((self.layers, 1, 1), dtype=dtype, device=device)}

    def forward(self, params, inputs):
        f = torch.squeeze(torch.as_tensor(inputs))
        outs = [f]
        for w, b in zip(params["weight"], params["bias"]):
            f = f + self.activation(torch.squeeze(w) * f + torch.squeeze(b))
            outs.append(f)
        return torch.stack(outs)


class ResBlockSimple(nn.Module):
    """u_{n+1} = u_n + W2 @ relu(W1 ⊙ (u_n − b))·dt with explicit knots."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features

    def init_params(self, generator=None, d: int = 1, dtype=torch.float32, device=None) -> dict:
        f = self.features
        return {"bias": sorted_bias_init((f, d), generator, dtype, device),
                "weights1": lecun_normal((f, d), generator, dtype, device),
                "weights2": lecun_normal((d, f), generator, dtype, device)}

    def forward(self, params, u, t, dt):
        u_in, u = _state(u)
        return (u + _knots(params, u) * dt).reshape(u_in.shape)


class ResBlockSimpleMasked(nn.Module):
    """``ResBlockSimple`` at a fixed neuron ``capacity``; ``n_active`` gates
    ``m = arange(capacity) < n_active``: inactive slots contribute nothing
    and, since the mask multiplies the activation, get exactly zero
    gradients, so width growth is an in-place scatter."""

    def __init__(self, capacity: int):
        super().__init__()
        self.capacity = capacity

    def init_params(self, generator=None, d: int = 1, dtype=torch.float32, device=None) -> dict:
        return ResBlockSimple(self.capacity).init_params(generator, d, dtype, device)

    def forward(self, params, u, t, dt, n_active):
        u_in, u = _state(u)
        mask = torch.arange(self.capacity, device=u.device) < n_active
        return (u + _knots(params, u, mask) * dt).reshape(u_in.shape)


def masked_params_from_simple(simple_params: dict, capacity: int) -> dict:
    """``ResBlockSimple(width)`` parameters embedded in a capacity-``capacity``
    masked net: the active prefix bit for bit, zero (inert) padding."""
    f = simple_params["bias"].shape[-2]
    pad = capacity - f
    if pad < 0:
        raise ValueError(f"capacity={capacity} < width={f}")
    rows = lambda x: nn.functional.pad(x, (0, 0, 0, pad))  # noqa: E731
    return {"bias": rows(simple_params["bias"]), "weights1": rows(simple_params["weights1"]),
            "weights2": nn.functional.pad(simple_params["weights2"], (0, pad))}


class ResBlock(nn.Module):
    """u_{n+1} = u_n + Dense→elu→Dense(u_n)·dt."""

    def __init__(self, feature_size: int, activation: Callable = nn.functional.elu):
        super().__init__()
        self.feature_size, self.activation = feature_size, activation

    def init_params(self, generator=None, d: int = 1, dtype=torch.float32, device=None) -> dict:
        return _dense_chain_init((d, self.feature_size, d), generator, dtype, device)

    def forward(self, params, u, t, dt):
        u_in, u = _state(u)
        f = _dense(self.activation(_dense(u, params["Dense_0"])), params["Dense_1"])
        return (u + f * dt).reshape(u_in.shape)


def _dense_chain_init(widths, generator, dtype, device) -> dict:
    return {f"Dense_{i}": {"kernel": lecun_normal((a, b), generator, dtype, device),
                           "bias": torch.zeros((b,), dtype=dtype, device=device)}
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}


class ResNetBlock(nn.Module):
    """u_{n+1} = u_n + MLP(u_n)·dt through the hidden widths ``size``
    (the Dense chain of Main_FD_with_net.py:52-57)."""

    def __init__(self, size: Sequence[int] | int, activation: Callable = torch.relu):
        super().__init__()
        self.sizes = (size,) if isinstance(size, int) else tuple(size)
        self.activation = activation

    def init_params(self, generator=None, d: int = 1, dtype=torch.float32, device=None) -> dict:
        return _dense_chain_init((d, *self.sizes, d), generator, dtype, device)

    def forward(self, params, u, t, dt):
        u_in, u = _state(u)
        f = u
        for i in range(len(self.sizes)):
            f = self.activation(_dense(f, params[f"Dense_{i}"]))
        f = _dense(f, params[f"Dense_{len(self.sizes)}"])
        return (u + f * dt).reshape(u_in.shape)


class ResNetODE(nn.Module):
    """One ``ResNetBlock(width)`` per time step (depth ≡ the time grid, ``dt``
    given at call time); returns the whole trajectory (S+1, *shape(u0))."""

    def __init__(self, width: int, activation: Callable = torch.relu):
        super().__init__()
        self.block = ResNetBlock(width, activation)

    def init_params(self, n_steps: int, generator=None, d: int = 1, dtype=torch.float32,
                    device=None) -> dict:
        per_step = [self.block.init_params(generator, d, dtype, device) for _ in range(n_steps)]
        return {k: {leaf: torch.stack([p[k][leaf] for p in per_step]) for leaf in per_step[0][k]}
                for k in per_step[0]}

    def forward(self, params, u0, dt):
        _, u0 = _state(u0)
        return resnet_ode_apply(self.block, params, u0, dt)


def resnet_ode_apply(net: nn.Module, params, u_0, dt):
    """Full-trajectory apply of a per-step net over stacked parameters."""
    return forward_march_per_step(lambda u, t, d, p: net(p, u, t, d), u_0, dt, params)
