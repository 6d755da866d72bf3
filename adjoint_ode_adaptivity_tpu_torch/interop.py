"""Carry state across from the JAX package.

The state two implementations must share is the discretization, the
advection operator bundle, the mixed-order DG-in-time operator stack, the
gaussian-mixture ODE's constants (drawn from JAX's PRNG in the JAX package),
and the NN strand's parameters and Adam state. The first four are host
float64 NumPy, so a JAX-package ``Discretization1D._asdict()`` or
``MixedDGTimeOperators._asdict()`` (all NumPy) crosses over without loss,
and the tests can feed both packages bit-identical operators even where the
port's own L0 builders are under test. Flax parameter trees and optax's Adam
moments cross over as NumPy leaves, dtype for dtype, so a run can start (or
resume) from JAX's own draws and moments.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators_from_numpy
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import MixedDGTimeOperators
from adjoint_ode_adaptivity_tpu_torch.odes import ODEProblem, gaussian_mixture_ode
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D
from adjoint_ode_adaptivity_tpu_torch.train.loop import AdamState
from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

__all__ = [
    "discretization_from_numpy",
    "advec_operators_from_numpy",
    "gaussian_mixture_from_numpy",
    "mixed_operators_from_numpy",
    "resblock_params_from_numpy",
    "dense_params_from_numpy",
    "adam_state_from_numpy",
    "tree_to_numpy",
]


def _from_fields(cls, fields: Mapping):
    """``cls`` (a NamedTuple) from a field mapping: arrays are copied as
    NumPy arrays, integers stay integers. Raises ``KeyError`` on a missing
    field."""
    out = {}
    for name in cls._fields:
        value = fields[name]
        out[name] = np.array(value) if isinstance(value, np.ndarray) else value
    return cls(**out)


def discretization_from_numpy(fields: Mapping) -> Discretization1D:
    """The port's :class:`Discretization1D` from a field mapping (e.g. the
    JAX package's ``disc._asdict()``)."""
    return _from_fields(Discretization1D, fields)


def mixed_operators_from_numpy(fields: Mapping) -> MixedDGTimeOperators:
    """The port's mixed-order operator stack from a field mapping (e.g. the
    JAX package's ``dg_time_operators_mixed(n)._asdict()``), so a test can
    feed both packages the same tables and tell operator differences from
    solver differences."""
    return _from_fields(MixedDGTimeOperators, fields)


def gaussian_mixture_from_numpy(u_m, u_s, t_m, t_s, c) -> ODEProblem:
    """The port's gaussian-mixture ODE from explicit constants (e.g. the JAX
    package's draws as NumPy arrays): ``c`` holds the u-mode weights, then
    the t-mode weights. The FD strand has no other parameters to carry."""
    return gaussian_mixture_ode(*(np.asarray(x, dtype=np.float64) for x in (u_m, u_s, t_m, t_s, c)))


def _leaf(x, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def resblock_params_from_numpy(params: Mapping, device=None) -> dict:
    """ResBlockSimple(Masked) parameters ({'bias', 'weights1', 'weights2'},
    stacked over steps or not; e.g. a flax params dict as NumPy) as the
    port's dict of tensors, dtypes kept."""
    keys = ("bias", "weights1", "weights2")
    if set(params) != set(keys):
        raise KeyError(f"expected the keys {keys}, got {sorted(params)}")
    out = {k: _leaf(params[k], device) for k in keys}
    f = out["bias"].shape[-2]
    if out["weights1"].shape != out["bias"].shape or out["weights2"].shape[-1] != f:
        raise ValueError(f"inconsistent shapes {[tuple(v.shape) for v in out.values()]}")
    return out


def dense_params_from_numpy(params: Mapping, device=None) -> dict:
    """The Dense chain's flax parameters ({'Dense_i': {'kernel', 'bias'}})
    as the port's nested dict of tensors, dtypes kept."""
    n = len(params)
    names = [f"Dense_{i}" for i in range(n)]
    if sorted(params) != sorted(names):
        raise KeyError(f"expected {names}, got {sorted(params)}")
    return {k: {leaf: _leaf(params[k][leaf], device) for leaf in ("kernel", "bias")}
            for k in names}


def adam_state_from_numpy(count, mu, nu, device=None) -> AdamState:
    """optax's ``ScaleByAdamState(count, mu, nu)`` (leaves as NumPy) as the
    port's :class:`~adjoint_ode_adaptivity_tpu_torch.train.loop.AdamState`:
    the count is the step, mu and nu the moments, same tree as the
    parameters."""
    conv = lambda x: _leaf(x, device)  # noqa: E731
    return AdamState(int(np.asarray(count)), tree_map(conv, _plain(mu)), tree_map(conv, _plain(nu)))


def _plain(tree):
    """Mappings (e.g. flax FrozenDicts) as plain dicts."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def tree_to_numpy(tree):
    """A tree of tensors as a tree of NumPy arrays (the way back); an
    :class:`AdamState` becomes (count, mu, nu)."""
    if isinstance(tree, AdamState):
        return (tree.step, tree_to_numpy(tree.exp_avg), tree_to_numpy(tree.exp_avg_sq))
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    tree)
