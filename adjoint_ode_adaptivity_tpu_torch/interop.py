"""Carry state across from the JAX package.

This system has no weights: the state two implementations must share is the
discretization, the advection operator bundle, the mixed-order DG-in-time
operator stack, and the gaussian-mixture ODE's constants (drawn from JAX's
PRNG in the JAX package). All are host float64 NumPy, so a JAX-package
``Discretization1D._asdict()`` or ``MixedDGTimeOperators._asdict()`` (all
NumPy) crosses over without loss, and the tests can feed both packages
bit-identical operators even where the port's own L0 builders are under
test.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators_from_numpy
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import MixedDGTimeOperators
from adjoint_ode_adaptivity_tpu_torch.odes import ODEProblem, gaussian_mixture_ode
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "discretization_from_numpy",
    "advec_operators_from_numpy",
    "gaussian_mixture_from_numpy",
    "mixed_operators_from_numpy",
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
