"""Carry state across from the JAX package.

This system has no weights: the state two implementations must share is the
discretization, the advection operator bundle, and the gaussian-mixture
ODE's constants (drawn from JAX's PRNG in the JAX package). All are host
float64 NumPy, so a JAX-package ``Discretization1D._asdict()`` (all NumPy)
crosses over without loss, and the tests can feed both packages bit-identical
operators even where the port's own L0 builders are under test.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators_from_numpy
from adjoint_ode_adaptivity_tpu_torch.odes import ODEProblem, gaussian_mixture_ode
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "discretization_from_numpy",
    "advec_operators_from_numpy",
    "gaussian_mixture_from_numpy",
]


def discretization_from_numpy(fields: Mapping) -> Discretization1D:
    """The port's :class:`Discretization1D` from a field mapping (e.g. the
    JAX package's ``disc._asdict()``): arrays are copied as NumPy arrays,
    integers stay integers. Raises ``KeyError`` on a missing field."""
    out = {}
    for name in Discretization1D._fields:
        value = fields[name]
        out[name] = np.array(value) if isinstance(value, np.ndarray) else value
    return Discretization1D(**out)


def gaussian_mixture_from_numpy(u_m, u_s, t_m, t_s, c) -> ODEProblem:
    """The port's gaussian-mixture ODE from explicit constants (e.g. the JAX
    package's draws as NumPy arrays): ``c`` holds the u-mode weights, then
    the t-mode weights. The FD strand has no other parameters to carry."""
    return gaussian_mixture_ode(*(np.asarray(x, dtype=np.float64) for x in (u_m, u_s, t_m, t_s, c)))
