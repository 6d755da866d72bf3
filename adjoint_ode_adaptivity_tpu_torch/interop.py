"""Carry state across from the JAX package.

This system has no weights: the state two implementations must share is the
discretization and the advection operator bundle. Both are built on the host
in float64 NumPy, so a JAX-package ``Discretization1D._asdict()`` (all NumPy)
crosses over without loss, and the tests can feed both packages bit-identical
operators even where the port's own L0 builders are under test.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators_from_numpy
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = ["discretization_from_numpy", "advec_operators_from_numpy"]


def discretization_from_numpy(fields: Mapping) -> Discretization1D:
    """The port's :class:`Discretization1D` from a field mapping (e.g. the
    JAX package's ``disc._asdict()``): arrays are copied as NumPy arrays,
    integers stay integers. Raises ``KeyError`` on a missing field."""
    out = {}
    for name in Discretization1D._fields:
        value = fields[name]
        out[name] = np.array(value) if isinstance(value, np.ndarray) else value
    return Discretization1D(**out)
