"""Discretization export/import: the ``Save_to_1D_global_data.m`` bridge.

Counterpart of the JAX package's ``ops/io.py``. The reference dumps all DG
globals (Dr, LIFT, vmaps, rk4 coefficients, …) to text files as a
MATLAB→Python data bridge (utils/Save_to_1D_global_data.m). Here the whole
:class:`Discretization1D` (host NumPy) round-trips through one ``.npz``
(plus optional per-field ``.txt`` for eyeballing and diffing against the
MATLAB dumps). The keys and the LSRK coefficients are the JAX package's,
so a file that either package writes loads in the other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = ["save_discretization", "load_discretization"]

_SCALARS = ("n", "np_", "k", "map_i", "map_o", "vmap_i", "vmap_o")


def save_discretization(disc: Discretization1D, path: str | Path, text: bool = False) -> Path:
    """Write the discretization (+ LSRK coefficients) to ``path`` (.npz)."""
    path = Path(path)
    data = disc._asdict()
    data.update(rk4a=RK4A, rk4b=RK4B, rk4c=RK4C)
    np.savez(path, **data)
    if text:
        txt_dir = path.with_suffix("")
        txt_dir.mkdir(exist_ok=True)
        for name, val in data.items():
            np.savetxt(txt_dir / f"{name}.txt", np.atleast_2d(val))
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def load_discretization(path: str | Path) -> Discretization1D:
    with np.load(Path(path)) as data:
        fields = {}
        for name in Discretization1D._fields:
            val = data[name]
            fields[name] = int(val) if name in _SCALARS else val
    return Discretization1D(**fields)
