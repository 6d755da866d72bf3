"""The port imports torch and NumPy, never jax: import every module of
``adjoint_ode_adaptivity_tpu_torch`` in a fresh interpreter and check that
jax never entered ``sys.modules``."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
import adjoint_ode_adaptivity_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "adjoint_ode_adaptivity_tpu_torch.drivers.advec_dg" in names, names
assert "adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs" in names, names
for mod in ("odes", "functionals", "march.fd", "adjoint.discrete", "adjoint.estimate",
            "adapt.policy", "adapt.fd_loop", "ops.fast_trig", "ops.cuda.fd_ensemble",
            "drivers.fd_adaptive", "march.dg_time", "adjoint.dg_time", "march.dg_batched",
            "ops.cuda.dg_slab", "adapt.dg_loop", "drivers.dg_adaptive", "march.dg_mixed",
            "adjoint.dg_mixed", "ops.cuda.dg_slab_mixed", "adapt.hp_loop", "models",
            "models.blocks", "models.surgery", "train", "train.loop", "train.adaptive",
            "train.data", "train.losses", "train.metrics", "train.checkpoint", "tree",
            "ops.cuda.train_fused", "ops.cuda.train_dense_fused", "drivers.train_resnet_ode",
            "ops.limiters", "march.burgers", "ops.cuda.burgers", "drivers.burgers_dg",
            "adjoint.checkpointing", "adjoint.revolve_vjp", "ops.cuda.dg_tiled",
            "ops.cuda.dg_mxu", "ops.cuda.dg_sharded", "parallel", "parallel.mesh",
            "parallel.dg_shard"):
    assert "adjoint_ode_adaptivity_tpu_torch." + mod in names, (mod, names)
# the entry points exported lazily resolve
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import make_cuda_fwd_adj_estimate_grid_mxu
from adjoint_ode_adaptivity_tpu_torch.parallel import make_cuda_fwd_adj_estimate_sharded_blocked
# the revolve planner loads the checkout's native/librevolve.so, never the
# JAX package's installed copy under adjoint_ode_adaptivity_tpu/_native
from adjoint_ode_adaptivity_tpu_torch.adjoint.checkpointing import plan_schedule
assert plan_schedule(10, 3)
maps = open("/proc/self/maps").read()
assert "adjoint_ode_adaptivity_tpu/_native" not in maps
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "adjoint_ode_adaptivity_tpu.")) or m == "adjoint_ode_adaptivity_tpu")
assert not bad, bad
print(len(names))
"""


def test_port_never_imports_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 60


@pytest.mark.parametrize("module", ["ops.cuda.dg_rhs", "ops.cuda.burgers", "march", "adjoint",
                                    "adjoint.revolve_vjp", "drivers.burgers_dg",
                                    "ops.cuda.dg_tiled", "adapt.advec_loop", "ops.cuda.dg_mxu",
                                    "ops.cuda.dg_sharded", "parallel"])
def test_each_entry_module_imports_first(module):
    """Imported first in a fresh interpreter, each module loads: the
    packages ``march`` and ``adjoint`` import each other's modules, so an
    import order that none of the other tests takes can meet a partly
    initialised module."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import adjoint_ode_adaptivity_tpu_torch.{module}"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_package_data_ships_every_included_source():
    # every `#include "..."` in csrc/ must name a file that the package-data
    # globs of pyproject.toml ship, or an installed copy cannot build
    import fnmatch
    import re
    import tomllib

    conf = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["adjoint_ode_adaptivity_tpu_torch"]
    csrc = REPO / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    shipped = {f"csrc/{p.name}" for p in csrc.iterdir()
               if any(fnmatch.fnmatch(f"csrc/{p.name}", g) for g in globs)}
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert {f"csrc/{p.name}" for p in sources} <= shipped
    includes = {m for p in sources for m in re.findall(r'#include "([^"]+)"', p.read_text())}
    assert {"odes.cuh", "small_solve.cuh", "dg_stage.cuh"} <= includes
    # a user library's generated functors (ops/cuda/functor.py), written
    # beside the library at build time (ops/cuda load_user_library)
    includes.remove("aoa_user_functors.cuh")
    for name in includes:
        assert f"csrc/{name}" in shipped, name
