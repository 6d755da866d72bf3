"""The port's member-sharded ensembles over gloo ranks on the CPU
(parallel/ensemble.py, the ``mesh=`` of ``run_adaptive_dg_ensemble``,
``run_adaptive_dg_per_member`` and ``run_adaptive_fd_per_member``), against
the unsharded port and the JAX package.

One spawn per world size (1, 2 and 4 ranks, all started together): each
rank runs every case of tests/torch_ensemble_ranks.py on a grid of one
``data`` axis and writes the global results it got; the ranks meet through
a FileStore under ``tmp_path``. The JAX references and the unsharded port
are computed meanwhile. Each check:

- the four functions on seeded float64 inputs against JAX's on the
  conftest's CPU mesh of as many devices, to 1e-14 of the largest entry
  (the same float64 formulas; libm's sin and XLA's may differ by an ulp),
  the argmax equal, and every rank's results bit-equal;
- the loops (torch engine, B = 8, a few iterations; Newton fixed at 8
  steps, as JAX's own mesh tests fix it, so that a shard's Newton makes the
  same steps as the whole batch's): at world 1 the unsharded port's history
  bit for bit; at worlds 2 and 4 the same partitions, ``n_active`` and
  ``n_refining`` as the unsharded port, the values within 1e-12 in
  float64 and 32·ε₃₂ of each field's largest entry (of Σ|terms| for a
  field that is a sum) in float32 (the ranks add their sums in another
  order), the device loop bit-equal to the host
  loop, every rank the same history; in float64 against the JAX loops
  (their XLA engine, the engine of tests/test_device_loop.py's FD mesh
  test; the Pallas interpret mode would not fit this file's budget) under
  a ``Mesh`` of as many devices: the same partitions to 1e-12 (the bound
  of tests/test_device_loop.py:220-225), ``n_active`` equal, the values to
  1e-12;
- a study stopped after two iterations and resumed from its checkpoint
  (rank 0 writes, every rank reads) gives the straight run's decisions and
  values at every world, the iterations after the resume bit for bit;
- the refusals: B that does not divide over the ranks, a mesh that is not a
  RankGrid, a missing axis.
"""
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ensemble_ranks as ranks
from torch_rank_procs import kill_ranks, rank_logs
from adjoint_ode_adaptivity_tpu import odes as jodes
from adjoint_ode_adaptivity_tpu.adapt import dg_loop as jdg
from adjoint_ode_adaptivity_tpu.adapt import fd_loop as jfd
from adjoint_ode_adaptivity_tpu.march import euler_step as jeuler
from adjoint_ode_adaptivity_tpu.parallel import ensemble as jens
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop
from adjoint_ode_adaptivity_tpu_torch.parallel import (
    RankGrid,
    all_gather,
    all_reduce_sum,
    make_rank_grid,
    shard_along,
)

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

WORLDS = (1, 2, 4)
LOOPS = tuple(ranks.SETTINGS)
EPS32 = float(np.finfo(np.float32).eps)
ATOL64 = 1e-12
EXACT = ("times", "n_active", "n_refining")  # decisions: equal, not close


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _jax_functions(n):
    """JAX's four functions on the same inputs, on an n-device mesh."""
    u0, w = (jnp.asarray(x) for x in ranks.fn_inputs())
    a = jnp.float64(ranks.FN_A)

    def member_fn(u, aa):
        return jnp.stack([jnp.sin(aa * u), u * u])

    def step_errors(u, dt):
        out = []
        for _ in range(ranks.FN_STEPS):
            out.append(jnp.abs(jnp.sin(u) * jnp.cos(u)) * (0.5 * dt * dt))
            u = u + dt * jnp.sin(u)
        return jnp.stack(out)

    m = _mesh(n)
    vmap = np.asarray(jens.ensemble_vmap(member_fn, m)(u0, a))
    batched = np.asarray(jens.ensemble_batched(lambda u, s, ww: u * s + ww, m,
                                               shard_extras={1})(u0, a, w))
    mean = np.asarray(jens.ensemble_mean(member_fn, m)(u0, a))
    signal, arg = jens.ensemble_refinement_signal(step_errors, m)(u0, ranks.FN_DT)
    return {"vmap": vmap, "batched": batched, "mean": mean, "signal": np.asarray(signal),
            "argmax": int(arg)}


def _jax_loop(name, n):
    """JAX's loop ``name`` in float64 (XLA engine) under an n-device mesh."""
    y0s = ranks.loop_y0s()
    if name == "fd_per_member":
        step = jeuler(jodes.get_ode("du/dt=sin(u)").f)
        hist = jfd.run_adaptive_fd_per_member(step, y0s, ranks.SPAN, mesh=_mesh(n),
                                              **ranks.FD_PER_MEMBER)
    else:
        run = getattr(jdg, f"run_adaptive_{name}")
        hist = run(lambda u, t: jnp.sin(u), y0s, ranks.SPAN, mesh=_mesh(n),
                   **ranks.SETTINGS[name])
    return [{k: np.asarray(v) for k, v in r._asdict().items()} for r in hist]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> every rank's results; the JAX references, world -> case;
    the unsharded port's histories, case key -> history."""
    procs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"ens{world}")
        procs[world] = (tmp, [
            subprocess.Popen([sys.executable, ranks.__file__, str(tmp / "store"), str(world),
                              str(r), str(tmp)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    try:
        refs = {world: {"functions": _jax_functions(world),
                        **{name: _jax_loop(name, world) for name in LOOPS}}
                for world in WORLDS}
        port = {f"{name}/{tag}/{dl}": ranks.run_loop(name, None, dtype, device_loop=dl)
                for name in LOOPS for tag, dtype in ranks.DTYPES.items()
                for dl in (False, True)}
    except BaseException:  # the references failed: no rank outlives the fixture
        kill_ranks(procs)
        raise
    logs = rank_logs(procs, timeout=600)  # kills every rank on a timeout
    out = {}
    for world, (tmp, ps) in procs.items():
        for p, log in zip(ps, logs[world]):
            assert p.returncode == 0, log
        out[world] = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                out[world].append(pickle.load(fh))
    return out, refs, port


def _same(a, b):
    """Two histories (lists of dicts) equal bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


# the terms whose sum a field is: its float32 error scales with their
# magnitudes, not with the sum's (the sums cancel)
SUM_OF = {"est_total_mean": ("err_mean", None), "est_total": ("err", 1),
          "err_total": ("err_steps", 1)}


def _tol32(key, row):
    """32·ε₃₂ of the field's largest entry, or of Σ|terms| for a sum."""
    if key in SUM_OF:
        terms, axis = SUM_OF[key]
        return 32 * EPS32 * np.sum(np.abs(np.asarray(row[terms], np.float64)), axis=axis)
    return 32 * EPS32 * float(np.max(np.abs(np.asarray(row[key], np.float64))))


def _close(a, b, tol):
    """Equal decisions; each value field of a row within ``tol(key, row)``
    of the reference row's."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in y:
            got, want = np.asarray(x[k], np.float64), np.asarray(y[k], np.float64)
            if k in EXACT:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                bound = tol(k, y)
                assert np.all(np.abs(got - want) <= bound), (k, np.abs(got - want), bound)


@pytest.mark.parametrize("world", WORLDS)
def test_functions_match_jax(runs, world):
    got, refs, _ = runs
    want = refs[world]["functions"]
    for res in got[world]:
        fns = res["functions"]
        for key, ref in (("vmap_True", want["vmap"]), ("vmap_False", want["vmap"]),
                         ("batched", want["batched"]), ("mean", want["mean"]),
                         ("signal", want["signal"])):
            np.testing.assert_allclose(fns[key], ref, rtol=0,
                                       atol=1e-14 * float(np.max(np.abs(ref))), err_msg=key)
        assert fns["argmax"] == want["argmax"] == int(np.argmax(want["signal"]))
        for key in fns:  # every rank holds the same global results
            np.testing.assert_array_equal(fns[key], got[world][0]["functions"][key])


@pytest.mark.parametrize("name", LOOPS)
def test_world_one_is_the_unsharded_loop(runs, name):
    got, _, port = runs
    for tag in ranks.DTYPES:
        for dl in (False, True):
            key = f"{name}/{tag}/{dl}"
            _same(got[1][0][key], port[key])


@pytest.mark.parametrize("tag", list(ranks.DTYPES))
@pytest.mark.parametrize("name", LOOPS)
@pytest.mark.parametrize("world", (2, 4))
def test_sharded_loop_matches_the_unsharded_port(runs, world, name, tag):
    """The same decisions; the values within 1e-12 (float64) or 32·ε₃₂ of
    the field's largest entry (float32); the device loop bit-equal to the
    host loop; every rank the same history."""
    got, _, port = runs
    key = f"{name}/{tag}/False"
    _close(got[world][0][key], port[key], (lambda k, row: ATOL64) if tag == "f64" else _tol32)
    _same(got[world][0][f"{name}/{tag}/True"], got[world][0][key])
    for res in got[world][1:]:
        _same(res[key], got[world][0][key])
        _same(res[f"{name}/{tag}/True"], got[world][0][key])


@pytest.mark.parametrize("name", LOOPS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_loop_matches_jax_under_a_mesh(runs, world, name):
    got, refs, _ = runs
    _close(got[world][0][f"{name}/f64/False"], refs[world][name], lambda k, row: ATOL64)


@pytest.mark.parametrize("name", LOOPS)
@pytest.mark.parametrize("world", WORLDS)
def test_resume_from_a_checkpoint(runs, world, name):
    """Two iterations (maxit 1), saved by rank 0, then resumed on every rank
    to the study's maxit: the straight run's decisions and values, the
    iterations after the resume bit for bit. The two restored ones were
    padded to fewer elements, which may move a float64 sum by an ulp."""
    got, _, _ = runs
    for res in got[world]:
        resumed, straight = res[f"{name}/resumed"], res[f"{name}/f64/False"]
        _close(resumed, straight, lambda k, row: ATOL64)
        _same(resumed[2:], straight[2:])


@pytest.mark.parametrize("world", (2, 4))
def test_members_must_divide_over_the_ranks(runs, world):
    got, _, _ = runs
    for res in got[world]:
        assert res["refusals"] == [f"B={world + 1} must divide over {world} ranks of mesh "
                                   "axis 'data'"] * 3


def test_mesh_must_be_a_rank_grid_with_the_axis():
    sin = odes.get_ode("du/dt=sin(u)")
    y0s = ranks.loop_y0s()
    for run in (dg_loop.run_adaptive_dg_ensemble, dg_loop.run_adaptive_dg_per_member,
                fd_loop.run_adaptive_fd_per_member):
        with pytest.raises(TypeError, match="RankGrid"):
            run(sin.f, y0s, ranks.SPAN, mesh=_mesh(2), maxit=1, device="cpu")
        with pytest.raises(KeyError, match="'data' not in the grid's axes"):
            run(sin.f, y0s, ranks.SPAN, mesh=make_rank_grid({"space": 1}), maxit=1,
                device="cpu")


def test_one_rank_gathers_and_reduces_to_itself():
    """Without a process group: shard_along's block is everything,
    all_gather and all_reduce_sum along an axis are identities."""
    grid = make_rank_grid({"data": 1, "space": -1})
    assert isinstance(grid, RankGrid) and grid.world == 1
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(shard_along(x, grid, "data"), x)
    assert torch.equal(all_gather(shard_along(x, grid, "data"), grid, "data"), x)
    assert torch.equal(all_reduce_sum(x, grid, "data"), x)
    assert torch.equal(all_reduce_sum(x, grid), x)
