"""The port's element-sharded advection over gloo ranks on the CPU
(parallel/mesh.py, parallel/dg_shard.py, ops/cuda/dg_sharded.py), against
the port's single-process pipelines and the JAX package.

One spawn per world size (1, 2 and 4 ranks, all started together): each
rank runs every case of tests/torch_parallel_ranks.py on its share and
returns its arrays through a file; the ranks meet through a FileStore under
``tmp_path`` (no TCP port: the tests run under xdist). World 1 runs without
a process group, where every exchange is the identity.

- ``dg_shard``'s march and pipeline in float64 against JAX's
  ``advec_march_sharded`` / ``advec_fwd_adj_estimate_sharded`` on the
  conftest's 8-device CPU mesh, at tests/test_parallel.py's rtol 1e-10
  (absolute floors 1e-12·max|x|: an entry near 0 keeps the roundoff of
  the largest), and equal to the single-device port at world 1;
- the two sharded factories through the plain KT1/KT2, bit-equal to the
  port's single-process tiled pipeline at every world size, a segment-2
  4-rank case included (tests/test_pallas_sharded.py:153-172's regime);
- the factories against JAX's two sharded factories in interpret mode at
  tests/test_pallas_sharded.py's sizes and tolerances (u 1e-6, λ 1e-5,
  η 1e-6 absolute, |J − Σλ·u| < 1e-4 for the blocked pipeline; 3e-6 for u
  and η of the grid pipeline, λ 1e-5);
- J within (Np·L + D)·ε₃₂·Σ|λ·u| of Σ λ·u in float64 (the summation
  bound of a local float32 sum of Np·L terms and a D-term all-reduce);
- the factories' and the rank grid's validation errors.
"""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from torch_rank_procs import kill_ranks, rank_logs
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_sharded, dg_tiled
from adjoint_ode_adaptivity_tpu_torch.parallel import (
    RankGrid,
    advec_march_sharded,
    exchange,
    make_rank_grid,
    replicate,
    shard_along,
)

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

WORLDS = (1, 2, 4)
EPS32 = float(np.finfo(np.float32).eps)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("space",))


JAX_FACTORY_CASES = (("blocked", 4), ("grid_seg2", 4))


def _jax_dg_shard():
    """JAX's dg_shard march and pipeline (float64, 8-device mesh)."""
    from adjoint_ode_adaptivity_tpu.march.advec import advec_operators
    from adjoint_ode_adaptivity_tpu.ops import startup_1d
    from adjoint_ode_adaptivity_tpu.parallel import (
        advec_fwd_adj_estimate_sharded as jax_pipeline,
        advec_march_sharded as jax_march,
    )

    c = ranks.SHARD_MARCH
    disc = startup_1d(c["n_order"], 0.0, 2 * np.pi, c["k"])
    ops = advec_operators(disc, a=ranks.A, dtype=jnp.float64)
    march = jax_march(ops, _mesh(8), jnp.asarray(np.sin(disc.x)), c["dt"], c["n_steps"])
    c = ranks.SHARD_PIPE
    _, dt, u0, lam = ranks.problem(c["k"], c["n_order"], torch.float64, c["seed"])
    pipe = jax_pipeline(ops, _mesh(8), jnp.asarray(u0.numpy()), jnp.asarray(lam.numpy()), dt,
                        c["n_steps"], segment=c["segment"], t0=0.1)
    return np.asarray(march), [np.asarray(x) for x in pipe]


def _jax_factory(name, n_dev):
    """JAX's sharded factory of a case in interpret mode on ``n_dev`` devices."""
    from adjoint_ode_adaptivity_tpu.ops import startup_1d
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_sharded import (
        make_pallas_fwd_adj_estimate_sharded_blocked,
    )
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_tiled_sharded import (
        make_pallas_fwd_adj_estimate_tiled_grid_sharded,
    )

    _, _, k, seg, n_seg, chunks = next(c for c in ranks.FACTORY_CASES if c[0] == name)
    _, dt, u0, lam = ranks.problem(k)
    disc = startup_1d(2, 0.0, 2 * np.pi, k)
    if chunks is None:
        run = make_pallas_fwd_adj_estimate_sharded_blocked(
            disc, ranks.A, dt, _mesh(n_dev), segment=seg, n_segments=n_seg, interpret=True)
    else:
        run = make_pallas_fwd_adj_estimate_tiled_grid_sharded(
            disc, ranks.A, dt, _mesh(n_dev), segment=seg, n_segments=n_seg,
            chunks=chunks // n_dev, interpret=True)
    return [np.asarray(x) for x in run(jnp.asarray(u0.numpy()), jnp.float32(0.0),
                                       jnp.asarray(lam.numpy()))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs, world -> {case key: the ranks' shares joined
    along the element axis, or the list of every rank's J}, and the JAX
    references, computed while the ranks run."""
    procs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        procs[world] = (tmp, [
            subprocess.Popen([sys.executable, ranks.__file__, str(tmp / "store"), str(world),
                              str(r), str(tmp)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    try:
        jax_refs = {"dg_shard": _jax_dg_shard(),
                    **{case: _jax_factory(*case) for case in JAX_FACTORY_CASES}}
    except BaseException:  # the references failed: no rank outlives the fixture
        kill_ranks(procs)
        raise
    logs = rank_logs(procs, timeout=600)  # kills every rank on a timeout
    out = {}
    for world, (tmp, ps) in procs.items():
        for p, log in zip(ps, logs[world]):
            assert p.returncode == 0, log
        parts = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
        out[world] = {key: ([float(x[key]) for x in parts] if key.endswith("_j")
                            else np.concatenate([x[key] for x in parts], axis=-1))
                      for key in parts[0]}
    return out, jax_refs


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-2 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("world", WORLDS)
def test_dg_shard_matches_jax_f64(runs, world):
    march, (uf, lam0, eta, j) = runs[1]["dg_shard"]
    got = runs[0][world]
    _close(got["march"], march, 1e-10)
    for key, want in (("u_final", uf), ("lam0", lam0), ("eta", eta)):
        _close(got[f"pipe_{key}"], want, 1e-10)
    assert all(abs(x - float(j)) <= 1e-10 * abs(float(j)) for x in got["pipe_j"])


def test_dg_shard_at_one_rank_is_the_single_device_port(runs):
    """No process group: the sharded march is the port's ``advec_march``
    bit for bit, and the pipeline its ``advec_fwd_adj_estimate`` (the
    transpose by autograd instead of the written-out one: 1e-12)."""
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import advec_fwd_adj_estimate
    from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_march, advec_operators
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    c = ranks.SHARD_MARCH
    disc = startup_1d(c["n_order"], 0.0, 2 * np.pi, c["k"])
    ops = advec_operators(disc, a=ranks.A, dtype=torch.float64, device="cpu")
    u0 = torch.tensor(np.sin(disc.x))
    want = advec_march(ops, u0, c["dt"], c["n_steps"])
    sharded = runs[0]
    assert np.array_equal(sharded[1]["march"], want.numpy())
    grid = make_rank_grid()
    assert torch.equal(advec_march_sharded(ops, grid, u0, c["dt"], 3), advec_march(ops, u0, c["dt"], 3))
    c = ranks.SHARD_PIPE
    disc, dt, u0, lam = ranks.problem(c["k"], c["n_order"], torch.float64, c["seed"])
    ops = advec_operators(disc, a=ranks.A, dtype=torch.float64, device="cpu")
    ref = advec_fwd_adj_estimate(ops, disc, u0, dt, c["n_steps"], segment=c["segment"], t0=0.1,
                                 lam_end=lam)
    for key, want in zip(("u_final", "lam0", "eta"), ref[:3]):
        _close(sharded[1][f"pipe_{key}"], want.numpy(), 1e-12)


@functools.cache
def _single_process(name):
    """The port's single-process tiled pipeline on a case's inputs."""
    _, factory, k, seg, n_seg, chunks = next(c for c in ranks.FACTORY_CASES if c[0] == name)
    disc, dt, u0, lam = ranks.problem(k)
    if chunks is None:
        run = dg_tiled.make_cuda_fwd_adj_estimate_tiled(disc, ranks.A, dt, segment=seg,
                                                        n_segments=n_seg, chunks=1, device="cpu")
    else:
        run = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
            disc, ranks.A, dt, segment=seg, n_segments=n_seg, chunks=chunks, device="cpu")
    return [x.numpy() for x in run(u0, 0.0, lam)], u0.numpy(), lam.numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in ranks.FACTORY_CASES])
def test_sharded_factories_are_the_single_process_bits(runs, name, world):
    (uf, lam0, eta), u0, lam = _single_process(name)
    got = runs[0][world]
    for key, want in (("u_final", uf), ("lam0", lam0), ("eta", eta)):
        assert got[f"{name}_{key}"].dtype == np.float32
        assert np.array_equal(got[f"{name}_{key}"], want), (name, world, key)
    if name == "blocked":
        prod = lam.astype(np.float64) * uf.astype(np.float64)
        bound = (uf.size // world + world) * EPS32 * float(np.sum(np.abs(prod)))
        for j in got["blocked_j"]:
            assert abs(j - float(np.sum(prod))) <= bound, (j, float(np.sum(prod)), bound)


@pytest.mark.parametrize("name,n_dev", JAX_FACTORY_CASES)
def test_sharded_factories_match_the_jax_factories(runs, name, n_dev):
    want = runs[1][(name, n_dev)]
    blocked = next(c for c in ranks.FACTORY_CASES if c[0] == name)[5] is None
    atol = (1e-6, 1e-5, 1e-6) if blocked else (3e-6, 1e-5, 3e-6)
    got = runs[0][n_dev]
    for key, w, tol in zip(("u_final", "lam0", "eta"), want, atol):
        np.testing.assert_allclose(got[f"{name}_{key}"], w, rtol=0, atol=tol)
    if blocked:
        assert all(abs(j - float(want[3])) < 1e-4 for j in got["blocked_j"])


def test_validation_raises_as_the_jax_factories():
    """tests/test_pallas_sharded.py's validation cases, on grids of 7 and 8
    ranks (validation runs before any exchange), and the card's limits."""
    grid7, grid8 = (RankGrid(("space",), (d,), 0, None, None) for d in (7, 8))
    disc, dt, _, _ = ranks.problem(640)
    blocked = dg_sharded.make_cuda_fwd_adj_estimate_sharded_blocked
    grid_sh = dg_sharded.make_cuda_fwd_adj_estimate_tiled_grid_sharded
    with pytest.raises(ValueError, match="not divisible"):
        blocked(disc, ranks.A, dt, grid7, segment=2, n_segments=4, device="cpu")
    with pytest.raises(ValueError, match="ghost width"):
        blocked(disc, ranks.A, dt, grid8, segment=32, n_segments=1, device="cpu")
    with pytest.raises(ValueError, match="even"):  # 120 elements: 15 a rank
        blocked(ranks.problem(120)[0], ranks.A, dt, grid8, segment=1, device="cpu")
    disc, dt, _, _ = ranks.problem(3072)
    with pytest.raises(ValueError, match="not divisible"):
        grid_sh(disc, ranks.A, dt, grid7, segment=1, n_segments=2, chunks=2, device="cpu")
    with pytest.raises(ValueError, match="ghost width"):
        # lm = 3072/8/8/6 = 8 < w = 20
        grid_sh(disc, ranks.A, dt, grid8, segment=1, n_segments=2, chunks=6, device="cpu")
    with pytest.raises(ValueError, match="segment"):
        # W = 10·65 + 10 fits the share of one rank, the kernels take 1..64
        blocked(ranks.problem(4096)[0], ranks.A, dt, make_rank_grid(), segment=65, device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

        vx = 2 * np.pi * np.linspace(0.0, 1.0, 641) ** 1.5
        blocked(startup_1d(2, 0.0, 2 * np.pi, 640, vx=vx), ranks.A, dt, make_rank_grid(),
                segment=2, device="cpu")
    with pytest.raises(ValueError, match="share"):
        run = blocked(ranks.problem(640)[0], ranks.A, dt, make_rank_grid(), segment=2,
                      n_segments=1, device="cpu")
        run(torch.zeros((3, 320)), 0.0, torch.zeros((3, 320)))


def test_rank_grid_without_a_process_group():
    """make_mesh's contract on one rank: axis inference, the oversized grid
    error, shard_along's blocks; replicate, exchange and the all-reduce are
    the identity (a 1-device mesh)."""
    grid = make_rank_grid()
    assert grid.shape == {"space": 1} and grid.world == 1 and grid.axis_index("space") == 0
    assert make_rank_grid({"data": -1, "space": 1}).shape == {"data": 1, "space": 1}
    with pytest.raises(ValueError, match="needs 1024 ranks"):
        make_rank_grid({"data": 1024})
    with pytest.raises(KeyError):
        grid.axis_size("model")
    x = torch.arange(24.0).reshape(2, 12)
    assert shard_along(x, grid, "space", dim=1) is not None
    assert torch.equal(shard_along(x, grid, "space", dim=1), x)
    g3 = RankGrid(("data", "space"), (2, 3), 4, None, None)
    assert (g3.axis_index("data"), g3.axis_index("space")) == (1, 1)
    assert (g3.neighbour("space", -1), g3.neighbour("space", 1), g3.neighbour("data", 1)) == (3, 5, None)
    assert torch.equal(shard_along(x, g3, "space", dim=1), x[:, 4:8])
    with pytest.raises(ValueError, match="does not split"):
        shard_along(x, RankGrid(("space",), (5,), 0, None, None), "space", dim=1)
    assert replicate(x, grid) is x
    assert exchange(x[:, :1], x[:, -1:], grid, "space") == (None, None)
