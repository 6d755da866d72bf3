"""The port's data- and pipeline-parallel pieces over gloo ranks on the CPU:
the hp loops' ``mesh=``, the fused train steps' ``mesh=``, both drivers'
``--dp`` and ``parallel.pipeline_march``, against the JAX package and the
unsharded port.

One launch per world size (1, 2 and 4 ranks, all started together): each
rank is a process of tests/torch_dp_ranks.py with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``
on localhost; none at world 1), joins through ``parallel.init_dp_grid`` and
writes the global results it got. The inputs drawn with JAX go to the
ranks in a file; the JAX references are computed meanwhile, once each, on
the conftest's 8-device CPU mesh (the JAX tests' own meshes). Each check,
at the JAX tests' settings and tolerances:

- hp loops (torch engine, float64; tests/test_dg_mixed.py:528 and :613):
  the shared-partition ensemble's ``ns`` and ``times`` equal to JAX's under
  ``mesh=`` and ``err`` within 1e-13 at every iteration; the per-member
  study's last ``times``, ``ns`` and ``n_active`` equal (device loop, and
  the host loop too); through the hp kernel's plain version (float32,
  tests/test_pallas_hp.py:317) the orders and element counts equal to the
  JAX kernel's under a 2-device mesh, the float32 partitions within 1e-6,
  ``err`` and ``est_total`` within 2e-5 (tests/test_pallas_hp.py:64-101's
  float32 tolerance between two implementations). At world 1 the
  unsharded port's history bit for bit (smooth mode too); at worlds 2 and
  4 the unsharded port's decisions, the values within 1e-12 (float64) or
  32·ε₃₂ of each field's largest entry (float32); the device loop
  bit-equal to the host loop; every rank the same history; a resume from
  rank 0's checkpoint the straight run's;
- fused train steps (the kernels' plain versions; T1 plain, mixed and
  masked, T2; tests/test_pallas_train.py:191, :408 and :520 at its S and
  F, two Adam steps, B = 1024 distinct members): the losses within rtol
  1e-6 and the parameters within rtol 1e-4, atol 1e-7 of JAX's fused step
  under an 8-device mesh; the parameters bit-identical across the ranks;
  world 1 the unsharded step's bits. Teeth: at world 2, the same step with
  rank 1's share dropped or rank 0's counted twice fails the check;
- pipeline (tests/test_parallel.py:165-300): finals within rtol 1e-12 and
  gradients (every rank's own slice, joined over the pipe axis) within
  rtol 1e-10 of JAX's ``pipeline_march``; D = 1 the single-process march's
  bits; a step count that does not divide raises JAX's ``ValueError``;
  data × pipe on a 2 × 2 grid, finals and gradients;
- drivers: ``dg_adaptive --dp`` (the ensemble, per-member and both hp
  branches) and ``train_resnet_ode --dp`` print ``dp over N devices``,
  rank 0 alone prints the iterations and writes the files, and world 2
  reproduces world 1 as tests/test_drivers.py:223-241 and :288-303 hold
  them.
"""
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_dp_ranks as ranks
from torch_rank_procs import kill_ranks, rank_logs
from adjoint_ode_adaptivity_tpu import models as jmodels
from adjoint_ode_adaptivity_tpu.adapt import hp_loop as jhp
from adjoint_ode_adaptivity_tpu.parallel import make_mesh, pipeline_march as jpipeline_march
from adjoint_ode_adaptivity_tpu.train import loop as jloop
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop
from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive, train_resnet_ode
from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

WORLDS = (1, 2, 4)
S, F, B = 6, 37, 1024  # tests/test_pallas_train.py's S and F
EPS32 = float(np.finfo(np.float32).eps)
ATOL64 = 1e-12
F_SIN = lambda u, t: jnp.sin(u)  # noqa: E731
EXACT = ("times", "ns", "n_active", "n_refining")  # decisions: equal, not close


def _mesh(n, axes=("data",)):
    return Mesh(np.array(jax.devices()[:n]), axes)


# ------------------------------------------------------------ the inputs


def _resblock_params(seed, f=F, s=S):
    """tests/test_pallas_train.py's ``_setup`` parameters: one step's flax
    init stacked over S steps, each leaf perturbed per step."""
    p1 = jmodels.ResBlockSimple(features=f).init(jrand.PRNGKey(seed), jnp.ones(1), 0.0,
                                                 0.1)["params"]
    params = jax.tree_util.tree_map(lambda l: jnp.stack([l] * s).astype(jnp.float32), p1)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jrand.split(jrand.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.05 * jrand.normal(k, l.shape, l.dtype) for l, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _members(seed):
    dt = np.random.default_rng(seed).uniform(0.05, 0.15, S).astype(np.float32)
    u0 = np.random.default_rng(seed + 2).uniform(-2, 2, B).astype(np.float32)
    return dt, u0, (np.sin(u0) + 0.3).astype(np.float32)


def train_inputs():
    """kind -> params, dt, u0, target (and the extras) as NumPy."""
    npy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = {}
    dt, u0, tr = _members(11)
    out["t1"] = dict(params=npy(_resblock_params(11)), dt=dt, u0=u0, target=tr, features=F)
    dt, u0, _ = _members(35)
    nodes = np.concatenate([[0.0], np.cumsum(dt, dtype=np.float32)]).astype(np.float32)
    traj = (np.sin(u0[:, None] + nodes[None, :]) + 0.3).astype(np.float32)
    out["t1_mixed"] = dict(params=npy(_resblock_params(35)), dt=dt, u0=u0, target=traj,
                           features=F)
    # tests/test_pallas_train.py's masked setup: width 9 in a capacity of 24
    cap, width = 24, 9
    p_s = jmodels.ResBlockSimple(features=width).init(jrand.PRNGKey(21), jnp.ones(1), 0.0,
                                                      0.1)["params"]
    p1 = jmodels.masked_params_from_simple(p_s, cap)
    dt, u0, tr = _members(21)
    out["t1_masked"] = dict(
        params=npy(jax.tree_util.tree_map(lambda l: jnp.stack([l] * S).astype(jnp.float32),
                                          p1)),
        dt=dt, u0=u0, target=tr, features=cap,
        n_active=np.asarray([width, width + 3, width, cap, 1, width], np.int32))
    sizes = (3, 5)
    p = jmodels.ResNetBlock(sizes).init(jrand.PRNGKey(49), jnp.ones(1), 0.0, 0.1)["params"]
    dt, u0, tr = _members(49)
    out["t2"] = dict(params=npy(jax.tree_util.tree_map(lambda l: l.astype(jnp.float32), p)),
                     dt=dt, u0=u0, target=tr, sizes=sizes)
    return out


def pipeline_inputs():
    """tests/test_parallel.py's pipeline settings."""
    out = {}
    rng = np.random.default_rng(0)
    s, m, mb = 8, 4, 5
    out["pipe_finals"] = dict(params={"w": rng.uniform(0.5, 1.5, s),
                                      "b": rng.uniform(-0.1, 0.1, s)},
                              dt=rng.uniform(0.05, 0.15, s), u0s=rng.uniform(-2, 2, (m, mb)))
    rng = np.random.default_rng(1)
    s, m, mb = 8, 3, 4
    out["pipe_grads"] = dict(params={"w": rng.uniform(0.5, 1.5, s),
                                     "b": rng.uniform(-0.3, 0.3, s)},
                             dt=np.full((s,), 0.1), u0s=rng.uniform(-1, 1, (m, mb)))
    n_steps, width, m, mb = 8, 6, 3, 4
    p1 = jmodels.ResBlockSimple(width).init(jrand.PRNGKey(0), jnp.ones(1), 0.0, 0.1)["params"]
    stacked = jax.tree_util.tree_map(
        lambda l: np.stack([np.asarray(l * (1 + 0.01 * i), np.float64) for i in range(n_steps)]),
        p1)
    out["pipe_resnet"] = dict(params=stacked, width=width,
                              dt=np.full((n_steps,), 1.0 / n_steps),
                              u0s=np.asarray(jrand.uniform(jrand.PRNGKey(3), (m, mb),
                                                           minval=-2, maxval=2), np.float64))
    rng = np.random.default_rng(2)
    s, m, mb = 4, 3, 6
    out["pipe_data"] = dict(params={"w": rng.uniform(0.5, 1.5, s)}, dt=np.full((s,), 0.1),
                            u0s=rng.uniform(-1, 1, (m, mb)))
    return out


# ------------------------------------------------------ the JAX references


def _jax_hp():
    """The JAX hp loops under the JAX tests' meshes."""
    out = {}
    y0s, kw = ranks.HP["hp_ensemble"]
    out["hp_ensemble"] = jhp.run_adaptive_dg_hp(F_SIN, y0s, ranks.SPAN, mesh=_mesh(8), **kw)
    y0s, kw = ranks.HP["hp_per_member"]
    out["hp_per_member"] = jhp.run_adaptive_dg_hp_per_member(
        F_SIN, y0s, ranks.SPAN, mesh=_mesh(8), device_loop=True, **kw)
    y0s, kw = ranks.HP["hp_kernel"]
    out["hp_kernel"] = jhp.run_adaptive_dg_hp_per_member(
        F_SIN, y0s, ranks.SPAN, mesh=_mesh(2), **{**kw, "engine": "pallas"})
    return out


def _jax_train(inp):
    """Two steps of JAX's fused train steps (interpret mode) under the
    8-device mesh: kind -> (losses, params)."""
    tx, mesh, out = optax.adam(ranks.LR), _mesh(8), {}
    for kind, c in inp.items():
        st = jloop.create_train_state(c["params"], tx)
        dt, u0, tg = (jnp.asarray(c[k]) for k in ("dt", "u0", "target"))
        losses = []
        if kind == "t1":
            step = jloop.make_per_step_train_step_fused(tx, S, F, interpret=True, mesh=mesh)
            args = lambda it: (dt, u0, tg)  # noqa: E731
        elif kind == "t1_mixed":
            step = jloop.make_mixed_loss_train_step_fused(tx, S, F, interpret=True, mesh=mesh)
            args = lambda it: (dt, u0, tg, jnp.asarray(it))  # noqa: E731
        elif kind == "t1_masked":
            step = jloop.make_per_step_masked_train_step_fused(tx, S, c["features"],
                                                                interpret=True, mesh=mesh)
            args = lambda it: (dt, jnp.asarray(c["n_active"]), u0, tg)  # noqa: E731
        else:
            step = jloop.make_shared_train_step_fused(tx, dt, c["sizes"], interpret=True,
                                                      mesh=mesh)
            args = lambda it: (u0, tg)  # noqa: E731
        for it in range(ranks.N_TRAIN_STEPS):
            st, loss = step(st, *args(it))
            losses.append(float(loss))
        out[kind] = (losses, jax.tree_util.tree_map(np.asarray, st.params))
    return out


def _jax_pipeline(inp):
    out = {}
    c = inp["pipe_finals"]

    def step_sin(u, t, dt, p):
        return u + dt * (jnp.sin(p["w"] * u) + 0.1 * t + p["b"])

    out["finals"] = np.asarray(jax.jit(jpipeline_march(step_sin, make_mesh({"pipe": 4})))(
        c["params"], c["dt"], c["u0s"], t0=0.25))

    c = inp["pipe_grads"]

    def step_tanh(u, t, dt, p):
        return u + dt * jnp.tanh(p["w"] * u + p["b"])

    pipe = jpipeline_march(step_tanh, make_mesh({"pipe": 4}))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(pipe(p, jnp.asarray(c["dt"]), jnp.asarray(c["u0s"])) ** 2)))(
        c["params"])
    out["grads/loss"], out["grads"] = float(loss), jax.tree_util.tree_map(np.asarray, grads)

    c = inp["pipe_resnet"]
    net = jmodels.ResBlockSimple(c["width"])
    step_mb = jax.vmap(lambda u, t, dt, p: net.apply({"params": p}, u, t, dt),
                       in_axes=(0, None, None, None))
    out["resnet"] = np.asarray(jax.jit(jpipeline_march(step_mb, make_mesh({"pipe": 4})))(
        c["params"], c["dt"], c["u0s"]))

    c = inp["pipe_data"]

    def step_w(u, t, dt, p):
        return u + dt * jnp.tanh(p["w"] * u)

    fn = jpipeline_march(step_w, make_mesh({"data": 2, "pipe": 4}), axis="pipe",
                         data_axis="data")
    out["data_pipe"] = np.asarray(jax.jit(fn)(c["params"], c["dt"], c["u0s"]))
    from adjoint_ode_adaptivity_tpu.march.fd import forward_march_per_step

    step_mb = jax.vmap(step_w, in_axes=(0, None, None, None))
    out["data_pipe/grads"] = jax.tree_util.tree_map(np.asarray, jax.grad(lambda p: sum(
        jnp.sum(forward_march_per_step(step_mb, jnp.asarray(u), jnp.asarray(c["dt"]), p)[-1] ** 2)
        for u in c["u0s"]))(c["params"]))
    try:
        jpipeline_march(lambda u, t, dt, p: u, make_mesh({"pipe": 4}))(
            {"w": jnp.zeros(6)}, jnp.ones(6), jnp.zeros((2, 3)))
    except ValueError as exc:
        out["mismatch"] = str(exc)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> every rank's results; the JAX references."""
    inp = {**train_inputs(), **pipeline_inputs()}
    procs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"dp{world}")
        with open(tmp / "inputs.pkl", "wb") as fh:
            pickle.dump(inp, fh)
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                            "MASTER_ADDR", "MASTER_PORT")}
        port = _free_port()
        procs[world] = (tmp, [])
        for r in range(world):
            renv = dict(env) if world == 1 else {
                **env, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port)}
            procs[world][1].append(subprocess.Popen(
                [sys.executable, ranks.__file__, str(tmp)], env=renv, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    try:
        refs = {"hp": _jax_hp(), "train": _jax_train({k: inp[k] for k in ranks.TRAIN_STEPS}),
                "pipeline": _jax_pipeline(inp)}
    except BaseException:  # the references failed: no rank outlives the fixture
        kill_ranks(procs)
        raise
    logs = rank_logs(procs, timeout=900)  # kills every rank on a timeout
    out = {}
    for world, (tmp, ps) in procs.items():
        for p, log in zip(ps, logs[world]):
            assert p.returncode == 0, log
        out[world] = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                out[world].append(pickle.load(fh))
        out[world][0]["dir"] = tmp
    return out, refs


def _same(a, b):
    """Two histories (lists of dicts) equal bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


SUM_OF = {"est_total": ("err", -1)}  # a sum: its float32 error scales with its terms


def _tol32(key, row):
    if key in SUM_OF:
        terms, axis = SUM_OF[key]
        return 32 * EPS32 * np.sum(np.abs(np.asarray(row[terms], np.float64)), axis=axis)
    return 32 * EPS32 * float(np.max(np.abs(np.asarray(row[key], np.float64))))


def _close(a, b, tol):
    """Equal decisions; each value field within ``tol(key, row)``."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in y:
            got, want = np.asarray(x[k], np.float64), np.asarray(y[k], np.float64)
            if k in EXACT:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                bound = tol(k, y)
                assert np.all(np.abs(got - want) <= bound), (k, np.max(np.abs(got - want)))


# ---------------------------------------------------------------- hp loops


def test_the_ranks_join_through_the_torchrun_environment(runs):
    got, _ = runs
    for world in WORLDS:
        for res in got[world]:
            assert res["grid"] == (("data",), (world,), None if world == 1 else "gloo")


@pytest.mark.parametrize("world", WORLDS)
def test_hp_ensemble_matches_jax_under_a_mesh(runs, world):
    """tests/test_dg_mixed.py:528's check: ns and times equal, err within
    1e-13, at every iteration."""
    got, refs = runs
    for res in got[world]:
        for dl in (False, True):
            hist = res[f"hp_ensemble/{dl}"]
            assert len(hist) == len(refs["hp"]["hp_ensemble"])
            for a, b in zip(hist, refs["hp"]["hp_ensemble"]):
                np.testing.assert_array_equal(a["ns"], b.ns)
                np.testing.assert_array_equal(a["times"], b.times)
                np.testing.assert_allclose(a["err"], np.asarray(b.err), rtol=0, atol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_hp_per_member_matches_jax_under_a_mesh(runs, world):
    """tests/test_dg_mixed.py:613's check on the last iteration, device
    loop and host loop."""
    got, refs = runs
    want = refs["hp"]["hp_per_member"]
    for res in got[world]:
        for dl in (False, True):
            hist = res[f"hp_per_member/{dl}"]
            assert len(hist) == len(want)
            for k in ("times", "ns", "n_active"):
                np.testing.assert_array_equal(hist[-1][k], getattr(want[-1], k), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_hp_kernel_loop_matches_the_jax_kernel_under_a_mesh(runs, world):
    """tests/test_pallas_hp.py:317's check: the hp kernel's plain version
    (float32) takes the JAX kernel's decisions. Its 1e-6 on est_total holds
    one kernel against itself; two float32 implementations of the member
    pipeline meet tests/test_pallas_hp.py:64-101's 2e-5 on err instead
    (each element, and est_total)."""
    got, refs = runs
    want = refs["hp"]["hp_kernel"]
    for res in got[world]:
        for dl in (False, True):
            hist = res[f"hp_kernel/{dl}"]
            assert len(hist) == len(want)
            for a, b in zip(hist, want):
                # float32 partitions against the JAX loop's float64 ones: the
                # same bisections and orders (tests/test_pallas_hp.py:297's
                # 1e-6 between the engines' partitions)
                np.testing.assert_array_equal(a["ns"], b.ns)
                np.testing.assert_array_equal(a["n_active"], b.n_active)
                np.testing.assert_allclose(a["times"], b.times, rtol=0, atol=1e-6)
                np.testing.assert_allclose(a["err"], b.err, rtol=0, atol=2e-5)
                np.testing.assert_allclose(a["est_total"], b.est_total, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", list(ranks.HP))
def test_hp_world_one_is_the_unsharded_loop(runs, name):
    got, _ = runs
    for dl in (False, True):
        _same(got[1][0][f"{name}/{dl}"], got[1][0][f"{name}/{dl}/unsharded"])


@pytest.mark.parametrize("name", list(ranks.HP))
@pytest.mark.parametrize("world", (2, 4))
def test_hp_sharded_loop_matches_the_unsharded_port(runs, world, name):
    """The same decisions, the values within 1e-12 (float64) or 32·ε₃₂ of
    the field's largest entry (float32); the device loop bit-equal to the
    host loop; every rank the same history."""
    got, _ = runs
    ref = got[1][0][f"{name}/False/unsharded"]
    tol = _tol32 if name == "hp_kernel" else (lambda k, row: ATOL64)
    first = got[world][0][f"{name}/False"]
    _close(first, ref, tol)
    for res in got[world]:
        _same(res[f"{name}/False"], first)
        _same(res[f"{name}/True"], first)


@pytest.mark.parametrize("name", ["hp_ensemble", "hp_per_member"])
@pytest.mark.parametrize("world", WORLDS)
def test_hp_resume_from_rank_zeros_checkpoint(runs, world, name):
    """Two iterations saved by rank 0, resumed on every rank: the straight
    run's decisions and values, the iterations after the resume bit for
    bit."""
    got, _ = runs
    for res in got[world]:
        resumed, straight = res[f"{name}/resumed"], res[f"{name}/False"]
        _close(resumed, straight, lambda k, row: ATOL64)
        _same(resumed[2:], straight[2:])


def test_hp_mesh_refusals(runs):
    got, _ = runs
    for world in (2, 4):
        for res in got[world]:
            assert res["hp_refusals"] == [f"B={world + 1} must divide over {world} ranks of "
                                          "mesh axis 'data'"] * 2
    sin = odes.get_ode("du/dt=sin(u)")
    with pytest.raises(ValueError, match=r"mesh= requires a \(B,\) initial-condition array"):
        hp_loop.run_adaptive_dg_hp(sin.f, 1.0, ranks.SPAN, mesh=make_rank_grid({"data": 1}),
                                   maxit=1, device="cpu")
    with pytest.raises(TypeError, match="RankGrid"):
        hp_loop.run_adaptive_dg_hp_per_member(sin.f, np.ones(2), ranks.SPAN, mesh=_mesh(2),
                                              maxit=1, device="cpu")


# ------------------------------------------------------- fused train steps


def _train_close(got, want):
    """JAX's tests/test_pallas_train.py tolerances: (losses ok, params ok)."""
    (l_got, p_got), (l_want, p_want) = got, want
    losses = np.allclose(l_got, l_want, rtol=1e-6, atol=0)
    leaves_got = jax.tree_util.tree_leaves(p_got)
    leaves_want = jax.tree_util.tree_leaves(p_want)
    params = all(np.allclose(a, b, rtol=1e-4, atol=1e-7) for a, b in zip(leaves_got, leaves_want))
    return losses, params


@pytest.mark.parametrize("kind", ranks.TRAIN_STEPS)
@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_jax_under_a_mesh(runs, world, kind):
    got, refs = runs
    for res in got[world]:
        assert _train_close(res[f"{kind}/mesh"], refs["train"][kind]) == (True, True)
        # Adam on every rank on the same sums: the same parameters, bit for bit
        for a, b in zip(jax.tree_util.tree_leaves(res[f"{kind}/mesh"][1]),
                        jax.tree_util.tree_leaves(got[world][0][f"{kind}/mesh"][1])):
            np.testing.assert_array_equal(a, b)
        assert res[f"{kind}/mesh"][0] == got[world][0][f"{kind}/mesh"][0]


@pytest.mark.parametrize("kind", ranks.TRAIN_STEPS)
def test_train_step_world_one_is_the_unsharded_step(runs, kind):
    got, _ = runs
    (l1, p1), (l0, p0) = got[1][0][f"{kind}/mesh"], got[1][0][f"{kind}/unsharded"]
    assert l1 == l0
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["drop", "twice"])
@pytest.mark.parametrize("kind", ranks.TRAIN_STEPS)
def test_train_step_checks_tell_a_dropped_or_doubled_share(runs, kind, fault):
    """The check has teeth: a sum over the ranks missing rank 1's share, or
    counting rank 0's twice, fails it, through the loss. (Adam's update
    m̂/(√v̂ + eps) barely sees a share's scale: after two steps the
    parameters move by about lr·sign(g) whatever the sum, so the
    parameter tolerance alone need not tell.)"""
    got, refs = runs
    for res in got[2]:
        losses, _ = _train_close(res[f"{kind}/{fault}"], refs["train"][kind])
        assert not losses


# --------------------------------------------------------------- pipeline


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_jax(runs, world):
    got, refs = runs
    want = refs["pipeline"]
    for res in got[world]:
        np.testing.assert_allclose(res["finals"], want["finals"], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(res["resnet"], want["resnet"], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(res["grads/loss"], want["grads/loss"], rtol=1e-12)
        for k in want["grads"]:
            np.testing.assert_allclose(res["grads"][k], want["grads"][k], rtol=1e-10,
                                       atol=1e-12, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_gradient_lands_on_each_ranks_own_steps(runs, world):
    """Each rank's gradient is its own S/D slice of the steps, zero
    elsewhere, and equal to that slice of JAX's: the last stage's broadcast
    hands the cotangent to the last rank once, not D times."""
    got, refs = runs
    want = refs["pipeline"]["grads"]
    for r, res in enumerate(got[world]):
        for k, g in res["grads/own"].items():
            share = len(g) // world
            mine = slice(r * share, (r + 1) * share)
            np.testing.assert_allclose(g[mine], want[k][mine], rtol=1e-10, atol=1e-12)
            assert np.all(np.delete(g, np.arange(len(g))[mine]) == 0)


def test_pipeline_on_one_rank_is_the_single_process_march(runs):
    got, _ = runs
    np.testing.assert_array_equal(got[1][0]["finals"], got[1][0]["finals/sequential"])


def test_pipeline_step_count_mismatch_raises(runs):
    got, refs = runs
    assert refs["pipeline"]["mismatch"] == "n_steps=6 not divisible by pipe axis size 4"
    for world in (2, 4):
        for res in got[world]:
            assert res["mismatch"] == (f"n_steps={world + 1} not divisible by pipe axis size "
                                       f"{world}")


def test_pipeline_composes_with_a_data_axis(runs):
    got, refs = runs
    want = refs["pipeline"]
    for res in got[4]:
        np.testing.assert_allclose(res["data_pipe"], want["data_pipe"], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(res["data_pipe/grads"]["w"], want["data_pipe/grads"]["w"],
                                   rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------- drivers


def _iteration_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("-- it") or "outer it" in ln]


@pytest.mark.parametrize("name", list(ranks.DG_ARGV))
def test_dg_adaptive_dp_reproduces_the_one_rank_run(runs, name):
    """tests/test_drivers.py:288-303's check: world 2's last partition and
    estimate within 1e-12 of world 1's; every rank the same history; rank 0
    alone prints, ``dp over N devices`` first."""
    got, _ = runs
    h1, out1 = got[1][0][f"dg/{name}"]
    assert out1.splitlines()[0] == "dp over 1 devices"
    h2, out2 = got[2][0][f"dg/{name}"]
    assert out2.splitlines()[0] == "dp over 2 devices"
    assert got[2][1][f"dg/{name}"][1] == ""
    assert len(h2) == len(h1) and len(_iteration_lines(out2)) >= len(h1)
    for k in ("times", "est_total_mean", "est_total", "ns", "n_active"):
        if k in h1[-1]:
            np.testing.assert_allclose(np.asarray(h2[-1][k], np.float64),
                                       np.asarray(h1[-1][k], np.float64), rtol=0,
                                       atol=ATOL64, err_msg=k)
    _same(got[2][1][f"dg/{name}"][0], h2)


def test_train_resnet_ode_dp_reproduces_the_one_rank_run(runs):
    """tests/test_drivers.py:223-241's check: world 2's refined grid within
    1e-6 of world 1's; every rank the same grid and parameters; rank 0
    alone prints and writes the JSONL and the checkpoints."""
    got, _ = runs
    t1, _, out1 = got[1][0]["train"]
    t2, p2, out2 = got[2][0]["train"]
    np.testing.assert_allclose(t2, t1, rtol=0, atol=1e-6)
    assert out1.splitlines()[0] == "dp over 1 devices"
    assert out2.splitlines()[0] == "dp over 2 devices" and _iteration_lines(out2)
    assert _iteration_lines(out2) == _iteration_lines(out1)
    t2b, p2b, out2b = got[2][1]["train"]
    assert out2b == ""
    np.testing.assert_array_equal(t2b, t2)
    for a, b in zip(jax.tree_util.tree_leaves(p2b), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(a, b)
    # the 2 epochs of 2 outer iterations, one JSONL record each, from rank 0
    assert got[2][0]["train/jsonl_lines"] == 4
    ckpts = sorted(p.name for p in (got[2][0]["dir"] / "train_ckpt").iterdir())
    assert ckpts == ["ckpt_0.pt", "ckpt_1.pt", "meta.json"]
    for res in got[2]:
        assert res["train/refusal"] == "--dp: n-train=1025 must divide over the 2 ranks"


def test_drivers_refuse_dp_where_jax_does(capsys):
    with pytest.raises(SystemExit, match="only supported with the fused engines"):
        train_resnet_ode.main(["--dp", "--device", "cpu", "--method", "recurrent",
                               "--train-engine", "cuda"])
    with pytest.raises(SystemExit, match="--dp requires the fused engine"):
        train_resnet_ode.main(["--dp", "--device", "cpu"])
    with pytest.raises(SystemExit):
        dg_adaptive.main(["--dp", "--hp", "hp", "--device", "cpu"])
    assert "--dp requires --ensemble with --hp" in capsys.readouterr().err
