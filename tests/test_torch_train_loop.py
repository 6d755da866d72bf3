"""The port's training steps, Adam, evaluation, padded adaptive trainer,
checkpoints and metrics against the JAX package's (train/loop.py,
train/adaptive.py) on the same inputs, carried across as NumPy.

Tolerances: the data are float64 and the parameters float32 on both sides
(as the JAX driver runs under x64), so losses agree to 1e-12 relative on
the first step; the float32 parameter updates may then differ by an ulp
where a float64 gradient rounds to float32 on the other side of a tie, so
trajectories over many epochs are held to 1e-6 relative (losses) and 1e-5
(parameters). Adam alone, fed identical gradients, is bit-identical to
optax. The fused (cuda) engine runs T1/T2's plain versions on the CPU and
is held to the JAX fused step in interpret mode at float32 roundoff.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adjoint_ode_adaptivity_tpu import models as jm
from adjoint_ode_adaptivity_tpu.train import adaptive as jad
from adjoint_ode_adaptivity_tpu.train import loop as jl
from adjoint_ode_adaptivity_tpu_torch import interop, models
from adjoint_ode_adaptivity_tpu_torch.train import adaptive, checkpoint, loop
from adjoint_ode_adaptivity_tpu_torch.train.metrics import MetricsLogger, StepTimer

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

S, F, B = 3, 16, 128


def T(x):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), x)


def N(x):
    return interop.tree_to_numpy(x)


def _setup(seed=0, f=F, s=S, b=B, masked_cap=None):
    p1 = jm.ResBlockSimple(f).init(jax.random.PRNGKey(seed), jnp.ones(1), 0.0, 0.1)["params"]
    if masked_cap:
        p1 = jm.masked_params_from_simple(p1, masked_cap)
    rng = np.random.default_rng(seed)
    stacked = {k: (np.stack([np.asarray(v)] * s) + 0.05 * rng.normal(size=(s,) + v.shape)
                   ).astype(np.float32) for k, v in p1.items()}
    dt = rng.uniform(0.2, 0.4, s)
    u0s = rng.uniform(-3, 3, b)
    trues = np.sin(u0s) + 0.3
    traj = np.stack([np.sin(u0s * (1 + 0.1 * n)) for n in range(s + 1)], axis=1)  # (B, S+1)
    return stacked, dt, u0s, trues, traj


def _compare_params(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(N(got)[k], np.asarray(want[k]), rtol=rtol, atol=1e-7)


def test_adam_is_bit_identical_to_optax():
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    tx, ptx = optax.adam(1e-3), loop.Adam(1e-3)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), None
    js = tx.init(jp)
    tp, ts = T(p), ptx.init(T(p))
    for _ in range(40):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-6, 1)).astype(np.float32)
             for k, v in p.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = ptx.update(T(g), ts, tp)
    for k in p:
        np.testing.assert_array_equal(N(tp)[k], np.asarray(jp[k]))
        np.testing.assert_array_equal(N(ts.exp_avg_sq)[k], np.asarray(js[0].nu[k]))
    assert ts.step == int(js[0].count) == 40


def test_adam_trajectory_matches_the_xla_step_over_32_epochs():
    stacked, dt, u0s, trues, _ = _setup(seed=9)
    tx = optax.adam(1e-3)
    jstep = jl.make_per_step_train_step(jm.ResBlockSimple(F), tx)
    pstep = loop.make_per_step_train_step(models.ResBlockSimple(F), loop.Adam(1e-3))
    js = jl.create_train_state(jax.tree_util.tree_map(jnp.asarray, stacked), tx)
    ps = loop.create_train_state(T(stacked), loop.Adam(1e-3))
    jargs = [jnp.asarray(x) for x in (dt, u0s, trues)]
    pargs = [torch.from_numpy(x) for x in (dt, u0s, trues)]
    for epoch in range(32):
        js, jloss = jstep(js, *jargs)
        ps, ploss = pstep(ps, *pargs)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-12 if epoch == 0 else 1e-6)
    _compare_params(ps.params, js.params, 1e-5)
    assert ps.opt_state.step == 32 and ps.step == 32


def test_step_factories_match_jax():
    tx, ptx = optax.adam(1e-3), loop.Adam(1e-3)
    stacked, dt, u0s, trues, traj = _setup(seed=4)
    cases = []
    # per-step terminal MSE
    cases.append((jl.make_per_step_train_step(jm.ResBlockSimple(F), tx),
                  loop.make_per_step_train_step(models.ResBlockSimple(F), ptx),
                  stacked, (dt, u0s, trues)))
    # masked at capacity 20, n_active varying per step
    ms, *_ = _setup(seed=5, masked_cap=20)
    na = np.array([16, 9, 20], np.int32)
    cases.append((jl.make_per_step_masked_train_step(jm.ResBlockSimpleMasked(20), tx),
                  loop.make_per_step_masked_train_step(models.ResBlockSimpleMasked(20), ptx),
                  ms, (dt, na, u0s, trues)))
    # mixed loss at outer iteration 9 (ramp weight 10**-3)
    cases.append((jl.make_mixed_loss_train_step(jm.ResBlockSimple(F), tx),
                  loop.make_mixed_loss_train_step(models.ResBlockSimple(F), ptx),
                  stacked, (dt, u0s, traj, 9)))
    # shared Dense chain
    net = jm.ResNetBlock((8, 16))
    pd = jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(3), jnp.ones(1), 0.0,
                                                     0.1)["params"])
    cases.append((jl.make_shared_train_step(net, tx, jnp.asarray(dt)),
                  loop.make_shared_train_step(models.ResNetBlock((8, 16)), ptx,
                                              torch.from_numpy(dt)),
                  pd, (u0s[:32], trues[:32])))
    for jstep, pstep, p, args in cases:
        js = jl.create_train_state(jax.tree_util.tree_map(jnp.asarray, p), tx)
        ps = loop.create_train_state(T(p), ptx)
        for rtol in (1e-12, 1e-6):
            js, jloss = jstep(js, *(jnp.asarray(a) for a in args))
            ps, ploss = pstep(ps, *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                    for a in args))
            np.testing.assert_allclose(float(ploss), float(jloss), rtol=rtol)
        jleaves = jax.tree_util.tree_leaves(js.params)
        pleaves = jax.tree_util.tree_leaves(N(ps.params))
        for a, b in zip(pleaves, jleaves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
            assert a.dtype == np.float32


def test_fused_steps_on_the_cpu_match_the_jax_fused_steps():
    # the cuda engine's factories run T1/T2's plain versions on CPU tensors;
    # the JAX fused steps run the Pallas kernels in interpret mode (float32)
    tx, ptx = optax.adam(1e-3), loop.Adam(1e-3)
    stacked, dt, u0s, trues, traj = _setup(seed=6)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    ms, *_ = _setup(seed=7, masked_cap=20)
    na = np.array([16, 9, 20], np.int32)
    net = jm.ResNetBlock((8, 16))
    pd = jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(3), jnp.ones(1), 0.0,
                                                     0.1)["params"])
    cases = [
        (jl.make_per_step_train_step_fused(tx, S, F, interpret=True),
         loop.make_per_step_train_step_fused(ptx, S, F, device="cpu"), stacked,
         (f32(dt), f32(u0s), f32(trues))),
        (jl.make_per_step_masked_train_step_fused(tx, S, 20, interpret=True),
         loop.make_per_step_masked_train_step_fused(ptx, S, 20, device="cpu"), ms,
         (f32(dt), na, f32(u0s), f32(trues))),
        (jl.make_mixed_loss_train_step_fused(tx, S, F, interpret=True),
         loop.make_mixed_loss_train_step_fused(ptx, S, F, device="cpu"), stacked,
         (f32(dt), f32(u0s), f32(traj), 9)),
        (jl.make_shared_train_step_fused(tx, jnp.asarray(f32(dt)), (8, 16), interpret=True,
                                         block_members=32),
         loop.make_shared_train_step_fused(ptx, torch.from_numpy(f32(dt)), (8, 16),
                                           device="cpu"), pd, (f32(u0s[:32]), f32(trues[:32]))),
    ]
    for jstep, pstep, p, args in cases:
        js = jl.create_train_state(jax.tree_util.tree_map(jnp.asarray, p), tx)
        ps = loop.create_train_state(T(p), ptx)
        js, jloss = jstep(js, *(jnp.asarray(a) for a in args))
        ps, ploss = pstep(ps, *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                for a in args))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-6)
        for a, b in zip(jax.tree_util.tree_leaves(N(ps.params)),
                        jax.tree_util.tree_leaves(js.params)):
            # one Adam step moves each entry by ~lr; float32 gradients that
            # differ in the last bits move it the same way
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-6)


def test_evaluate_matches_jax():
    stacked, dt, u0s, trues, _ = _setup(seed=8)
    want = jl.evaluate(jm.ResBlockSimple(F), jax.tree_util.tree_map(jnp.asarray, stacked),
                       jnp.asarray(dt), jnp.asarray(u0s), jnp.asarray(trues))
    got = loop.evaluate(models.ResBlockSimple(F), T(stacked), torch.from_numpy(dt),
                        torch.from_numpy(u0s), torch.from_numpy(trues))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    ms, *_ = _setup(seed=8, masked_cap=20)
    na = np.array([3, 20, 11], np.int32)
    want = jl.evaluate_masked(jm.ResBlockSimpleMasked(20), jax.tree_util.tree_map(jnp.asarray, ms),
                              jnp.asarray(na), jnp.asarray(dt), jnp.asarray(u0s),
                              jnp.asarray(trues))
    got = loop.evaluate_masked(models.ResBlockSimpleMasked(20), T(ms), torch.from_numpy(na),
                               torch.from_numpy(dt), torch.from_numpy(u0s),
                               torch.from_numpy(trues))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_padded_adaptive_trainer_matches_jax(engine):
    # padded zero-dt steps stay inert; losses, the refined grid, the active
    # count and the signal match the JAX xla trainer
    p1 = jm.ResBlockSimple(16).init(jax.random.PRNGKey(2), jnp.ones(1), 0.0, 0.1)["params"]
    u0s = np.random.default_rng(4).uniform(-2, 2, 128)
    trues = np.sin(u0s) + 0.3
    if engine == "cuda":
        u0s, trues = u0s.astype(np.float32), trues.astype(np.float32)
    times0 = np.linspace(0.0, 1.0, 4).astype(u0s.dtype)
    tx = optax.adam(1e-3)
    init, tstep, refine = jad.make_padded_adaptive_trainer(jm.ResBlockSimple(16), tx, max_depth=8)
    st = init(p1, jnp.asarray(times0))
    pinit, ptstep, prefine = adaptive.make_padded_adaptive_trainer(
        models.ResBlockSimple(16), loop.Adam(1e-3), max_depth=8, train_engine=engine,
        device="cpu")
    pst = pinit(T(p1), torch.from_numpy(times0))
    for epoch in range(3):
        st, loss = tstep(st, jnp.asarray(u0s), jnp.asarray(trues))
        pst, ploss = ptstep(pst, torch.from_numpy(u0s), torch.from_numpy(trues))
        rtol = 2e-5 if engine == "cuda" else (1e-12 if epoch == 0 else 1e-6)
        np.testing.assert_allclose(float(ploss), float(loss), rtol=rtol)
    st, err_steps, err_total = refine(st, jnp.asarray(u0s[:32]), jnp.asarray(trues[:32]))
    pst, perr, ptotal = prefine(pst, torch.from_numpy(u0s[:32]), torch.from_numpy(trues[:32]))
    np.testing.assert_allclose(pst.times.numpy(), np.asarray(st.times), atol=1e-6)
    assert int(pst.n_active) == int(st.n_active) == 4
    np.testing.assert_allclose(perr.numpy(), np.asarray(err_steps), rtol=1e-4, atol=1e-9)
    assert not perr[4:].any()
    # padded steps' parameters and moments never moved off their fill
    for k in ("bias", "weights1", "weights2"):
        np.testing.assert_array_equal(pst.train.opt_state.exp_avg[k][5:].numpy(), 0.0)


def test_checkpoint_round_trip_and_template_check(tmp_path):
    stacked, *_ = _setup()
    state = {"params": T(stacked), "times": torch.linspace(0, 1, 4), "it": 3}
    for step in range(5):
        checkpoint.save_checkpoint(tmp_path, step, state)
    assert checkpoint.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]
    back = checkpoint.restore_checkpoint(tmp_path, state)
    for k in stacked:
        assert torch.equal(back["params"][k], state["params"][k])
    assert back["it"] == 3
    bad = dict(state, times=torch.zeros(5))
    with pytest.raises(ValueError, match="template"):
        checkpoint.restore_checkpoint(tmp_path, bad)
    assert checkpoint.latest_step(tmp_path / "none") is None


def test_metrics_logger_writes_jsonl(tmp_path, capsys):
    log = MetricsLogger("run", jsonl_path=tmp_path / "m.jsonl", verbose=True)
    log.log({"Epoch": 0, "Loss": torch.tensor(0.5), "Error": 0.25})
    log.finish()
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec == {"Epoch": 0, "Loss": 0.5, "Error": 0.25}
    assert "Loss: 5.000e-01" in capsys.readouterr().out
    timer = StepTimer()
    timer.lap()
    assert len(timer.laps) == 1 and timer.mean >= 0.0
