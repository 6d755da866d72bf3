"""The port's ``train_resnet_ode`` driver against the JAX driver: the same
run (``--method variable_params``) from the JAX driver's own initial draws
(its PRNGKey(seed) parameters and ICs, rebuilt here as its code makes them,
and its noise insertions), per-epoch losses and errors, the refinement
signal of every outer iteration, the inserted steps and the final depth.
The ensemble refinement signal against the JAX driver's for each kind of
net (per-step, masked at a capacity, shared), to 1e-12 relative. Then the
port alone: every method through ``main`` on the CPU, resume from a
checkpoint, and the refusals. ``recurrent`` is held to JAX in
tests/test_torch_train_recurrent.py.

Tolerance: the JAX run uses float64 data and float32 parameters (tests run
JAX with x64); the port is fed the same dtypes. The first epoch agrees to
~1e-12; float32 parameter updates that round differently by an ulp then
move the losses by ~1e-8 relative, so losses, errors and the per-step
signal are held to 1e-6 relative, and an insertion decision is compared
where the signal's top-two margin exceeds 2e-6 of its largest entry.
"""
import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu import models as jm
from adjoint_ode_adaptivity_tpu.drivers import train_resnet_ode as jd
from adjoint_ode_adaptivity_tpu_torch import interop, models
from adjoint_ode_adaptivity_tpu_torch.drivers import train_resnet_ode as td
from adjoint_ode_adaptivity_tpu_torch.train.adaptive import ensemble_refinement_signal
from adjoint_ode_adaptivity_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

RTOL = 1e-6


def jax_initial_draws(args):
    """The JAX driver's initial parameters and ICs (driver :164-210), as tensors."""
    rng = jrand.PRNGKey(args.seed)
    if args.method == "width":
        cap = args.width_capacity or (args.width + args.maxit + 4)
        p1 = jm.masked_params_from_simple(
            jm.ResBlockSimple(args.width).init(rng, jnp.ones(1), 0.0, 0.1)["params"], cap)
    elif args.method == "recurrent":
        p1 = jm.ResNetBlock(td.hidden_sizes(args)).init(rng, jnp.ones(1), 0.0, 0.1)["params"]
    else:
        p1 = jm.ResBlockSimple(args.width).init(rng, jnp.ones(1), 0.0, 0.1)["params"]
    u0_train = jrand.uniform(rng, (args.n_train,), minval=-3.0, maxval=3.0)
    u0_test = jnp.concatenate([u0_train[:1], jnp.array([-5.0]),
                               4.0 * jrand.normal(rng, (args.n_test - 2,))])
    t = lambda x: torch.from_numpy(np.array(x, copy=True))  # noqa: E731
    p1 = {k: ({q: t(w) for q, w in v.items()} if hasattr(v, "items") else t(v))
          for k, v in p1.items()}
    return p1, t(u0_train), t(u0_test)


JAX_DRAWS = td.Draws(
    lambda key, n: torch.from_numpy(np.array(jrand.permutation(jrand.PRNGKey(key), n))),
    lambda key, shape, dtype, device: torch.from_numpy(np.array(jrand.normal(
        jrand.PRNGKey(key), tuple(shape), {torch.float32: jnp.float32,
                                           torch.float64: jnp.float64}[dtype]))))


def run_both(argv, tmp_path, monkeypatch):
    """(records, printed lines, signals) of the JAX run and of the port's."""
    out = {}
    for side in ("jax", "torch"):
        path = tmp_path / f"{side}.jsonl"
        signals = []
        if side == "jax":
            orig = jd._ensemble_refinement_signal
            monkeypatch.setattr(jd, "_ensemble_refinement_signal", lambda *a, **k: (
                signals.append(np.asarray(r := orig(*a, **k))), r)[1])
        else:
            orig_t = td.ensemble_refinement_signal
            monkeypatch.setattr(td, "ensemble_refinement_signal", lambda *a, **k: (
                signals.append((r := orig_t(*a, **k)).numpy()), r)[1])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if side == "jax":
                jd.main(argv + ["--train-engine", "xla", "--jsonl", str(path), "--quiet"])
            else:
                args = td.build_parser().parse_args(
                    argv + ["--device", "cpu", "--train-engine", "torch", "--jsonl", str(path),
                            "--quiet"])
                p1, u0_train, u0_test = jax_initial_draws(args)
                assert u0_train.dtype == torch.float64
                assert all(x.dtype == torch.float32 for x in tree_leaves(p1))
                state, times = td.train(args, p1, u0_train, u0_test, draws=JAX_DRAWS,
                                        device="cpu")
        records = [json.loads(x) for x in path.read_text().splitlines()]
        out[side] = (records, buf.getvalue().splitlines(), signals)
    return out["jax"], out["torch"]


def assert_same_run(jax_run, port_run):
    (rj, lj, sj), (rt, lt, st) = jax_run, port_run
    assert len(rj) == len(rt) > 0
    for a, b in zip(rj, rt):
        assert (a["Epoch"], a["Refinements"]) == (b["Epoch"], b["Refinements"])
        np.testing.assert_allclose(b["Loss"], a["Loss"], rtol=RTOL)
        np.testing.assert_allclose(b["Error"], a["Error"], rtol=RTOL)
    assert len(sj) == len(st) > 0
    decided = 0
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(b.sum(), a.sum(), rtol=RTOL)
        top = np.sort(a)[::-1]
        if len(top) == 1 or top[0] - top[1] > 2 * RTOL * top[0]:
            assert int(np.argmax(b)) == int(np.argmax(a))
            decided += 1
    assert decided >= 1
    pat = re.compile(r"outer it (\d+): err_total=\S+  (.*)  \(n_steps=(\d+)\)")
    js = [pat.match(x).groups() for x in lj if pat.match(x)]
    ts = [pat.match(x).groups() for x in lt if pat.match(x)]
    assert js == ts and len(js) == len(sj)


def test_variable_params_run_matches_the_jax_driver(tmp_path, monkeypatch):
    argv = ["--method", "variable_params", "--width", "16", "--n-train", "128", "--n-steps", "2",
            "--epochs", "3", "--maxit", "2"]
    jax_run, port_run = run_both(argv, tmp_path, monkeypatch)
    assert_same_run(jax_run, port_run)
    assert "depth insert" in jax_run[1][-1] and "(n_steps=5)" in jax_run[1][-1]


@pytest.mark.parametrize("method,extra", [
    ("new_loss", []),
    ("detect", ["--epochs", "4"]),
    ("width", ["--depth-rel-tol", "0"]),
    ("width", []),
])
def test_every_method_runs_through_main_on_the_cpu(tmp_path, capsys, method, extra):
    main_args = ["--method", method, "--device", "cpu", "--n-train", "128", "--n-test", "16",
                 "--epochs", "2", "--maxit", "1", "--jsonl", str(tmp_path / "m.jsonl"),
                 "--quiet"] + extra
    state, times = td.main(main_args)
    out = capsys.readouterr().out
    assert "outer it 1:" in out
    recs = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["Loss"]) and np.isfinite(r["Error"]) for r in recs)
    if method == "width" and extra:
        assert "width grow at steps" in out and times.shape == (3,)
    elif method != "width":
        assert times.shape == (5,) and state.params["bias"].shape[0] == 4
    if method == "detect":  # no plateau in 4-epoch windows: 20·epochs per iteration
        assert len(recs) == 2 * 20 * 4


@pytest.mark.parametrize("method", ["variable_params", "width"])
def test_resume_continues_the_run(tmp_path, capsys, method):
    base = ["--method", method, "--device", "cpu", "--n-train", "128", "--n-test", "8",
            "--epochs", "2", "--quiet", "--depth-rel-tol", "0.5", "--width-capacity", "24"]
    full, t_full = td.main(base + ["--maxit", "2"])
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    td.main(base + ["--maxit", "0"] + ck)
    resumed, t_res = td.main(base + ["--maxit", "2", "--resume"] + ck)
    assert "resumed from checkpoint step 0 (outer it 1)" in capsys.readouterr().out
    assert json.loads((tmp_path / "ck" / "meta.json").read_text())["n_steps"] == len(t_res) - 1
    assert torch.equal(t_full, t_res)
    for k in full.params:
        torch.testing.assert_close(resumed.params[k], full.params[k], rtol=0, atol=0)


def test_refusals():
    # --dp as the JAX driver refuses it: not the shared chain, not autograd
    with pytest.raises(SystemExit, match="only supported with the fused engines"):
        td.main(["--dp", "--device", "cpu", "--method", "recurrent", "--train-engine", "cuda"])
    with pytest.raises(SystemExit, match="--dp requires the fused engine"):
        td.main(["--dp", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.main(["--epochs", "1", "--maxit", "0"])


@pytest.mark.parametrize("kind", ["per_step", "masked", "shared"])
def test_refinement_signal_matches_the_jax_driver(kind):
    s, rf = 3, 4
    rng = np.random.default_rng(20)
    dt = rng.uniform(0.2, 0.4, s)
    u0s, trues = rng.uniform(-3, 3, 24), rng.uniform(-1, 1, 24)
    n_active = None
    if kind == "shared":
        net = jm.ResNetBlock((8, 16))
        p = net.init(jax.random.PRNGKey(1), jnp.ones(1), 0.0, 0.1)["params"]
        jp = jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (s,) + l.shape), p)
        pp = interop.dense_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        port_net = models.ResNetBlock((8, 16))
    else:
        cap = 20 if kind == "masked" else 12
        p = jm.ResBlockSimple(12).init(jax.random.PRNGKey(2), jnp.ones(1), 0.0, 0.1)["params"]
        if kind == "masked":
            p = jm.masked_params_from_simple(p, cap)
            n_active = np.array([12, 15, 20], np.int32)
        jp = {k: np.stack([np.asarray(v) + 0.05 * n for n in range(s)]).astype(np.float32)
              for k, v in p.items()}
        pp = interop.resblock_params_from_numpy(jp)
        net = jm.ResBlockSimpleMasked(cap) if kind == "masked" else jm.ResBlockSimple(cap)
        port_net = (models.ResBlockSimpleMasked(cap) if kind == "masked"
                    else models.ResBlockSimple(cap))
    want = jd._ensemble_refinement_signal(
        net, jp, jnp.asarray(dt), rf, jnp.asarray(u0s), jnp.asarray(trues),
        n_active=None if n_active is None else jnp.asarray(n_active))
    if kind == "masked":
        step, stacked = (lambda u, t, d, pm: port_net(pm[0], u, t, d, pm[1]),
                         (pp, torch.from_numpy(n_active)))
    else:
        step, stacked = (lambda u, t, d, q: port_net(q, u, t, d)), pp
    with torch.no_grad():
        got = ensemble_refinement_signal(step, stacked, torch.from_numpy(dt), rf,
                                         torch.from_numpy(u0s), torch.from_numpy(trues))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-16)
    assert got.shape == (s,) and float(got.min()) > 0


def test_refinement_signal_at_a_tie_takes_the_jax_cotangent():
    """One member sits exactly on its target (its own terminal value, in
    each framework): d|u_N − true|/du_N is +1 there, as jax.grad(jnp.abs)
    gives, so that member still weighs in the mean signal."""
    from adjoint_ode_adaptivity_tpu.adjoint import interp_to_fine as j_interp
    from adjoint_ode_adaptivity_tpu.adjoint import refine_all as j_refine
    from adjoint_ode_adaptivity_tpu.march.fd import forward_march_per_step as j_fwd
    from adjoint_ode_adaptivity_tpu_torch.adjoint.estimate import interp_to_fine, refine_all
    from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march_per_step

    s, rf, tie = 3, 4, 5
    rng = np.random.default_rng(21)
    dt = rng.uniform(0.2, 0.4, s)
    u0s, trues = rng.uniform(-3, 3, 24), rng.uniform(-1, 1, 24)
    p = jm.ResBlockSimple(12).init(jax.random.PRNGKey(2), jnp.ones(1), 0.0, 0.1)["params"]
    jp = {k: np.stack([np.asarray(v) + 0.05 * n for n in range(s)]).astype(np.float32)
          for k, v in p.items()}
    net, port_net = jm.ResBlockSimple(12), models.ResBlockSimple(12)
    pp = interop.resblock_params_from_numpy(jp)

    def j_step(u, t, d, q):
        return net.apply({"params": q}, u, t, d)

    def j_terminal(u0):
        u = j_fwd(j_step, jnp.atleast_1d(u0), jnp.asarray(dt), jp)
        return j_interp(jnp.squeeze(u), jnp.asarray(dt), j_refine(jnp.asarray(dt), rf))[-1]

    step = lambda u, t, d, q: port_net(q, u, t, d)  # noqa: E731
    dt_t = torch.from_numpy(dt)
    with torch.no_grad():
        u = forward_march_per_step(step, torch.from_numpy(u0s)[:, None], dt_t, pp)[..., 0]
        u_fin = interp_to_fine(u, dt_t, refine_all(dt_t, rf))[-1]
    trues_t, trues_j = trues.copy(), trues.copy()
    trues_t[tie] = float(u_fin[tie])
    trues_j[tie] = float(jax.vmap(j_terminal)(jnp.asarray(u0s))[tie])
    want = jd._ensemble_refinement_signal(net, jp, jnp.asarray(dt), rf, jnp.asarray(u0s),
                                          jnp.asarray(trues_j))
    with torch.no_grad():
        got = ensemble_refinement_signal(step, pp, dt_t, rf, torch.from_numpy(u0s),
                                         torch.from_numpy(trues_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-16)
