"""The port's NN building blocks against the JAX package on the same inputs:
the residual blocks, the losses, the RK4 truth, the plateau and
width-vs-depth triggers, every surgery function, batching, and the interop
converters. Inputs are made from seeded NumPy generators (or JAX's own
parameter draws) and carried across as NumPy.

Tolerances: float64 states with float32 parameters compute in float64 on
both sides (JAX promotes, so does the port), so results agree to 1e-12
relative (a few ulp of float64 through a different summation order);
integer and boolean outputs (bins, insert positions, decisions) exactly.
"""
import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu import models as jm
from adjoint_ode_adaptivity_tpu import odes as jodes
from adjoint_ode_adaptivity_tpu.adapt import policy as jpol
from adjoint_ode_adaptivity_tpu.train import data as jdata
from adjoint_ode_adaptivity_tpu.train import losses as jloss
from adjoint_ode_adaptivity_tpu_torch import interop, models, odes
from adjoint_ode_adaptivity_tpu_torch.adapt import policy
from adjoint_ode_adaptivity_tpu_torch.train import data, losses

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

RTOL = 1e-12


def T(x):
    """A JAX/NumPy tree as tensors (dtypes kept)."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), x)


def N(x):
    return interop.tree_to_numpy(x)


def close(a, b, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _simple(f=6, seed=0):
    return jm.ResBlockSimple(f).init(jrand.PRNGKey(seed), jnp.ones(1), 0.0, 0.1)["params"]


def _u(n=17, seed=1):
    return np.random.default_rng(seed).uniform(-2.5, 2.5, n)


class TestBlocks:
    def test_resblock_simple_matches_jax(self):
        net, p = jm.ResBlockSimple(6), _simple()
        u = _u()
        want = jax.vmap(lambda x: net.apply({"params": p}, jnp.atleast_1d(x), 0.3, 0.05))(u)
        got = models.ResBlockSimple(6)(T(p), torch.from_numpy(u)[:, None], 0.3, 0.05)
        close(got, want)
        assert got.dtype == torch.float64

    def test_masked_block_and_embedding_match_jax(self):
        p = _simple(5)
        pm = jm.masked_params_from_simple(p, 9)
        got_pm = models.masked_params_from_simple(T(p), 9)
        for k in pm:
            np.testing.assert_array_equal(N(got_pm)[k], np.asarray(pm[k]))
        net = jm.ResBlockSimpleMasked(9)
        u = _u()
        for n_a in (3, 5, 9):
            want = jax.vmap(lambda x: net.apply({"params": pm}, jnp.atleast_1d(x), 0.0, 0.1, n_a))(u)
            got = models.ResBlockSimpleMasked(9)(got_pm, torch.from_numpy(u)[:, None], 0.0, 0.1,
                                                 n_a)
            close(got, want)

    @pytest.mark.parametrize("sizes", [(3, 5), (4,), (3, 6, 5)])
    def test_dense_chain_matches_jax(self, sizes):
        net = jm.ResNetBlock(sizes)
        p = net.init(jrand.PRNGKey(2), jnp.ones(1), 0.0, 0.1)["params"]
        u = _u()
        want = jax.vmap(lambda x: net.apply({"params": p}, jnp.atleast_1d(x), 0.0, 0.25))(u)
        got = models.ResNetBlock(sizes)(interop.dense_params_from_numpy(N(T(p))),
                                        torch.from_numpy(u)[:, None], 0.0, 0.25)
        close(got, want)

    def test_resblock_elu_and_single_neuron_layers_match_jax(self):
        net = jm.ResBlock(7)
        p = net.init(jrand.PRNGKey(3), jnp.ones(1), 0.0, 0.1)["params"]
        u = _u()
        want = jax.vmap(lambda x: net.apply({"params": p}, jnp.atleast_1d(x), 0.0, 0.2))(u)
        close(models.ResBlock(7)(T(p), torch.from_numpy(u)[:, None], 0.0, 0.2), want)
        sn = jm.SingleNeuronLayers(4)
        ps = sn.init(jrand.PRNGKey(4), jnp.ones(1))["params"]
        x = np.float64(0.7)
        close(models.SingleNeuronLayers(4)(T(ps), torch.tensor(x)), sn.apply({"params": ps}, x))

    def test_resnet_ode_matches_jax(self):
        net = jm.ResNetODE(4)
        dt = np.array([0.1, 0.2, 0.15])
        p = net.init(jrand.PRNGKey(5), jnp.ones(1), jnp.asarray(dt))["params"]
        want = net.apply({"params": p}, jnp.array([0.4]), jnp.asarray(dt))
        stacked = T(p["Scan_CarryBlock_0"]["ResNetBlock_0"])
        got = models.ResNetODE(4)(stacked, torch.tensor([0.4], dtype=torch.float64),
                                  torch.from_numpy(dt))
        close(got, want)

    def test_init_draws_lecun_normal_and_sorted_knots(self):
        g = torch.Generator().manual_seed(0)
        p = models.ResBlockSimple(4000).init_params(g)
        assert p["bias"].shape == (4000, 1) and p["weights2"].shape == (1, 4000)
        assert torch.all(torch.diff(p["bias"][:, 0]) >= 0)
        w1 = p["weights1"].double() * np.sqrt(4000)  # fan_in F: unit variance
        assert abs(float(w1.var()) - 1.0) < 0.08 and float(w1.abs().max()) <= 2 / 0.8796 + 1e-6
        w2 = p["weights2"].double()  # fan_in 1
        assert abs(float(w2.var()) - 1.0) < 0.08
        d = models.ResNetBlock((8, 16)).init_params(g)
        assert d["Dense_1"]["kernel"].shape == (8, 16) and not d["Dense_2"]["bias"].any()


class TestLossesAndData:
    def test_losses_match_jax(self):
        rng = np.random.default_rng(6)
        u, y, dt = rng.normal(size=5), rng.normal(size=5), rng.uniform(0.1, 0.3, 4)
        close(losses.terminal_mse(torch.from_numpy(u), y[-1]), jloss.terminal_mse(u, y[-1]))
        close(losses.trajectory_trapezoid(*map(torch.from_numpy, (u, y, dt))),
              jloss.trajectory_trapezoid(u, y, dt))
        close(losses.trajectory_mse(torch.from_numpy(u), torch.from_numpy(y)),
              jloss.trajectory_mse(u, y))
        for it in (0, 8, 9, 19, 33):
            assert losses.mixed_ramp_weight(it) == float(jloss.mixed_ramp_weight(jnp.asarray(it)))

    @pytest.mark.parametrize("name", ["du/dt=t*sin(u)", "du/dt=10cos(u)", "gaussian_mixture"])
    def test_rk4_truth_matches_jax(self, name):
        jode = jodes.gaussian_mixture_ode() if name == "gaussian_mixture" else jodes.get_ode(name)
        ode = odes.gaussian_mixture_ode() if name == "gaussian_mixture" else odes.get_ode(name)
        u0 = _u(9, 7)
        close(data.rk4_truth(ode.f, torch.from_numpy(u0), (0.0, 1.0), n_sub=64),
              jdata.rk4_truth(jode.f, jnp.asarray(u0), (0.0, 1.0), n_sub=64), rtol=1e-11)
        save = np.array([0.0, 0.13, 0.5, 0.77, 1.0])
        close(data.rk4_truth(ode.f, torch.from_numpy(u0), (0.0, 1.0), n_sub=64,
                             save_times=torch.from_numpy(save)),
              jdata.rk4_truth(jode.f, jnp.asarray(u0), (0.0, 1.0), n_sub=64,
                              save_times=jnp.asarray(save)), rtol=1e-11)

    def test_make_batches_and_split_match_jax(self):
        u0, tr = _u(37, 8), _u(37, 9)
        key = jrand.PRNGKey(3)
        ju, jt = jdata.make_batches(key, jnp.asarray(u0), jnp.asarray(tr), 8)
        perm = torch.from_numpy(np.asarray(jrand.permutation(key, 37)))
        pu, pt = data.make_batches(torch.from_numpy(u0), torch.from_numpy(tr), 8, perm=perm)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        gen = data.make_batches(torch.from_numpy(u0), torch.from_numpy(tr), 8,
                                generator=torch.Generator().manual_seed(0))[0]
        assert gen.shape == (4, 8) and len(set(gen.reshape(-1).tolist())) == 32
        (a, b), (c, d) = data.train_test_split(torch.from_numpy(u0), torch.from_numpy(tr), 5)
        (ja, jb), (jc, jd) = jdata.train_test_split(jnp.asarray(u0), jnp.asarray(tr), 5)
        for x, y in ((a, ja), (b, jb), (c, jc), (d, jd)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


class TestTriggers:
    @pytest.mark.parametrize("c1_over_tol", [0.999, 1.001, 0.5, 2.0, -0.9995])
    def test_plateau_detect_matches_jax_near_threshold(self, c1_over_tol):
        # log-loss windows whose slope sits just below and just above the
        # 5e-5 tolerance: the fit must decide as JAX's polyfit does
        tol, n = 5e-5, 200
        x = np.arange(n, dtype=np.float64)
        noise = 1e-9 * np.random.default_rng(10).normal(size=n)
        hist = np.exp(-3.0 + c1_over_tol * tol * x + 1e-8 * x**2 + noise)
        for min_loss in (1e10, float(np.mean(hist)) * 0.5):
            want_r, want_m = jpol.plateau_detect(jnp.asarray(hist), jnp.asarray(min_loss), tol)
            got_r, got_m = policy.plateau_detect(torch.from_numpy(hist), min_loss, tol)
            assert bool(got_r) == bool(want_r)
            close(got_m, want_m)
        # the fit itself, against JAX's polyfit coefficients
        want = np.asarray(jnp.polyfit(jnp.asarray(x), jnp.log(jnp.asarray(hist)), 2))
        lhs = torch.stack([torch.from_numpy(x) ** 2, torch.from_numpy(x), torch.ones(n,
                                                                               dtype=torch.float64)], 1)
        scale = torch.sqrt((lhs * lhs).sum(0))
        got = policy._lstsq_svd(lhs / scale, torch.log(torch.from_numpy(hist)),
                                n * np.finfo(np.float64).eps) / scale
        close(got, want, rtol=1e-9, atol=1e-15)

    def test_should_refine_depth_matches_jax(self):
        for drop in (0.05, 0.0999, 0.1001, 0.5, -0.1):
            hist = np.linspace(1.0, 1.0 - drop, 10)
            assert bool(policy.should_refine_depth(torch.from_numpy(hist), 0.1)) == bool(
                jpol.should_refine_depth(jnp.asarray(hist), 0.1))


def _stacked(f=6, s=3, seed=0):
    p = _simple(f, seed)
    rng = np.random.default_rng(seed)
    return {k: np.stack([np.asarray(v) + 0.01 * n * rng.normal(size=v.shape).astype(np.float32)
                         for n in range(s)]) for k, v in p.items()}


class TestSurgery:
    def test_insert_step_params_matches_jax(self):
        p = _stacked()
        for idx in (0, 1, 3):
            want = jm.insert_step_params(p, idx, mode="copy_left")
            got = models.insert_step_params(T(p), idx, mode="copy_left")
            for k in p:
                np.testing.assert_array_equal(N(got)[k], np.asarray(want[k]))
        key = jrand.PRNGKey(4)
        want = jm.insert_step_params(p, 2, mode="noise", key=key)
        noise = lambda shape, dtype, dev: torch.from_numpy(  # noqa: E731
            np.asarray(jrand.normal(key, tuple(shape), jnp.float32)))
        got = models.insert_step_params(T(p), 2, mode="noise", noise=noise)
        for k in p:
            np.testing.assert_array_equal(N(got)[k], np.asarray(want[k]))

    @pytest.mark.parametrize("fill", ["copy_left", "zero"])
    def test_insert_step_params_padded_matches_jax(self, fill):
        p = _stacked(s=5)
        tree = {"p": p, "count": np.int32(7)}
        for idx in (0, 2, 4):
            want = jm.insert_step_params_padded(tree, 3, jnp.asarray(idx), fill=fill)
            got = models.insert_step_params_padded(T(tree), 3, torch.tensor(idx), fill=fill)
            for k in p:
                np.testing.assert_array_equal(N(got)["p"][k], np.asarray(want["p"][k]))
            assert int(got["count"]) == 7

    def test_bins_and_width_growth_match_jax(self):
        p = _simple(8, 1)
        bias = np.sort(np.asarray(p["bias"][:, 0]).astype(np.float64))
        u = _u(40, 11)
        loss = np.random.default_rng(12).uniform(0, 1e-3, 40)
        for x, y in zip(models.bin_losses(*map(torch.from_numpy, (u, loss, bias))),
                        jm.bin_losses(jnp.asarray(u), jnp.asarray(loss), jnp.asarray(bias))):
            close(x, y)
        for tol in (5e-5, 1.0):  # insert, and no insert
            want, wi = jm.grow_width(p, jnp.asarray(u), jnp.asarray(loss), tol=tol)
            got, gi = models.grow_width(T(p), torch.from_numpy(u), torch.from_numpy(loss), tol=tol)
            assert gi == wi
            for k in want:
                close(N(got)[k], want[k])
        b_new, w_in, w_out = models.insert_neuron(
            torch.from_numpy(bias), torch.ones(8, 1), torch.ones(1, 8), 3, torch.tensor(0.25))
        jb, jwi, jwo = jm.insert_neuron(jnp.asarray(bias), jnp.ones((8, 1), jnp.float32),
                                        jnp.ones((1, 8), jnp.float32), jnp.asarray(3),
                                        jnp.asarray(0.25))
        for x, y in ((b_new, jb), (w_in, jwi), (w_out, jwo)):
            close(x, y)

    def test_padded_width_machinery_matches_jax(self):
        pm = jm.masked_params_from_simple(_simple(6, 2), 10)
        rng = np.random.default_rng(13)
        pm = {k: np.asarray(v) + (rng.normal(size=v.shape) * 0.1).astype(np.float32)
              for k, v in pm.items()}
        u = _u(50, 14)
        for n_a in (4, 6, 10):
            srt = jm.sort_neurons_padded(pm, n_a)
            got_srt = models.sort_neurons_padded(T(pm), n_a)
            for k in pm:
                np.testing.assert_array_equal(N(got_srt)[k], np.asarray(srt[k]))
            b = np.asarray(srt["bias"][:, 0])
            close(models.layer_knot_losses(torch.from_numpy(u), torch.from_numpy(b).double(), n_a),
                  jm.layer_knot_losses(jnp.asarray(u), jnp.asarray(b, jnp.float64), n_a))
            loss = np.abs(np.sin(3 * u)) * 1e-3
            for x, y in zip(models.bin_losses_padded(torch.from_numpy(u), torch.from_numpy(loss),
                                                     torch.from_numpy(b).double(), n_a),
                            jm.bin_losses_padded(jnp.asarray(u), jnp.asarray(loss),
                                                 jnp.asarray(b, jnp.float64), n_a)):
                close(x, y)
            for k_ins in (0, 2, n_a):
                want, wn = jm.insert_neuron_padded(srt, jnp.asarray(n_a), jnp.asarray(k_ins),
                                                   jnp.asarray(0.5))
                got, gn = models.insert_neuron_padded(T(srt), torch.tensor(n_a), k_ins,
                                                      torch.tensor(0.5))
                assert int(gn) == int(wn)
                for k in pm:
                    np.testing.assert_array_equal(N(got)[k], np.asarray(want[k]))
            for tol in (1e-4, 1.0):
                want, wn, wi = jm.grow_width_padded(pm, jnp.asarray(n_a), jnp.asarray(u),
                                                    jnp.asarray(loss), tol=tol)
                got, gn, gi = models.grow_width_padded(T(pm), torch.tensor(n_a),
                                                       torch.from_numpy(u), torch.from_numpy(loss),
                                                       tol=tol)
                assert (int(gn), bool(gi)) == (int(wn), bool(wi))
                for k in pm:
                    close(N(got)[k], want[k])

    def test_grow_width_all_steps_and_moments_match_jax(self):
        cap, s = 10, 3
        pm = jm.masked_params_from_simple(_simple(6, 3), cap)
        stacked = {k: np.stack([np.asarray(v)] * s) for k, v in pm.items()}
        n_active = np.array([6, 6, 10], np.int32)
        rng = np.random.default_rng(15)
        u_states = rng.uniform(-2, 2, (40, s + 1))
        trues = rng.uniform(-2, 2, 40)
        want = jm.grow_width_all_steps(stacked, jnp.asarray(n_active), jnp.asarray(u_states),
                                       jnp.asarray(trues), tol=1e-3)
        got = models.grow_width_all_steps(T(stacked), torch.from_numpy(n_active),
                                          torch.from_numpy(u_states), torch.from_numpy(trues),
                                          tol=1e-3)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2].any() and not got[2].all()
        for k in stacked:
            close(N(got[0])[k], want[0][k])
        import optax

        opt = optax.adam(1e-3).init(jax.tree_util.tree_map(jnp.asarray, stacked))
        opt = jax.tree_util.tree_map(lambda x: x + 1.0, opt)
        want_o = jm.zero_step_moments(opt, want[2])
        state = interop.adam_state_from_numpy(opt[0].count, opt[0].mu, opt[0].nu)
        got_o = models.zero_step_moments(state, got[2])
        assert got_o.step == int(want_o[0].count)
        for k in stacked:
            np.testing.assert_array_equal(N(got_o.exp_avg)[k], np.asarray(want_o[0].mu[k]))
            np.testing.assert_array_equal(N(got_o.exp_avg_sq)[k], np.asarray(want_o[0].nu[k]))


class TestInterop:
    def test_parameter_and_adam_round_trips(self):
        import optax

        p = _stacked()
        got = interop.resblock_params_from_numpy(p)
        for k in p:
            back = interop.tree_to_numpy(got)[k]
            np.testing.assert_array_equal(back, p[k])
            assert back.dtype == p[k].dtype
        with pytest.raises(KeyError):
            interop.resblock_params_from_numpy({"bias": p["bias"]})
        d = jm.ResNetBlock((3, 5)).init(jrand.PRNGKey(0), jnp.ones(1), 0.0, 0.1)["params"]
        dn = jax.tree_util.tree_map(np.asarray, d)
        back = interop.tree_to_numpy(interop.dense_params_from_numpy(dn))
        for k in dn:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(back[k][leaf], dn[k][leaf])
        tx = optax.adam(1e-3)
        opt = tx.init(dn)
        _, opt = tx.update(jax.tree_util.tree_map(jnp.ones_like, dn), opt)
        st = interop.adam_state_from_numpy(opt[0].count, opt[0].mu, opt[0].nu)
        count, mu, nu = interop.tree_to_numpy(st)
        assert count == 1
        for k in dn:
            np.testing.assert_array_equal(mu[k]["kernel"], np.asarray(opt[0].mu[k]["kernel"]))
            np.testing.assert_array_equal(nu[k]["bias"], np.asarray(opt[0].nu[k]["bias"]))
