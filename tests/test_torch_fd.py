"""The port's FD building blocks against the JAX package, float64 on the
CPU: the ODE registry (f, closed-form f_u, the gaussian-mixture constants),
the functionals and K = ∂J/∂U, the one-step marches, the discrete adjoints,
the estimate (interpolation on padded grids, residual, both indicator
conventions), the padded bisections and the fast-trig polynomials.

Inputs come from numpy seeds and go to both packages. Tolerances: the two
packages evaluate the same float64 formulas in a different operation order
(XLA fuses, torch does not), so values agree to a few ulp — 1e-13 relative
for a march or adjoint of a few dozen steps; exact equality where the
operations are the same (constants, bisection, interpolation at nodes)."""
import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu import functionals as jfnl
from adjoint_ode_adaptivity_tpu import odes as jodes
from adjoint_ode_adaptivity_tpu.adapt import policy as jpol
from adjoint_ode_adaptivity_tpu.adjoint import discrete as jdis
from adjoint_ode_adaptivity_tpu.adjoint import estimate as jest
from adjoint_ode_adaptivity_tpu.march import fd as jfd
from adjoint_ode_adaptivity_tpu.ops.pallas import fast_trig as jft
from adjoint_ode_adaptivity_tpu_torch import functionals as fnl
from adjoint_ode_adaptivity_tpu_torch import interop, odes
from adjoint_ode_adaptivity_tpu_torch.adapt import policy as pol
from adjoint_ode_adaptivity_tpu_torch.adjoint import discrete as dis
from adjoint_ode_adaptivity_tpu_torch.adjoint import estimate as est
from adjoint_ode_adaptivity_tpu_torch.march import fd
from adjoint_ode_adaptivity_tpu_torch.ops import fast_trig as ft

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
SCALAR_ODES = ["du/dt=u", "du/dt=sin(u)", "du/dt=cos(2*pi*u)", "du/dt=10cos(u)",
               "du/dt=t*sin(u)", "gaussian_mixture"]
RTOL = 1e-13


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _grid(n, seed=0):
    """A nonuniform grid of n steps over [0, 2]."""
    w = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    return 2.0 * w / w.sum()


def _padded_times(n_act, max_nodes, seed=0):
    t = np.concatenate([[0.0], np.cumsum(_grid(n_act, seed))])
    return np.concatenate([t, np.full(max_nodes - n_act - 1, t[-1])])


# ------------------------------------------------------------------ registry


def test_gaussian_mixture_constants_equal_the_jax_draws():
    """The port's literals are the JAX package's PRNG draws (keys 1, 2, 3;
    t_m reuses the u_m key, as the reference does), bit for bit."""
    m_rng, s_rng, c_rng = jrand.PRNGKey(1), jrand.PRNGKey(2), jrand.PRNGKey(3)
    draws = {
        "u_m": jrand.normal(m_rng, (5,)),
        "u_s": jnp.abs(jrand.normal(s_rng, (5,)) / 3 + 1),
        "t_m": jnp.abs(jrand.normal(m_rng, (3,)) / 6 + 0.5),
        "t_s": jnp.abs(jrand.normal(s_rng, (3,)) / 3 + 1),
        "c": jrand.normal(c_rng, (8,)),
    }
    for name, value in draws.items():
        np.testing.assert_array_equal(np.array(odes.GAUSSIAN_MIXTURE_CONSTANTS[name]),
                                      np.asarray(value), err_msg=name)
    assert odes.get_ode("gaussian_mixture").kernel_params == tuple(
        tuple(odes.GAUSSIAN_MIXTURE_CONSTANTS[k]) for k in ("u_m", "u_s", "t_m", "t_s", "c"))


@pytest.mark.parametrize("name", SCALAR_ODES)
def test_registry_f_and_closed_form_f_u_match_jax(name):
    """f against the JAX entry's f, and the port's closed-form f_u against
    jax.jvp of that f (the JAX package differentiates the entries it gives
    no f_u by AD)."""
    rng = np.random.default_rng(1)
    u, t = rng.uniform(-3, 3, 64), rng.uniform(0, 2, 64)
    ref = jodes.get_ode(name)
    ours = odes.get_ode(name)
    assert ours.kernel_id == odes.KERNEL_IDS[name]
    f_ref = np.asarray(ref.f(jnp.asarray(u), jnp.asarray(t)))
    fu_ref = np.asarray(jax.jvp(lambda x: ref.f(x, jnp.asarray(t)), (jnp.asarray(u),),
                                (jnp.ones(64),))[1])
    np.testing.assert_allclose(ours.f(t64(u), t64(t)).numpy(), f_ref, rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(ours.f_u(t64(u), t64(t)).numpy(), fu_ref, rtol=RTOL, atol=1e-15)


def test_harmonic_oscillator_f_jacobian_and_exact_solutions():
    rng = np.random.default_rng(2)
    u = rng.uniform(-1, 1, (16, 2))
    ref, ours = jodes.get_ode("harmonic_oscillator"), odes.get_ode("harmonic_oscillator")
    np.testing.assert_array_equal(ours.f(t64(u), 0.3).numpy(), np.asarray(ref.f(jnp.asarray(u), 0.3)))
    jac = np.asarray(jax.jacfwd(lambda x: ref.f(x, 0.0))(jnp.asarray(u[0])))  # [m, i]
    np.testing.assert_array_equal(ours.f_u(t64(u[0]), 0.0).numpy(), jac)
    for name, u0 in (("harmonic_oscillator", u[0]), ("du/dt=sin(u)", 1.3), ("du/dt=u", 0.7)):
        a = jodes.get_ode(name).exact_fwd(jnp.asarray(1.7), jnp.asarray(u0))
        b = odes.get_ode(name).exact_fwd(t64(1.7), t64(u0))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)


def test_exact_adjoint_rk4_matches_jax():
    t_eval = np.linspace(0.0, 2.0, 9)
    g_u = jfnl.get_functional("J=int(u^2)").g_u
    want = jodes.exact_adjoint_rk4(jodes.get_ode("du/dt=sin(u)"), g_u, jnp.asarray(t_eval),
                                   1.0, 2.0, n_sub=64)
    got = odes.exact_adjoint_rk4(odes.get_ode("du/dt=sin(u)"),
                                 fnl.get_functional("J=int(u^2)").g_u, t64(t_eval), 1.0, 2.0,
                                 n_sub=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_gaussian_mixture_from_numpy_carries_the_constants():
    c = odes.GAUSSIAN_MIXTURE_CONSTANTS
    ode = interop.gaussian_mixture_from_numpy(*(np.array(c[k]) for k in
                                                ("u_m", "u_s", "t_m", "t_s", "c")))
    u = t64(np.linspace(-2, 2, 7))
    assert torch.equal(ode.f(u, 0.4), odes.get_ode("gaussian_mixture").f(u, 0.4))
    with pytest.raises(ValueError):
        interop.gaussian_mixture_from_numpy([0.0], [1.0], [0.0], [1.0], [1.0])


# --------------------------------------------------------------- functionals


@pytest.mark.parametrize("name", ["J=int(u)", "J=int(u^2)", "J=u_N"])
def test_functional_value_and_k_match_jax_grad(name):
    rng = np.random.default_rng(3)
    u, dt = rng.uniform(-2, 2, 13), _grid(12)
    ref, ours = jfnl.get_functional(name), fnl.get_functional(name)
    np.testing.assert_allclose(float(ours.value(t64(u), t64(dt))),
                               float(ref.value(jnp.asarray(u), jnp.asarray(dt))), rtol=RTOL)
    np.testing.assert_allclose(fnl.get_k(ours, t64(u), t64(dt)).numpy(),
                               np.asarray(jfnl.get_k(ref, jnp.asarray(u), jnp.asarray(dt))),
                               rtol=RTOL, atol=0)


# ------------------------------------------------------------ march, adjoint


@pytest.mark.parametrize("rule", ["euler_step", "heun_step", "rk4_step"])
def test_forward_march_and_padding_identity(rule):
    dt = np.concatenate([_grid(10, seed=4), np.zeros(3)])  # zero-width padding
    ref_step = getattr(jfd, rule)(jodes.get_ode("du/dt=t*sin(u)").f)
    step = getattr(fd, rule)(odes.get_ode("du/dt=t*sin(u)").f)
    want = jfd.forward_march(ref_step, 1.2, jnp.asarray(dt), 0.5)
    got = fd.forward_march(step, 1.2, t64(dt), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert torch.equal(got[-1], got[-4])  # dt == 0 steps are exact identities
    np.testing.assert_allclose(fd.times_from_dt(t64(dt), 0.5).numpy(),
                               np.asarray(jfd.times_from_dt(jnp.asarray(dt), 0.5)), rtol=RTOL)


def test_adjoints_match_jax_and_the_dense_oracle():
    dt = _grid(12, seed=5)
    ode_j, ode_t = jodes.get_ode("du/dt=sin(u)"), odes.get_ode("du/dt=sin(u)")
    step_j, step_t = jfd.euler_step(ode_j.f), fd.euler_step(ode_t.f)
    u_j = jfd.forward_march(step_j, 0.9, jnp.asarray(dt))
    u_t = fd.forward_march(step_t, 0.9, t64(dt))
    k_j = jfnl.get_k(jfnl.get_functional("J=int(u^2)"), u_j, jnp.asarray(dt))
    k_t = fnl.get_k(fnl.get_functional("J=int(u^2)"), u_t, t64(dt))
    want = np.asarray(jdis.adjoint_march(step_j, u_j, jnp.asarray(dt), k_j))
    for got in (
        dis.adjoint_march(step_t, u_t, t64(dt), k_t),
        dis.adjoint_march_linearized(ode_t.f_u, u_t, t64(dt), k_t),
        dis.adjoint_dense_oracle(step_t, u_t, t64(dt), k_t),
    ):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


def test_per_step_parameter_march_and_adjoint_match_jax():
    """Per-step parameters (the ResNet-ODE pattern): step n scales f by p_n."""
    dt, p = _grid(8, seed=6), np.random.default_rng(6).uniform(0.5, 1.5, 8)

    def step_j(u, t, h, pn):
        return u + pn * jnp.sin(u) * h

    def step_t(u, t, h, pn):
        return u + pn * torch.sin(u) * h

    u_j = jfd.forward_march_per_step(step_j, 0.4, jnp.asarray(dt), jnp.asarray(p))
    u_t = fd.forward_march_per_step(step_t, 0.4, t64(dt), t64(p))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=RTOL)
    k = np.linspace(0.1, 1.0, 9)
    want = jdis.adjoint_march_per_step(step_j, u_j, jnp.asarray(dt), jnp.asarray(k), jnp.asarray(p))
    got = dis.adjoint_march_per_step(step_t, u_t, t64(dt), t64(k), t64(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# ------------------------------------------------------------------ estimate


def test_interp_equals_jnp_interp_on_padded_grids():
    """Padded grids repeat the final time: zero-width coarse intervals must
    give no NaN and jnp.interp's values, clamps included. The port computes
    jnp.interp's formula op for op; XLA's compiled float64 arithmetic rounds
    the slope term differently in the last bit, so values between nodes
    agree to one ulp of max|fp|, and values at the nodes, at the clamps and
    on zero-width intervals exactly."""
    times = _padded_times(5, 9, seed=7)
    fp = np.random.default_rng(7).uniform(-1, 1, 9)
    ulp = np.finfo(np.float64).eps * np.max(np.abs(fp))

    def ref(x, xp, f):
        return np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(f)))

    x = np.linspace(-0.5, 2.5, 41)
    got = est.interp(t64(x), t64(times), t64(fp)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref(x, times, fp), rtol=0, atol=ulp)
    at_nodes = est.interp(t64(times), t64(times), t64(fp)).numpy()
    np.testing.assert_array_equal(at_nodes, ref(times, times, fp))
    outside = np.array([-1.0, -1e-9, 2.0, 2.0 + 1e-9, 3.0])
    np.testing.assert_array_equal(est.interp(t64(outside), t64(times), t64(fp)).numpy(),
                                  ref(outside, times, fp))
    # one grid per column (the per-member layout) gives each column's values
    cols = np.stack([times, _padded_times(8, 9, seed=8)], axis=1)
    fps = np.stack([fp, fp[::-1]], axis=1)
    xs = np.stack([x[:20], x[20:40]], axis=1)
    got2 = est.interp(t64(xs), t64(cols), t64(fps)).numpy()
    for c in range(2):
        np.testing.assert_allclose(got2[:, c], ref(xs[:, c], cols[:, c], fps[:, c]),
                                   rtol=0, atol=ulp)


@pytest.mark.parametrize("convention", ["strided", "block"])
def test_estimate_pipeline_on_a_padded_grid_matches_jax(convention):
    rf = 4
    dt = np.diff(_padded_times(6, 10, seed=9))
    ode_j, ode_t = jodes.get_ode("gaussian_mixture"), odes.get_ode("gaussian_mixture")
    step_j, step_t = jfd.euler_step(ode_j.f), fd.euler_step(ode_t.f)
    dtf_j, dtf_t = jest.refine_all(jnp.asarray(dt), rf), est.refine_all(t64(dt), rf)
    np.testing.assert_array_equal(dtf_t.numpy(), np.asarray(dtf_j))
    u_j = jfd.forward_march(step_j, 0.3, jnp.asarray(dt))
    u_t = fd.forward_march(step_t, 0.3, t64(dt))
    uf_j = jest.interp_to_fine(u_j, jnp.asarray(dt), dtf_j)
    uf_t = est.interp_to_fine(u_t, t64(dt), dtf_t)
    np.testing.assert_allclose(uf_t.numpy(), np.asarray(uf_j), rtol=RTOL)
    res_j = jest.residual(step_j, uf_j, dtf_j)
    res_t = est.residual(step_t, uf_t, dtf_t)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-9, atol=1e-15)
    v = np.random.default_rng(9).uniform(-1, 1, res_t.shape[0])
    err_j = jest.coarse_indicator(jest.error_estimate(res_j, jnp.asarray(v)), rf, convention)
    err_t = est.coarse_indicator(est.error_estimate(res_t, t64(v)), rf, convention)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-9, atol=1e-15)
    assert np.all(err_t.numpy()[6:] == 0)  # zero-width steps contribute exactly 0
    with pytest.raises(ValueError):
        est.coarse_indicator(err_t, rf, "nope")


# ------------------------------------------------------------------ policies


def test_padded_bisections_are_bit_equal_to_jax():
    rng = np.random.default_rng(10)
    for seed, n_act in ((11, 4), (12, 7), (13, 8)):  # n_act 8 of 9 nodes: full grid
        times = _padded_times(n_act, 9, seed=seed)
        err = np.concatenate([rng.uniform(0, 1, n_act), np.zeros(8 - n_act)])
        err[1] = err.max()  # a tie: both must take the first maximum
        blocked = np.zeros(8, bool)
        blocked[int(np.argmax(err))] = True
        ja = jpol.bisect_refine_padded(jnp.asarray(times), jnp.asarray(n_act, jnp.int32),
                                       jnp.asarray(err))
        to = pol.bisect_refine_padded(t64(times), torch.tensor(n_act, dtype=torch.int32), t64(err))
        np.testing.assert_array_equal(to[0].numpy(), np.asarray(ja[0]))
        assert int(to[1]) == int(ja[1])
        jm = jpol.bisect_refine_padded_masked(jnp.asarray(times), jnp.asarray(n_act, jnp.int32),
                                              jnp.asarray(err), jnp.asarray(blocked))
        tm = pol.bisect_refine_padded_masked(t64(times), torch.tensor(n_act, dtype=torch.int32),
                                             t64(err), torch.as_tensor(blocked))
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jc = jpol.coarsen_merge_padded(jnp.asarray(times), jnp.asarray(n_act, jnp.int32),
                                       jnp.asarray(err), jnp.asarray(blocked), 0.9)
        tc = pol.coarsen_merge_padded(t64(times), torch.tensor(n_act, dtype=torch.int32),
                                      t64(err), torch.as_tensor(blocked), 0.9)
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the member-batched form equals one call per member
    times = np.stack([_padded_times(k, 9, seed=k) for k in (3, 5, 8)])
    err = rng.uniform(0, 1, (3, 8)) * (np.arange(8) < np.array([3, 5, 8])[:, None])
    n_act = torch.tensor([3, 5, 8], dtype=torch.int32)
    tb, nb = pol.bisect_refine_padded(t64(times), n_act, t64(err))
    for m in range(3):
        ja = jpol.bisect_refine_padded(jnp.asarray(times[m]), jnp.asarray(int(n_act[m]), jnp.int32),
                                       jnp.asarray(err[m]))
        np.testing.assert_array_equal(tb[m].numpy(), np.asarray(ja[0]))
        assert int(nb[m]) == int(ja[1])


def test_dynamic_bisections_and_pad_times_match_jax():
    times, err = np.concatenate([[0.0], np.cumsum(_grid(6, 14))]), np.random.default_rng(14).uniform(0, 1, 6)
    np.testing.assert_array_equal(pol.bisect_refine(t64(times), t64(err)).numpy(),
                                  np.asarray(jpol.bisect_refine(jnp.asarray(times), jnp.asarray(err))))
    mask = np.array([False, True, False, False, True, False])
    jt, ji = jpol.bisect_refine_masked(jnp.asarray(times), jnp.asarray(err), jnp.asarray(mask))
    tt, ti = pol.bisect_refine_masked(t64(times), t64(err), torch.as_tensor(mask))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ti == ji
    for tol in (0.0, 0.8, 5.0):
        np.testing.assert_array_equal(
            pol.coarsen_merge(t64(times), t64(err), tol).numpy(),
            np.asarray(jpol.coarsen_merge(jnp.asarray(times), jnp.asarray(err), tol)))
    pj, nj = jpol.pad_times(jnp.asarray(times), 10)
    pt, nt = pol.pad_times(t64(times), 10)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert int(nt) == int(nj)
    with pytest.raises(ValueError):
        pol.pad_times(t64(times), 3)


# ----------------------------------------------------------------- fast trig


def test_fast_trig_coefficients_equal_jax_and_accuracy_bounds_hold():
    assert ft.SIN_C == jft._SIN_C and ft.COS_C == jft._COS_C
    assert ft.DOMAIN == jft.DOMAIN
    # tests/test_fast_trig.py's bounds: float64 ...
    x = np.linspace(-ft.DOMAIN, ft.DOMAIN, 200_001)
    assert np.max(np.abs(ft.fast_sin(x) - np.sin(x))) < 2e-7
    assert np.max(np.abs(ft.fast_cos(x) - np.cos(x))) < 2e-8
    s, c = ft.fast_sincos(t64(x))
    assert torch.equal(s, ft.fast_sin(t64(x))) and torch.equal(c, ft.fast_cos(t64(x)))
    # ... and float32 Horner roundoff (peaks near |x| = DOMAIN)
    x32 = torch.linspace(-ft.DOMAIN, ft.DOMAIN, 100_001, dtype=torch.float32)
    ref = x32.double()
    assert float((ft.fast_sin(x32).double() - torch.sin(ref)).abs().max()) < 2e-6
    assert float((ft.fast_cos(x32).double() - torch.cos(ref)).abs().max()) < 2e-6
