"""The FD kernels' plain PyTorch versions (ops/cuda/fd_ensemble.py) against
the JAX package, float64 on the CPU, and the wrappers' CPU behaviour.

F1 and F2 are held to JAX's XLA primitives composed per IC (forward march,
jnp.interp to the fine grid, jax.grad of J = ∫u², the VJP adjoint, the
residual and the block indicator — tests/test_pallas.py:306-355's
reference), F3 to the per-member Pallas kernel in interpret mode (B = 8, a
few steps) and to the same composition per member. Tolerance: the plain
versions interpolate as traj[i] + (q/rf)·Δ and form K and the adjoint in
closed form, where the composition uses jnp.interp, jax.grad and VJPs:
the same float64 quantities in another operation order, so they agree to
float64 roundoff over a sweep of a few dozen fine nodes (atol 1e-12 on
indicators of order 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu import functionals as jfnl
from adjoint_ode_adaptivity_tpu import odes as jodes
from adjoint_ode_adaptivity_tpu.adjoint import (
    adjoint_march,
    coarse_indicator,
    interp_to_fine,
    refine_all,
    residual,
)
from adjoint_ode_adaptivity_tpu.march import euler_step, forward_march
from adjoint_ode_adaptivity_tpu.ops.pallas.fd_ensemble import make_pallas_fd_estimate_per_member
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
ATOL = 1e-12
SCALAR_ODES = ["du/dt=u", "du/dt=sin(u)", "du/dt=cos(2*pi*u)", "du/dt=10cos(u)",
               "du/dt=t*sin(u)", "gaussian_mixture"]
DT = np.array([0.1, 0.3, 0.05, 0.2, 0.15, 0.25])  # nonuniform, 6 steps


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _xla_indicator(name, dt, rf, u0s, convention="block"):
    """Per-IC indicator (n_steps, n) from the JAX package's XLA primitives."""
    ode = jodes.get_ode(name)
    step = euler_step(ode.f)
    dt = jnp.asarray(dt)
    dtf = refine_all(dt, rf)
    vec = jnp.ndim(u0s) == 2

    def value(uf, h):
        return jnp.sum((uf[:-1] ** 2).sum(-1) * h) if vec else jfnl.get_functional(
            "J=int(u^2)").value(uf, h)

    def one(u0):
        u = forward_march(step, u0, dt)
        uf = interp_to_fine(u, dt, dtf)
        v = adjoint_march(step, uf, dtf, jax.grad(value)(uf, dtf))
        e = residual(step, uf, dtf) * v
        return coarse_indicator(e.sum(-1) if vec else e, rf, convention)

    return np.asarray(jax.vmap(one)(jnp.asarray(u0s))).T


@pytest.mark.parametrize("name", SCALAR_ODES)
def test_fd_ensemble_plain_matches_xla_primitives(name):
    rf = 4
    u0s = np.random.default_rng(1).uniform(-1, 1, 48)
    want = _xla_indicator(name, DT, rf, u0s)
    run = fe.make_cuda_fd_ensemble(name, len(DT), rf, DT, device="cpu")
    before = fe.fd_ensemble.launches
    got = run(t64(u0s))
    assert fe.fd_ensemble.launches == before  # a CPU tensor takes the plain version
    assert got.shape == (len(DT), 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fd_ensemble_uniform_dt_equals_its_vector():
    u0s = t64(np.random.default_rng(2).uniform(-3, 3, 32))
    a = fe.make_cuda_fd_ensemble("du/dt=sin(u)", 8, 4, 0.25, device="cpu")(u0s)
    b = fe.make_cuda_fd_ensemble("du/dt=sin(u)", 8, 4, [0.25] * 8, device="cpu")(u0s)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(fe.fine_grid(8, 4, 0.25), fe.fine_grid(8, 4, np.full(8, 0.25)))


def test_fast_trig_pipeline_agrees_with_libm():
    """tests/test_fast_trig.py's pipeline check through the plain version:
    the polynomial error (≤ 2e-7 per evaluation) stays at float32-roundoff
    scale through march, adjoint and indicator, and the ensemble signal's
    argmax — what the adaptive loop consumes — is the same."""
    n_steps, rf = 16, 4
    u0s = t64(np.random.default_rng(3).uniform(-3, 3, 2048))
    libm = fe.make_cuda_fd_ensemble("du/dt=sin(u)", n_steps, rf, 2.0 / n_steps, device="cpu")
    fast = fe.make_cuda_fd_ensemble("du/dt=sin(u)", n_steps, rf, 2.0 / n_steps, trig="fast",
                                    device="cpu")
    got, want = fast(u0s).numpy(), libm(u0s).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-4)
    assert int(np.argmax(got.mean(1))) == int(np.argmax(want.mean(1)))


def test_fd_ensemble_vec_plain_matches_xla_primitives():
    rf = 4
    u0s = np.random.default_rng(21).uniform(-1, 1, (32, 2))
    want = _xla_indicator("harmonic_oscillator", DT[:5], rf, u0s)
    got = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", 5, rf, DT[:5], device="cpu")(t64(u0s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _padded_dt(b, n_steps, seed):
    """Per-member grids over [0, 2] with 2..n_steps active steps and
    zero-width padded tails."""
    rng = np.random.default_rng(seed)
    times = np.full((b, n_steps + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, n_steps + 1, b)):
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0, 2, n_act - 1)), [2.0]])
    return np.diff(times, axis=1)


def test_fd_estimate_per_member_plain_matches_the_interpret_mode_kernel():
    """_pm_kernel (fd_ensemble.py:357) in interpret mode at B = 8: both
    conventions, err and J, zero-width tails contributing exactly 0."""
    b, n_steps, rf = 8, 5, 4
    dt_b = _padded_dt(b, n_steps, seed=4)
    u0s = np.random.default_rng(4).uniform(0.5, 2.0, b)
    assert (dt_b == 0).any()
    for conv in ("strided", "block"):
        ref = make_pallas_fd_estimate_per_member(
            lambda u, t: jnp.sin(u), lambda u, t: jnp.cos(u), n_steps, rf,
            convention=conv, interpret=True)
        e_ref, j_ref = ref(jnp.asarray(dt_b), jnp.asarray(u0s))
        run = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", n_steps, rf, conv, device="cpu")
        e, j = run(t64(dt_b), t64(u0s))
        np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0, atol=ATOL)
        np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), rtol=1e-13)
        assert np.all(e.numpy()[dt_b == 0] == 0)


@pytest.mark.parametrize("convention", ["strided", "block"])
def test_fd_estimate_per_member_plain_time_dependent_matches_xla(convention):
    """A time-dependent RHS on per-member grids: the JAX package's XLA
    primitives vmapped over members (tc accumulates from t0 = 0 in both)."""
    b, n_steps, rf = 6, 5, 4
    dt_b = _padded_dt(b, n_steps, seed=5)
    u0s = np.random.default_rng(5).uniform(-1, 1, b)
    step = euler_step(jodes.get_ode("gaussian_mixture").f)
    j_fn = jfnl.get_functional("J=int(u^2)").value

    def one(u0, dt):
        dtf = refine_all(dt, rf)
        u = forward_march(step, u0, dt)
        uf = interp_to_fine(u, dt, dtf)
        v = adjoint_march(step, uf, dtf, jax.grad(j_fn)(uf, dtf))
        return coarse_indicator(residual(step, uf, dtf) * v, rf, convention), j_fn(u, dt)

    want, j_want = jax.vmap(one)(jnp.asarray(u0s), jnp.asarray(dt_b))
    run = fe.make_cuda_fd_estimate_per_member("gaussian_mixture", n_steps, rf, convention,
                                              device="cpu")
    e, j = run(t64(dt_b), t64(u0s))
    np.testing.assert_allclose(e.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_want), rtol=1e-13)


def test_entry_points_refuse_what_the_kernels_do_not_take():
    # an ODE without a kernel_id is traced: a reduction is not elementwise
    untraceable = odes.ODEProblem("du/dt=-sum(u)", lambda u, t: -torch.sum(u) * u,
                                  f_u=lambda u, t: -torch.ones_like(u))
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        fe.make_cuda_fd_ensemble(untraceable, 4, 4, 0.1, device="cpu")
    with pytest.raises(ValueError, match="vector"):
        fe.make_cuda_fd_ensemble_vec("du/dt=sin(u)", 4, 4, 0.1, device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        fe.make_cuda_fd_ensemble("harmonic_oscillator", 4, 4, 0.1, device="cpu")
    with pytest.raises(ValueError, match="sin"):
        fe.make_cuda_fd_ensemble("du/dt=10cos(u)", 4, 4, 0.1, trig="fast", device="cpu")
    with pytest.raises(ValueError, match="convention"):
        fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", 4, 4, "nope", device="cpu")
    with pytest.raises(ValueError, match="length"):
        fe.make_cuda_fd_ensemble("du/dt=sin(u)", 4, 4, [0.1, 0.2], device="cpu")
    if not torch.cuda.is_available():  # the entry points default to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fe.make_cuda_fd_ensemble("du/dt=sin(u)", 4, 4, 0.1)
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", 4, 4, 0.1, device="cpu")
    with pytest.raises(TypeError):
        run(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        run(torch.zeros(8, 2, dtype=F64))
    pm = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", 4, 4, device="cpu")
    with pytest.raises(ValueError, match="per-member dt"):
        pm(torch.zeros(8, 3, dtype=F64), torch.zeros(8, dtype=F64))
    with pytest.raises(ValueError, match="must match"):
        pm(torch.zeros(8, 4, dtype=torch.float32), torch.zeros(8, dtype=F64))
