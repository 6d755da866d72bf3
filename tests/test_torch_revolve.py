"""The port's revolve checkpointing (adjoint/checkpointing.py,
adjoint/revolve_vjp.py) against the JAX package and against the port's
stored-trajectory paths, on the CPU.

- The schedules are byte-identical: the port's native and Python planners
  and the JAX package's Python planner (tests/test_infra.py:16-28's cases).
- ``checkpointed_march``'s gradients in u0 and dt equal autograd through the
  stored march at 1e-12 (the same float64 operations, in reverse order per
  step) and the JAX ``checkpointed_march``'s; its forward saves only u0, dt.
- ``checkpointed_advec_march``'s gradient equals JAX's at 1e-11 (as
  tests/test_revolve_vjp.py holds JAX's to its own autograd).
- ``revolve_advec_estimate`` on CPU tensors (K1/K2's plain versions) equals
  the port's stored pipeline in float64 (u and λ bit for bit: the same
  steps and transposes in the same order; η at 1e-12 relative above the
  float64 roundoff of its terms, its sum associated per unit), and the JAX composition run in interpret mode in
  float32 at tests/test_revolve_pipeline.py's tolerances for u (rtol 1e-6)
  and λ (1e-6). There η is below float32 roundoff (its float64 value is
  ~1e-13 per element), so both float32 η are roundoff; they are held to the
  roundoff bound 8·n_steps·Np·ε₃₂·max|u|·max|λ| (chip_smoke.py's
  ``tolerances``), and the float64 η to the JAX XLA estimate at 1e-9 as in
  tests/test_torch_dg_rhs.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint import checkpointing as jck
from adjoint_ode_adaptivity_tpu.adjoint import revolve_vjp as jrv
from adjoint_ode_adaptivity_tpu.adjoint.advec import advec_fwd_adj_estimate
from adjoint_ode_adaptivity_tpu.adjoint.advec import terminal_integral_cotangent as jax_lam
from adjoint_ode_adaptivity_tpu.march import advec as jmarch
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint import checkpointing as ck
from adjoint_ode_adaptivity_tpu_torch.adjoint import revolve_vjp as rv
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.march import advec as tmarch
from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
F64 = torch.float64
CASES = [(2, 1), (7, 1), (10, 3), (100, 7), (1000, 10), (5, 4), (4096, 12)]


# ------------------------------------------------------------------ planner


@pytest.mark.parametrize("steps,snaps", CASES)
def test_schedule_is_byte_identical_to_the_jax_planner(steps, snaps):
    want = jck._plan_py(steps, snaps)
    assert ck._plan_py(steps, snaps) == want
    assert ck.plan_schedule(steps, snaps) == want  # native when built
    assert ck.simulate_schedule(steps, snaps) == jck.simulate_schedule(steps, snaps, want)
    assert ck.min_repetitions(steps, snaps) == jck.min_repetitions(steps, snaps)
    assert ck.max_steps(snaps, 3) == jck.max_steps(snaps, 3)
    assert ck.optimal_snaps(steps) == jck.optimal_snaps(steps)
    assert ck.optimal_snaps(steps, budget_states=4) == jck.optimal_snaps(steps, budget_states=4)


def test_native_planner_is_the_checkouts_own():
    assert ck.NATIVE_LIB.parent.name == "native" and "_native" not in ck.NATIVE_LIB.parts
    if not ck.NATIVE_LIB.exists():
        pytest.skip("native/librevolve.so not built")
    assert ck.native_available()
    assert ck._load_native()._name == str(ck.NATIVE_LIB)


def test_simulate_rejects_an_empty_schedule():
    with pytest.raises(AssertionError):
        ck.simulate_schedule(10, 3, [])


# ------------------------------------------------------- checkpointed_march


def _f_t(u, t):
    return torch.sin(u) + 0.5 * torch.cos(t)


def _step_t(u, t, dt):
    return u + _f_t(u, t) * dt


def _step_j(u, t, dt):
    return u + (jnp.sin(u) + 0.5 * jnp.cos(t)) * dt


def _grads(fn, u0, dt):
    u0 = torch.tensor(u0, dtype=F64, requires_grad=True)
    dt = torch.tensor(dt, dtype=F64, requires_grad=True)
    return torch.autograd.grad(fn(u0, dt) ** 2, (u0, dt))


@pytest.mark.parametrize("snaps", [2, 3, 5])
def test_checkpointed_march_grad_matches_stored_and_jax(snaps):
    n_steps = 48
    dt = np.random.default_rng(0).uniform(0.01, 0.05, size=n_steps)
    march = rv.checkpointed_march(_step_t, n_steps, snaps=snaps)
    g_u, g_dt = _grads(march, 0.7, dt)
    s_u, s_dt = _grads(lambda u, d: forward_march(_step_t, u, d)[-1], 0.7, dt)
    np.testing.assert_allclose(g_u.numpy(), s_u.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_dt.numpy(), s_dt.numpy(), rtol=1e-12, atol=1e-14)
    jm = jrv.checkpointed_march(_step_j, n_steps, snaps=snaps)
    j_u, j_dt = jax.grad(lambda u, d: jm(u, d) ** 2, argnums=(0, 1))(jnp.asarray(0.7), jnp.asarray(dt))
    np.testing.assert_allclose(g_u.numpy(), np.asarray(j_u), rtol=1e-12)
    np.testing.assert_allclose(g_dt.numpy(), np.asarray(j_dt), rtol=1e-12, atol=1e-14)
    assert march.revolve_stats == jm.revolve_stats


def test_checkpointed_march_value_and_batch():
    n_steps = 16
    dt = torch.full((n_steps,), 0.03, dtype=F64)
    march = rv.checkpointed_march(_step_t, n_steps, snaps=3)
    u0s = torch.linspace(-1.0, 1.0, 8, dtype=F64)
    assert torch.equal(march(u0s, dt), forward_march(_step_t, u0s, dt)[-1])
    u0s.requires_grad_(True)
    (g,) = torch.autograd.grad(march(u0s, dt).pow(2).sum(), u0s)
    (w,) = torch.autograd.grad(forward_march(_step_t, u0s, dt)[-1].pow(2).sum(), u0s)
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12)


def test_checkpointed_march_saves_only_u0_and_dt():
    n_steps = 12
    u0 = torch.tensor(0.3, dtype=F64, requires_grad=True)
    dt = torch.full((n_steps,), 0.05, dtype=F64, requires_grad=True)
    march = rv.checkpointed_march(_step_t, n_steps, snaps=3)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: packed.append(x) or x, lambda x: x):
        out = march(u0, dt)
    assert len(packed) == 2
    assert packed[0] is u0 and packed[1] is dt
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0].shape == () and saved[1].shape == (n_steps,)


def test_executor_slots_and_recompute_match_plan():
    n_steps, snaps = 40, 3
    schedule = ck.plan_schedule(n_steps, snaps)
    sim = ck.simulate_schedule(n_steps, snaps, schedule)
    calls = {"fwd": 0}

    def step_at(i, u):
        calls["fwd"] += 1
        return u + 1.0

    lam, stats = rv.execute_revolve(step_at, lambda i, u, lam: lam + u, torch.tensor(0.0),
                                    torch.tensor(0.0), n_steps, snaps, schedule)
    assert stats["max_slots"] <= snaps
    assert stats["forward_steps"] == sim["forward_steps"] == calls["fwd"]
    assert stats["forward_steps"] <= ck.min_repetitions(n_steps, snaps) * n_steps
    assert float(lam) == sum(range(n_steps))  # every step reversed once, at its own state


# ------------------------------------------------- checkpointed_advec_march


def test_checkpointed_advec_march_matches_jax_and_autograd():
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, 8)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    dt, n_steps, snaps = 1e-3, 20, 4
    ops_t = tmarch.advec_operators(disc, a=A, dtype=F64, device="cpu")
    ops_j = jmarch.advec_operators(disc_j, a=A, dtype=jnp.float64)
    w = np.random.default_rng(1).normal(size=(disc.np_, disc.k))
    march = rv.checkpointed_advec_march(ops_t, dt, n_steps, snaps=snaps, t0=0.05)
    u0 = torch.tensor(np.sin(disc.x), requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(torch.tensor(w) * march(u0)), u0)
    (s,) = torch.autograd.grad(
        torch.sum(torch.tensor(w) * tmarch.advec_march(ops_t, u0, dt, n_steps, t0=0.05)), u0)
    jm = jrv.checkpointed_advec_march(ops_j, dt, n_steps, snaps=snaps, t0=0.05)
    want = jax.grad(lambda u: jnp.sum(jnp.asarray(w) * jm(u)))(jnp.asarray(np.sin(disc.x)))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-11, atol=1e-14)
    assert march.revolve_stats == jm.revolve_stats


# -------------------------------------------------- revolve_advec_estimate


@pytest.fixture(scope="module")
def setup():
    # tests/test_revolve_pipeline.py's setup
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, 64)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict()), 2e-4


@pytest.mark.parametrize("snaps", [2, 3])
def test_revolve_estimate_equals_the_stored_pipeline_f64(setup, snaps):
    _, disc, dt = setup
    u0 = torch.tensor(np.sin(disc.x))
    lam = terminal_integral_cotangent(disc, F64, "cpu")
    mono = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, 32, "cpu")
    rev = rv.revolve_advec_estimate(disc, A, dt, 32, unit_steps=8, snaps=snaps, device="cpu")
    launches = dg_rhs.fwd_march.launches
    got, want = rev(u0, 0.05, lam), mono(u0, 0.05, lam)
    assert dg_rhs.fwd_march.launches == launches  # CPU tensors: plain versions
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # η's terms λ·(u_{n+1} − half2) are differences of O(1) states, and the
    # units restart their step times at t0 + i·unit_dt (an ulp off t0 + n·dt
    # in the inflow): floor at the terms' float64 roundoff
    floor = 8 * 32 * disc.np_ * 2.0**-52 * float(u0.abs().max()) * float(lam.abs().max())
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-12, atol=floor)
    st = rev.revolve_stats
    assert st["n_units"] == 4 and st["max_slots"] <= snaps
    assert st["n_units"] - 1 <= st["forward_units"] <= st["repetitions"] * st["n_units"]


def test_revolve_estimate_matches_jax(setup):
    disc_j, disc, dt = setup
    n_steps, unit, snaps = 32, 8, 2
    # float64 η against the JAX XLA estimate
    rev = rv.revolve_advec_estimate(disc, A, dt, n_steps, unit_steps=unit, snaps=snaps, device="cpu")
    _, _, eta64 = rev(torch.tensor(np.sin(disc.x)), 0.0, terminal_integral_cotangent(disc, F64, "cpu"))
    ref = advec_fwd_adj_estimate(jmarch.advec_operators(disc_j, a=A, dtype=jnp.float64), disc_j,
                                 jnp.asarray(np.sin(disc_j.x)), dt, n_steps, segment=8)
    np.testing.assert_allclose(eta64.numpy(), np.asarray(ref.eta), rtol=1e-9, atol=1e-15)
    # float32 against the JAX composition of Pallas kernels (interpret mode)
    jr = jrv.revolve_advec_estimate(disc_j, A, dt, n_steps, unit_steps=unit, snaps=snaps, segment=8,
                                    interpret=True)
    want = jr(jnp.asarray(np.sin(disc_j.x), jnp.float32), jnp.float32(0.0), jax_lam(disc_j, jnp.float32))
    lam32 = terminal_integral_cotangent(disc, torch.float32, "cpu")
    got = rev(torch.tensor(np.sin(disc.x), dtype=torch.float32), 0.0, lam32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-8)
    eta_bound = 8 * n_steps * disc.np_ * 2.0**-23 * float(got[0].abs().max()) * float(lam32.abs().max())
    for eta32 in (got[2].numpy(), np.asarray(want[2])):
        assert np.max(np.abs(eta32 - eta64.numpy())) < eta_bound
    assert rev.revolve_stats == jr.revolve_stats


def test_revolve_estimate_validates_and_defaults_to_the_card(setup):
    _, disc, dt = setup
    with pytest.raises(ValueError, match="n_steps=30 not a multiple of 8"):
        rv.revolve_advec_estimate(disc, A, dt, 30, unit_steps=8, device="cpu")
    with pytest.raises(ValueError, match="unit_steps=4 not a multiple of 8"):
        rv.revolve_advec_estimate(disc, A, dt, 32, unit_steps=4, device="cpu")
    assert rv.revolve_advec_estimate(disc, A, dt, 32, unit_steps=4, segment=4,
                                     device="cpu").revolve_stats["n_units"] == 8
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rv.revolve_advec_estimate(disc, A, dt, 32, unit_steps=8)
