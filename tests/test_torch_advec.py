"""The port's eager advection march, transpose step and fused estimate
against the JAX package's XLA functions, in float64 on the CPU.

Both sides get bit-identical operators (the JAX discretization carried
across with ``interop``). Tolerance ~1e-12: the two sum the same float64
products in different orders, over at most a few hundred stages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint import advec as jadj
from adjoint_ode_adaptivity_tpu.march import advec as jmarch
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint import advec as tadj
from adjoint_ode_adaptivity_tpu_torch.march import advec as tmarch

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
F64 = torch.float64


def _pair(disc_j, alpha=1.0):
    disc = interop.discretization_from_numpy(disc_j._asdict())
    ops_j = jmarch.advec_operators(disc_j, a=A, alpha=alpha, dtype=jnp.float64)
    ops_t = interop.advec_operators_from_numpy(
        disc.dr, disc.lift, disc.rx, disc.fscale, disc.nx, A, alpha, "cpu", F64
    )
    return disc, ops_j, ops_t


def _graded(k=24, n=2):
    return jax_startup_1d(n, 0.0, 2 * np.pi, 0, vx=2 * np.pi * np.linspace(0, 1, k + 1) ** 1.6)


@pytest.fixture(scope="module")
def bench16():
    # the setup of tests/test_advec.py::test_fwd_adj_estimate_runs_and_estimates_j_error
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, 16)
    disc, ops_j, ops_t = _pair(disc_j)
    dt_cfl, _ = jmarch.cfl_dt(disc_j, A, final_time=0.25)
    n_steps = int(np.ceil(0.25 / dt_cfl / 8)) * 8
    return disc_j, disc, ops_j, ops_t, 0.25 / n_steps, n_steps


@pytest.mark.parametrize("alpha,graded", [(1.0, False), (0.5, False), (1.0, True)])
def test_advec_rhs_matches_xla(alpha, graded):
    disc_j = _graded() if graded else jax_startup_1d(3, 0.0, 2 * np.pi, 12)
    _, ops_j, ops_t = _pair(disc_j, alpha)
    u = np.random.default_rng(0).normal(size=disc_j.x.shape)
    for t, inflow in ((0.3, True), (0.0, False)):
        want = jmarch.advec_rhs(ops_j, jnp.asarray(u), t, inflow=inflow)
        got = tmarch.advec_rhs(ops_t, torch.tensor(u), t, inflow=inflow)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-12)


def test_cfl_dt_equal(bench16):
    disc_j, disc, *_ = bench16
    assert tmarch.cfl_dt(disc, A, 0.75, 2.0) == jmarch.cfl_dt(disc_j, A, 0.75, 2.0)


def test_advec_march_matches_xla(bench16):
    disc_j, disc, ops_j, ops_t, dt, n_steps = bench16
    u0 = np.sin(disc.x)
    want = jmarch.advec_march(ops_j, jnp.asarray(u0), dt, n_steps, t0=0.1)
    got = tmarch.advec_march(ops_t, torch.tensor(u0), dt, n_steps, t0=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("graded", [False, True])
def test_transpose_step_is_exact_adjoint(graded):
    disc_j = _graded() if graded else jax_startup_1d(2, 0.0, 2 * np.pi, 16)
    _, _, ops = _pair(disc_j)
    rng = np.random.default_rng(1)
    v = torch.tensor(rng.normal(size=disc_j.x.shape))
    w = torch.tensor(rng.normal(size=disc_j.x.shape))
    dt = 2e-3
    lv = tadj.lsrk_step_homogeneous(ops, v, dt)
    ltw = tadj.lsrk_step_homogeneous_t(ops, w, dt)
    # ⟨Lv, w⟩ = ⟨v, Lᵀw⟩ to roundoff of O(1) inner products
    assert abs(float(torch.sum(lv * w) - torch.sum(v * ltw))) < 1e-12
    _, vjp = torch.func.vjp(lambda x: tadj.lsrk_step_homogeneous(ops, x, dt), v)
    np.testing.assert_allclose(ltw.numpy(), vjp(w)[0].numpy(), rtol=1e-12, atol=1e-13)


def test_adjoint_march_matches_xla(bench16):
    disc_j, disc, ops_j, ops_t, dt, _ = bench16
    lam = jadj.terminal_integral_cotangent(disc_j, jnp.float64)
    lam_t = tadj.terminal_integral_cotangent(disc, F64, "cpu")
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam), rtol=1e-15)
    want = jadj.advec_adjoint_march(ops_j, lam, dt, 12)
    got = tadj.advec_adjoint_march(ops_t, lam_t, dt, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("fine", [True, False])
def test_fwd_adj_estimate_matches_xla(bench16, fine):
    disc_j, disc, ops_j, ops_t, dt, n_steps = bench16
    u0 = np.sin(disc.x)
    seg = n_steps // 4
    ref = jadj.advec_fwd_adj_estimate(
        ops_j, disc_j, jnp.asarray(u0), dt, n_steps, segment=seg, fine_adjoint=fine
    )
    got = tadj.advec_fwd_adj_estimate(
        ops_t, disc, torch.tensor(u0), dt, n_steps, segment=seg, fine_adjoint=fine
    )
    np.testing.assert_allclose(got.u_final.numpy(), np.asarray(ref.u_final), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.lam0.numpy(), np.asarray(ref.lam0), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.eta.numpy(), np.asarray(ref.eta), rtol=1e-9, atol=1e-15)
    assert abs(float(got.j_value) - float(ref.j_value)) < 1e-13


def test_effectivity_identity_f64(bench16):
    """Ση == J(u_dt) − J(u_dt/2) to roundoff with the fine adjoint."""
    _, disc, _, ops, dt, n_steps = bench16
    u0 = torch.tensor(np.sin(disc.x))
    res = tadj.advec_fwd_adj_estimate(ops, disc, u0, dt, n_steps, segment=n_steps // 4)
    u_half = tmarch.advec_march(ops, u0, dt / 2, 2 * n_steps)
    lam = tadj.terminal_integral_cotangent(disc, F64, "cpu")
    gap = float(res.j_value) - float(torch.sum(lam * u_half))
    est = float(torch.sum(res.eta))
    assert abs(gap) > 0
    assert abs(est - gap) < 1e-12, (est, gap)
    assert abs(est - gap) < 1e-8 * abs(gap), (est, gap)


def test_estimate_rejects_ragged_segment(bench16):
    _, disc, _, ops, dt, _ = bench16
    with pytest.raises(ValueError):
        tadj.advec_fwd_adj_estimate(ops, disc, torch.tensor(np.sin(disc.x)), dt, 10, segment=4)


def test_building_blocks_default_to_the_card(bench16):
    """advec_operators and terminal_integral_cotangent run on the card
    unless the caller asks for the CPU; without a GPU the default raises."""
    _, disc, _, ops, _, _ = bench16
    got = tmarch.advec_operators(disc, a=A, dtype=F64, device="cpu")
    assert got.dr.device.type == "cpu" and torch.equal(got.rx, ops.rx)
    assert tadj.terminal_integral_cotangent(disc, F64, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    for build in (lambda: tmarch.advec_operators(disc, a=A), lambda: tadj.terminal_integral_cotangent(disc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
