"""The MXU-layout pipeline of ops/cuda/dg_mxu.py (KM1, KM2) on the CPU,
against the JAX package's ``make_pallas_fwd_adj_estimate_grid_mxu`` and the
port's stored pipeline.

On a CPU tensor the wrappers run the plain version, the kernels' operations
in their order, float32.

- Against the Pallas kernels in interpret mode at tests/test_pallas_mxu.py's
  cases (N 7, 2, 3; seg 4, 4 segments, B = 8; inputs from its seed), plus a
  step 10× larger where η sits above float32 roundoff: both run the same
  float32 operations but the volume dot and the η row sum in another order
  and sin from another library, so u and λ agree to an ulp per step of
  their largest entry, and η to an ulp of max|λ|·max|u| per node and step
  (n_steps·ε₃₂·max, n_steps·Np·ε₃₂·max|λ|·max|u|; measured: ≤ 2.4 ulp of
  max|u| after 16 steps, η within 1/20 of its bound);
- against the port's plain K1/K2 pipeline (``store_trajectory=True``:
  tables folded another way, rx apart, stage times in double) at
  tests/test_pallas_mxu.py's tolerances against the XLA oracle (u rtol 2e-4
  atol 1e-6, λ0 rtol 2e-3 atol 2e-5, η rtol 5e-3 atol 1e-7);
- the factory's refusals (Np outside 2-8, a non-uniform mesh, shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import terminal_integral_cotangent as jax_lam
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
EPS32 = float(np.finfo(np.float32).eps)
SEG, N_SEG, B = 4, 4, 8
CASES = [(7, 24, 5e-5), (2, 64, 2e-4), (3, 48, 2e-4), (2, 64, 2e-3)]


def _problem(n_order, k):
    """tests/test_pallas_mxu.py's inputs: B phase-shifted sines from
    default_rng(7), J = ∫u(T) for every state."""
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    rng = np.random.default_rng(7)
    u0 = np.stack([np.sin(np.asarray(disc.x) + p) for p in rng.uniform(0, 6, B)],
                  axis=1).astype(np.float32)
    lam = np.asarray(jax_lam(disc_j, jnp.float32))
    lam_b = np.ascontiguousarray(np.broadcast_to(lam[:, None, :], (disc.np_, B, k)))
    return disc_j, disc, u0, lam_b


@pytest.mark.parametrize("n_order,k,dt", CASES)
def test_plain_matches_pallas_mxu_interpret(n_order, k, dt):
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_mxu import make_pallas_fwd_adj_estimate_grid_mxu

    disc_j, disc, u0, lam = _problem(n_order, k)
    want = make_pallas_fwd_adj_estimate_grid_mxu(
        disc_j, A, dt, segment=SEG, n_segments=N_SEG, batch=B, interpret=True)(
        jnp.asarray(u0), jnp.float32(0.0), jnp.asarray(lam))
    run = dg_mxu.make_cuda_fwd_adj_estimate_grid_mxu(disc, A, dt, segment=SEG,
                                                     n_segments=N_SEG, batch=B, device="cpu")
    assert run.n_steps == SEG * N_SEG
    got = run(torch.tensor(u0), 0.0, torch.tensor(lam))
    n = run.n_steps
    umax, lmax = float(np.abs(u0).max()), float(np.abs(lam).max())
    tols = (n * EPS32 * umax, n * EPS32 * lmax, n * disc.np_ * EPS32 * umax * lmax)
    for g, w, tol in zip(got, want, tols):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= tol
    if dt == CASES[-1][2]:  # η above roundoff: the bound has teeth
        assert float(np.abs(np.asarray(want[2])).max()) > 10 * tols[2]


@pytest.mark.parametrize("n_order,k,dt", CASES)
def test_plain_matches_the_stored_pipeline(n_order, k, dt):
    _, disc, u0, lam = _problem(n_order, k)
    got = dg_mxu.make_cuda_fwd_adj_estimate_grid_mxu(
        disc, A, dt, segment=SEG, n_segments=N_SEG, batch=B, device="cpu")(
        torch.tensor(u0), 0.0, torch.tensor(lam))
    want = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(
        disc, A, dt, SEG * N_SEG, B, "cpu", store_trajectory=True)(
        torch.tensor(u0), 0.0, torch.tensor(lam))
    for g, w, (rtol, atol) in zip(got, want, ((2e-4, 1e-6), (2e-3, 2e-5), (5e-3, 1e-7))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol)


def test_wrappers_take_the_plain_path_and_count_only_kernel_launches():
    _, disc, u0, lam = _problem(3, 16)
    ops = dg_mxu.mxu_ops(disc, A, 1e-3, 2, 3, B, "cpu")
    dg_mxu.reset_launch_counts()
    u = torch.tensor(u0).reshape(disc.np_, -1)
    traj, uf = dg_mxu.km_fwd_traj(u, 0.0, ops)
    assert traj.shape == (6, disc.np_, B * 16) and torch.equal(traj[0], u)
    lam0, eta = dg_mxu.km_adj_est(traj, uf, torch.tensor(lam).reshape(disc.np_, -1), 0.0, ops)
    assert eta.shape == (B * 16,)
    assert dg_mxu.km_fwd_traj.launches == 0 and dg_mxu.km_adj_est.launches == 0
    # float64 on the plain path: the same operations at the float32 tables
    traj64, uf64 = dg_mxu.km_fwd_traj(u.double(), 0.0, ops)
    assert uf64.dtype == torch.float64
    np.testing.assert_allclose(uf64.numpy(), uf.numpy(), rtol=0, atol=48 * EPS32)
    with pytest.raises(ValueError, match="shape"):
        dg_mxu.km_fwd_traj(u[:, 1:], 0.0, ops)
    with pytest.raises(TypeError):
        dg_mxu.km_fwd_traj(u.half(), 0.0, ops)


def test_stage_times_follow_the_pallas_kernel():
    """Step m of segment i starts at (t0 + i·seg·dt) + m·dt in float32, not
    at t0 + n·dt: the two differ in the last bits at large n."""
    _, disc, _, _ = _problem(2, 8)
    ops = dg_mxu.mxu_ops(disc, A, 0.0123, 16, 64, 1, "cpu")
    t = dg_mxu._step_times(0.25, ops)
    n = np.arange(1024)
    i, m = n // 16, n % 16
    want = (np.float32(0.25) + (i * 16 * 0.0123).astype(np.float32)) + (m * 0.0123).astype(np.float32)
    assert t.dtype == np.float32 and np.array_equal(t, want)
    assert not np.array_equal(t, (0.25 + n * 0.0123).astype(np.float32))
    fwd, rev = dg_mxu.fwd_inflow(0.25, ops), dg_mxu.rev_inflow(0.25, ops)
    assert fwd.shape == (1024, 5) and rev.shape == (1024, 10)
    assert fwd.dtype == rev.dtype == np.float32
    assert np.array_equal(fwd[:, 0], rev[:, 0])  # c_0 = 0: both start at t_n


def test_refusals_raise_as_the_jax_factory():
    make = dg_mxu.make_cuda_fwd_adj_estimate_grid_mxu
    _, disc, _, _ = _problem(8, 16)  # Np = 9
    with pytest.raises(ValueError, match="Np=9 unsupported"):
        make(disc, A, 1e-4, device="cpu")
    disc1 = interop.discretization_from_numpy(jax_startup_1d(1, 0.0, 2 * np.pi, 16)._asdict())
    make(disc1, A, 1e-4, segment=1, n_segments=1, device="cpu")  # Np = 2 is the smallest
    vx = 2 * np.pi * np.linspace(0.0, 1.0, 17) ** 1.5
    graded = interop.discretization_from_numpy(
        jax_startup_1d(2, 0.0, 2 * np.pi, 16, vx=vx)._asdict())
    with pytest.raises(ValueError, match="uniform"):
        make(graded, A, 1e-4, device="cpu")
    _, disc, u0, lam = _problem(2, 16)
    run = make(disc, A, 1e-4, segment=1, n_segments=2, batch=B, device="cpu")
    with pytest.raises(ValueError, match="must be"):
        run(torch.tensor(u0)[:, :4], 0.0, torch.tensor(lam))
    with pytest.raises(ValueError, match=">= 1"):
        make(disc, A, 1e-4, segment=0, device="cpu")
