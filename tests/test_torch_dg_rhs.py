"""The CUDA kernels' plain PyTorch versions and entry points
(ops/cuda/dg_rhs.py) on the CPU, against the JAX package.

On a CPU tensor every wrapper runs its kernel's plain version, so these
tests drive the entry points end to end without a card:

- float64: per batch member equal to the XLA ``advec_fwd_adj_estimate`` at
  ~1e-12 (uniform and graded meshes; the tables are folded in float64).
  η gets an absolute floor of 1e-15: each term λ·(u_{n+1} − half2) is a
  difference of O(1) states, so its roundoff (~n_steps·eps·|λ|) does not
  shrink with η;
- float32: equal to the JAX Pallas stored-trajectory pipeline run with
  ``interpret=True``, at tests/test_pallas.py's tolerances (rtol 2e-4 for
  u, 2e-3 for λ, 5e-3 for η) — both fold their tables in float32, in a
  different order of operations.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import advec_fwd_adj_estimate
from adjoint_ode_adaptivity_tpu.adjoint.advec import terminal_integral_cotangent as jax_lam
from adjoint_ode_adaptivity_tpu.march.advec import advec_march, advec_operators
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi


def _disc(n_order, k, graded):
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict())


def _phased(disc, b, seed):
    phases = np.random.default_rng(seed).uniform(0, 2 * np.pi, b)
    return np.stack([np.sin(disc.x + p) for p in phases], axis=1)  # (Np, B, K)


@pytest.mark.parametrize(
    "n_order,k,graded,dt", [(2, 24, False, 2e-3), (2, 24, True, 1e-3), (7, 12, False, 2e-4)]
)
def test_plain_pipeline_matches_xla_f64(n_order, k, graded, dt):
    disc_j, disc = _disc(n_order, k, graded)
    b, n_steps = 3, 12
    u0 = _phased(disc, b, seed=n_order)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu")
    lam_b = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, b, "cpu",
                                                         store_trajectory=True)
    uf, lam0, eta = run(torch.tensor(u0), 0.05, lam_b)
    assert eta.shape == (b, k)
    ops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    for j in range(b):
        ref = advec_fwd_adj_estimate(
            ops, disc_j, jnp.asarray(u0[:, j]), dt, n_steps, segment=4, t0=0.05
        )
        np.testing.assert_allclose(uf[:, j].numpy(), np.asarray(ref.u_final), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(lam0[:, j].numpy(), np.asarray(ref.lam0), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(eta[j].numpy(), np.asarray(ref.eta), rtol=1e-9, atol=1e-15)


def test_plain_pipeline_matches_pallas_interpret_f32():
    """The one interpret-mode case: test_pallas.py:164-197's stored config."""
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_rhs import (
        make_pallas_fwd_adj_estimate_grid_batched,
    )

    disc_j, disc = _disc(2, 64, False)
    dt, seg, nseg, b = 5e-4, 4, 4, 8
    u0 = _phased(disc, b, seed=7).astype(np.float32)
    lam_j = jax_lam(disc_j, jnp.float32)
    pallas = make_pallas_fwd_adj_estimate_grid_batched(
        disc_j, A, dt, segment=seg, n_segments=nseg, batch=b, interpret=True,
        store_trajectory=True,
    )
    want = pallas(
        jnp.asarray(u0), jnp.float32(0.0),
        jnp.broadcast_to(lam_j[:, None, :], (disc.np_, b, disc.k)),
    )
    lam = terminal_integral_cotangent(disc, torch.float32, "cpu")
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, seg * nseg, b, "cpu",
                                                         store_trajectory=True)
    got = run(torch.tensor(u0), 0.0, lam[:, None, :].expand(disc.np_, b, disc.k).contiguous())
    for g, w, rtol, atol in zip(got, want, (2e-4, 2e-3, 5e-3), (1e-6, 2e-5, 1e-7)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


def test_single_and_march_entry_points_f64():
    disc_j, disc = _disc(3, 16, True)
    dt, n_steps = 1e-3, 8
    u0 = np.sin(disc.x)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu")
    uf, lam0, eta = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, n_steps, "cpu")(
        torch.tensor(u0), 0.0, lam
    )
    ops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    ref = advec_fwd_adj_estimate(ops, disc_j, jnp.asarray(u0), dt, n_steps, segment=4)
    assert uf.shape == lam0.shape == disc.x.shape and eta.shape == (disc.k,)
    np.testing.assert_allclose(uf.numpy(), np.asarray(ref.u_final), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(eta.numpy(), np.asarray(ref.eta), rtol=1e-9, atol=1e-15)
    u = dg_rhs.make_cuda_advec_march(disc, A, dt, n_steps, "cpu")(torch.tensor(u0), 0.2)
    want = advec_march(ops, jnp.asarray(u0), dt, n_steps, t0=0.2)
    np.testing.assert_allclose(u.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


def test_wrappers_validate_and_count_only_kernel_launches():
    _, disc = _disc(2, 8, False)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, "cpu")
    dg_rhs.reset_launch_counts()
    u0 = torch.zeros((3, 2, 8), dtype=torch.float64)
    traj, uf = dg_rhs.fwd_march(u0, 0.0, 4, ops, store_trajectory=True)
    assert traj.shape == (4, 3, 2, 8)
    assert dg_rhs.fwd_march(u0, 0.0, 4, ops)[0] is None
    dg_rhs.adj_est_stored(traj, uf, uf, 0.0, ops)
    # the plain path launched no kernel
    assert dg_rhs.fwd_march.launches == 0 and dg_rhs.adj_est_stored.launches == 0
    with pytest.raises(ValueError):
        dg_rhs.fwd_march(torch.zeros((3, 2, 9)), 0.0, 4, ops)
    with pytest.raises(ValueError):
        dg_rhs.fwd_march(u0, 0.0, 0, ops)
    with pytest.raises(TypeError):
        dg_rhs.fwd_march(u0.to(torch.float16), 0.0, 4, ops)
    with pytest.raises(ValueError, match="MAX_NP = 16"):
        dg_rhs.kernel_ops(interop.discretization_from_numpy(
            jax_startup_1d(16, 0.0, 1.0, 4)._asdict()), A, 1e-3, "cpu")
