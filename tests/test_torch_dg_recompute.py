"""The recompute pipeline and the unbatched entry points of
ops/cuda/dg_rhs.py (K1's checkpoint mode, K2r, KA) on the CPU, against the
stored pipeline and the JAX package.

On a CPU tensor every wrapper runs its kernel's plain version:

- the recompute pipeline reproduces the stored one bit for bit (the same
  steps at the same times t0 + n·dt, recomputed from the checkpoints);
- float64: equal to the XLA functions (``advec_fwd_adj_estimate`` with the
  same segment, ``advec_adjoint_march``) at 1e-12 relative, with η's
  absolute floor of 1e-15 (each term λ·(u_{n+1} − half2) is a difference of
  O(1) states, so its roundoff does not shrink with η);
- float32: equal to the JAX Pallas factories in interpret mode at
  tests/test_pallas.py's tolerances (rtol 2e-4 for u, 2e-3 for λ, 5e-3 for
  η; 3e-4 for the pure adjoint march) — both fold their tables in float32,
  in a different order of operations;
- the effectivity identity Σ η = J(u_dt) − J(u_dt/2) to 1e-10 relative in
  float64 on the recompute path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import (
    advec_adjoint_march as jax_adjoint_march,
    advec_fwd_adj_estimate,
)
from adjoint_ode_adaptivity_tpu.adjoint.advec import terminal_integral_cotangent as jax_lam
from adjoint_ode_adaptivity_tpu.march.advec import advec_operators
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adapt import advec_loop
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, pick_chunk

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
F32_TOL = ((2e-4, 1e-6), (2e-3, 2e-5), (5e-3, 1e-7))  # test_pallas.py: u, λ, η


def _disc(n_order, k, graded):
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict())


def _phased(disc, b, seed):
    phases = np.random.default_rng(seed).uniform(0, 2 * np.pi, b)
    return np.stack([np.sin(disc.x + p) for p in phases], axis=1)  # (Np, B, K)


def _cotangent(disc, b, dtype, seed):
    """J = ∫u(T)'s cotangent with a per-node weight, so that λ is not
    uniform across the batch."""
    lam = terminal_integral_cotangent(disc, dtype, "cpu")[:, None, :]
    w = np.random.default_rng(seed).uniform(0.5, 1.5, (disc.np_, b, disc.k))
    return (lam * torch.tensor(w, dtype=dtype)).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("graded,segment", [(False, 2), (True, 4), (True, 12)])
def test_recompute_reproduces_the_stored_pipeline_bit_for_bit(dtype, graded, segment):
    _, disc = _disc(2, 20, graded)
    b, n_steps, dt = 3, 12, 1e-3
    u0 = torch.tensor(_phased(disc, b, seed=3), dtype=dtype)
    lam = _cotangent(disc, b, dtype, seed=4)
    stored = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(
        disc, A, dt, n_steps, b, "cpu", store_trajectory=True)
    recompute = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(
        disc, A, dt, n_steps, b, "cpu", segment=segment)
    for got, want in zip(recompute(u0, 0.05, lam), stored(u0, 0.05, lam)):
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_checkpoints_are_the_trajectory_every_segment_steps():
    _, disc = _disc(3, 12, True)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, "cpu")
    u0 = torch.tensor(_phased(disc, 2, seed=5))
    traj, uf = dg_rhs.fwd_march(u0, 0.1, 12, ops, store_trajectory=True)
    dg_rhs.reset_launch_counts()
    ckpts, uf_c = dg_rhs.fwd_march_ckpt(u0, 0.1, 12, 3, ops)
    assert ckpts.shape == (4, disc.np_, 2, disc.k)
    assert torch.equal(ckpts, traj[::3]) and torch.equal(uf_c, uf)
    lam0, eta = dg_rhs.adj_est_recompute(ckpts, _cotangent(disc, 2, torch.float64, 6), 0.1, 3, ops)
    assert eta.shape == (2, disc.k)
    # the plain path launched no kernel
    assert all(fn.launches == 0 for fn in dg_rhs._WRAPPERS)
    with pytest.raises(ValueError, match="multiple"):
        dg_rhs.fwd_march_ckpt(u0, 0.1, 12, 5, ops)
    with pytest.raises(ValueError):
        dg_rhs.adj_est_recompute(ckpts[:, :, :1], lam0, 0.1, 3, ops)
    with pytest.raises(ValueError):
        dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, 1e-3, 12, 2, "cpu", segment=5)


@pytest.mark.parametrize("n_order,k,graded,segment", [(2, 24, False, 4), (2, 24, True, 3), (6, 10, True, 6)])
def test_recompute_plain_matches_xla_f64(n_order, k, graded, segment):
    disc_j, disc = _disc(n_order, k, graded)
    b, n_steps, dt = 2, 12, 1e-3
    u0 = _phased(disc, b, seed=n_order)
    lam = _cotangent(disc, b, torch.float64, seed=9)
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, b, "cpu",
                                                         segment=segment)
    uf, lam0, eta = run(torch.tensor(u0), 0.05, lam)
    ops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    for j in range(b):
        ref = advec_fwd_adj_estimate(ops, disc_j, jnp.asarray(u0[:, j]), dt, n_steps,
                                     segment=segment, t0=0.05,
                                     lam_end=jnp.asarray(lam[:, j].numpy()))
        np.testing.assert_allclose(uf[:, j].numpy(), np.asarray(ref.u_final), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(lam0[:, j].numpy(), np.asarray(ref.lam0), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(eta[j].numpy(), np.asarray(ref.eta), rtol=1e-12, atol=1e-15)


def test_unbatched_entry_points_match_xla_f64():
    disc_j, disc = _disc(2, 32, False)
    dt, seg, nseg = 1e-3, 4, 3
    u0 = np.sin(disc.x)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu")
    ops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    ref = advec_fwd_adj_estimate(ops, disc_j, jnp.asarray(u0), dt, seg * nseg, segment=seg, t0=0.2)
    chunked = dg_rhs.make_cuda_fwd_adj_estimate(disc, A, dt, segment=seg, device="cpu")
    grid = dg_rhs.make_cuda_fwd_adj_estimate_grid(disc, A, dt, segment=seg, n_segments=nseg,
                                                  device="cpu")
    for uf, lam0, eta in (chunked(torch.tensor(u0), 0.2, nseg, lam), grid(torch.tensor(u0), 0.2, lam)):
        assert uf.shape == lam0.shape == disc.x.shape and eta.shape == (disc.k,)
        np.testing.assert_allclose(uf.numpy(), np.asarray(ref.u_final), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(lam0.numpy(), np.asarray(ref.lam0), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(eta.numpy(), np.asarray(ref.eta), rtol=1e-12, atol=1e-15)


def test_adjoint_march_matches_xla_f64():
    disc_j, disc = _disc(3, 20, False)
    dt, spc, n_calls = 2e-3, 3, 4
    lam = np.random.default_rng(2).normal(size=disc.x.shape)
    got = dg_rhs.make_cuda_advec_adjoint(disc, A, dt, steps_per_call=spc, device="cpu")(
        torch.tensor(lam), n_calls)
    ops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    want = jax_adjoint_march(ops, jnp.asarray(lam), dt, spc * n_calls)
    # absolute floor 1e-13: λ here is O(1) normal noise, and an entry near 0
    # is a sum of O(1) terms whose roundoff does not shrink with it
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)
    # KA on (Np, B, K): each member is the unbatched march
    ops_k = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    lam_b = torch.tensor(np.stack([lam, 2 * lam], axis=1))
    both = dg_rhs.adj_march(lam_b, spc * n_calls, ops_k)
    assert torch.equal(both[:, 0], got)


def test_effectivity_identity_on_the_recompute_path_f64():
    """Σ η = J(u_dt) − J(u_dt/2) to 1e-10 relative (bench.py's check on a
    small mesh: J over [π, π+1] of a wave that keeps the gap far above
    float64 roundoff)."""
    _, disc = _disc(2, 96, False)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt, n_steps = 0.5 * (0.75 / A) * xmin, 48
    u0 = torch.tensor(np.sin(12 * disc.x)[:, None, :])
    xc = disc.x.mean(axis=0)
    window = torch.tensor((xc >= np.pi) & (xc <= np.pi + 1.0), dtype=torch.float64)
    lam = (terminal_integral_cotangent(disc, torch.float64, "cpu") * window)[:, None, :].contiguous()
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, 1, "cpu", segment=8)
    uf, _, eta = run(u0, 0.0, lam)
    _, uf_half = dg_rhs.fwd_march_plain(u0, 0.0, 2 * n_steps, dg_rhs.kernel_ops(disc, A, dt / 2, "cpu"))
    gap = float(torch.sum(lam * uf) - torch.sum(lam * uf_half))
    assert abs(gap) > 1e-7
    assert abs(float(eta.sum()) - gap) <= 1e-10 * abs(gap)


def test_recompute_matches_pallas_batched_interpret_f32():
    """make_pallas_fwd_adj_estimate_grid_batched(store_trajectory=False) on a
    graded mesh (tools/tpu_smoke.py's recompute entry, at test size)."""
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_rhs import (
        make_pallas_fwd_adj_estimate_grid_batched,
    )

    disc_j, disc = _disc(2, 64, True)
    dt, seg, nseg, b = 2e-4, 4, 4, 8
    u0 = _phased(disc, b, seed=7).astype(np.float32)
    lam_j = jax_lam(disc_j, jnp.float32)
    pallas = make_pallas_fwd_adj_estimate_grid_batched(
        disc_j, A, dt, segment=seg, n_segments=nseg, batch=b, interpret=True)
    want = pallas(jnp.asarray(u0), jnp.float32(0.0),
                  jnp.broadcast_to(lam_j[:, None, :], (disc.np_, b, disc.k)))
    lam = terminal_integral_cotangent(disc, torch.float32, "cpu")
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, seg * nseg, b, "cpu",
                                                         segment=seg)
    got = run(torch.tensor(u0), 0.0, lam[:, None, :].expand(disc.np_, b, disc.k).contiguous())
    for g, w, (rtol, atol) in zip(got, want, F32_TOL):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("factory", ["chunked", "grid"])
def test_unbatched_estimates_match_pallas_interpret_f32(factory):
    """test_pallas.py's TestPallasFusedEstimate / TestPallasGridPipeline
    configuration: K = 64, N = 2, dt 5e-4, 4 segments of 4 steps."""
    from adjoint_ode_adaptivity_tpu.ops.pallas import dg_rhs as pallas

    disc_j, disc = _disc(2, 64, False)
    dt, seg, nseg = 5e-4, 4, 4
    u0 = np.sin(disc.x).astype(np.float32)
    lam_j = jax_lam(disc_j, jnp.float32)
    lam = terminal_integral_cotangent(disc, torch.float32, "cpu")
    if factory == "chunked":
        want = pallas.make_pallas_fwd_adj_estimate(disc_j, A, dt, segment=seg, interpret=True)(
            jnp.asarray(u0), jnp.float32(0.0), nseg, lam_j)
        got = dg_rhs.make_cuda_fwd_adj_estimate(disc, A, dt, segment=seg, device="cpu")(
            torch.tensor(u0), 0.0, nseg, lam)
    else:
        want = pallas.make_pallas_fwd_adj_estimate_grid(
            disc_j, A, dt, segment=seg, n_segments=nseg, interpret=True)(
            jnp.asarray(u0), jnp.float32(0.0), lam_j)
        got = dg_rhs.make_cuda_fwd_adj_estimate_grid(
            disc, A, dt, segment=seg, n_segments=nseg, device="cpu")(torch.tensor(u0), 0.0, lam)
    for g, w, (rtol, atol) in zip(got, want, F32_TOL):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


def test_adjoint_march_matches_pallas_interpret_f32():
    """test_pallas.py's TestPallasAdjoint configuration (K = 256, dt 1e-4,
    8 steps) at its tolerance."""
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_rhs import make_pallas_advec_adjoint

    disc_j, disc = _disc(2, 256, False)
    lam = np.random.default_rng(0).normal(size=disc.x.shape).astype(np.float32)
    want = make_pallas_advec_adjoint(disc_j, A, 1e-4, steps_per_call=4, interpret=True)(
        jnp.asarray(lam), 2)
    got = dg_rhs.make_cuda_advec_adjoint(disc, A, 1e-4, steps_per_call=4, device="cpu")(
        torch.tensor(lam), 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["make_cuda_advec_adjoint", "make_cuda_fwd_adj_estimate",
                                  "make_cuda_fwd_adj_estimate_grid"])
def test_unbatched_factories_require_a_uniform_mesh(name):
    """As test_pallas.py::test_unbatched_kernels_still_require_uniform."""
    _, disc = _disc(2, 16, True)
    with pytest.raises(ValueError, match="uniform"):
        getattr(dg_rhs, name)(disc, A, 1e-4, device="cpu")


@pytest.mark.parametrize(
    "n_steps,k,free_bytes,store",
    [
        (4096, 600, 10**9, True),  # the adaptive loop's sizes: 29.5 MB of trajectory
        (81_920, 100_000, 80 * 10**9, False),  # 98.3 GB past the card's 80 GB
        (64, 10, (64 + advec_loop.STORED_EXTRA_STATES) * 120, True),  # exactly enough
        (64, 10, (64 + advec_loop.STORED_EXTRA_STATES) * 120 - 1, False),
        (8, 10, 0, False),
    ],
)
def test_storage_choice_follows_free_memory(n_steps, k, free_bytes, store):
    got = advec_loop.choose_storage(n_steps, 3, 1, k, free_bytes)
    assert got == (store, pick_chunk(n_steps))
    assert n_steps % got[1] == 0


def test_loop_estimate_is_the_same_stored_or_recomputed(monkeypatch):
    """The loop's CUDA-engine estimate takes the recompute pipeline when the
    card's free memory is below the stored trajectory, and its result — the
    loop's history — is the same bits either way (plain path, CPU)."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, 13) ** 1.3
    disc = interop.discretization_from_numpy(
        jax_startup_1d(2, 0.0, 2 * np.pi, 12, vx=vx)._asdict())
    chosen = []
    real = dg_rhs.make_cuda_fwd_adj_estimate_single

    def spy(*args, **kw):
        chosen.append(kw["store_trajectory"])
        return real(*args, **kw)

    monkeypatch.setattr(dg_rhs, "make_cuda_fwd_adj_estimate_single", spy)
    results = []
    for free in (10**9, 0):
        monkeypatch.setattr(advec_loop, "_free_device_bytes", lambda device, free=free: free)
        results.append(advec_loop._cuda_estimate(disc, A, 2e-3, 16, np.sin, "cpu"))
    assert chosen == [True, False]
    (j0, eta0), (j1, eta1) = results
    assert torch.equal(j0, j1) and torch.equal(eta0, eta1)
