"""The element-tiled pipeline of ops/cuda/dg_tiled.py (KT1, KT2) on the
CPU, against the port's stored pipeline and the JAX package.

On a CPU tensor the wrappers run the plain version: the same CTA tiles and
ghost windows as the kernels, with explicit ghost rings, so the halo logic
itself runs here.

- float64: equal to the port's stored plain pipeline (K1 + K2's plain
  versions) and to the XLA ``advec_fwd_adj_estimate`` at 1e-12 relative —
  every local element is exact under the ghost rule W ≥ 10·seg + 10, so the
  tiling must not show; and a ring narrower than the forward's 5·seg
  elements must show;
- float32: equal to ``make_pallas_fwd_adj_estimate_tiled`` and
  ``_tiled_grid`` in interpret mode at tests/test_pallas_tiled.py's
  tolerances (u 1e-6 / 2e-6, λ 1e-5, η 1e-6 / 2e-6 absolute);
- the factories raise the JAX factories' ValueErrors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import terminal_integral_cotangent as jax_lam
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi


def _problem(k=640, n_order=2, vx=None):
    """tests/test_pallas_tiled.py's problem: u0 = sin x, J = ∫u(T), the CFL
    step 0.5·(0.75/a)·x_min."""
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    return disc_j, disc, 0.5 * (0.75 / A) * xmin


def _weighted_lam(disc, dtype, seed=1):
    lam = terminal_integral_cotangent(disc, dtype, "cpu")
    w = np.random.default_rng(seed).uniform(0.5, 1.5, disc.x.shape)
    return lam * torch.tensor(w, dtype=dtype)


@pytest.mark.parametrize("chunks,tile", [(1, None), (4, None), (8, None), (4, 37), (8, 7)])
def test_tiled_plain_matches_the_stored_pipeline_f64(chunks, tile):
    """Through the factory (its own tile plan), or with CTA tiles narrower
    than a chunk, and a ragged last tile."""
    _, disc, dt = _problem(k=320)
    seg, n_seg = 2, 3
    u0 = torch.tensor(np.sin(disc.x))
    lam = _weighted_lam(disc, torch.float64)
    run = dg_tiled.make_cuda_fwd_adj_estimate_tiled(
        disc, A, dt, segment=seg, n_segments=n_seg, chunks=chunks, device="cpu")
    assert run.n_steps == seg * n_seg and run.ghost >= 10 * seg + 10
    if tile is None:
        got = run(u0, 0.1, lam)
    else:
        plan = dg_tiled.tile_plan(320, disc.np_, seg, run.ghost, 320 // chunks, tile)
        assert plan.tile == tile and plan.n_tiles == -(-320 // tile)
        got = dg_tiled.tiled_plain(u0, 0.1, lam, n_seg, plan, dg_rhs.kernel_ops(disc, A, dt, "cpu"))
    want = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, seg * n_seg, "cpu")(u0, 0.1, lam)
    for g, w, floor in zip(got, want, (1e-13, 1e-15, 1e-15)):
        assert g.shape == w.shape and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=floor)


@pytest.mark.parametrize("grid", [False, True])
def test_tiled_factories_match_xla_f64(grid):
    """Both factories' float64 plain paths against the XLA
    ``advec_fwd_adj_estimate`` at 1e-12 relative; absolute floors: u 1e-13,
    λ 1e-12·max|λ| (at the CFL step an entry of λ near 0 keeps the roundoff
    of the largest), η 1e-15 (as tests/test_torch_dg_recompute.py)."""
    from adjoint_ode_adaptivity_tpu.adjoint.advec import advec_fwd_adj_estimate
    from adjoint_ode_adaptivity_tpu.march.advec import advec_operators

    disc_j, disc, dt = _problem(k=960)
    seg, n_seg = 2, 3
    u0 = np.sin(disc.x)
    lam = _weighted_lam(disc, torch.float64, seed=3)
    make = (dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid if grid
            else dg_tiled.make_cuda_fwd_adj_estimate_tiled)
    got = make(disc, A, dt, segment=seg, n_segments=n_seg, chunks=4, device="cpu")(
        torch.tensor(u0), 0.1, lam)
    ops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    ref = advec_fwd_adj_estimate(ops, disc_j, jnp.asarray(u0), dt, seg * n_seg, segment=seg,
                                 t0=0.1, lam_end=jnp.asarray(lam.numpy()))
    lam_floor = 1e-12 * float(np.max(np.abs(np.asarray(ref.lam0))))
    for g, w, floor in zip(got, (ref.u_final, ref.lam0, ref.eta), (1e-13, lam_floor, 1e-15)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=floor)


def test_tiled_plain_on_a_graded_mesh_f64():
    """The factories keep the JAX uniform-mesh contract, but KT1/KT2 read
    per-element geometry: the wrappers on a graded mesh still equal K1/K2."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, 121) ** 1.5
    _, disc, dt = _problem(k=120, n_order=3, vx=vx)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    plan = dg_tiled.tile_plan(120, disc.np_, 2, 30, 120, tile=25)
    u0 = torch.tensor(np.sin(disc.x))
    lam = _weighted_lam(disc, torch.float64, seed=2)
    traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.0, 3, plan, ops)
    lam0, eta = dg_tiled.tiled_rev_seg(traj, uf, lam, 0.0, plan, ops)
    traj_s, uf_s = dg_rhs.fwd_march_plain(u0[:, None], 0.0, 6, ops, True)
    lam0_s, eta_s = dg_rhs.adj_est_stored_plain(traj_s, uf_s, lam[:, None], 0.0, ops)
    np.testing.assert_allclose(traj.numpy(), traj_s[:, :, 0].numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(lam0.numpy(), lam0_s[:, 0].numpy(), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(eta.numpy(), eta_s[0].numpy(), rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="uniform"):
        dg_tiled.make_cuda_fwd_adj_estimate_tiled(disc, A, dt, segment=2, chunks=2, device="cpu")


def test_a_narrow_ghost_ring_shows():
    """The ghost rule has teeth on the plain path: with W one element short
    of the forward's 5·seg, tile edges reach local elements."""
    _, disc, dt = _problem(k=200)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    seg = 2
    u0 = torch.tensor(np.sin(3 * disc.x))
    lam = _weighted_lam(disc, torch.float64)
    want = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, 2 * seg, "cpu")(u0, 0.0, lam)
    for ghost, exact in ((5 * seg - 1, False), (10 * seg + 10, True)):
        plan = dg_tiled.TilePlan(seg, ghost, 20, 10)
        got = dg_tiled.tiled_plain(u0, 0.0, lam, 2, plan, ops)
        same = np.allclose(got[0].numpy(), want[0].numpy(), rtol=1e-12, atol=1e-13)
        assert same == exact, ghost


@pytest.mark.parametrize("chunks", [1, 4, 8])
def test_tiled_matches_pallas_tiled_interpret_f32(chunks):
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_tiled import make_pallas_fwd_adj_estimate_tiled

    disc_j, disc, dt = _problem()
    seg, n_seg = 2, 4
    u0 = np.sin(disc.x).astype(np.float32)
    want = make_pallas_fwd_adj_estimate_tiled(
        disc_j, A, dt, segment=seg, n_segments=n_seg, chunks=chunks, interpret=True)(
        jnp.asarray(u0), jnp.float32(0.0), jax_lam(disc_j, jnp.float32))
    run = dg_tiled.make_cuda_fwd_adj_estimate_tiled(
        disc, A, dt, segment=seg, n_segments=n_seg, chunks=chunks, device="cpu")
    got = run(torch.tensor(u0), 0.0, terminal_integral_cotangent(disc, torch.float32, "cpu"))
    for g, w, atol in zip(got, want, (1e-6, 1e-5, 1e-6)):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


@pytest.mark.parametrize("chunks", [1, 4, 8])
def test_tiled_grid_matches_pallas_tiled_grid_interpret_f32(chunks):
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_tiled import (
        make_pallas_fwd_adj_estimate_tiled_grid,
    )

    disc_j, disc, dt = _problem(k=2048)
    seg, n_seg = 2, 4
    u0 = np.sin(disc.x).astype(np.float32)
    want = make_pallas_fwd_adj_estimate_tiled_grid(
        disc_j, A, dt, segment=seg, n_segments=n_seg, chunks=chunks, interpret=True)(
        jnp.asarray(u0), jnp.float32(0.0), jax_lam(disc_j, jnp.float32))
    run = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
        disc, A, dt, segment=seg, n_segments=n_seg, chunks=chunks, device="cpu")
    assert run.ghost == 10 * seg + 10 and run.n_steps == seg * n_seg
    got = run(torch.tensor(u0), 0.0, terminal_integral_cotangent(disc, torch.float32, "cpu"))
    for g, w, atol in zip(got, want, (2e-6, 1e-5, 2e-6)):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_validation_raises_as_the_jax_factories():
    """tests/test_pallas_tiled.py's two validation tests, on the port."""
    _, disc, dt = _problem()
    with pytest.raises(ValueError, match="not divisible"):
        dg_tiled.make_cuda_fwd_adj_estimate_tiled(disc, A, dt, chunks=7, device="cpu")
    with pytest.raises(ValueError, match="ghost width"):
        dg_tiled.make_cuda_fwd_adj_estimate_tiled(disc, A, dt, segment=32, chunks=8, device="cpu")
    _, disc, dt = _problem(k=2048)
    with pytest.raises(ValueError, match="not divisible"):
        dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(disc, A, dt, chunks=7, device="cpu")
    with pytest.raises(ValueError, match="ghost width"):
        # Lm = 256/32 = 8 < w = 30
        dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(disc, A, dt, segment=2, chunks=32,
                                                       device="cpu")
    _, disc, dt = _problem(k=100)
    with pytest.raises(ValueError, match="divisible by 8"):
        dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(disc, A, dt, segment=1, chunks=1,
                                                       device="cpu")


def test_tile_plan_fits_the_shared_memory_budget():
    """bench.py's rows: each chunk in equal tiles whose KT2 window fits."""
    for k, np_, seg, ghost, chunk, want in (
        (100_000, 3, 8, 90, 3125, (1042, 96)),  # tiled_grid, chunks 4
        (1_000_000, 3, 16, 170, 5000, (1250, 800)),  # tiled_grid, chunks 25
        (100_000, 3, 8, 92, 25_000, (1389, 72)),  # tiled, chunks 4
    ):
        plan = dg_tiled.tile_plan(k, np_, seg, ghost, chunk)
        assert (plan.tile, plan.n_tiles) == want
        assert (4 * np_ + 3) * 4 * (plan.tile + 2 * ghost) <= dg_tiled.SMEM_BUDGET
    with pytest.raises(ValueError, match="budget"):
        dg_tiled.tile_plan(10_000, 8, 64, 650, 10_000)
    with pytest.raises(ValueError, match="segment"):
        dg_tiled.tile_plan(10_000, 3, 65, 660, 10_000)


def test_wrappers_validate_and_count_only_kernel_launches():
    _, disc, dt = _problem(k=64)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    plan = dg_tiled.tile_plan(64, 3, 1, 20, 64, tile=16)
    dg_tiled.reset_launch_counts()
    u0 = torch.zeros((3, 64), dtype=torch.float64)
    traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.0, 2, plan, ops)
    assert traj.shape == (2, 3, 64)
    dg_tiled.tiled_rev_seg(traj, uf, uf, 0.0, plan, ops)
    assert dg_tiled.tiled_fwd_seg.launches == 0 and dg_tiled.tiled_rev_seg.launches == 0
    with pytest.raises(ValueError):
        dg_tiled.tiled_fwd_seg(torch.zeros((3, 63)), 0.0, 2, plan, ops)
    with pytest.raises(ValueError):
        dg_tiled.tiled_rev_seg(traj[:1, :, :], uf, uf, 0.0, dg_tiled.TilePlan(2, 30, 16, 4), ops)
    with pytest.raises(TypeError):
        dg_tiled.tiled_fwd_seg(u0.to(torch.float16), 0.0, 2, plan, ops)
