"""KM2's fused launch schedule (ops/cuda/dg_mxu.py) on the CPU.

On the card KM2 runs s_f steps a launch, one CTA per (tile, member) on a
window of L local columns and W ghost columns a side (K2's windows). Its
plain emulation, ``km_adj_est_fused_plain``, runs that schedule in plain
PyTorch — the same tiles, windows, s_f, remainders and first/last masks (the
window's ends) — so the halo logic is tested here:

- bit-equal to the untiled plain version ``km_adj_est_plain`` in float32
  and float64 at Np 2, 3 and 8 with B = 3: K below one tile, ragged last
  tiles, n_steps = 13 with s_f = 4;
- against the JAX package's MXU pipeline in interpret mode at
  tests/test_torch_dg_mxu.py's tolerances;
- the ghost rule has teeth: a halo one column short of the reverse's
  dependency cone moves a local column;
- ``km_rev_plan``'s choices.
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
B = 3
EPS32 = float(np.finfo(np.float32).eps)


def _ops(n_order, k, dt, n_steps, b=B, dtype=torch.float64, seed=0, cfl=None):
    """A uniform mesh, KM1's plain trajectory from B phase-shifted sines,
    and a cotangent with per-node weights; the step ``dt``, or cfl·x_min/a."""
    disc = interop.discretization_from_numpy(jax_startup_1d(n_order, 0.0, 2 * np.pi, k)._asdict())
    if cfl is not None:
        dt = cfl / A * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_mxu.mxu_ops(disc, A, dt, n_steps, 1, b, "cpu")
    rng = np.random.default_rng(seed)
    u0 = np.concatenate([np.sin(disc.x + p) for p in rng.uniform(0, 2 * np.pi, b)], axis=1)
    lam = rng.uniform(0.5, 1.5, (disc.np_, b * k))
    traj, uf = dg_mxu.km_fwd_traj_plain(torch.tensor(u0, dtype=dtype), 0.1, ops)
    return disc, ops, traj, uf, torch.tensor(lam, dtype=dtype)


# (K, tile): K below one tile; tiles of 110 (110, 110, 80) and of 37 (eight
# whole, a ragged 4)
SHAPES = [(60, None), (300, 110), (300, 37)]


def _plan(k, tile):
    plan = dg_rhs.fused_plan(k, 4, 512)
    return plan if tile is None else plan._replace(tile=tile, n_tiles=-(-k // tile))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_order", [1, 2, 7])
@pytest.mark.parametrize("k,tile", SHAPES)
def test_fused_schedule_gives_the_plain_bits(dtype, n_order, k, tile):
    n_steps = 13
    disc, ops, traj, uf, lam = _ops(n_order, k, None, n_steps, dtype=dtype, seed=n_order, cfl=0.375)
    plan = _plan(k, tile)
    assert plan.segment == 4 and plan.ghost == 50 and n_steps % plan.segment
    want = dg_mxu.km_adj_est_plain(traj, uf, lam, 0.1, ops)
    got = dg_mxu.km_adj_est_fused_plain(traj, uf, lam, 0.1, ops, plan)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


def test_fused_schedule_matches_pallas_mxu_interpret():
    """The schedule on narrow tiles (s_f 4, L 20, four tiles a member)
    against the Pallas kernels in interpret mode, at
    test_plain_matches_pallas_mxu_interpret's tolerances (n·ε·max|u|,
    n·ε·max|λ|, n·Np·ε·max|λ|·max|u|) and its step, where η sits above
    float32 roundoff."""
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_mxu import make_pallas_fwd_adj_estimate_grid_mxu

    n_order, k, dt, seg, n_seg, b = 2, 64, 2e-3, 4, 4, 8
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    rng = np.random.default_rng(7)
    u0 = np.stack([np.sin(np.asarray(disc.x) + p) for p in rng.uniform(0, 6, b)],
                  axis=1).astype(np.float32)
    lam = np.ascontiguousarray(np.broadcast_to(
        np.asarray(jax_lam(disc_j, jnp.float32))[:, None, :], (disc.np_, b, k)))
    want = make_pallas_fwd_adj_estimate_grid_mxu(
        disc_j, A, dt, segment=seg, n_segments=n_seg, batch=b, interpret=True)(
        jnp.asarray(u0), jnp.float32(0.0), jnp.asarray(lam))
    ops = dg_mxu.mxu_ops(disc, A, dt, seg, n_seg, b, "cpu")
    flat = (disc.np_, b * k)
    traj, uf = dg_mxu.km_fwd_traj_plain(torch.tensor(u0).reshape(flat), 0.0, ops)
    plan = _plan(k, 20)
    lam0, eta = dg_mxu.km_adj_est_fused_plain(traj, uf, torch.tensor(lam).reshape(flat), 0.0,
                                              ops, plan)
    n = seg * n_seg
    umax, lmax = float(np.abs(u0).max()), float(np.abs(lam).max())
    tols = (n * EPS32 * umax, n * EPS32 * lmax, n * disc.np_ * EPS32 * umax * lmax)
    for g, w, tol in zip((uf, lam0, eta), want, tols):
        assert g.dtype == torch.float32
        assert float(np.abs(g.reshape(w.shape).numpy() - np.asarray(w)).max()) <= tol
    assert float(np.abs(np.asarray(want[2])).max()) > 10 * tols[2]  # η above roundoff


@pytest.mark.parametrize("s_f", [1, 2])
def test_the_ghost_rule_has_teeth(s_f):
    """λ's 10 transposed stages a step lose one column a stage at each
    window edge, and the residual half steps start from u_n, read exact from
    the trajectory, so the reverse's dependency cone is 10·s_f columns: W =
    10·s_f − 1 moves a local column and W = 10·s_f does not (nor the plans'
    W = 10·s_f + 10). A large step (3·x_min/a) keeps the edge's error above
    rounding."""
    k = 120
    n_steps = 2 * s_f
    _, ops, traj, uf, lam = _ops(2, k, None, n_steps, b=2, cfl=3.0)
    want = dg_mxu.km_adj_est_plain(traj, uf, lam, 0.0, ops)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for ghost, exact in ((10 * s_f - 1, False), (10 * s_f, True), (10 * s_f + 10, True)):
        plan = dg_rhs.FusedPlan(s_f, ghost, 40, 3, 512)
        got = dg_mxu.km_adj_est_fused_plain(traj, uf, lam, 0.0, ops, plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == exact, ghost


def test_plans():
    """km_rev_plan on a 132-SM card: K2's windows and search under KM2's
    cost (fitted on the card), 512 threads at Np ≥ 7, s_f at most n_steps,
    ⌈K/L⌉ tiles; the cache."""
    FP = dg_rhs.FusedPlan
    # BASELINE.md:61's row and the headline row
    assert dg_mxu.km_rev_plan(10_000, 8, 8, 256) == FP(4, 50, 313, 32, 512)
    assert dg_mxu.km_rev_plan(10_000, 8, 3, 2048) == FP(4, 50, 625, 16, 1024)
    for k, b, np_, n_steps in ((10_000, 8, 7, 256), (24, 8, 3, 16), (1000, 3, 8, 3),
                               (5, 1, 2, 100)):
        plan = dg_mxu.km_rev_plan(k, b, np_, n_steps)
        assert plan.ghost == 10 * plan.segment + 10
        assert plan.segment in (4, 8) or plan.segment == n_steps
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.n_tiles == -(-k // plan.tile) and (plan.threads == 512 or np_ <= 6)
    assert dg_mxu.km_step_warp_us(8) == pytest.approx(dg_mxu.KM_STEP_WARP_US * 204)
    assert dg_mxu.km_rev_plan(10_000, 8, 8, 256) is dg_mxu.km_rev_plan(10_000, 8, 8, 256)


def test_cpu_wrapper_takes_the_untiled_plain_version():
    disc, ops, traj, uf, lam = _ops(2, 40, None, 5, dtype=torch.float32, cfl=0.375)
    dg_mxu.reset_launch_counts()
    got = dg_mxu.km_adj_est(traj, uf, lam, 0.1, ops)
    want = dg_mxu.km_adj_est_plain(traj, uf, lam, 0.1, ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dg_mxu.km_adj_est.launches == dg_mxu.km_adj_est.cuda_launches == 0
