"""K2's and K2r's fused launch schedule (ops/cuda/dg_rhs.py) on the CPU.

On the card K2 and K2r run s_f steps a launch, one CTA per (tile, member)
on a window of L local elements and W ghosts a side. Their plain emulations,
``adj_est_stored_fused_plain`` and ``adj_est_recompute_fused_plain``, run
that schedule in plain PyTorch — the same tiles, windows, s_f, remainders,
member rows and per-element geometry — so the halo logic is tested here:

- bit-equal to the untiled plain versions (``adj_est_stored_plain``,
  ``adj_est_recompute_plain``) in float32 and float64 on a graded mesh with
  B = 3: K below one tile, a ragged last tile, n_steps = 13 with s_f = 4,
  checkpoint segments 1, 4 and 13;
- in float64 equal to the XLA ``advec_fwd_adj_estimate`` at 1e-12 relative
  (tests/test_torch_dg_recompute.py's tolerance);
- the ghost rule has teeth: a ring one element short of the reverse's
  dependency cone changes a local element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import advec_fwd_adj_estimate
from adjoint_ode_adaptivity_tpu.march.advec import advec_operators
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
B = 3


def _problem(k, n_order=2, graded=True, cfl=0.5 * 0.75, dtype=torch.float64, b=B, seed=0):
    """A graded mesh (vx ∝ s^1.6), B phase-shifted sines, J = ∫u(T)'s
    cotangent weighted per node, and the step cfl·x_min/a."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = cfl / A * xmin
    rng = np.random.default_rng(seed)
    u0 = np.stack([np.sin(disc.x + p) for p in rng.uniform(0, 2 * np.pi, b)], axis=1)
    lam = terminal_integral_cotangent(disc, dtype, "cpu")[:, None, :]
    lam = lam * torch.tensor(rng.uniform(0.5, 1.5, (disc.np_, b, k)), dtype=dtype)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    return disc_j, disc, dt, ops, torch.tensor(u0, dtype=dtype), lam.contiguous()


def _plan(k, steps, tile=None):
    """stored_plan's windows at ``steps`` a launch, or narrower tiles."""
    plan = dg_rhs.fused_plan(k, steps)
    return plan if tile is None else plan._replace(tile=tile, n_tiles=-(-k // tile))


# (K, tile): K below one tile; three tiles, the last ragged (110, 110, 80)
SHAPES = [(120, None), (300, 110)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,tile", SHAPES)
def test_stored_schedule_gives_the_untiled_bits(dtype, k, tile):
    _, _, _, ops, u0, lam = _problem(k, dtype=dtype)
    n_steps = 13
    plan = _plan(k, 4, tile)
    assert plan.segment == 4 and plan.ghost == 50 and n_steps % plan.segment
    traj, uf = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, store_trajectory=True)
    want = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.1, ops)
    got = dg_rhs.adj_est_stored_fused_plain(traj, uf, lam, 0.1, ops, plan)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("segment,n_steps", [(1, 13), (4, 12), (13, 13)])
def test_recompute_schedule_gives_the_untiled_bits(dtype, segment, n_steps):
    """Segments 1, 4 and 13 in recompute_plan's launches (s_f 1, 4 and 7:
    13 = 7 + 6) on ragged tiles: K2r's plain version's bits, which are
    K2's."""
    k = 300
    _, _, _, ops, u0, lam = _problem(k, dtype=dtype, seed=segment)
    s_f = dg_rhs.recompute_plan(k, B, 3, segment, n_steps).segment
    assert s_f == {1: 1, 4: 4, 13: 7}[segment]
    plan = _plan(k, s_f, tile=110)
    ckpts, _ = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, checkpoint_every=segment)
    want = dg_rhs.adj_est_recompute_plain(ckpts, lam, 0.1, segment, ops)
    got = dg_rhs.adj_est_recompute_fused_plain(ckpts, lam, 0.1, segment, ops, plan)
    traj, uf = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, store_trajectory=True)
    stored = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.1, ops)
    for g, w, s in zip(got, want, stored):
        assert torch.equal(g, w) and torch.equal(g, s)


def test_fused_schedule_matches_xla_f64():
    """The schedule on B = 1 of a graded mesh against the XLA pipeline (the
    same tolerances as tests/test_torch_dg_recompute.py)."""
    disc_j, _, dt, ops, u0, lam = _problem(200, b=1, seed=4)
    n_steps, segment = 12, 4
    plan = _plan(200, 4, tile=60)
    ckpts, uf = dg_rhs.fwd_march_plain(u0, 0.05, n_steps, ops, checkpoint_every=segment)
    lam0, eta = dg_rhs.adj_est_recompute_fused_plain(ckpts, lam, 0.05, segment, ops, plan)
    ref = advec_fwd_adj_estimate(advec_operators(disc_j, a=A, dtype=jnp.float64), disc_j,
                                 jnp.asarray(u0[:, 0].numpy()), dt, n_steps, segment=segment,
                                 t0=0.05, lam_end=jnp.asarray(lam[:, 0].numpy()))
    np.testing.assert_allclose(uf[:, 0].numpy(), np.asarray(ref.u_final), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(lam0[:, 0].numpy(), np.asarray(ref.lam0), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(eta[0].numpy(), np.asarray(ref.eta), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("s_f", [1, 2])
def test_the_ghost_rule_has_teeth(s_f):
    """λ's 10 transposed stages a step lose one element a stage at each
    window edge, and the half steps read u_n exact from the trajectory, so
    the reverse's dependency cone is 10·s_f elements: W = 10·s_f − 1 changes
    a local element and W = 10·s_f does not. The repo's rule W ≥ 10·s_f + 10
    (the plans') keeps 10 elements of margin, so W = 10·s_f + 9 cannot show.
    A large step (3·x_min/a) keeps the edge's error above rounding: at the
    CFL step it decays below an ulp within ~8 elements."""
    k = 120
    _, _, _, ops, u0, lam = _problem(k, graded=False, cfl=3.0, b=2)
    n_steps = 2 * s_f
    traj, uf = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, store_trajectory=True)
    want = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for ghost, exact in ((10 * s_f - 1, False), (10 * s_f, True), (10 * s_f + 10, True)):
        plan = dg_rhs.FusedPlan(s_f, ghost, 40, 3, 512)
        got = dg_rhs.adj_est_stored_fused_plain(traj, uf, lam, 0.0, ops, plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == exact, ghost


def test_plans():
    """The wrappers' choices on a 132-SM card: the headline's grid one
    1024-thread CTA an SM, B = 1 rows in 1024-thread CTAs, Np = 8 on 512
    threads (the 1024-thread instance spills), a small problem in the fewest
    tiles; the checkpoint segments' s_f; what fused_plan refuses."""
    FP = dg_rhs.FusedPlan
    assert dg_rhs.stored_plan(10_000, 8, 3, 2048) == FP(8, 90, 625, 16, 1024)
    assert dg_rhs.stored_plan(1_000_000, 1, 3, 64) == FP(4, 50, 860, 1163, 1024)
    assert dg_rhs.stored_plan(10_000, 8, 8, 2048) == FP(4, 50, 313, 32, 512)
    assert dg_rhs.stored_plan(512, 1, 3, 5462) == FP(8, 90, 256, 2, 512)
    assert dg_rhs.stored_plan(24, 1, 2, 3) == FP(3, 40, 24, 1, 512)
    for segment, s_f in ((1, 1), (2, 2), (4, 4), (5, 5), (13, 7), (64, 8), (256, 8)):
        plan = dg_rhs.recompute_plan(10_000, 8, 3, segment, 8 * segment)
        assert plan.segment == s_f and plan.ghost == 10 * s_f + 10
    # every plan holds its window and keeps the ghost rule
    for k, b, np_ in ((10_000, 8, 3), (100_000, 1, 2), (700, 3, 8), (5, 1, 4)):
        plan = dg_rhs.stored_plan(k, b, np_, 100)
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.ghost >= 10 * plan.segment + 10 and plan.n_tiles == -(-k // plan.tile)
        assert plan.threads == 512 or np_ <= 6
    assert dg_rhs.fused_plan(10_000, 8, 1024) == FP(8, 90, 844, 12, 1024)
    for steps, threads in ((0, 512), (17, 512), (4, 256)):
        with pytest.raises(ValueError):
            dg_rhs.fused_plan(1000, steps, threads)


def test_cpu_wrappers_take_the_untiled_plain_versions():
    _, _, _, ops, u0, lam = _problem(60, dtype=torch.float32)
    dg_rhs.reset_launch_counts()
    traj, uf = dg_rhs.fwd_march(u0, 0.0, 5, ops, store_trajectory=True)
    got = dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)
    want = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    dg_rhs.adj_est_recompute(traj[::5].contiguous(), lam, 0.0, 5, ops)
    assert all(fn.launches == 0 for fn in dg_rhs._WRAPPERS)
    assert dg_rhs.adj_est_stored.cuda_launches == dg_rhs.adj_est_recompute.cuda_launches == 0
