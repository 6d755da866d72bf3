"""KM1's fused launch schedule (ops/cuda/dg_mxu.py) on the CPU.

On the card KM1 runs s_f steps a launch, one CTA per (tile, member) on a
window of L local columns and W = 5·s_f ghost columns a side (K1's windows),
or one untiled CTA where a member's K fits. Its plain emulation,
``km_fwd_traj_fused_plain``, runs that schedule in plain PyTorch — the same
tiles, windows, s_f, remainders and first/last masks (the window's ends) —
so the halo logic is tested here:

- bit-equal to the untiled plain version ``km_fwd_traj_plain`` (trajectory
  and final state) in float32 at Np 2, 3 and 8 with B = 3, on tiled and
  untiled plans, with s_f that divides neither the TPU's segment nor
  n_steps;
- the ghost rule has teeth: a halo one column short of the forward's
  dependency cone moves a local column;
- ``km_fwd_plan``'s choices;
- with KM2's plain version, against the JAX package's MXU pipeline in
  interpret mode.
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
FP = dg_rhs.FusedPlan


def _ops(n_order, k, segment, n_segments, b=B, cfl=0.375, seed=0):
    """A uniform mesh at the step cfl·x_min/a and B phase-shifted sines
    (float32, (Np, B·K))."""
    disc = interop.discretization_from_numpy(jax_startup_1d(n_order, 0.0, 2 * np.pi, k)._asdict())
    dt = cfl / A * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_mxu.mxu_ops(disc, A, dt, segment, n_segments, b, "cpu")
    rng = np.random.default_rng(seed)
    u0 = np.concatenate([np.sin(disc.x + p) for p in rng.uniform(0, 2 * np.pi, b)], axis=1)
    return ops, torch.tensor(u0, dtype=torch.float32)


# (K, plan): one untiled CTA (no ghosts); s_f 4 on tiles of 110 (110, 110,
# 80) and s_f 3 on tiles of 37 (eight whole, a ragged 4). 14 steps as two
# segments of 7: neither s_f divides the segment or n_steps.
CASES = [(60, FP(4, 0, 60, 1, 512)), (300, FP(4, 20, 110, 3, 512)), (300, FP(3, 15, 37, 9, 1024))]


@pytest.mark.parametrize("n_order", [1, 2, 7])
@pytest.mark.parametrize("k,plan", CASES)
def test_fused_schedule_gives_the_plain_bits(n_order, k, plan):
    ops, u0 = _ops(n_order, k, 7, 2, seed=n_order)
    n_steps = ops.segment * ops.n_segments
    assert n_steps % plan.segment and ops.segment % plan.segment
    want = dg_mxu.km_fwd_traj_plain(u0, 0.1, ops)
    got = dg_mxu.km_fwd_traj_fused_plain(u0, 0.1, ops, plan)
    assert got[0].shape == (n_steps, ops.np_, ops.n)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("s_f", [1, 3])
def test_the_ghost_rule_has_teeth(s_f):
    """A forward step runs 5 stages, each coupling ±1 column, so after s_f
    steps a window edge's error has reached 5·s_f columns: W = 5·s_f − 1
    moves a local column and W = 5·s_f does not. A large step (3·x_min/a)
    keeps the edge's error above rounding."""
    ops, u0 = _ops(2, 120, 2 * s_f, 1, b=2, cfl=3.0)
    want = dg_mxu.km_fwd_traj_plain(u0, 0.0, ops)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for ghost, exact in ((5 * s_f - 1, False), (5 * s_f, True)):
        got = dg_mxu.km_fwd_traj_fused_plain(u0, 0.0, ops, FP(s_f, ghost, 40, 3, 512))
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == exact, ghost


def test_plans():
    """km_fwd_plan on a 132-SM card: K1's candidate windows under KM1's
    cost; W = 5·s_f, or one untiled CTA where K fits; s_f at most n_steps;
    ⌈K/L⌉ tiles; the cache."""
    assert dg_mxu.KM_FWD_STEP_WARP_US > 0
    for k, b, np_, n_steps in ((10_000, 8, 8, 256), (10_000, 8, 3, 2048), (24, 8, 3, 16),
                               (1000, 3, 8, 3), (5, 1, 2, 100), (700, 2, 4, 13)):
        plan = dg_mxu.km_fwd_plan(k, b, np_, n_steps)
        assert plan.segment in (4, 8, 16, 32) or plan.segment == n_steps
        assert plan.segment <= n_steps and plan.threads in (512, 1024)
        if plan.n_tiles == 1 and plan.ghost == 0:
            assert k <= plan.threads and plan.tile == k
        else:
            assert plan.ghost == 5 * plan.segment
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.n_tiles == -(-k // plan.tile)
        # ⌈n_steps/s_f⌉ launches, each plan's cost counts them
        cost = dg_mxu.km_fwd_cost(k, b, np_, n_steps, plan)
        assert cost >= -(-n_steps // plan.segment) * dg_rhs.LAUNCH_US
    # a member's K within one CTA: one untiled CTA a member
    assert dg_mxu.km_fwd_plan(24, 8, 3, 16) == FP(16, 0, 24, 1, 512)
    assert dg_mxu.km_fwd_step_warp_us(8) == pytest.approx(dg_mxu.KM_FWD_STEP_WARP_US * 204)
    assert dg_mxu.km_fwd_plan(10_000, 8, 8, 256) is dg_mxu.km_fwd_plan(10_000, 8, 8, 256)


def test_cpu_wrapper_takes_the_untiled_plain_version():
    ops, u0 = _ops(2, 40, 5, 1)
    dg_mxu.reset_launch_counts()
    got = dg_mxu.km_fwd_traj(u0, 0.1, ops)
    want = dg_mxu.km_fwd_traj_plain(u0, 0.1, ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dg_mxu.km_fwd_traj.launches == dg_mxu.km_fwd_traj.cuda_launches == 0


def test_fused_pipeline_matches_pallas_mxu_interpret():
    """The fused forward on narrow tiles (s_f 3, L 20: four tiles a member,
    a remainder) and KM2's plain version against the Pallas kernels in
    interpret mode, at test_plain_matches_pallas_mxu_interpret's tolerances
    (n·ε·max|u|, n·ε·max|λ|, n·Np·ε·max|λ|·max|u|) and its step, where η
    sits above float32 roundoff."""
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_mxu import make_pallas_fwd_adj_estimate_grid_mxu

    n_order, k, dt, seg, n_seg, b = 2, 64, 2e-3, 4, 4, 8
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    rng = np.random.default_rng(11)
    u0 = np.stack([np.sin(np.asarray(disc.x) + p) for p in rng.uniform(0, 6, b)],
                  axis=1).astype(np.float32)
    lam = np.ascontiguousarray(np.broadcast_to(
        np.asarray(jax_lam(disc_j, jnp.float32))[:, None, :], (disc.np_, b, k)))
    want = make_pallas_fwd_adj_estimate_grid_mxu(
        disc_j, A, dt, segment=seg, n_segments=n_seg, batch=b, interpret=True)(
        jnp.asarray(u0), jnp.float32(0.0), jnp.asarray(lam))
    ops = dg_mxu.mxu_ops(disc, A, dt, seg, n_seg, b, "cpu")
    flat = (disc.np_, b * k)
    traj, uf = dg_mxu.km_fwd_traj_fused_plain(torch.tensor(u0).reshape(flat), 0.0, ops,
                                              FP(3, 15, 20, 4, 512))
    lam0, eta = dg_mxu.km_adj_est_plain(traj, uf, torch.tensor(lam).reshape(flat), 0.0, ops)
    n = seg * n_seg
    umax, lmax = float(np.abs(u0).max()), float(np.abs(lam).max())
    tols = (n * EPS32 * umax, n * EPS32 * lmax, n * disc.np_ * EPS32 * umax * lmax)
    for g, w, tol in zip((uf, lam0, eta), want, tols):
        assert g.dtype == torch.float32
        assert float(np.abs(g.reshape(w.shape).numpy() - np.asarray(w)).max()) <= tol
    assert float(np.abs(np.asarray(want[2])).max()) > 10 * tols[2]  # η above roundoff
