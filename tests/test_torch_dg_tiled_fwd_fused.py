"""KT1, the element-tiled forward, on K1's fused windows (ops/cuda/dg_tiled.py
``tiled_fwd_seg``) on the CPU.

On the card ``tiled_fwd_seg`` runs K1's fused kernel at B = 1 on
``forward_plan``'s windows, storing every step, from the global step
first_segment·segment. Its launch schedule is ``dg_rhs._fwd_fused_plain``'s.
Here:

- that schedule with ``n_first = first_segment·segment`` gives
  ``tiled_fwd_seg_plain``'s float32 bits (the tile plan's windows), traj
  and u_final, at first_segment 0 and 3, on a uniform and a graded mesh,
  with s_f not dividing the segment and narrow tiles;
- the ghost rule has teeth at an offset start: W = 5·s_f − 1 moves a local
  element, W = 5·s_f does not;
- the plans at the K = 10⁶ row and a rank's extended chunk take the grid;
- the whole tiled pipeline, its forward one segment a call on the fused
  schedule as the sharded composition calls it, in float64 against the XLA
  ``advec_fwd_adj_estimate`` at 1e-12 of each output's scale.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py, and
chip_smoke.py phases 24, 28, 29 and 37).
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
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi


def _problem(k, graded, dtype=torch.float32, cfl=0.5 * 0.75, seed=0):
    """One state on a uniform or graded (vx ∝ s^1.6) mesh, a phase-shifted
    sine, J = ∫u(T)'s cotangent, and the step cfl·x_min/a."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = cfl / A * xmin
    rng = np.random.default_rng(seed)
    u0 = torch.tensor(np.sin(disc.x + rng.uniform(0, 2 * np.pi)), dtype=dtype)
    lam = terminal_integral_cotangent(disc, dtype, "cpu")
    return disc_j, dt, dg_rhs.kernel_ops(disc, A, dt, "cpu"), u0, lam


def _fused_fwd(u0, t0, n_first, n_steps, ops, plan):
    """KT1's schedule on an (Np, K) state: K1's at B = 1, every step stored."""
    traj, uf = dg_rhs._fwd_fused_plain(u0[:, None], t0, n_first, n_steps, ops, plan, 1)
    return traj[:, :, 0], uf[:, 0]


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("first_segment", [0, 3])
def test_fused_schedule_gives_the_tiled_plain_bits(graded, first_segment):
    """Two segments of 3 steps from the march's segment ``first_segment``:
    the tile plan's windows (tiled_fwd_seg_plain, through the wrapper's CPU
    path) and K1's fused windows (s_f 4 over 6 steps: a remainder launch;
    the widest tile, then narrow tiles) give the same float32 bits."""
    k, seg = 120, 3
    _, _, ops, u0, _ = _problem(k, graded, seed=first_segment)
    tplan = dg_tiled.TilePlan(seg, 40, 50, 3)
    want = dg_tiled.tiled_fwd_seg_plain(u0, 0.1, 2, tplan, ops, first_segment)
    before = dg_tiled.tiled_fwd_seg.launches
    got = dg_tiled.tiled_fwd_seg(u0, 0.1, 2, tplan, ops, first_segment)
    assert dg_tiled.tiled_fwd_seg.launches == before  # a CPU tensor takes the plain version
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want[0].shape == (2 * seg, *u0.shape)
    plan = dg_rhs.fwd_fused_plan(k, 4)
    assert 2 * seg % plan.segment
    for p in (plan, plan._replace(tile=35, n_tiles=4), plan._replace(tile=7, n_tiles=18)):
        got = _fused_fwd(u0, 0.1, first_segment * seg, 2 * seg, ops, p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), p
    # the offset matters: the same steps from step 0 differ
    if first_segment:
        other = _fused_fwd(u0, 0.1, 0, 2 * seg, ops, plan)
        assert not torch.equal(other[1], want[1])


@pytest.mark.parametrize("s_f", [1, 2])
def test_the_ghost_rule_has_teeth_at_an_offset(s_f):
    """From the march's step 4·s_f: a forward step's 5 stages each couple ±1
    element, so K1's dependency cone over s_f steps is 5·s_f elements, and
    W = 5·s_f − 1, one short of it, moves a local element while W = 5·s_f
    does not. A large step (3·x_min/a) in float64 keeps the edge's error
    above rounding."""
    k = 120
    _, _, ops, u0, _ = _problem(k, False, dtype=torch.float64, cfl=3.0, seed=s_f)
    n_first, n_steps = 4 * s_f, 2 * s_f
    want = dg_tiled.tiled_fwd_seg_plain(u0, 0.0, 1, dg_tiled.TilePlan(n_steps, 0, k, 1), ops,
                                        n_first // n_steps)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for ghost, exact in ((5 * s_f - 1, False), (5 * s_f, True), (5 * s_f + 4, True)):
        got = _fused_fwd(u0, 0.0, n_first, n_steps, ops, dg_rhs.FusedPlan(s_f, ghost, 40, 3, 512))
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == exact, ghost


def test_plans_at_the_rows():
    """forward_plan at B = 1 storing every step, for the tiled rows (K = 10⁵
    and 10⁶) and a sharded rank's extended chunk (K/2 + W, 16 steps): a grid
    of whole windows within the launch limits, K1's ghost rule kept (W ≥
    5·s_f, or one tile with no ghosts), ⌈n/s_f⌉ launches of at most
    MAX_FWD_FUSED steps for any segment up to MAX_SEGMENT."""
    for k, n_steps in ((1_000_000, 64), (500_170, 16), (100_000, 256), (640, 8)):
        plan = dg_rhs.forward_plan(k, 1, 3, n_steps, 1)
        assert plan.n_tiles == -(-k // plan.tile) and plan.n_tiles < 2**31 - 1
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.threads in dg_rhs.FUSED_THREADS
        assert 1 <= plan.segment <= min(dg_rhs.MAX_FWD_FUSED, n_steps)
        assert plan.ghost >= 5 * plan.segment or (plan.n_tiles == 1 and plan.ghost == 0)
    # one CTA holds K = 300: no ghosts
    assert dg_rhs.forward_plan(300, 1, 3, 8, 1) == dg_rhs.FusedPlan(8, 0, 300, 1, 512)
    for n_steps in (1, 13, dg_tiled.MAX_SEGMENT):
        assert dg_rhs.forward_plan(1_000, 1, 3, n_steps, 1).segment <= dg_rhs.MAX_FWD_FUSED


def test_segment_calls_match_xla_f64():
    """The tiled pipeline in float64 with the forward one segment a call on
    K1's fused schedule from the global step offset (s_f 3 on narrow tiles)
    and the reverse on the tile plan's windows, against the XLA pipeline."""
    k, seg, n_seg = 120, 4, 3
    disc_j, dt, ops, u0, lam = _problem(k, False, dtype=torch.float64, seed=7)
    tplan = dg_tiled.TilePlan(seg, 50, 40, 3)
    plan = dg_rhs.fwd_fused_plan(k, 3)._replace(tile=45, n_tiles=3)
    parts, u = [], u0
    for s in range(n_seg):
        traj, u = _fused_fwd(u, 0.05, s * seg, seg, ops, plan)
        parts.append(traj)
    traj = torch.cat(parts)
    lam0, eta = dg_tiled.tiled_rev_seg_plain(traj, u, lam, 0.05, tplan, ops)
    ref = advec_fwd_adj_estimate(advec_operators(disc_j, a=A, dtype=jnp.float64), disc_j,
                                 jnp.asarray(u0.numpy()), dt, n_seg * seg, segment=seg, t0=0.05,
                                 lam_end=jnp.asarray(lam.numpy()))
    # 1e-12 of each output's scale: u's and λ's largest entry; η sums
    # λ·(u_{n+1} − half2), a cancellation, so its scale is max|λ|·max|u|
    scale = {"u": float(u.abs().max()), "lam": float(lam.abs().max())}
    scale["eta"] = scale["u"] * scale["lam"]
    for name, got, want in (("u", u, ref.u_final), ("lam", lam0, ref.lam0), ("eta", eta, ref.eta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12 * scale[name])
