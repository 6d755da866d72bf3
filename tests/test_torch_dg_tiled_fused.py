"""KT2, the element-tiled reverse, on K2's fused windows (ops/cuda/dg_tiled.py
``tiled_rev_seg``) on the CPU.

On the card ``tiled_rev_seg`` runs K2's fused kernel at B = 1 on
``stored_plan``'s windows, from the global step first_segment·segment with
η carried in. Its launch schedule is ``dg_rhs._rev_fused_plain``'s. Here:

- that schedule with ``n_first = first_segment·segment`` and η carried in
  gives ``tiled_rev_seg_plain``'s float32 bits (the tile plan's windows),
  at first_segment 0 and 3, on a uniform and a graded mesh, with s_f not
  dividing the sweep and narrow tiles;
- the whole tiled pipeline, its reverse one segment a call on the fused
  schedule as the sharded composition calls it, in float64 against the XLA
  ``advec_fwd_adj_estimate`` at 1e-12 of each output's scale;
- the ghost rule has teeth at an offset start with η carried in;
- the plans at the K = 10⁶ row and a rank's extended chunk take the grid.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py, and
chip_smoke.py phases 24, 28 and 35).
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
    sine, J = ∫u(T)'s cotangent weighted per node, and the step cfl·x_min/a."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = cfl / A * xmin
    rng = np.random.default_rng(seed)
    u0 = torch.tensor(np.sin(disc.x + rng.uniform(0, 2 * np.pi)), dtype=dtype)
    lam = terminal_integral_cotangent(disc, dtype, "cpu")
    lam = lam * torch.tensor(rng.uniform(0.5, 1.5, lam.shape), dtype=dtype)
    eta = torch.tensor(rng.uniform(-1e-3, 1e-3, k), dtype=dtype)
    return disc_j, dt, dg_rhs.kernel_ops(disc, A, dt, "cpu"), u0, lam, eta


def _fused_rev(traj, uf, lam, eta, t0, n_first, ops, plan):
    """KT2's schedule on (Np, K) states: K2's at B = 1."""
    lam0, eta = dg_rhs._rev_fused_plain(traj[:, :, None], uf[:, None], lam[:, None], eta[None],
                                        t0, n_first, ops, plan)
    return lam0[:, 0], eta[0]


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("first_segment", [0, 3])
def test_fused_schedule_gives_the_tiled_plain_bits(graded, first_segment):
    """Two segments of 2 steps from the march's segment ``first_segment``,
    η carried in: the tile plan's windows (tiled_rev_seg_plain) and K2's
    fused windows (s_f 3 over 4 steps: a remainder launch; one tile, then
    narrow tiles) give the same float32 bits."""
    k, seg = 120, 2
    _, _, ops, u0, lam, eta = _problem(k, graded, seed=first_segment)
    n_first = first_segment * seg
    traj, uf = dg_rhs._fwd_steps_plain(u0[:, None], 0.1, n_first, 2 * seg, ops, 1)
    traj, uf = traj[:, :, 0], uf[:, 0]
    want = dg_tiled.tiled_rev_seg_plain(traj, uf, lam, 0.1, dg_tiled.TilePlan(seg, 30, 50, 3),
                                        ops, first_segment, eta)
    before = dg_tiled.tiled_rev_seg.launches
    got = dg_tiled.tiled_rev_seg(traj, uf, lam, 0.1, dg_tiled.TilePlan(seg, 30, 50, 3), ops,
                                 first_segment, eta)
    assert dg_tiled.tiled_rev_seg.launches == before  # a CPU tensor takes the plain version
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    plan = dg_rhs.fused_plan(k, 3)
    for p in (plan, plan._replace(tile=35, n_tiles=4)):
        got = _fused_rev(traj, uf, lam, eta, 0.1, n_first, ops, p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), p
    # the offset matters: the same sweep from step 0 differs
    if first_segment:
        other = _fused_rev(traj, uf, lam, eta, 0.1, 0, ops, plan)
        assert not torch.equal(other[1], want[1])


def test_segment_calls_match_xla_f64():
    """The tiled pipeline in float64 with the reverse one segment a call
    (η carried in, the global step offset, s_f 3 on narrow tiles), as the
    sharded composition calls it, against the XLA pipeline."""
    k, seg, n_seg = 120, 4, 3
    disc_j, dt, ops, u0, lam, _ = _problem(k, False, dtype=torch.float64, seed=7)
    tplan = dg_tiled.TilePlan(seg, 50, 40, 3)
    traj, uf = dg_tiled.tiled_fwd_seg_plain(u0, 0.05, n_seg, tplan, ops)
    plan = dg_rhs.fused_plan(k, 3)._replace(tile=45, n_tiles=3)
    lam_s, eta, bound = lam, torch.zeros(k, dtype=torch.float64), uf
    for s in reversed(range(n_seg)):
        part = traj[s * seg:(s + 1) * seg]
        lam_s, eta = _fused_rev(part, bound, lam_s, eta, 0.05, s * seg, ops, plan)
        bound = part[0]
    ref = advec_fwd_adj_estimate(advec_operators(disc_j, a=A, dtype=jnp.float64), disc_j,
                                 jnp.asarray(u0.numpy()), dt, n_seg * seg, segment=seg, t0=0.05,
                                 lam_end=jnp.asarray(lam.numpy()))
    # 1e-12 of each output's scale: u's and λ's largest entry; η sums
    # λ·(u_{n+1} − half2), a cancellation, so its scale is max|λ|·max|u|
    scale = {"u": float(uf.abs().max()), "lam": float(lam.abs().max())}
    scale["eta"] = scale["u"] * scale["lam"]
    for name, got, want in (("u", uf, ref.u_final), ("lam", lam_s, ref.lam0),
                            ("eta", eta, ref.eta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12 * scale[name])


@pytest.mark.parametrize("s_f", [1, 2])
def test_the_ghost_rule_has_teeth_at_an_offset(s_f):
    """From the march's segment 2 with η carried in: λ's 10 transposed
    stages a step and the half steps' 10 from the exact u_n make the
    reverse's dependency cone 10·s_f elements, so W = 10·s_f − 1, one short
    of it, moves a local element, and W = 10·s_f and the plans' 10·s_f + 10
    (and so 10·s_f + 9, inside the margin) do not. A large step
    (3·x_min/a) in float64 keeps the edge's error above rounding."""
    k = 120
    _, _, ops, u0, lam, eta = _problem(k, False, dtype=torch.float64, cfl=3.0, seed=s_f)
    n_first = 2 * 2 * s_f
    traj, uf = dg_rhs._fwd_steps_plain(u0[:, None], 0.0, n_first, 2 * s_f, ops, 1)
    traj, uf = traj[:, :, 0], uf[:, 0]
    want = dg_tiled.tiled_rev_seg_plain(traj, uf, lam, 0.0, dg_tiled.TilePlan(2 * s_f, 0, k, 1),
                                        ops, 2, eta)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for ghost, exact in ((10 * s_f - 1, False), (10 * s_f, True), (10 * s_f + 9, True),
                         (10 * s_f + 10, True)):
        got = _fused_rev(traj, uf, lam, eta, 0.0, n_first, ops,
                         dg_rhs.FusedPlan(s_f, ghost, 40, 3, 512))
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == exact, ghost


def test_plans_at_the_rows():
    """stored_plan at B = 1 for the tiled row (K = 10⁶, 64 steps) and a
    sharded rank's extended chunk (K/2 + W, 16 steps): a grid of whole
    windows within the launch limits, the ghost rule kept, ⌈n/s_f⌉ launches
    of at most MAX_FUSED steps for any segment up to MAX_SEGMENT."""
    for k, n_steps in ((1_000_000, 64), (500_170, 16), (100_000, 256), (640, 8)):
        plan = dg_rhs.stored_plan(k, 1, 3, n_steps)
        assert plan.n_tiles == -(-k // plan.tile) and plan.n_tiles < 2**31 - 1
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.ghost >= 10 * plan.segment + 10 and 1 <= plan.segment <= dg_rhs.MAX_FUSED
    assert dg_rhs.stored_plan(1_000_000, 1, 3, 64).segment == 4  # 16 launches
    assert dg_rhs.stored_plan(1_000, 1, 3, dg_tiled.MAX_SEGMENT).segment <= dg_rhs.MAX_FUSED
