"""K1's fused launch schedule (ops/cuda/dg_rhs.py) on the CPU.

On the card K1 runs s_f steps a launch, one CTA per (tile, member) on a
window of L local elements and W ghosts a side, in every mode: the whole
trajectory, every segment-th entry state (the checkpoints) or none. Its
plain emulation, ``fwd_march_fused_plain``, runs that schedule in plain
PyTorch — the same tiles, windows, s_f, remainders, member rows and
per-element geometry — so the halo logic is tested here:

- bit-equal to the untiled plain version (``fwd_march_plain``) in float32
  and float64 on a graded mesh with B = 3: K below one tile, a ragged last
  tile and one tile with no ghosts, n_steps = 13 with s_f = 4, storing
  nothing or every 1st, 3rd, 4th or 13th entry state (the global step
  decides, whatever s_f);
- in float64 equal to the XLA ``advec_march`` at 1e-12 relative
  (tests/test_torch_dg_rev_fused.py's tolerance for u);
- the ghost rule has teeth: a ring one element short of the forward's
  dependency cone (5·s_f) changes a local element;
- :func:`forward_plan`'s choices and what :func:`fwd_fused_plan` refuses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march.advec import advec_march, advec_operators
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
B = 3


def _problem(k, graded=True, cfl=0.5 * 0.75, dtype=torch.float64, b=B, seed=0):
    """A graded mesh (vx ∝ s^1.6) at N = 2, B phase-shifted sines, and the
    step cfl·x_min/a."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = cfl / A * xmin
    rng = np.random.default_rng(seed)
    u0 = np.stack([np.sin(disc.x + p) for p in rng.uniform(0, 2 * np.pi, b)], axis=1)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    return disc_j, dt, ops, torch.tensor(u0, dtype=dtype)


def _plan(k, steps, tile=None):
    """K1's windows (W = 5·steps) on 512 threads: the widest tile, narrower
    tiles, or ``"mesh"``, one tile with no ghosts."""
    if tile == "mesh":
        return dg_rhs.FusedPlan(steps, 0, k, 1, 512)
    plan = dg_rhs.fwd_fused_plan(k, steps)
    return plan if tile is None else plan._replace(tile=tile, n_tiles=-(-k // tile))


def _untiled(u0, t0, n_steps, ops, store_every):
    if store_every == 1:
        return dg_rhs.fwd_march_plain(u0, t0, n_steps, ops, store_trajectory=True)
    return dg_rhs.fwd_march_plain(u0, t0, n_steps, ops, checkpoint_every=store_every)


# (K, tile): K below one 472-element tile; three tiles, the last ragged (110,
# 110, 80); one tile holding the mesh with no ghosts
SHAPES = [(120, None), (300, 110), (120, "mesh")]


@pytest.mark.parametrize("store_every", [None, 1, 3, 4, 13])
@pytest.mark.parametrize("k,tile", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_schedule_gives_the_untiled_bits(dtype, k, tile, store_every):
    _, _, ops, u0 = _problem(k, dtype=dtype, seed=k)
    n_steps = 13
    plan = _plan(k, 4, tile)
    assert plan.segment == 4 and n_steps % plan.segment
    store, uf = dg_rhs.fwd_march_fused_plain(u0, 0.1, n_steps, ops, plan, store_every)
    want_store, want_uf = _untiled(u0, 0.1, n_steps, ops, store_every)
    assert uf.dtype == dtype and torch.equal(uf, want_uf)
    if store_every is None:
        assert store is None and want_store is None
    else:
        assert store.shape[0] == -(-n_steps // store_every) and torch.equal(store, want_store)


def test_forward_schedule_matches_xla_f64():
    """The schedule on B = 1 of a graded mesh, checkpoints every 4 steps,
    against the XLA march saving every 4th state (its states after steps 4,
    8 and 12 are our entry states of steps 4, 8 and 12)."""
    disc_j, dt, ops, u0 = _problem(200, b=1, seed=4)
    n_steps, every = 13, 4
    store, uf = dg_rhs.fwd_march_fused_plain(u0, 0.05, n_steps, ops, _plan(200, 4, tile=60), every)
    ref_uf, saved = advec_march(advec_operators(disc_j, a=A, dtype=jnp.float64),
                                jnp.asarray(u0[:, 0].numpy()), dt, n_steps, t0=0.05,
                                save_every=every)
    np.testing.assert_allclose(uf[:, 0].numpy(), np.asarray(ref_uf), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(store[1:, :, 0].numpy(), np.asarray(saved), rtol=1e-12,
                               atol=1e-13)
    assert torch.equal(store[0], u0)


@pytest.mark.parametrize("s_f", [1, 2])
def test_the_forward_ghost_rule_has_teeth(s_f):
    """A forward stage couples ±1 element through both faces, so the
    window's wrong ends (the inflow value at its first element, no right face
    at its last) reach 5·s_f elements in over a launch: W = 5·s_f − 1
    changes a local element and W = 5·s_f does not. The cone is two-sided,
    so the rule is symmetric. A large step (3·x_min/a) keeps the edge's
    error above rounding."""
    k = 120
    _, _, ops, u0 = _problem(k, graded=False, cfl=3.0, b=2)
    n_steps = 2 * s_f
    want = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, store_trajectory=True)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for ghost, exact in ((5 * s_f - 1, False), (5 * s_f, True), (5 * s_f + 5, True)):
        plan = dg_rhs.FusedPlan(s_f, ghost, 40, 3, 512)
        got = dg_rhs.fwd_march_fused_plain(u0, 0.0, n_steps, ops, plan, 1)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == exact, ghost
        if not exact:  # both edges of the middle tile move
            moved = (got[1] != want[1]).any(dim=(0, 1))
            assert bool(moved[40]) and bool(moved[79])


def test_forward_plans():
    """The wrappers' choices on a 132-SM card: the headline's grid one
    1024-thread CTA an SM at s_f = 16 in every mode; revolve's advance at
    K = 10⁵ over 131 SMs; the K = 512 march and the adaptive study's first
    mesh in one tile with no ghosts at s_f = 32; Np = 8 on 1024 threads (the
    forward kernel does not spill there); s_f capped by n_steps; what
    fwd_fused_plan refuses."""
    FP = dg_rhs.FusedPlan
    for every in (None, 1, 4, 64):
        assert dg_rhs.forward_plan(10_000, 8, 3, 2048, every) == FP(16, 80, 625, 16, 1024)
    assert dg_rhs.forward_plan(100_000, 1, 3, 128) == FP(16, 80, 764, 131, 1024)
    assert dg_rhs.forward_plan(512, 1, 3, 5462) == FP(32, 0, 512, 1, 512)
    assert dg_rhs.forward_plan(512, 1, 3, 688, 1) == FP(32, 0, 512, 1, 512)
    assert dg_rhs.forward_plan(10_000, 8, 8, 2048, 1) == FP(16, 80, 625, 16, 1024)
    assert dg_rhs.forward_plan(24, 1, 2, 3) == FP(3, 0, 24, 1, 512)
    for k, b, np_, n in ((10_000, 8, 3, 100), (1_000_000, 1, 2, 64), (700, 3, 8, 13),
                         (516, 1, 3, 1368), (5, 1, 4, 40)):
        plan = dg_rhs.forward_plan(k, b, np_, n, 1)
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.ghost >= 5 * plan.segment or plan.tile >= k
        assert plan.n_tiles == -(-k // plan.tile) and plan.segment <= min(n, 32)
    assert dg_rhs.fwd_fused_plan(10_000, 16, 1024) == FP(16, 80, 864, 12, 1024)
    for steps, threads in ((0, 512), (33, 512), (4, 256)):
        with pytest.raises(ValueError):
            dg_rhs.fwd_fused_plan(1000, steps, threads)


def test_cpu_wrappers_take_the_untiled_plain_version():
    _, _, ops, u0 = _problem(60, dtype=torch.float32)
    dg_rhs.reset_launch_counts()
    got = dg_rhs.fwd_march(u0, 0.0, 9, ops, store_trajectory=True)
    want = dg_rhs.fwd_march_plain(u0, 0.0, 9, ops, store_trajectory=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = dg_rhs.fwd_march_ckpt(u0, 0.0, 9, 3, ops)
    assert torch.equal(got[0], want[0][::3]) and torch.equal(got[1], want[1])
    assert dg_rhs.fwd_march(u0, 0.0, 9, ops)[0] is None
    assert dg_rhs.fwd_march.launches == dg_rhs.fwd_march_ckpt.launches == 0
    assert dg_rhs.fwd_march.cuda_launches == dg_rhs.fwd_march_ckpt.cuda_launches == 0
