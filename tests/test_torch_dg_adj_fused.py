"""KA's fused launch schedule (ops/cuda/dg_rhs.py) on the CPU.

On the card KA, the pure coarse adjoint march λ0 = (Lᵀ)ⁿ λN, runs s_f steps
a launch, one CTA per (tile, member) on a window of L local elements and W
ghosts a side, as K1 does. Its plain emulation, ``adj_march_fused_plain``,
runs that schedule in plain PyTorch — the same tiles, windows, s_f,
remainders, member rows and per-element geometry — so the halo logic is
tested here:

- bit-equal to the untiled plain version (``adj_march_plain``) in float32
  and float64 on a graded mesh with B = 3: K below one tile, a ragged last
  tile and one tile with no ghosts, n_steps = 13 with s_f = 4;
- in float64 equal to the XLA ``advec_adjoint_march`` at 1e-12 relative,
  with tests/test_torch_dg_recompute.py's absolute floor of 1e-13 for its
  O(1) random λ;
- the ghost rule has teeth: a ring one element short of the transposed
  march's dependency cone (5·s_f) changes a local element;
- :func:`adjoint_plan`'s choices and what the wrapper does on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import advec_adjoint_march
from adjoint_ode_adaptivity_tpu.march.advec import advec_operators
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
B = 3


def _problem(k, graded=True, cfl=0.5 * 0.75, dtype=torch.float64, b=B, seed=0):
    """A graded mesh (vx ∝ s^1.6) at N = 2, B random cotangents, and the
    step cfl·x_min/a."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = cfl / A * xmin
    lam = np.random.default_rng(seed).normal(size=(disc.np_, b, k))
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    return disc_j, dt, ops, torch.tensor(lam, dtype=dtype)


def _plan(k, steps, tile=None):
    """KA's windows (W = 5·steps) on 512 threads: the widest tile, narrower
    tiles, or ``"mesh"``, one tile with no ghosts."""
    if tile == "mesh":
        return dg_rhs.FusedPlan(steps, 0, k, 1, 512)
    plan = dg_rhs.fwd_fused_plan(k, steps)
    return plan if tile is None else plan._replace(tile=tile, n_tiles=-(-k // tile))


# (K, tile): K below one 472-element tile; three tiles, the last ragged (110,
# 110, 80); one tile holding the mesh with no ghosts
SHAPES = [(120, None), (300, 110), (120, "mesh")]


@pytest.mark.parametrize("k,tile", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adjoint_schedule_gives_the_untiled_bits(dtype, k, tile):
    _, _, ops, lam = _problem(k, dtype=dtype, seed=k)
    n_steps = 13
    plan = _plan(k, 4, tile)
    assert plan.segment == 4 and n_steps % plan.segment
    got = dg_rhs.adj_march_fused_plain(lam, n_steps, ops, plan)
    want = dg_rhs.adj_march_plain(lam, n_steps, ops)
    assert got.dtype == dtype and torch.equal(got, want)


def test_adjoint_schedule_matches_xla_f64():
    """The schedule on B = 1 of a graded mesh in ragged tiles against the
    XLA transpose march."""
    disc_j, dt, ops, lam = _problem(200, b=1, seed=4)
    n_steps = 13
    got = dg_rhs.adj_march_fused_plain(lam, n_steps, ops, _plan(200, 4, tile=60))
    want = advec_adjoint_march(advec_operators(disc_j, a=A, dtype=jnp.float64),
                               jnp.asarray(lam[:, 0].numpy()), dt, n_steps)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("s_f", [1, 2])
def test_the_adjoint_ghost_rule_has_teeth(s_f):
    """A transposed stage couples ±1 element (each element takes both
    neighbours' lifted faces), and the window's ends are wrong (no face from
    beyond them), so over a launch of 5·s_f stages the error reaches 5·s_f
    elements in: W = 5·s_f − 1 changes a local element at both edges of a
    middle tile, W = 5·s_f does not. A large step (3·x_min/a) keeps the
    edge's error above rounding."""
    k = 120
    _, _, ops, lam = _problem(k, graded=False, cfl=3.0, b=2)
    n_steps = 2 * s_f
    want = dg_rhs.adj_march_plain(lam, n_steps, ops)
    assert bool(torch.isfinite(want).all())
    for ghost, exact in ((5 * s_f - 1, False), (5 * s_f, True), (5 * s_f + 5, True)):
        plan = dg_rhs.FusedPlan(s_f, ghost, 40, 3, 512)
        got = dg_rhs.adj_march_fused_plain(lam, n_steps, ops, plan)
        assert torch.equal(got, want) == exact, ghost
        if not exact:
            moved = (got != want).any(dim=(0, 1))
            assert bool(moved[40]) and bool(moved[79])


def test_adjoint_plans():
    """The wrapper's choices on a 132-SM card: phase 23(d)'s row (K = 10⁴,
    B = 1, 2048 steps) in launches of 32 steps; the headline's grid as K1's;
    a mesh that fits one CTA in one tile with no ghosts; s_f capped by
    n_steps; every plan within the kernel's rules."""
    FP = dg_rhs.FusedPlan
    row = dg_rhs.adjoint_plan(10_000, 1, 3, 2048)
    assert row.segment == 32 and row.ghost == 160 and row.threads == 512
    assert dg_rhs.adjoint_plan(10_000, 8, 3, 2048) == FP(16, 80, 625, 16, 1024)
    assert dg_rhs.adjoint_plan(512, 1, 3, 5462) == FP(32, 0, 512, 1, 512)
    assert dg_rhs.adjoint_plan(24, 1, 2, 3) == FP(3, 0, 24, 1, 512)
    for k, b, np_, n in ((10_000, 1, 3, 2048), (1_000_000, 1, 2, 64), (700, 3, 8, 13),
                         (516, 1, 3, 1368), (5, 1, 4, 40)):
        plan = dg_rhs.adjoint_plan(k, b, np_, n)
        assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
        assert plan.ghost >= 5 * plan.segment or plan.tile >= k
        assert plan.n_tiles == -(-k // plan.tile) and plan.segment <= min(n, 32)


def test_cpu_adjoint_wrapper_takes_the_untiled_plain_version():
    _, _, ops, lam = _problem(60, dtype=torch.float32)
    dg_rhs.reset_launch_counts()
    assert torch.equal(dg_rhs.adj_march(lam, 9, ops), dg_rhs.adj_march_plain(lam, 9, ops))
    assert dg_rhs.adj_march.launches == dg_rhs.adj_march.cuda_launches == 0
    with pytest.raises(ValueError):
        dg_rhs.adj_march(lam, 0, ops)
    with pytest.raises(ValueError):
        dg_rhs.adj_march(lam[:, 0], 4, ops)
