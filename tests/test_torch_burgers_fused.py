"""B1's fused launch schedule (ops/cuda/burgers.py) on the CPU.

On the card B1 runs s_f steps a launch, one CTA per (tile, member) on a
window of L local elements and W ghosts a side taken around the periodic
ring; where one tile holds the mesh the window is the ring and the whole
march is one launch. Its plain emulation, ``burgers_march_fused_plain``,
runs that schedule in plain PyTorch — the same tiles, windows, s_f,
remainders, member rows and per-element geometry, the window's end slots
taking their own face values and averages for their missing neighbours',
the limiter's copied endpoints at the GLOBAL ends — so the halo logic is
tested here:

- bit-equal to the untiled plain version (``burgers_march_plain``) in
  float32 and float64 with ΠN, Π¹ and no limiter on a graded mesh with
  B = 3: K below one tile (a window wider than the ring), a ragged last
  tile with the first and last tiles reading the other end's elements as
  ghosts, and one tile holding the ring with no ghosts; n_steps = 7 with
  s_f = 3 and 2;
- in float64 equal to the XLA ``march/burgers.py::burgers_march`` at 1e-12
  relative (tests/test_torch_burgers.py's tolerance);
- the derived ghost rule has teeth: a stage's update reads the neighbours'
  traces and the limiter then reads their updated averages, ±2 elements a
  stage, so W = 10·s_f limited (5·s_f unlimited); one element fewer changes
  a local element;
- :func:`burgers_plan`'s choices and what the plans refuse.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march import burgers as jb
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

BP = cb.BurgersPlan
K = 60


def _disc(k, graded=True):
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(2, 0.0, 2 * np.pi, k, vx=vx)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict())


def _rough(disc, b=3, seed=0, dtype=torch.float64):
    """B phase-shifted sines with element-scale noise: cells the limiters
    act on, in both types."""
    rng = np.random.default_rng(seed)
    x = np.asarray(disc.x)
    u0 = np.stack([(0.5 + 0.4 * ph) * np.sin(x + 3 * ph) + 0.1 * ph
                   + 0.05 * rng.standard_normal(x.shape) for ph in rng.uniform(0, 1, b)], axis=1)
    return torch.tensor(u0, dtype=dtype)


def _plan(shape, steps, limiter):
    """The schedules under test at K = 60: ``below``, one tile wider than
    the mesh (its window wraps past the ring); ``ragged``, tiles of 13 (the
    last 8), the first and last reading across the seam; ``ring``, one tile
    of the whole mesh with no ghosts."""
    ghost = cb.ghost_rule(limiter) * steps
    if shape == "below":
        return BP(steps, ghost, 100, 1, 512)
    if shape == "ragged":
        return BP(steps, ghost, 13, 5, 512)
    return BP(steps, 0, K, 1, 512)


@pytest.mark.parametrize("shape,steps", [("below", 3), ("ragged", 3), ("ragged", 2),
                                         ("ring", 3)])
@pytest.mark.parametrize("limiter", ["n", "1", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_schedule_gives_the_untiled_bits(dtype, limiter, shape, steps):
    _, disc = _disc(K)
    tab = cb.burgers_tables(disc, 2e-3, limiter, "cpu")
    u0 = _rough(disc, seed=len(shape), dtype=dtype)
    n_steps = 7
    plan = _plan(shape, steps, limiter)
    assert n_steps % plan.segment
    got = cb.burgers_march_fused_plain(u0, n_steps, tab, plan)
    want = cb.burgers_march_plain(u0, n_steps, tab)
    assert got.dtype == dtype and bool(torch.isfinite(want).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("limiter", ["n", "1"])
def test_fused_schedule_matches_xla_f64(limiter):
    """Member 0 of the ragged schedule against the XLA march."""
    disc_j, disc = _disc(K)
    tab = cb.burgers_tables(disc, 2e-3, limiter, "cpu")
    u0 = _rough(disc, seed=2)
    got = cb.burgers_march_fused_plain(u0, 7, tab, _plan("ragged", 3, limiter))
    want = jb.burgers_march(jb.burgers_operators(disc_j, jnp.float64),
                            jnp.asarray(u0[:, 0].numpy()), 2e-3, 7, limiter=limiter)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("s_f", [1, 2])
@pytest.mark.parametrize("limiter", ["1", "none"])
def test_the_ghost_rule_has_teeth(limiter, s_f):
    """A window's end slot has no outer neighbour and is wrong from the
    first stage. A stage's update carries that one element in (the traces)
    and Π¹ one more (the updated averages), so over s_f steps the error
    reaches 10·s_f slots in (5·s_f unlimited): W one short changes the first
    local element of the middle tiles, W = rule does not. On exp(x/π), convex
    and increasing, Π¹ takes the backward difference of the averages in
    every cell, so the limiter's hop is live at every stage; ΠN's troubled
    cells run Π¹'s arithmetic, so its cone is Π¹'s. A step of 0.3·x_min keeps
    the edge's error above rounding."""
    _, disc = _disc(K, graded=False)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    tab = cb.burgers_tables(disc, 0.3 * xmin, limiter, "cpu")
    x = np.asarray(disc.x)
    prof = np.exp(x / np.pi) if limiter == "1" else np.sin(x)
    u0 = torch.tensor(prof[:, None, :] * np.array([1.0, 0.5])[None, :, None])
    n_steps = 2 * s_f
    want = cb.burgers_march_plain(u0, n_steps, tab)
    assert bool(torch.isfinite(want).all())
    rule = cb.ghost_rule(limiter) * s_f
    for ghost, exact in ((rule - 1, False), (rule, True), (rule + 3, True)):
        got = cb.burgers_march_fused_plain(u0, n_steps, tab, BP(s_f, ghost, 15, 4, 512))
        assert torch.equal(got, want) == exact, ghost
        if not exact:
            moved = (got != want).any(dim=(0, 1))
            assert bool(moved[15:46:15].any())


def test_burgers_plans():
    """The wrapper's choices on a 132-SM card: burgers_dg's mesh (K = 48)
    as one ring CTA, one launch; bench.py's row at B = 8 on s_f = 8, 16
    tiles of 625 + 2·80 on 1024 threads (one CTA an SM) and at B = 1 on s_f
    = 16, 53 tiles of 189 + 2·160 on 512 threads (phase 33's fastest
    plans); every window within its CTA; float64 on 512 threads; the
    unlimited ghost rule 5·s_f; what the plans refuse."""
    assert cb.burgers_plan(48, 1, 5, 7500) == BP(7500, 0, 48, 1, 512)
    assert cb.burgers_plan(48, 8, 5, 64, "none") == BP(64, 0, 48, 1, 512)
    assert cb.burgers_plan(10_000, 8, 3, 2048) == BP(8, 80, 625, 16, 1024)
    assert cb.burgers_plan(10_000, 1, 3, 2048) == BP(16, 160, 189, 53, 512)
    for k, b, n, lim, f64 in ((10_000, 8, 2048, "n", False), (10_000, 1, 2048, "n", False),
                              (10_000, 8, 2048, "n", True), (10_000, 8, 2048, "none", False),
                              (2_000, 2, 13, "1", False), (700, 1, 5, "n", True)):
        plan = cb.burgers_plan(k, b, 3, n, lim, f64)
        assert plan.threads in ((512,) if f64 else cb.CTA_THREADS)
        assert cb.window_of(k, plan) <= plan.threads
        assert plan.n_tiles == -(-k // plan.tile) and plan.segment <= n
        assert cb.is_ring(k, plan) or plan.ghost >= cb.ghost_rule(lim) * plan.segment
    assert cb.burgers_fused_plan(10_000, 8, 1024) == BP(8, 80, 864, 12, 1024)
    assert cb.burgers_fused_plan(10_000, 8, 512, "none") == BP(8, 40, 432, 24, 512)
    for steps, threads in ((0, 512), (26, 512), (4, 256)):
        with pytest.raises(ValueError):
            cb.burgers_fused_plan(1000, steps, threads)
    with pytest.raises(ValueError):
        cb.burgers_plan(48, 1, 5, 0)
