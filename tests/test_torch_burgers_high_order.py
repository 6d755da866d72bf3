"""The limited Burgers march B1 at high order (N = 8-15, Np 9-16) on the CPU.

The card runs csrc/burgers.cu's B1 at every order, one thread an element;
here its plain version and the launch schedule's emulation
(ops/cuda/burgers.py):

- float64 at N = 8: the entry point on a CPU tensor (the plain version)
  against the JAX XLA march for the ΠN, Π¹ and no limiter, at
  tests/test_pallas.py:629's rtol 1e-12 / atol 1e-13, as the lower orders
  are held in tests/test_torch_burgers.py;
- the schedule (windows cut into ragged tiles around the ring, and the
  one-tile ring) gives the untiled plain bits at N = 8;
- the ghost cone at Np = 12: W one element short of 10·s_f (Π¹, s_f = 1)
  moves a local element, W at the rule does not;
- ``burgers_tables`` takes Np 9-16 and ``burgers_plan`` returns plans the
  kernel takes there (512 threads, windows within the CTA); Np = 17 raises
  a ValueError naming MAX_NP.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march import burgers as jb
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

BP = cb.BurgersPlan
F64 = torch.float64


def _disc(n_order, k):
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict())


def _batch(disc, b, seed):
    """test_pallas.py:612-619's batched ICs, (Np, B, K)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(disc.x)
    return np.stack([(0.5 + 0.4 * ph) * np.sin(x) + 0.1 * ph for ph in rng.uniform(0, 1, b)], axis=1)


def _plan(k, steps, ghost, tile, threads=512):
    return BP(steps, ghost, tile, -(-k // tile), threads)


@pytest.mark.parametrize("limiter", ["n", "1", "none"])
def test_b1_plain_version_matches_the_xla_march_at_n8(limiter):
    """K = 12, B = 2, 16 steps at dt = 0.3·x_min."""
    disc_j, disc = _disc(8, 12)
    dt = 0.3 * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    u0b = _batch(disc, 2, seed=8)
    got = cb.make_cuda_burgers_march(disc, dt, 16, batch=2, limiter=limiter, device="cpu")(
        torch.tensor(u0b))
    ops_j = jb.burgers_operators(disc_j, jnp.float64)
    for j in range(2):
        want = jb.burgers_march(ops_j, jnp.asarray(u0b[:, j]), dt, 16, limiter=limiter)
        np.testing.assert_allclose(got[:, j].numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("limiter", ["n", "none"])
def test_node_parallel_schedule_gives_the_untiled_bits(limiter, dtype):
    """N = 8, K = 40, B = 2, 7 steps: the ring (one launch) and ragged tiles
    with the ghost rule (s_f = 2: the last launch takes the remainder)."""
    _, disc = _disc(8, 40)
    dt = 0.3 * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    tab = cb.burgers_tables(disc, dt, limiter, "cpu")
    u0 = torch.tensor(_batch(disc, 2, seed=3), dtype=dtype)
    want = cb.burgers_march_plain(u0, 7, tab)
    ghost = cb.ghost_rule(limiter) * 2
    for plan in (_plan(40, 7, 0, 40), _plan(40, 2, ghost, 15)):
        got = cb.burgers_march_fused_plain(u0, 7, tab, plan)
        assert got.dtype == dtype and torch.equal(got, want), plan


def test_the_ghost_cone_at_np12():
    """N = 11 under Π¹ on exp(x/π) (the limiter's hop live in every cell,
    tests/test_torch_burgers_fused.py's profile): a stage couples ±2
    elements, so over one step W = 10·s_f − 1 = 9 changes a local element of
    the middle tiles and W = 10 does not. A step of 0.3·x_min keeps the
    edge's error above rounding over one step (over two, at W = 19, the
    error that reaches the tile lies below an ulp at this order)."""
    k, s_f = 60, 1
    _, disc = _disc(11, k)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    tab = cb.burgers_tables(disc, 0.3 * xmin, "1", "cpu")
    x = np.asarray(disc.x)
    u0 = torch.tensor(np.exp(x / np.pi)[:, None, :] * np.array([1.0, 0.5])[None, :, None])
    n_steps = 2 * s_f
    want = cb.burgers_march_plain(u0, n_steps, tab)
    assert bool(torch.isfinite(want).all())
    rule = cb.ghost_rule("1") * s_f
    for ghost, exact in ((rule - 1, False), (rule, True)):
        got = cb.burgers_march_fused_plain(u0, n_steps, tab, _plan(k, s_f, ghost, 15))
        assert torch.equal(got, want) == exact, ghost
        if not exact:
            moved = (got != want).any(dim=(0, 1))
            assert bool(moved[15:46:15].any())


def test_high_orders_take_node_parallel_plans():
    for n_order in range(8, 16):
        tab = cb.burgers_tables(startup_1d(n_order, 0.0, 2 * np.pi, 4), 1e-3, "n", "cpu")
        assert tab.np_ == n_order + 1 and tab.packed.size == (n_order + 1) * (n_order + 5) + 10
    for np_ in range(9, 17):
        for k, b, n, lim, f64 in ((10_000, 8, 2048, "n", False), (48, 1, 7500, "n", False),
                                  (48, 1, 7500, "n", True), (700, 3, 45, "none", False),
                                  (10_000, 1, 2048, "1", True)):
            plan = cb.burgers_plan(k, b, np_, n, lim, f64)
            assert plan.threads == 512 and cb.window_of(k, plan) <= plan.threads
            assert plan.n_tiles == -(-k // plan.tile)
            assert cb.is_ring(k, plan) or plan.ghost >= cb.ghost_rule(lim) * plan.segment
    # burgers_dg's mesh as one ring CTA; bench.py's row on the high-order fit
    assert cb.burgers_plan(48, 1, 9, 7500) == _plan(48, 7500, 0, 48)
    assert cb.burgers_plan(10_000, 8, 9, 2048) == BP(4, 40, 304, 33, 512)
    # Np ≤ 8 keeps the plans of the Np ≤ 8 model
    assert cb.burgers_plan(10_000, 8, 8, 2048) == BP(8, 80, 625, 16, 1024)
    with pytest.raises(ValueError, match="MAX_NP = 16"):
        cb.burgers_tables(startup_1d(16, 0.0, 2 * np.pi, 4), 1e-3, "n", "cpu")
