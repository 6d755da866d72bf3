"""D1 with G lanes of a warp per member (ops/cuda/dg_slab.py) on the CPU.

On the card the G lanes of a member split every quadrature loop (lane ℓ the
points q ≡ ℓ mod G) and join their partial sums by an xor butterfly, so the
kernel sums in another order than the plain version. Here:

- ``dg_estimate_ensemble_lanes_plain``, the lanes' sum order in plain
  PyTorch, at G = 1, 4, 8 and 16 against the JAX package's batched pipeline
  (XLA, float32, per-member partitions with zero-width tails) inside
  ``dg_kernel_tolerance``'s per-element bounds, and an err of 0 outside
  them;
- the bounds hold the float32 plain version against float64 with room, and
  have teeth wherever err lies above float32 roundoff;
- ``d1_plan``'s choices.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py, and
chip_smoke.py phases 9-11 and 35).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march.dg_batched import dg_estimate_batched
from adjoint_ode_adaptivity_tpu.march.dg_time import dg_time_operators as jops
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

NAMES = ("u", "v", "err")


def _inputs(k, b, per_member, seed, t1=2.0):
    rng = np.random.default_rng(seed)
    y0s = rng.uniform(0.5, 2.0, b).astype(np.float32)
    if not per_member:
        return torch.tensor(np.linspace(0.0, t1, k + 1), dtype=torch.float32), torch.tensor(y0s)
    times = np.full((b, k + 1), t1)
    for m, n_act in enumerate(rng.integers(2, k, b)):  # at least one zero-width tail slab
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, t1 - 0.1,
                                                                            n_act - 1)), [t1]])
    return torch.tensor(times, dtype=torch.float32), torch.tensor(y0s)


def _run(ode, n, k, newton_iters=6, trig="libm"):
    return ds.make_cuda_dg_estimate_ensemble(ode, dg_time_operators(n), dg_time_operators(n + 1),
                                             k, newton_iters, trig=trig, device="cpu")


def _shares(got, want, tol):
    """Each output's worst |got − want| as a share of its per-element bound."""
    return {name: float(((g.double() - w.double()).abs() / tol[name])
                        .nan_to_num(0.0, posinf=float("inf")).max())
            for name, g, w in zip(NAMES, got, want)}


@pytest.fixture(scope="module")
def jax_case():
    """Order 1, K = 8, B = 48 per-member partitions on [0, 2] with tails:
    the JAX pipeline in float32 (the one JAX call of this file)."""
    k = 8
    times, y0s = _inputs(k, 48, True, seed=5)
    want = dg_estimate_batched(jops(1), jops(2), lambda u, t: jnp.sin(u),
                               jnp.asarray(times.numpy()), jnp.asarray(y0s.numpy()),
                               newton_iters=6)
    return times, y0s, _run("du/dt=sin(u)", 1, k), [torch.tensor(np.asarray(w)) for w in want]


@pytest.mark.parametrize("lanes", [1, 4, 8, 16])
def test_lanes_order_within_the_bounds_of_jax(jax_case, lanes):
    times, y0s, run, want = jax_case
    got = ds.dg_estimate_ensemble_lanes_plain(times, y0s, run.plan, lanes)
    plain = run(times, y0s)
    tol = ds.dg_kernel_tolerance(times, y0s, plain, run.plan)
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == torch.float32 and g.shape == w.shape and tol[name].shape[:2] == w.shape[:2]
    assert max(_shares(got, want, tol).values()) <= 1.0
    assert max(_shares(got, plain, tol).values()) <= 0.25
    # teeth: an err of 0 fails the bound, and the zero-width tails are exactly 0
    assert bool((want[2].abs() > tol["err"]).any())
    pad = torch.diff(times, dim=1) == 0
    assert bool(pad.any()) and bool((got[2][pad] == 0).all()) and bool((tol["err"][pad] == 0).all())


# (ode, order, K, per-member partitions, trig) on [0, 2]: err above float32 roundoff
# in each (orders 2 and 4 need long slabs or fast dynamics for that)
TEETH_CASES = [
    ("du/dt=sin(u)", 1, 16, False, "libm"),
    ("du/dt=sin(u)", 1, 8, True, "fast"),
    ("du/dt=sin(u)", 2, 2, False, "libm"),
    ("du/dt=10cos(u)", 4, 4, False, "libm"),
    ("gaussian_mixture", 1, 4, True, "libm"),
    ("du/dt=t*sin(u)", 1, 16, False, "libm"),
]


@pytest.mark.parametrize("ode,n,k,per_member,trig", TEETH_CASES)
def test_tolerance_covers_float32_roundoff_and_has_teeth(ode, n, k, per_member, trig):
    """The float32 plain version within a tenth of every per-element bound
    of float64; some |err| above its bound (an err of 0 fails)."""
    times, y0s = _inputs(k, 32, per_member, seed=n)
    run = _run(ode, n, k, trig=trig)
    p32 = run(times, y0s)
    p64 = ds.dg_estimate_ensemble_plain(times.double(), y0s.double(), run.plan)
    tol = ds.dg_kernel_tolerance(times, y0s, p32, run.plan)
    assert max(_shares(p32, p64, tol).values()) <= 0.1
    assert bool((p64[2].abs() > tol["err"]).any())


def test_lanes_order_differs_from_one_thread_order_within_the_bounds():
    """At Nq = 13 (the sweep at order 2) G = 4 and 16 sum in another order
    than G = 1: not the same bits, inside the bounds."""
    times, y0s = _inputs(12, 24, False, seed=9)
    run = _run("du/dt=sin(u)", 1, 12)
    one = ds.dg_estimate_ensemble_lanes_plain(times, y0s, run.plan, 1)
    tol = ds.dg_kernel_tolerance(times, y0s, one, run.plan)
    for lanes in (4, 16):
        got = ds.dg_estimate_ensemble_lanes_plain(times, y0s, run.plan, lanes)
        assert not all(torch.equal(g, o) for g, o in zip(got, one))
        assert max(_shares(got, one, tol).values()) <= 0.25


def test_d1_plan():
    """The most lanes (at most the quadrature points) that keep B·G/32 within
    D1_MAX_WARPS warps: G = 8 at B = 1024 (order 1: Nq 10 and 13), fewer at
    B = 16,384, one at B = 102,400; every plan a launch the kernel takes."""
    nq = 13
    assert ds.d1_plan(1024, 2, nq).lanes == 8
    assert ds.d1_plan(1024, 2, 3).lanes == 2
    assert ds.d1_plan(16_384, 2, nq).lanes <= 2
    assert ds.d1_plan(102_400, 2, nq).lanes == 1
    for b in (1, 37, 1024, 4096, 16_384, 102_400):
        plan = ds.d1_plan(b, 2, nq)
        assert plan.lanes in ds.LANES and plan.threads in ds.CTA_THREADS
        assert plan.threads % 32 == 0 and plan.threads % plan.lanes == 0
        assert b * plan.lanes <= 32 * ds.D1_MAX_WARPS or plan.lanes == 1
