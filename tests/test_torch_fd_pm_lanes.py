"""F3's launch plan, its wrapper's CPU path and its tolerance (ops/cuda/
fd_ensemble.py) on the CPU.

On the card F3 runs G lanes of a warp per member (``fd_pm_plan``), the
member's tables in shared memory, the fine nodes swept in windows
(``pm_window``); the chain and the per-step sums keep the plain version's
order, so ``fd_estimate_per_member_plain`` stays its yardstick at
``fd_kernel_tolerance``. Here:

- the plan's rules: G by B, CTA sizes that fit, windows, refusals;
- the wrapper's CPU path takes (B, n_steps) widths and returns a contiguous
  (B, n_steps), the plain version's;
- the tolerance has teeth at a small B: entries of the plain err lie above
  it, so an err of 0 fails, and the float64 plain version lies within it.
"""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

L = fe.FdPmLaunch


def _inputs(b, n_steps, seed=5, dtype=torch.float32):
    """Per-member grids of 2..n_steps active steps over [0, 2] with padded
    zero-width tails and u0 ~ U(0.5, 2) (chip_smoke.py's phase 6(e))."""
    rng = np.random.default_rng(seed)
    times = np.full((b, n_steps + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, n_steps + 1, b)):
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0, 2, n_act - 1)), [2.0]])
    dt_b = torch.tensor(np.diff(times, axis=1), dtype=dtype)
    return dt_b, torch.tensor(rng.uniform(0.5, 2.0, b), dtype=dtype)


@pytest.mark.parametrize("b,lanes", [(1, 32), (1024, 32), (4096, 32), (8192, 16), (16_384, 8),
                                     (131_072, 1), (10**6, 1)])
def test_plan_lanes_by_batch(b, lanes):
    """G is the most lanes with B·G/32 ≤ PM_MAX_WARPS warps: one warp a
    member up to B = 4096 (the study's 1024: 1024 warps, ~8 an SM), down to
    one lane a member from B = 131,072; 128-thread CTAs at the study's
    shape, whose tables fit one window but at one lane a member (128
    members a CTA: windows of 107 of the 172 fine nodes)."""
    launch = fe.fd_pm_plan(b, 43, 4)
    assert launch == L(lanes, 128)
    assert b * launch.lanes <= 32 * fe.PM_MAX_WARPS or launch.lanes == 1
    assert fe.pm_window(launch, 43, 4) == (43 * 4 if lanes > 1 else 107)


def test_plan_shrinks_the_cta_and_window_to_fit():
    """Every member of a CTA keeps 4·(3·n_steps + 2 + 3·window) bytes of
    shared memory within a block's: one lane a member at 226 steps (the most
    the one-thread design took) needs 64-thread CTAs; larger n_fine sweeps
    in windows; past one member's coarse tables the kernel refuses (window
    0)."""
    big = 200_000
    assert fe.fd_pm_plan(big, 226, 4) == L(1, 64)
    assert fe.pm_window(L(1, 128), 226, 4) == 0
    w = fe.pm_window(L(1, 64), 226, 4)
    assert 1 <= w < 226 * 4
    assert 64 * 4 * (3 * 226 + 2 + 3 * w) <= fe.MAX_SMEM < 64 * 4 * (3 * 226 + 2 + 3 * (w + 1))
    assert fe.pm_window(L(32, 128), 226, 64) < 226 * 64  # 14,464 fine nodes: windows
    assert fe.fd_pm_plan(8, 5000, 4) == L(32, 64)  # 128 threads hold no window at 5000 steps
    assert fe.pm_window(L(32, 32), 20_000, 4) == 0  # one member's coarse tables too large
    for b, n, rf in ((1024, 43, 4), (big, 226, 1), (big, 226, 16), (8, 3000, 4)):
        launch = fe.fd_pm_plan(b, n, rf)
        assert launch.lanes in fe.PM_LANES and launch.threads in fe.PM_THREADS
        assert fe.pm_window(launch, n, rf) >= 1
    assert fe.fd_pm_plan(1024, 43, 4) is fe.fd_pm_plan(1024, 43, 4)


@pytest.mark.parametrize("convention", ["strided", "block"])
def test_cpu_wrapper_returns_contiguous_member_rows(convention):
    b, n_steps, rf = 37, 9, 4
    dt_b, u0 = _inputs(b, n_steps)
    run = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", n_steps, rf, convention,
                                              device="cpu")
    fe.reset_launch_counts()
    err, j = run(dt_b, u0)
    assert err.shape == (b, n_steps) and err.is_contiguous() and j.shape == (b,)
    want = fe.fd_estimate_per_member_plain(dt_b, u0, run.plan)
    assert torch.equal(err, want[0]) and torch.equal(j, want[1])
    assert bool((err[dt_b == 0] == 0).all())
    assert fe.fd_estimate_per_member.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("convention", ["strided", "block"])
def test_the_tolerance_has_teeth(convention):
    """At B = 64 some entries of the float32 plain err lie above
    fd_kernel_tolerance, so an err of 0 fails; the float64 plain version (no
    FMA, another rounding everywhere) lies within it, err and J."""
    b, n_steps, rf = 64, 12, 4
    dt_b, u0 = _inputs(b, n_steps, seed=3)
    run = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", n_steps, rf, convention,
                                              device="cpu")
    stats = {}
    err, j = fe.fd_estimate_per_member_plain(dt_b, u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf)
    tol_j = fe.fd_j_tolerance(stats, n_steps, 2.0)
    assert int((err.abs() > tol).sum()) > b  # most members, not one entry
    assert float((torch.zeros_like(err) - err).abs().max()) > tol
    err64, j64 = fe.fd_estimate_per_member_plain(dt_b.double(), u0.double(), run.plan)
    assert float((err.double() - err64).abs().max()) <= tol
    assert float((j.double() - j64).abs().max()) <= tol_j
