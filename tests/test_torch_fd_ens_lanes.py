"""F1's launch plan, its wrapper's CPU path and its tolerance (ops/cuda/
fd_ensemble.py) on the CPU.

On the card F1 runs G lanes of a warp per IC (``fd_ens_plan``: the fewest
lanes that put 8 warps on every SM), the IC's coarse trajectory in shared
memory and a block of fine nodes' pairs in registers ahead of the chain;
the chain and the per-step sums keep the plain version's order, so
``fd_ensemble_plain`` stays its yardstick at ``fd_kernel_tolerance``. Here:

- the plan's rules: G by the IC count, the CTA size that fits a block's
  shared memory, and a launch for every step count the one-thread-an-IC
  kernel took ((n_steps + 1)·128·4 bytes within a block);
- the wrapper's CPU path returns the plain version's (n_steps, n_ics);
- the tolerance has teeth at a small IC count in both trig modes: entries of
  the float32 plain err lie above it, so an err of 0 fails, and the float64
  plain version lies within it.
"""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

L = fe.FdEnsLaunch


@pytest.mark.parametrize("n_ics,lanes", [(1, 32), (3000, 16), (4096, 16), (8192, 8),
                                         (16_384, 4), (33_792, 1), (102_400, 1), (10**6, 1)])
def test_plan_lanes_by_ic_count(n_ics, lanes):
    """G is the fewest lanes that put ENS_WARPS_PER_SM warps on each of 132
    SMs (16 at 4,096 ICs, one lane an IC from 33,792), in 128-thread CTAs
    at FD_ENSEMBLE's 16 steps."""
    launch = fe.fd_ens_plan(n_ics, 16, 4)
    assert launch == L(lanes, 128)
    assert n_ics * lanes >= 32 * fe.ENS_WARPS_PER_SM * fe.H100_SMS or lanes == 32
    assert lanes == 1 or n_ics * lanes // 2 < 32 * fe.ENS_WARPS_PER_SM * fe.H100_SMS
    assert fe.ens_smem(launch, 16, 4) <= fe.MAX_SMEM
    assert fe.fd_ens_plan(n_ics, 16, 4) is launch  # cached


def test_stride_is_odd():
    """An IC's slice of shared memory is an odd number of floats, so the ICs
    of a warp at G = 1 read a coarse state on 32 distinct banks; a CTA's
    bytes are its rf weights and its ICs' slices."""
    for n_steps in (1, 16, 43, 452, 453):
        s = fe.ens_stride(n_steps)
        assert s % 2 == 1 and s - (n_steps + 1) in (0, 1)
        assert len({(k * s) % 32 for k in range(32)}) == 32
    assert fe.ens_smem(L(1, 128), 16, 4) == 4 * (4 + 128 * 17)
    assert fe.ens_smem(L(32, 128), 16, 4) == 4 * (4 + 4 * 17)


@pytest.mark.parametrize("rf", [1, 4, 16])
def test_plan_takes_every_step_count_the_old_kernel_took(rf):
    """The one-thread-an-IC kernel took n_steps with (n_steps + 1)·128·4
    bytes within a block (453 steps); the plan shrinks the CTA, so every
    such n_steps gets a launch within a block's shared memory, at
    FD_ENSEMBLE's IC count and at a small one, and so do longer ones."""
    for n_steps in (1, 16, 226, 452, 453, 454, 1000):
        for n_ics in (37, 102_400):
            launch = fe.fd_ens_plan(n_ics, n_steps, rf)
            assert launch.lanes in fe.PM_LANES and launch.threads in fe.PM_THREADS
            assert fe.ens_smem(launch, n_steps, rf) <= fe.MAX_SMEM
    assert fe.ens_smem(L(1, 128), 453, 4) > fe.MAX_SMEM  # the padded slice: 64 threads
    assert fe.fd_ens_plan(102_400, 453, 4) == L(1, 64)
    assert fe.fd_ens_plan(102_400, 452, 4) == L(1, 128)
    big = fe.fd_ens_plan(8, 60_000, 4)  # one IC's trajectory past a block: refused
    assert fe.ens_smem(big, 60_000, 4) > fe.MAX_SMEM


def test_cpu_wrapper_returns_the_plain_layout():
    """The wrapper's CPU path: the plain version's (n_steps, n_ics), no
    kernel launch counted."""
    rng = np.random.default_rng(1)
    n, n_steps, rf = 37, 9, 4
    u0 = torch.tensor(rng.uniform(-3, 3, n), dtype=torch.float32)
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", n_steps, rf, 2.0 / n_steps, device="cpu")
    fe.reset_launch_counts()
    err = run(u0)
    assert err.shape == (n_steps, n) and err.is_contiguous() and err.dtype == torch.float32
    assert torch.equal(err, fe.fd_ensemble_plain(u0, run.plan))
    assert fe.fd_ensemble.launches == 0  # the CPU takes the plain version
    assert run.plan.consts_ptr == run.plan.consts.ctypes.data
    assert run.plan.grid_ptr == run.plan.grid32.data_ptr()


@pytest.mark.parametrize("trig", ["libm", "fast"])
def test_the_tolerance_has_teeth(trig):
    """At 64 ICs some entries of the float32 plain err lie above
    fd_kernel_tolerance, so an err of 0 fails; the float64 plain version (no
    FMA, another rounding everywhere) lies within it."""
    rng = np.random.default_rng(3)
    n, n_steps, rf = 64, 16, 4
    u0 = torch.tensor(rng.uniform(-3, 3, n), dtype=torch.float32)
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", n_steps, rf, 2.0 / n_steps, trig=trig,
                                   device="cpu")
    stats = {}
    err = fe.fd_ensemble_plain(u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf)
    assert int((err.abs() > tol).sum()) > n  # most ICs, not one entry
    assert float((torch.zeros_like(err) - err).abs().max()) > tol
    err64 = fe.fd_ensemble_plain(u0.double(), run.plan)
    assert float((err.double() - err64).abs().max()) <= tol
