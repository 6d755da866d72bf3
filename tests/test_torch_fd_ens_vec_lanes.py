"""F2's launch plan, its wrapper's CPU path and its tolerance (ops/cuda/
fd_ensemble.py) on the CPU.

On the card F2 is F1 for d-vector states: G lanes of a warp per IC
(``fd_ens_plan`` with ``d``, the fewest lanes that put 8 warps on every SM),
the IC's d coarse trajectories in shared memory, a block of fine nodes'
pairs, residuals and chain coefficients in registers ahead of the chain;
the chain and the per-step sums keep the plain version's order, so
``fd_ensemble_vec_plain`` stays its yardstick at ``fd_kernel_tolerance(…,
d=2)``. Here:

- the plan's rules: G by the IC count, the CTA size whose shared memory
  (the rf weights and ens_stride(n_steps, 2) floats an IC, odd) fits a
  block, and a launch for every step count the one-thread-an-IC kernel took;
- the wrapper's CPU path returns the plain version's (n_steps, n_ics) from
  IC-major (n_ics, d) states, read as given;
- the tolerance has teeth at a small IC count: entries of the float32 plain
  err lie above it, so an err of 0 fails, and the float64 plain version
  lies within it.
"""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

L = fe.FdEnsLaunch
D = 2  # the harmonic oscillator's components


@pytest.mark.parametrize("n_ics,lanes", [(1, 32), (3000, 16), (4096, 16), (8192, 8),
                                         (16_384, 4), (33_792, 1), (102_400, 1)])
def test_plan_lanes_by_ic_count(n_ics, lanes):
    """F2 takes F1's lanes by IC count (16 at 4,096 ICs, one lane an IC from
    33,792), in 128-thread CTAs at FD_ENSEMBLE's 16 steps, d = 2."""
    launch = fe.fd_ens_plan(n_ics, 16, 4, fe.H100_SMS, D)
    assert launch == L(lanes, 128) == fe.fd_ens_plan(n_ics, 16, 4)
    assert fe.ens_smem(launch, 16, 4, D) <= fe.MAX_SMEM
    assert fe.fd_ens_plan(n_ics, 16, 4, fe.H100_SMS, D) is launch  # cached


def test_stride_is_odd_over_d_components():
    """An IC's slice holds d trajectories of n_steps + 1 states, rounded up
    to odd, so the ICs of a warp at G = 1 read one coarse state on 32
    distinct banks; d = 1 is F1's slice."""
    for n_steps in (1, 16, 43, 225, 226):
        s = fe.ens_stride(n_steps, D)
        assert s % 2 == 1 and s - D * (n_steps + 1) == 1
        assert len({(k * s) % 32 for k in range(32)}) == 32
        assert fe.ens_stride(n_steps, 1) == fe.ens_stride(n_steps)
    assert fe.ens_smem(L(1, 128), 16, 4, D) == 4 * (4 + 128 * 35)
    assert fe.ens_smem(L(16, 128), 16, 4, D) == 4 * (4 + 8 * 35)


@pytest.mark.parametrize("rf", [1, 4, 16])
def test_plan_fits_shared_memory_for_d2(rf):
    """The one-thread-an-IC kernel took (n_steps + 1)·2·128·4 bytes within a
    block (226 steps); the plan shrinks the CTA, so every such step count,
    and longer ones, gets a launch within a block at d = 2."""
    for n_steps in (1, 16, 225, 226, 227, 500):
        for n_ics in (37, 102_400):
            launch = fe.fd_ens_plan(n_ics, n_steps, rf, fe.H100_SMS, D)
            assert launch.lanes in fe.PM_LANES and launch.threads in fe.PM_THREADS
            assert fe.ens_smem(launch, n_steps, rf, D) <= fe.MAX_SMEM
    assert fe.fd_ens_plan(102_400, 225, 4, fe.H100_SMS, D) == L(1, 128)
    assert fe.fd_ens_plan(102_400, 226, 4, fe.H100_SMS, D) == L(1, 64)
    assert fe.fd_ens_plan(102_400, 226, 4) == L(1, 128)  # d = 1 fits 128 threads
    big = fe.fd_ens_plan(8, 30_000, 4, fe.H100_SMS, D)  # past a block: refused
    assert fe.ens_smem(big, 30_000, 4, D) > fe.MAX_SMEM


def test_cpu_wrapper_reads_ic_major_states():
    """The wrapper's CPU path: the plain version's (n_steps, n_ics) from the
    (n_ics, d) states as given (no transposed copy), no launch counted; a
    transposed or wrongly shaped input is refused."""
    rng = np.random.default_rng(1)
    n, n_steps, rf = 37, 9, 4
    u0 = torch.tensor(rng.uniform(-1, 1, (n, D)), dtype=torch.float32)
    run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", n_steps, rf, 2.0 / n_steps,
                                       device="cpu")
    fe.reset_launch_counts()
    err = run(u0)
    assert err.shape == (n_steps, n) and err.is_contiguous() and err.dtype == torch.float32
    assert torch.equal(err, fe.fd_ensemble_vec_plain(u0, run.plan))
    assert fe.fd_ensemble_vec.launches == 0  # the CPU takes the plain version
    # IC i's row alone gives column i: the states are read IC-major
    one = fe.fd_ensemble_vec_plain(u0[5:6], run.plan)
    assert torch.equal(one[:, 0], err[:, 5])
    with pytest.raises(ValueError, match=r"\(n_ics, 2\)"):
        run(u0.T.contiguous())


def test_the_tolerance_has_teeth():
    """At 64 ICs most entries of the float32 plain err lie above
    fd_kernel_tolerance(…, d=2), so an err of 0 fails; the float64 plain
    version (no FMA, another rounding everywhere) lies within it."""
    rng = np.random.default_rng(3)
    n, n_steps, rf = 64, 16, 4
    u0 = torch.tensor(rng.uniform(-1, 1, (n, D)), dtype=torch.float32)
    run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", n_steps, rf, 2.0 / n_steps,
                                       device="cpu")
    stats = {}
    err = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf, d=D)
    assert int((err.abs() > tol).sum()) > n  # most ICs, not one entry
    assert float(err.abs().max()) > tol
    err64 = fe.fd_ensemble_vec_plain(u0.double(), run.plan)
    assert float((err.double() - err64).abs().max()) <= tol
