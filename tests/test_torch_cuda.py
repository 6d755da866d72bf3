"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``; each test skips (from the fixture) where no GPU
is present. Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: both sides run float32 with the same folded tables but a
different order of operations (FMA contraction, the volume sum, the batch
reduction), so u and λ agree to a few ulp per step relative to their
largest entry, and η — a sum of differences λ·(u_{n+1} − half2) of O(1)
states — to a few ulp of max|λ|·max|u| per step.

The FD kernels: ops/cuda/fd_ensemble.fd_kernel_tolerance and
fd_j_tolerance — the residual r = u_j − (u_{j−1} + f·dt_f) is a difference
of O(max|u|) values, so each fine node's r·v differs by a few ulp of
max|u|·max|v| (FMA contraction in the kernel, none in the plain version);
an indicator sums rf nodes (and d components), and J = Σu²dt a few ulp of
max|u|²·T per step. Some entry of F3's plain err must lie above the bound
(an err of 0 fails).

The DG slab kernel: ops/cuda/dg_slab.dg_kernel_tolerance — every bound per
member and element, as the hp kernel's: u and v within 8·ε of their
element's system's |J⁻¹|·(the magnitudes of its terms), carried by the
inflow of the elements before (u) or after (v) it, err within 8·ε of the
sum of the magnitudes of its products.

The hp kernel: ops/cuda/dg_slab_mixed.hp_kernel_tolerance — every bound per
member and element: u and v within 8·ε of their element's system's
|J⁻¹|·(the magnitudes of its terms), carried by the inflow of the elements
before it, err within 8·ε of the sum of the magnitudes of its products.

D1 and H1 with the goal J = ∫u² (g_u = 2u by a functor): the same bounds,
extended by the source's terms h/2·Σ_j|M_ij|·|g_u| and the nodes' error
through g_u; the J = ∫u adjoint must lie outside them. F1-F3, D1 and H1 on a
caller's callables traced into functors (ops/cuda/functor.py): the same
bounds, with teeth.

The training kernels: each gradient entry against its own bound, against
the plain version in float64. T1's (ops/cuda/train_fused.
resblock_kernel_tolerance) is the first-order float32 error of every member
contribution plus the reduction, computed in float64; T2's (ops/cuda/
train_dense_fused.dense_kernel_tolerance) is 16 times the largest relative
deviation of a float32 evaluation in eager torch, times each entry's summed
contribution magnitudes, plus the reduction and a charge for any relu within
reach of a switch. Most entries of every leaf must exceed their bound, a
repeat call must be bit-identical, and inactive neurons, dead neurons and
zero-dt steps exactly 0.

The Burgers kernel B1: in float64 each entry within 1e-12·|plain| + 1e-13
(test_pallas.py:629's tolerance); in float32, before any shock, within
8·n_steps·ε·max|u0| (the troubled-cell test at ε₀ = 1e-8 lies below float32
roundoff near extrema, so the two may limit different cells by amounts far
below that). The revolve composition against the stored pipeline: u and λ
within float32 roundoff, η within 1e-4·|η| + 1e-9
(tests/test_revolve_pipeline.py).

The recompute (K1's checkpoint mode, K2r) and tiled pipelines run
csrc/dg_stage.cuh's arithmetic, every rounding explicit, at the same times
t0 + n·dt as K1 and K2 (the tiled KT1 and KT2 are K1's and K2's fused
kernels at B = 1 from the global step offset): their outputs are held to the
stored pipeline's bits, and to their plain versions by the bounds above.
"""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch import functionals
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    dg_adjoint_interp_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf
from adjoint_ode_adaptivity_tpu_torch.models import ResBlockSimple, ResNetBlock

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

pytestmark = pytest.mark.cuda
A = 2 * np.pi
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_order,k,b,graded", [(2, 24, 8, True), (7, 24, 8, False), (3, 50, 1, True)])
def test_kernels_match_plain_versions(device, n_order, k, b, graded):
    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt, n_steps = 0.5 * (0.75 / A) * xmin, 16
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    before = (dg_rhs.fwd_march.launches, dg_rhs.adj_est_stored.launches)
    traj, uf = dg_rhs.fwd_march(u0, 0.1, n_steps, ops, store_trajectory=True)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops)
    torch.cuda.synchronize()
    assert (dg_rhs.fwd_march.launches, dg_rhs.adj_est_stored.launches) == (
        before[0] + 1, before[1] + 1)
    traj_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, True)
    lam0_p, eta_p = dg_rhs.adj_est_stored_plain(traj_p, uf_p, lam, 0.1, ops)
    tol_u = 8 * n_steps * EPS32 * float(uf_p.abs().max())
    tol_l = 8 * n_steps * EPS32 * float(lam0_p.abs().max())
    tol_e = 8 * n_steps * disc.np_ * EPS32 * float(lam.abs().max()) * float(uf_p.abs().max())
    assert float((traj - traj_p).abs().max()) <= tol_u
    assert float((uf - uf_p).abs().max()) <= tol_u
    assert float((lam0 - lam0_p).abs().max()) <= tol_l
    assert float((eta - eta_p).abs().max()) <= tol_e


def test_kernel_rejects_float64_and_plain_is_not_taken(device):
    disc = startup_1d(2, 0.0, 2 * np.pi, 16)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, device)
    with pytest.raises(TypeError):
        dg_rhs.fwd_march(torch.zeros((3, 1, 16), dtype=torch.float64, device=device), 0.0, 4, ops)
    with pytest.raises(ValueError):  # not contiguous
        dg_rhs.fwd_march(torch.zeros((3, 16, 2), device=device).transpose(1, 2), 0.0, 4, ops)


@pytest.mark.parametrize("ode,trig", [("du/dt=sin(u)", "libm"), ("du/dt=sin(u)", "fast"),
                                      ("gaussian_mixture", "libm"), ("du/dt=t*sin(u)", "libm")])
def test_fd_ensemble_kernel_matches_its_plain_version(device, ode, trig):
    rng = np.random.default_rng(0)
    n, n_steps, rf = 3000, 8, 4
    dt = 2.0 * rng.uniform(0.5, 1.5, n_steps) / n_steps
    u0 = torch.tensor(rng.uniform(-3, 3, n), dtype=torch.float32, device=device)
    run = fe.make_cuda_fd_ensemble(ode, n_steps, rf, dt, trig=trig, device=device)
    before = fe.fd_ensemble.launches
    got = run(u0)
    torch.cuda.synchronize()
    assert fe.fd_ensemble.launches == before + 1
    stats = {}
    want = fe.fd_ensemble_plain(u0, run.plan, stats)
    assert got.shape == (n_steps, n) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= fe.fd_kernel_tolerance(stats, rf)


@pytest.mark.parametrize("trig", ["libm", "fast"])
@pytest.mark.parametrize("n_steps,rf", [(16, 4), (13, 3), (5, 2)])
def test_fd_ensemble_on_every_launch(device, trig, n_steps, rf):
    """F1 on every G and CTA size, at step counts whose fine nodes fill, or
    fall short of, the blocks of U·G nodes: within fd_kernel_tolerance of
    the plain version, some plain entry above it, a repeat's bits; the
    wrapper's launch is fd_ens_plan's; a launch past a block's shared
    memory raises."""
    rng = np.random.default_rng(2)
    n = 1000
    u0 = torch.tensor(rng.uniform(-3, 3, n), dtype=torch.float32, device=device)
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", n_steps, rf, 2.0 / n_steps, trig=trig,
                                   device=device)
    stats = {}
    want = fe.fd_ensemble_plain(u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf)
    assert bool((want.abs() > tol).any())  # the bound has teeth: an err of 0 fails
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wrapper = run(u0)
    assert torch.equal(wrapper, fe._f1_launch(u0, run.plan, fe.fd_ens_plan(n, n_steps, rf, sms)))
    for lanes in fe.PM_LANES:
        for threads in fe.PM_THREADS:
            launch = fe.FdEnsLaunch(lanes, threads)
            got = fe._f1_launch(u0, run.plan, launch)
            again = fe._f1_launch(u0, run.plan, launch)
            torch.cuda.synchronize()
            assert got.shape == (n_steps, n) and bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= tol, launch
            assert torch.equal(got, again), launch
    long = fe.make_cuda_fd_ensemble("du/dt=sin(u)", 60_000, 1, 1e-4, device=device)
    with pytest.raises(RuntimeError, match="shared memory"):
        long(u0[:8].contiguous())


def test_fd_ensemble_vec_kernel_matches_its_plain_version(device):
    """F2 on every G and CTA size, at step counts whose fine nodes fill, or
    fall short of, the blocks of U·G nodes: within fd_kernel_tolerance(…,
    d=2) of the plain version, some plain entry above it, a repeat's bits;
    the wrapper's launch is fd_ens_plan's for d = 2, one launch counted; a
    launch past a block's shared memory raises."""
    rng = np.random.default_rng(21)
    n = 3000
    u0 = torch.tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n_steps, rf in ((8, 4), (13, 3), (5, 2)):
        run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", n_steps, rf, 2.0 / n_steps,
                                           device=device)
        before = fe.fd_ensemble_vec.launches
        got = run(u0)
        torch.cuda.synchronize()
        assert fe.fd_ensemble_vec.launches == before + 1
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf, d=2)
        assert bool((want.abs() > tol).any())  # the bound has teeth: an err of 0 fails
        assert float((got - want).abs().max()) <= tol
        mine = fe.fd_ens_plan(n, n_steps, rf, sms, 2)
        assert torch.equal(got, fe._f2_launch(u0, run.plan, mine))
        for lanes in fe.PM_LANES:
            for threads in fe.PM_THREADS:
                launch = fe.FdEnsLaunch(lanes, threads)
                out = fe._f2_launch(u0, run.plan, launch)
                again = fe._f2_launch(u0, run.plan, launch)
                torch.cuda.synchronize()
                assert out.shape == (n_steps, n) and bool(torch.isfinite(out).all())
                assert float((out - want).abs().max()) <= tol, (n_steps, launch)
                assert torch.equal(out, again), (n_steps, launch)
    with pytest.raises(ValueError, match="shared memory"):  # refused before any launch
        fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", 30_000, 1, 1e-4, device=device)
    long = fe._plan(run.plan.functors, 30_000, 1, dt=1e-4, device=device)
    with pytest.raises(RuntimeError, match="shared memory"):  # and by the kernel's launcher
        fe._f2_launch(u0[:8].contiguous(), long, fe.REG_LEAST)


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name,d,cases", [("lorenz96", 5, ((16, 4), (13, 3))),
                                          ("dense", 15, ((1, 16), (3, 5)))])
def test_fd_ensemble_vec_wide_kernel_matches_its_plain_version(device, name, d, cases):
    """F2 at d = 5 (Lorenz-96: the register design, U = 1) and d = 15 (the
    dense system: the window design) on traced callables, 3,000 ICs, at step
    counts whose fine nodes fill, or fall short of, the windows: every
    launch the plan can return (the register design's G and CTA sizes; the
    window design's G >= d, W in 8, 4, 2, 1, 64 or 32 threads, and one IC a
    CTA), and at d = 5 the window design too, each within
    fd_kernel_tolerance(…, d) of the plain version with some plain entry
    above it, a repeat's bits; the wrapper's launch is f2_plan's."""
    cs = _chip_smoke()
    comps, jac = cs.wide_system(name, d)
    n = 3000
    u0 = torch.tensor(cs.wide_u0(name, n, d), dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n_steps, rf in cases:
        run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=n_steps,
                                           ref_factor=rf, dt=0.0125 if d == 5 else 0.1,
                                           device=device)
        nnz = run.plan.functors.nnz
        before = fe.fd_ensemble_vec.launches
        got = run(u0)
        torch.cuda.synchronize()
        assert fe.fd_ensemble_vec.launches == before + 1
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf, d)
        assert bool((want.abs() > tol).any())  # the bound has teeth: an err of 0 fails
        assert float((got - want).abs().max()) <= tol
        assert torch.equal(got, fe._f2_launch(u0, run.plan, fe.f2_plan(n, n_steps, rf, sms, d,
                                                                       nnz)))
        lanes = [g for g in fe.PM_LANES if g >= max(d, 8)]
        launches = [fe.FdVecLaunch(g, th, w) for g in lanes for th in (64, 32)
                    for w in (8, 4, 2, 1)] + [fe.VEC_LEAST]
        if fe.f2_registers(d, nnz):
            launches += [fe.FdEnsLaunch(g, th) for g in fe.PM_LANES for th in fe.PM_THREADS]
        for launch in launches:
            out = fe._f2_launch(u0, run.plan, launch)
            again = fe._f2_launch(u0, run.plan, launch)
            torch.cuda.synchronize()
            assert out.shape == (n_steps, n) and bool(torch.isfinite(out).all())
            assert float((out - want).abs().max()) <= tol, (n_steps, launch)
            assert torch.equal(out, again), (n_steps, launch)


@pytest.mark.parametrize("d", range(2, 16))
def test_fd_ensemble_vec_takes_every_step_count_jax_admits(device, d):
    """F2 on the dense system's leading d×d block (every Jacobian entry
    live: the register design to d = 6, the window design above) at every
    step count that JAX's scoped-VMEM check admits at d (45 at d = 2 ... 1
    at d = 14 and 15), 512 ICs, rf 4, through the entry point and
    f2_plan's launch, each within fd_kernel_tolerance(…, d) of the plain
    version."""
    cs = _chip_smoke()
    comps, jac = cs.dense_system(d)
    u0 = torch.tensor(cs.wide_u0("dense", 512, d), dtype=torch.float32, device=device)
    for n_steps in range(1, cs.jax_admitted_steps(d) + 1):
        run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=n_steps,
                                           ref_factor=4, dt=0.05, device=device)
        got = run(u0)
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, 4, d)
        assert bool(torch.isfinite(got).all()), (d, n_steps)
        assert float((got - want).abs().max()) <= tol, (d, n_steps)


@pytest.mark.parametrize("convention", ["strided", "block"])
def test_fd_estimate_per_member_kernel_matches_its_plain_version(device, convention):
    rng = np.random.default_rng(5)
    b, n_steps, rf = 300, 12, 4
    times = np.full((b, n_steps + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, n_steps + 1, b)):  # padded zero-width tails
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0, 2, n_act - 1)), [2.0]])
    dt_b = torch.tensor(np.diff(times, axis=1), dtype=torch.float32, device=device)
    u0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    run = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", n_steps, rf, convention,
                                              device=device)
    before = fe.fd_estimate_per_member.launches
    err, j = run(dt_b, u0)
    torch.cuda.synchronize()
    assert fe.fd_estimate_per_member.launches == before + 1
    stats = {}
    err_p, j_p = fe.fd_estimate_per_member_plain(dt_b, u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf)
    assert err.shape == (b, n_steps) and err.is_contiguous()
    assert float((err - err_p).abs().max()) <= tol
    assert bool((err_p.abs() > tol).any())  # the bound has teeth: an err of 0 fails
    assert float((j - j_p).abs().max()) <= fe.fd_j_tolerance(stats, n_steps, 2.0)
    assert bool((err[dt_b == 0] == 0).all())  # padding contributes exactly 0
    # every G and CTA size: within the bound, padding 0, a repeat's bits
    for lanes in fe.PM_LANES:
        for threads in fe.PM_THREADS:
            launch = fe.FdPmLaunch(lanes, threads)
            got = fe._f3_launch(dt_b, u0, run.plan, launch)
            again = fe._f3_launch(dt_b, u0, run.plan, launch)
            torch.cuda.synchronize()
            assert float((got[0] - err_p).abs().max()) <= tol, launch
            assert bool((got[0][dt_b == 0] == 0).all()), launch
            assert all(torch.equal(x, y) for x, y in zip(got, again)), launch


def test_fd_kernels_reject_float64_and_non_contiguous(device):
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", 4, 4, 0.1, device=device)
    with pytest.raises(TypeError):
        run(torch.zeros(64, dtype=torch.float64, device=device))
    with pytest.raises(ValueError):  # not contiguous
        run(torch.zeros(128, device=device)[::2])
    pm = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", 4, 4, device=device)
    with pytest.raises(ValueError):  # dt of another dtype than u0s
        pm(torch.zeros((8, 4), dtype=torch.float64, device=device), torch.zeros(8, device=device))
    # past one member's coarse tables in a block's shared memory the launcher refuses
    long = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", 20_000, 4, device=device)
    with pytest.raises(RuntimeError, match="shared memory"):
        long(torch.zeros((8, 20_000), device=device), torch.zeros(8, device=device))
    with pytest.raises(ValueError):  # dt not contiguous
        pm(torch.zeros((4, 8), device=device).T, torch.zeros(8, device=device))


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("ode,n,trig,per_member", [
    ("du/dt=sin(u)", 1, "libm", False), ("du/dt=sin(u)", 1, "fast", True),
    ("du/dt=sin(u)", 4, "libm", False), ("gaussian_mixture", 2, "libm", True),
])
def test_dg_slab_kernel_matches_its_plain_version(device, ode, n, trig, per_member, lanes):
    """D1 through its wrapper (d1_plan's launch) and on G lanes a member at
    every CTA size d1_plan chooses from: each output within its per-element
    bound of the plain version, a repeat bit-identical, the tails exactly 0."""
    rng = np.random.default_rng(n)
    k, b = 12, 3000
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    if per_member:  # random partitions with zero-width tails
        t = np.full((b, k + 1), 2.0)
        for m, n_act in enumerate(rng.integers(2, k, b)):
            t[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, n_act - 1)),
                                                [2.0]])
    else:
        t = np.linspace(0.0, 2.0, k + 1)
    times = torch.tensor(t, dtype=torch.float32, device=device)
    ops_p, ops_a = dg_time_operators(n), dg_time_operators(n + 1)
    run = ds.make_cuda_dg_estimate_ensemble(ode, ops_p, ops_a, k, 8, trig=trig, device=device)
    before = ds.dg_estimate_ensemble.launches
    outs = [run(times, y0)]
    torch.cuda.synchronize()
    assert ds.dg_estimate_ensemble.launches == before + 1
    for threads in ds.CTA_THREADS:
        outs.append(ds._d1_launch(times, y0, run.plan, ds.D1Launch(lanes, threads)))
    again = ds._d1_launch(times, y0, run.plan, ds.D1Launch(lanes, ds.CTA_THREADS[0]))
    torch.cuda.synchronize()
    assert ds.dg_estimate_ensemble.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(again, outs[1]))
    want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
    tol = ds.dg_kernel_tolerance(times, y0, want, run.plan)
    for got in outs:
        for g, w, name in zip(got, want, ("u", "v", "err")):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert bool(((g - w).abs().double() <= tol[name]).all()), name
        if per_member:  # a trailing zero-width slab contributes exactly 0
            assert bool((got[2][torch.diff(times, dim=1) == 0] == 0).all())


def test_dg_slab_kernel_refusals_raise(device):
    ops_p, ops_a = dg_time_operators(1), dg_time_operators(2)
    run = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, 4, device=device)
    times = torch.linspace(0.0, 2.0, 5, device=device)
    with pytest.raises(TypeError):
        run(times.double(), torch.ones(8, dtype=torch.float64, device=device))
    with pytest.raises(RuntimeError, match="dg_estimate_ensemble failed"):
        run(times, torch.ones(0, device=device))  # an empty grid: the launch is refused
    y0 = torch.ones(8, device=device)
    for launch in (ds.D1Launch(3, 128), ds.D1Launch(64, 128), ds.D1Launch(4, 96 + 1),
                   ds.D1Launch(4, 512)):  # lanes not a power of two ≤ 32, CTAs not in warps ≤ 256
        with pytest.raises(RuntimeError, match="launch plan"):
            ds._d1_launch(times, y0, run.plan, launch)


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("ode,n_user,fo,mode", [
    ("du/dt=sin(u)", 3, 2, "solve"), ("du/dt=sin(u)", 3, 2, "reconstruct"),
    ("du/dt=sin(u)", 5, 2, "solve"), ("gaussian_mixture", 2, 1, "reconstruct"),
])
def test_hp_kernel_matches_its_plain_version(device, ode, n_user, fo, mode, lanes):
    """H1 through its wrapper (hp_plan's launch) and on G lanes a member at
    every CTA size hp_plan searches: each output within its per-element
    bound of the plain version, a repeat bit-identical, the tails exactly 0."""
    rng = np.random.default_rng(n_user)
    k, b = 12, 3000
    # per-member partitions on a 2^-10 grid (distinct float32 nodes) with
    # zero-width tails, random orders
    t = np.full((b, k + 1), 2.0)
    ns = np.ones((b, k), np.int64)
    for m, n_act in enumerate(rng.integers(2, k, b)):
        inner = np.sort(rng.choice(np.arange(1, 2048), n_act - 1, replace=False)) / 1024
        t[m, : n_act + 1] = np.concatenate([[0.0], inner, [2.0]])
        ns[m, :n_act] = rng.integers(1, n_user + 1, n_act)
    times = torch.tensor(t, dtype=torch.float32, device=device)
    ns = torch.tensor(ns, device=device)
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    mops = dg_time_operators_mixed(n_user + fo)
    run = hm.make_cuda_dg_estimate_hp_per_member(
        ode, mops, dg_adjoint_interp_mixed(mops), k, n_max_user=n_user, fine_offset=fo,
        adjoint_mode=mode, rad=dg_radau_interp_mixed(mops), device=device)
    before = hm.dg_estimate_hp_per_member.launches
    outs = [run(times, ns, y0)]
    torch.cuda.synchronize()
    assert hm.dg_estimate_hp_per_member.launches == before + 1
    for threads in hm.CTA_THREADS:
        outs.append(hm._h1_launch(times, ns, y0, run.plan, hm.HpLaunch(lanes, threads)))
    again = hm._h1_launch(times, ns, y0, run.plan, hm.HpLaunch(lanes, hm.CTA_THREADS[0]))
    torch.cuda.synchronize()
    assert hm.dg_estimate_hp_per_member.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(again, outs[1]))
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, want, run.plan)
    for got in outs:
        for g, w, name in zip(got, want, ("u_c", "u_f", "v", "err")):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert bool(((g - w).abs().double() <= tol[name]).all()), name
        assert bool((got[3][times[:, :-1] == 2.0] == 0).all())  # the tails contribute exactly 0


def test_hp_kernel_refusals_raise(device):
    mops = dg_time_operators_mixed(4)
    run = hm.make_cuda_dg_estimate_hp_per_member("du/dt=sin(u)", mops,
                                                 dg_adjoint_interp_mixed(mops), 4, n_max_user=2,
                                                 device=device)
    times = torch.linspace(0.0, 2.0, 5, device=device).expand(8, 5).contiguous()
    ns = torch.ones((8, 4), dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        run(times.double(), ns, torch.ones(8, dtype=torch.float64, device=device))
    with pytest.raises(ValueError):  # not contiguous
        run(times, ns, torch.ones(16, device=device)[::2])
    with pytest.raises(RuntimeError, match="dg_estimate_hp_per_member failed"):
        run(times[:0], ns[:0], torch.ones(0, device=device))  # an empty grid: the launch is refused


U2 = functionals.get_functional("J=int(u^2)")


@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("n,per_member", [(1, True), (1, False), (3, False)])
def test_dg_slab_kernel_with_a_goal_matches_its_plain_version(device, n, per_member, lanes):
    """D1 with J = ∫u² through its wrapper and on G lanes at every CTA size:
    each output within its extended per-element bound of the plain version,
    a repeat bit-identical, the tails exactly 0; the J = ∫u kernel's v lies
    outside the bound."""
    rng = np.random.default_rng(20 + n)
    k, b = 12, 3000
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    if per_member:
        t = np.full((b, k + 1), 2.0)
        for m, n_act in enumerate(rng.integers(2, k, b)):
            t[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, n_act - 1)),
                                                [2.0]])
    else:
        t = np.linspace(0.0, 2.0, k + 1)
    times = torch.tensor(t, dtype=torch.float32, device=device)
    ops_p, ops_a = dg_time_operators(n), dg_time_operators(n + 1)
    run = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, k, 8, g_u=U2.g_u,
                                            device=device)
    before = ds.dg_estimate_ensemble.launches
    outs = [run(times, y0)]
    for threads in ds.CTA_THREADS:
        outs.append(ds._d1_launch(times, y0, run.plan, ds.D1Launch(lanes, threads)))
    again = ds._d1_launch(times, y0, run.plan, ds.D1Launch(lanes, ds.CTA_THREADS[0]))
    torch.cuda.synchronize()
    assert ds.dg_estimate_ensemble.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(again, outs[1]))
    want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
    tol = ds.dg_kernel_tolerance(times, y0, want, run.plan)
    for got in outs:
        for g, w, name in zip(got, want, ("u", "v", "err")):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert bool(((g - w).abs().double() <= tol[name]).all()), name
        if per_member:
            assert bool((got[2][torch.diff(times, dim=1) == 0] == 0).all())
    unit = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, k, 8,
                                             device=device)(times, y0)
    assert bool(((unit[1] - want[1]).abs().double() > tol["v"]).any())


@pytest.mark.parametrize("lanes", [4, 16])
@pytest.mark.parametrize("mode", ["solve", "reconstruct"])
def test_hp_kernel_with_a_goal_matches_its_plain_version(device, mode, lanes):
    """H1 with J = ∫u² (g_u at the live nodes, 0 at the padding) through its
    wrapper and on G lanes at every CTA size: within the extended bounds, a
    repeat bit-identical, the tails exactly 0; the J = ∫u kernel's v lies
    outside the bound."""
    rng = np.random.default_rng(31)
    k, b, n_user, fo = 12, 3000, 3, 2
    t = np.full((b, k + 1), 2.0)
    ns = np.ones((b, k), np.int64)
    for m, n_act in enumerate(rng.integers(2, k, b)):
        inner = np.sort(rng.choice(np.arange(1, 2048), n_act - 1, replace=False)) / 1024
        t[m, : n_act + 1] = np.concatenate([[0.0], inner, [2.0]])
        ns[m, :n_act] = rng.integers(1, n_user + 1, n_act)
    times = torch.tensor(t, dtype=torch.float32, device=device)
    ns = torch.tensor(ns, device=device)
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    mops = dg_time_operators_mixed(n_user + fo)

    def make(g_u):
        return hm.make_cuda_dg_estimate_hp_per_member(
            "du/dt=sin(u)", mops, dg_adjoint_interp_mixed(mops), k, n_max_user=n_user,
            fine_offset=fo, adjoint_mode=mode, rad=dg_radau_interp_mixed(mops), g_u=g_u,
            device=device)

    run = make(U2.g_u)
    before = hm.dg_estimate_hp_per_member.launches
    outs = [run(times, ns, y0)]
    for threads in hm.CTA_THREADS:
        outs.append(hm._h1_launch(times, ns, y0, run.plan, hm.HpLaunch(lanes, threads)))
    again = hm._h1_launch(times, ns, y0, run.plan, hm.HpLaunch(lanes, hm.CTA_THREADS[0]))
    torch.cuda.synchronize()
    assert hm.dg_estimate_hp_per_member.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(again, outs[1]))
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, want, run.plan)
    for got in outs:
        for g, w, name in zip(got, want, ("u_c", "u_f", "v", "err")):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert bool(((g - w).abs().double() <= tol[name]).all()), name
        assert bool((got[3][times[:, :-1] == 2.0] == 0).all())
    unit = make(None)(times, ns, y0)
    assert bool(((unit[2] - want[2]).abs().double() > tol["v"]).any())


def _most_above(leaves):
    """Most entries of each (reference, bound) leaf with a nonzero bound lie
    above it: a wrong or zero leaf cannot pass."""
    for ref, bnd in leaves:
        live = int((bnd > 0).sum())
        assert 2 * int((ref.abs() > bnd).sum()) > live > 0


@pytest.mark.parametrize("variant", ["plain", "masked", "mixed", "weighted"])
def test_resblock_epoch_kernel_matches_its_plain_version(device, variant):
    s_steps, f, b = 6, 120, 3000
    gen = torch.Generator().manual_seed(7)
    ps = [ResBlockSimple(f).init_params(gen) for _ in range(s_steps)]
    packed = tf.pack_params({k: torch.stack([q[k] for q in ps]) for k in ps[0]}, s_steps,
                            f).to(device)
    rng = np.random.default_rng(8)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
    dt[-1] = 0.0  # a padded step: exact identity, zero gradients
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32, device=device)
    tg = (torch.stack([torch.sin(u0 * (1 + 0.1 * n)) for n in range(s_steps + 1)])
          if variant == "mixed" else torch.sin(u0) + 0.3)
    kw = {"mixed": variant == "mixed"}
    if variant == "masked":
        kw["n_active"] = torch.tensor([120, 3, 60, 117, 1, 50], dtype=torch.int32, device=device)
    if variant == "mixed":
        kw["ramp_weight"] = 0.7
    if variant == "weighted":
        kw["weights"] = torch.tensor(rng.uniform(size=b) < 0.6, dtype=torch.float32,
                                     device=device)
    inv_b = 1.0 if variant == "weighted" else 1.0 / b
    before = tf.resblock_epoch_grad.launches
    loss, g = tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw)
    loss2, g2 = tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw)
    torch.cuda.synchronize()
    assert tf.resblock_epoch_grad.launches == before + 2
    assert torch.equal(g, g2) and torch.equal(loss, loss2)
    d64 = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
           for k, v in kw.items()}
    l64, g64 = tf.resblock_epoch_grad_plain(packed.double(), dt.double(), u0.double(),
                                            tg.double(), inv_b=inv_b, **d64)
    tol = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b, **kw)
    assert abs(float(loss) - float(l64)) <= tol["loss"]
    assert bool(((g.double() - g64).abs() <= tol["grads"]).all())
    assert int((g64.abs() > tol["grads"]).sum()) > s_steps * f
    _most_above([(g64[i], tol["grads"][i]) for i in range(3)])
    assert not g[:, -1].any()
    if variant == "masked":
        for n, na in enumerate(kw["n_active"].tolist()):
            assert not g[:, n, na:].any()
    # every member tile the kernel takes (B = 3000: 47 to 375 tiles, the
    # last ragged), twice, bit-identical, within the tolerance at its own
    # tile's reduction
    for bm in tf.TILE_MEMBERS:
        plan = tf.ResblockPlan(bm, -(-b // bm))
        l1, g1 = tf._t1_launch(packed, dt, u0, tg, kw.get("weights"), kw.get("n_active"),
                               kw.get("ramp_weight"), inv_b, kw["mixed"], plan)
        l2, g2 = tf._t1_launch(packed, dt, u0, tg, kw.get("weights"), kw.get("n_active"),
                               kw.get("ramp_weight"), inv_b, kw["mixed"], plan)
        torch.cuda.synchronize()
        assert torch.equal(g1, g2) and torch.equal(l1, l2), bm
        tol_p = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b,
                                             reduce_terms=tf.reduce_terms_of(plan), **kw)
        assert abs(float(l1) - float(l64)) <= tol_p["loss"], bm
        assert bool(((g1.double() - g64).abs() <= tol_p["grads"]).all()), bm


@pytest.mark.parametrize("sizes,b,s_steps", [((100, 500), 1000, 5), ((8, 16), 50, 5),
                                             ((12,), 33, 5), ((3, 6, 5), 70, 5),
                                             ((100, 500), 512, 2), ((100, 500), 8192, 5),
                                             ((64,) * 8, 300, 3)])
def test_dense_epoch_kernel_matches_its_plain_version(device, sizes, b, s_steps):
    """T2 on its plan (B = 1000 and 300 are not multiples of their tiles):
    twice, bit-identical, each entry within dense_kernel_tolerance at that
    plan's (BM, C)."""
    params = ResNetBlock(sizes).init_params(torch.Generator().manual_seed(9), device=device)
    rng = np.random.default_rng(10)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
    dt[min(2, s_steps - 1)] = 0.0
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32, device=device)
    tr = torch.sin(u0) + 0.3
    theta = td.pack_dense(params, sizes, device)
    before = td.dense_epoch_grad.launches
    loss, flat = td.dense_epoch_grad(theta, sizes, dt, u0, tr)
    loss2, flat2 = td.dense_epoch_grad(theta, sizes, dt, u0, tr)
    torch.cuda.synchronize()
    assert td.dense_epoch_grad.launches == before + 2
    assert torch.equal(flat, flat2) and torch.equal(loss, loss2)
    got = td.unpack_dense(flat, sizes)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double())
    plan = td.dense_plan(sizes, b, torch.cuda.get_device_properties(device).multi_processor_count)
    tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, plan.block_members, plan.cluster)
    assert abs(float(loss) - float(l64)) <= tol["loss"]
    for k in g64:
        for q in g64[k]:
            bnd = tol["grads"][k][q]
            assert bool(((got[k][q].double() - g64[k][q]).abs() <= bnd).all()), (k, q)
    _most_above([(g64[k][q], tol["grads"][k][q]) for k in g64 for q in g64[k]])


@pytest.mark.parametrize("sizes,b", [((100, 500), 200), ((8, 16, 12, 8), 70)])
def test_dense_epoch_kernel_on_every_plan(device, sizes, b):
    """T2 on every (BM, C) the kernel takes for these widths: each within
    dense_kernel_tolerance at its own (BM, C), bit-identical on a repeat."""
    s_steps = 3
    params = ResNetBlock(sizes).init_params(torch.Generator().manual_seed(4), device=device)
    rng = np.random.default_rng(5)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32, device=device)
    tr = torch.sin(u0) + 0.3
    theta = td.pack_dense(params, sizes, device)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double())
    plans = list(td._feasible(sizes))
    assert len(plans) >= 6
    for bm, c in plans:
        plan = td.DensePlan(bm, c, -(-b // bm), td.dense_smem_bytes(sizes, bm, c))
        loss, flat = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        loss2, flat2 = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        torch.cuda.synchronize()
        assert torch.equal(flat, flat2) and torch.equal(loss, loss2), (bm, c)
        tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, bm, c)
        got = td.unpack_dense(flat, sizes)
        assert abs(float(loss) - float(l64)) <= tol["loss"], (bm, c)
        for k in g64:
            for q in g64[k]:
                d = (got[k][q].double() - g64[k][q]).abs()
                assert bool((d <= tol["grads"][k][q]).all()), (bm, c, k, q)


BF16 = torch.bfloat16


@pytest.mark.parametrize("sizes,b,s_steps", [((100, 500), 1000, 5), ((8, 16), 50, 5),
                                             ((3, 6, 5), 70, 5), ((100, 500), 512, 2),
                                             ((64,) * 4, 300, 3)])
def test_dense_epoch_kernel_bf16_matches_its_plain_version(device, sizes, b, s_steps):
    """T2's bf16 mode (mma.sync bf16 tensor cores) on its plan: twice,
    bit-identical, each entry within the bf16 bound of the float64 bf16
    plain version at that plan's (BM, C); the float32 mode's entries lie
    outside it somewhere."""
    params = ResNetBlock(sizes).init_params(torch.Generator().manual_seed(9), device=device)
    rng = np.random.default_rng(10)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
    dt[min(2, s_steps - 1)] = 0.0
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32, device=device)
    tr = torch.sin(u0) + 0.3
    theta = td.pack_dense(params, sizes, device, BF16)
    before = td.dense_epoch_grad.launches
    loss, flat = td.dense_epoch_grad(theta, sizes, dt, u0, tr, BF16)
    loss2, flat2 = td.dense_epoch_grad(theta, sizes, dt, u0, tr, BF16)
    torch.cuda.synchronize()
    assert td.dense_epoch_grad.launches == before + 2
    assert torch.equal(flat, flat2) and torch.equal(loss, loss2)
    got = td.unpack_dense(flat, sizes, BF16)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    args64 = (dt.double(), u0.double(), tr.double())
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, *args64, mxu_dtype=BF16)
    _, f64 = td.dense_epoch_grad_plain(p64, sizes, *args64)
    plan = td.dense_plan(sizes, b, torch.cuda.get_device_properties(device).multi_processor_count,
                         BF16)
    tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, plan.block_members, plan.cluster,
                                    BF16)
    assert abs(float(loss) - float(l64)) <= tol["loss"]
    outside = 0
    for k in g64:
        for q in g64[k]:
            bnd = tol["grads"][k][q]
            assert bool(((got[k][q].double() - g64[k][q]).abs() <= bnd).all()), (k, q)
            outside += int(((f64[k][q] - g64[k][q]).abs() > bnd).sum())
    assert outside > 0


def test_dense_epoch_kernel_bf16_on_every_plan(device):
    """T2's bf16 mode on every (BM, C) it takes at (100, 500), B = 200."""
    sizes, b, s_steps = (100, 500), 200, 3
    params = ResNetBlock(sizes).init_params(torch.Generator().manual_seed(4), device=device)
    rng = np.random.default_rng(5)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32, device=device)
    tr = torch.sin(u0) + 0.3
    theta = td.pack_dense(params, sizes, device, BF16)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double(),
                                         mxu_dtype=BF16)
    plans = list(td._feasible(sizes, BF16))
    assert len(plans) >= 6
    for bm, c in plans:
        plan = td.DensePlan(bm, c, -(-b // bm), td.dense_smem_bytes(sizes, bm, c, BF16), True)
        loss, flat = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        loss2, flat2 = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        torch.cuda.synchronize()
        assert torch.equal(flat, flat2) and torch.equal(loss, loss2), (bm, c)
        tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, bm, c, BF16)
        got = td.unpack_dense(flat, sizes, BF16)
        assert abs(float(loss) - float(l64)) <= tol["loss"], (bm, c)
        for k in g64:
            for q in g64[k]:
                d = (got[k][q].double() - g64[k][q]).abs()
                assert bool((d <= tol["grads"][k][q]).all()), (bm, c, k, q)


@pytest.mark.parametrize("method", ["variable_params", "recurrent"])
def test_driver_trains_through_the_kernel_at_any_batch(device, method):
    """1000 members (not a multiple of 128; the recurrent minibatch is 62,
    not a multiple of 8): every epoch still launches T1 or T2."""
    from adjoint_ode_adaptivity_tpu_torch.drivers import train_resnet_ode as drv

    argv = ["--method", method, "--width", "32", "--hidden", "8,16", "--n-train", "1000",
            "--epochs", "3", "--maxit", "0", "--quiet"]
    tf.reset_launch_counts()
    td.reset_launch_counts()
    drv.main(argv)
    if method == "recurrent":
        assert td.dense_epoch_grad.launches == 3 * (1000 // 62) and tf.resblock_epoch_grad.launches == 0
    else:
        assert tf.resblock_epoch_grad.launches == 3 and td.dense_epoch_grad.launches == 0


def test_training_kernels_refuse_what_they_do_not_take(device):
    packed = torch.zeros((3, 2, 4), device=device)
    dt = torch.full((2,), 0.1, device=device)
    u0 = torch.zeros(8, device=device)
    with pytest.raises(ValueError, match="float32"):
        tf.resblock_epoch_grad(packed.double(), dt, u0, u0, inv_b=0.125)
    with pytest.raises(ValueError, match="contiguous"):
        tf.resblock_epoch_grad(packed, dt, torch.zeros(16, device=device)[::2], u0, inv_b=0.125)
    # member tiles the kernel is not built for
    for bm in (12, 128):
        with pytest.raises(RuntimeError, match="member tile"):
            tf._t1_launch(packed, dt, u0, u0, None, None, None, 0.125, False,
                          tf.ResblockPlan(bm, 1))
    theta = td.pack_dense(ResNetBlock((4,)).init_params(device=device), (4,), device)
    with pytest.raises(ValueError, match="hidden layers"):
        td.dense_epoch_grad(theta, (4,) * 9, dt, u0, u0)
    with pytest.raises(ValueError):
        td.dense_block_members((20000,))
    with pytest.raises(ValueError, match="float32"):
        td.dense_epoch_grad(theta.double(), (4,), dt, u0, u0)
    # plans the kernel refuses: a cluster of 16, a split single layer, past
    # the shared memory, a member tile of 8
    sizes = (100, 500)
    theta = td.pack_dense(ResNetBlock(sizes).init_params(device=device), sizes, device)
    for plan, what in ((td.DensePlan(32, 16, 1, 0), "cluster size"),
                       (td.DensePlan(64, 1, 1, 0), "shared memory"),
                       (td.DensePlan(8, 8, 1, 0), "member tile")):
        with pytest.raises(RuntimeError, match=what):
            td._t2_launch(theta, sizes, dt, u0, u0, plan)
    theta4 = td.pack_dense(ResNetBlock((4,)).init_params(device=device), (4,), device)
    with pytest.raises(RuntimeError, match="cluster size"):
        td._t2_launch(theta4, (4,), dt, u0, u0, td.DensePlan(16, 2, 1, 0))


# ---------------------------------------------------------------- Burgers B1


@pytest.mark.parametrize("limiter", ["n", "1", "none"])
@pytest.mark.parametrize("n_order,k,graded", [(2, 64, False), (4, 48, True), (7, 20, True)])
def test_burgers_kernel_matches_its_plain_version(device, limiter, n_order, k, graded):
    """float64: each entry within 1e-12·|plain| + 1e-13 (test_pallas.py:629);
    float32, before the shock: within 8·n_steps·ε₃₂·max|u0|. One wrapper
    call each; every other plan gives the wrapper's bits."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    tab = cb.burgers_tables(disc, 5e-5, limiter, device)
    u0 = np.stack([(0.5 + 0.05 * j) * np.sin(disc.x) for j in range(8)], axis=1)
    for dtype in (torch.float64, torch.float32):
        x = torch.tensor(u0, dtype=dtype, device=device)
        before = cb.burgers_march.launches
        got = cb.burgers_march(x, 32, tab)
        torch.cuda.synchronize()
        assert cb.burgers_march.launches == before + 1
        want = cb.burgers_march_plain(x, 32, tab)
        bound = (1e-12 * want.abs() + 1e-13 if dtype == torch.float64
                 else 8 * 32 * EPS32 * float(x.abs().max()))
        assert bool(((got - want).abs() <= bound).all())
        # several tiles (3, the last ragged, reading across the periodic seam),
        # one tile wider than the mesh, and the ring in 5-step launches: every
        # element's arithmetic is the same, so every plan gives the wrapper's
        # bits, and a repeat call gives them again
        rule = cb.ghost_rule(limiter)
        for plan in (cb.BurgersPlan(3, 3 * rule, -(-k // 3), 3, 512),
                     cb.BurgersPlan(2, 2 * rule, 400, 1, 512),
                     cb.BurgersPlan(5, 0, k, 1, 512)):
            for _ in range(2):
                tiled, n_cuda = cb._b1_launch(x, 32, tab, plan)
                torch.cuda.synchronize()
                assert torch.equal(tiled, got) and n_cuda == -(-32 // plan.segment), plan


def test_burgers_kernel_refusals_raise(device):
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    disc = startup_1d(2, 0.0, 2 * np.pi, 16)
    tab = cb.burgers_tables(disc, 1e-3, "n", device)
    with pytest.raises(TypeError):
        cb.burgers_march(torch.zeros((3, 1, 16), dtype=torch.float16, device=device), 4, tab)
    with pytest.raises(ValueError):  # not contiguous
        cb.burgers_march(torch.zeros((3, 16, 2), device=device).transpose(1, 2), 4, tab)
    with pytest.raises(ValueError):  # on the CPU, operands on the card
        cb.burgers_march(torch.zeros((3, 1, 16)), 4, tab)
    # plans the kernel refuses: a ghost ring short of 10·s_f, a CTA size it
    # is not built for, 1024 threads in float64, a window past the CTA
    u = torch.zeros((3, 2, 16), device=device)
    for plan, x in ((cb.BurgersPlan(2, 19, 8, 2, 512), u),
                    (cb.BurgersPlan(1, 10, 8, 2, 256), u),
                    (cb.BurgersPlan(1, 10, 8, 2, 1024), u.double()),
                    (cb.BurgersPlan(26, 260, 8, 2, 512), u)):
        with pytest.raises(RuntimeError, match="plan refused"):
            cb._b1_launch(x, 4, tab, plan)


def test_revolve_estimate_on_the_card_matches_the_stored_pipeline(device):
    from adjoint_ode_adaptivity_tpu_torch.adjoint.revolve_vjp import revolve_advec_estimate

    disc = startup_1d(2, 0.0, 2 * np.pi, 64)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    rev = revolve_advec_estimate(disc, A, 2e-4, 64, unit_steps=8, snaps=3, device=device)
    got = rev(u0, 0.0, lam)
    want = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, 2e-4, 64, device)(u0, 0.0, lam)
    tol = 8 * 64 * EPS32
    assert float((got[0] - want[0]).abs().max()) <= tol
    assert float((got[1] - want[1]).abs().max()) <= tol * float(lam.abs().max())
    assert bool(((got[2] - want[2]).abs() <= 1e-4 * want[2].abs() + 1e-9).all())
    assert rev.revolve_stats["max_slots"] <= 3


@pytest.mark.parametrize("n_order,k,b,graded,segment", [(2, 24, 8, True, 4), (7, 24, 8, False, 16),
                                                         (3, 50, 1, True, 8)])
def test_recompute_kernels_reproduce_the_stored_pipeline(device, n_order, k, b, graded, segment):
    """K1's checkpoint mode and K2r run the same stage kernels at the same
    times as K1 and K2: checkpoints, u, λ0 and η bit-equal; K2r and KA
    against their plain versions within the float32 bounds above."""
    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt, n_steps = 0.5 * (0.75 / A) * xmin, 32
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    traj, uf = dg_rhs.fwd_march(u0, 0.1, n_steps, ops, store_trajectory=True)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops)
    before = (dg_rhs.fwd_march_ckpt.launches, dg_rhs.adj_est_recompute.launches,
              dg_rhs.adj_march.launches)
    ckpts, uf_c = dg_rhs.fwd_march_ckpt(u0, 0.1, n_steps, segment, ops)
    lam0_r, eta_r = dg_rhs.adj_est_recompute(ckpts, lam, 0.1, segment, ops)
    lam_a = dg_rhs.adj_march(lam, n_steps, ops)
    torch.cuda.synchronize()
    assert (dg_rhs.fwd_march_ckpt.launches, dg_rhs.adj_est_recompute.launches,
            dg_rhs.adj_march.launches) == tuple(n + 1 for n in before)
    assert torch.equal(ckpts, traj[::segment]) and torch.equal(uf_c, uf)
    assert torch.equal(lam0_r, lam0) and torch.equal(eta_r, eta)
    lam0_p, eta_p = dg_rhs.adj_est_recompute_plain(ckpts, lam, 0.1, segment, ops)
    lam_ap = dg_rhs.adj_march_plain(lam, n_steps, ops)
    tol_l = 8 * n_steps * EPS32 * float(lam0_p.abs().max())
    tol_e = 8 * n_steps * disc.np_ * EPS32 * float(lam.abs().max()) * float(uf.abs().max())
    assert float((lam0_r - lam0_p).abs().max()) <= tol_l
    assert float((eta_r - eta_p).abs().max()) <= tol_e
    assert float((lam_a - lam_ap).abs().max()) <= 8 * n_steps * EPS32 * float(lam.abs().max())


@pytest.mark.parametrize("k,segment,chunks,grid", [(640, 2, 4, False), (2048, 2, 8, True),
                                                   (20_000, 8, 4, True)])
def test_tiled_kernels_reproduce_the_stored_pipeline(device, k, segment, chunks, grid):
    """KT1/KT2 compute every local element with K1/K2's arithmetic at the
    same times: u, λ0 and η bit-equal to the stored pipeline; and within the
    float32 bounds of their plain version at the smallest shape."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_tiled

    disc = startup_1d(2, 0.0, 2 * np.pi, k)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt, n_seg = 0.5 * (0.75 / A) * xmin, 4
    make = (dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid if grid
            else dg_tiled.make_cuda_fwd_adj_estimate_tiled)
    run = make(disc, A, dt, segment=segment, n_segments=n_seg, chunks=chunks, device=device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    before = (dg_tiled.tiled_fwd_seg.launches, dg_tiled.tiled_rev_seg.launches)
    got = run(u0, 0.0, lam)
    torch.cuda.synchronize()
    assert (dg_tiled.tiled_fwd_seg.launches, dg_tiled.tiled_rev_seg.launches) == (
        before[0] + 1, before[1] + 1)
    want = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, run.n_steps, device)(u0, 0.0, lam)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if k == 640:
        ops = dg_rhs.kernel_ops(disc, A, dt, device)
        plain = dg_tiled.tiled_plain(u0, 0.0, lam, n_seg, run.plan, ops)
        n = run.n_steps
        tol = (8 * n * EPS32, 8 * n * EPS32 * float(lam.abs().max()),
               8 * n * disc.np_ * EPS32 * float(lam.abs().max()))
        for g, p, t in zip(got, plain, tol):
            assert float((g - p).abs().max()) <= t


@pytest.mark.parametrize("k,segment,graded", [(640, 2, False), (20_000, 8, False),
                                             (3000, 4, True)])
def test_tiled_forward_one_segment_a_call(device, k, segment, graded):
    """KT1 is K1's fused kernel at B = 1 from the global step offset: one
    segment a call (first_segment = s) and two segments from the middle give
    the bits of the same steps inside one whole call, trajectory and
    u_final; ⌈n_steps/s_f⌉ CUDA launches a call on forward_plan's windows."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_tiled

    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(2, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_rhs.kernel_ops(disc, A, 0.5 * (0.75 / A) * xmin, device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    plan = dg_tiled.tile_plan(k, disc.np_, segment, 10 * segment + 10, k)
    n_seg = 4
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.1, n_seg, plan, ops)
    fused = dg_rhs.forward_plan(k, 1, disc.np_, n_seg * segment, 1, sms)
    assert dg_tiled.tiled_fwd_seg.cuda_launches == -(-n_seg * segment // fused.segment)
    u = u0
    for s in range(n_seg):
        part, u = dg_tiled.tiled_fwd_seg(u, 0.1, 1, plan, ops, first_segment=s)
        assert torch.equal(part, traj[s * segment:(s + 1) * segment]), s
    assert torch.equal(u, uf)
    part, u = dg_tiled.tiled_fwd_seg(traj[2 * segment].contiguous(), 0.1, 2, plan, ops,
                                     first_segment=2)
    assert torch.equal(part, traj[2 * segment:]) and torch.equal(u, uf)
    # the stored pipeline's K1 gives the same trajectory
    want, want_uf = dg_rhs.fwd_march(u0[:, None].contiguous(), 0.1, n_seg * segment, ops,
                                     store_trajectory=True)
    assert torch.equal(traj, want[:, :, 0]) and torch.equal(uf, want_uf[:, 0])


# (n_order, K, B, graded, n_steps, segment): Np 2, 3 and 8; B 1, 3 and 8; K
# below one 412-element tile, a whole number of tiles and ragged; n_steps not
# a multiple of s_f = 4; checkpoint segments 1, 4, 13 and 64
FUSED_CASES = [
    (1, 24, 1, False, 13, 1),
    (1, 1236, 1, False, 13, 13),
    (2, 1000, 3, True, 13, 13),
    (2, 2000, 8, False, 64, 4),
    (2, 2000, 8, True, 128, 64),
    (2, 5000, 1, False, 20, 4),
    (7, 500, 3, True, 9, 1),
    (7, 300, 8, False, 16, 4),
]


@pytest.mark.parametrize("n_order,k,b,graded,n_steps,segment", FUSED_CASES)
def test_fused_reverse_kernels(device, n_order, k, b, graded, n_steps, segment):
    """K2 and K2r fused over s_f steps a launch: (λ0, η) within
    chip_smoke.py's tolerances of their plain versions; K2r K2's bits; at B
    = 1 on a uniform mesh the KT1/KT2 pipeline's bits; ⌈n_steps/s_f⌉ CUDA
    launches for K2 and 2·⌈segment/s_f⌉ a checkpoint segment for K2r, at
    most 2·⌈n_steps/s_f⌉."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_tiled

    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt = 0.5 * (0.75 / A) * xmin
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    traj, uf = dg_rhs.fwd_march(u0, 0.1, n_steps, ops, store_trajectory=True)
    before = (dg_rhs.adj_est_stored.launches, dg_rhs.adj_est_recompute.launches)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    s_f = dg_rhs.stored_plan(k, b, disc.np_, n_steps, sms).segment
    assert dg_rhs.adj_est_stored.cuda_launches == -(-n_steps // s_f)
    ckpts = traj[::segment].contiguous()
    lam0_r, eta_r = dg_rhs.adj_est_recompute(ckpts, lam, 0.1, segment, ops)
    torch.cuda.synchronize()
    s_r = dg_rhs.recompute_plan(k, b, disc.np_, segment, n_steps, sms).segment
    n_r = dg_rhs.adj_est_recompute.cuda_launches
    assert n_r == 2 * (n_steps // segment) * -(-segment // s_r) <= 2 * -(-n_steps // s_r)
    assert (dg_rhs.adj_est_stored.launches, dg_rhs.adj_est_recompute.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(lam0_r, lam0) and torch.equal(eta_r, eta)
    lam0_p, eta_p = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.1, ops)
    eps, lmax, umax = EPS32, float(lam.abs().max()), float(uf.abs().max())
    assert float((lam0 - lam0_p).abs().max()) <= 8 * n_steps * eps * lmax
    assert float((eta - eta_p).abs().max()) <= 8 * n_steps * disc.np_ * eps * umax * lmax
    lam0_rp, eta_rp = dg_rhs.adj_est_recompute_plain(ckpts, lam, 0.1, segment, ops)
    assert float((lam0_r - lam0_rp).abs().max()) <= 8 * n_steps * eps * lmax
    assert float((eta_r - eta_rp).abs().max()) <= 8 * n_steps * disc.np_ * eps * umax * lmax
    if b == 1 and not graded:
        seg_kt = max(d for d in (1, 2, 4) if n_steps % d == 0)
        plan = dg_tiled.tile_plan(k, disc.np_, seg_kt, 10 * seg_kt + 10, k)
        traj_kt, uf_kt = dg_tiled.tiled_fwd_seg(u0[:, 0].contiguous(), 0.1, n_steps // seg_kt,
                                                plan, ops)
        lam0_kt, eta_kt = dg_tiled.tiled_rev_seg(traj_kt, uf_kt, lam[:, 0].contiguous(), 0.1,
                                                 plan, ops)
        assert torch.equal(uf_kt, uf[:, 0]) and torch.equal(traj_kt, traj[:, :, 0])
        assert torch.equal(lam0_kt, lam0[:, 0]) and torch.equal(eta_kt, eta[0])


def test_fused_reverse_plans_agree(device):
    """Other plans (s_f 1, 8 and 16 on 512 and 1024 threads, narrow tiles)
    give the same bits: the tiling does not show."""
    disc = startup_1d(2, 0.0, 2 * np.pi, 3000)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_rhs.kernel_ops(disc, A, 0.5 * (0.75 / A) * xmin, device)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in (0.0, 1.0)], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(3, 2, 3000).contiguous()
    traj, uf = dg_rhs.fwd_march(u0, 0.0, 24, ops, store_trajectory=True)
    want = dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)
    for steps, threads, tiles in ((8, 512, None), (8, 1024, None), (1, 512, None),
                                  (16, 1024, None), (4, 512, 40)):
        plan = dg_rhs.fused_plan(3000, steps, threads)
        if tiles:
            plan = plan._replace(tile=75, n_tiles=tiles)
        got = dg_rhs._k2_launch(traj, uf, lam, 0.0, ops, plan)
        assert got[2] == -(-24 // steps)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = dg_rhs._k2r_launch(traj[::8].contiguous(), lam, 0.0, 8, ops, plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (n_order, K, B, graded, n_steps, segment): Np 2, 3 and 8; B 1, 3 and 8;
# uniform and graded; K in one CTA with no ghosts, in whole and in ragged
# tiles; n_steps not a multiple of the plan's s_f; checkpoint segments 1, 3,
# 13 and 64, none a multiple of s_f
FWD_CASES = [
    (1, 24, 1, False, 13, 13),
    (1, 5000, 1, False, 21, 3),
    (2, 1000, 3, True, 26, 13),
    (2, 10_000, 8, False, 200, 1),
    (2, 3000, 8, True, 192, 64),
    (7, 500, 3, True, 9, 3),
    (7, 2000, 8, False, 39, 13),
    (7, 900, 1, True, 17, 1),
]
# other plans of K1 (s_f, threads, narrow tile or None): every one gives the
# wrappers' plan's bits
FWD_OTHER_PLANS = ((1, 512, None), (3, 1024, None), (8, 512, 70), (32, 1024, None), (32, 512, None))


@pytest.mark.parametrize("n_order,k,b,graded,n_steps,segment", FWD_CASES)
def test_fused_forward_kernel(device, n_order, k, b, graded, n_steps, segment):
    """K1 fused over s_f steps a launch in its three modes (trajectory,
    checkpoints, no store): within the float32 bounds above of its plain
    version; the three modes, and every other plan, the same bits;
    checkpoints the trajectory's every segment-th state, and any store_every
    whether it divides n_steps or not; ⌈n_steps/s_f⌉ CUDA launches; K2r from
    the checkpoints K2's bits; at B = 1 on a uniform mesh KT1's bits."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_tiled, load_library

    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_rhs.kernel_ops(disc, A, 0.5 * (0.75 / A) * xmin, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    before = (dg_rhs.fwd_march.launches, dg_rhs.fwd_march_ckpt.launches)
    traj, uf = dg_rhs.fwd_march(u0, 0.1, n_steps, ops, store_trajectory=True)
    plan = dg_rhs.forward_plan(k, b, disc.np_, n_steps, 1, sms)
    assert dg_rhs.fwd_march.cuda_launches == -(-n_steps // plan.segment)
    none, uf_n = dg_rhs.fwd_march(u0, 0.1, n_steps, ops)
    plan_n = dg_rhs.forward_plan(k, b, disc.np_, n_steps, None, sms)
    assert dg_rhs.fwd_march.cuda_launches == -(-n_steps // plan_n.segment)
    ckpts, uf_c = dg_rhs.fwd_march_ckpt(u0, 0.1, n_steps, segment, ops)
    plan_c = dg_rhs.forward_plan(k, b, disc.np_, n_steps, segment, sms)
    assert dg_rhs.fwd_march_ckpt.cuda_launches == -(-n_steps // plan_c.segment)
    torch.cuda.synchronize()
    assert (dg_rhs.fwd_march.launches, dg_rhs.fwd_march_ckpt.launches) == (
        before[0] + 2, before[1] + 1)
    assert none is None and torch.equal(uf_n, uf) and torch.equal(uf_c, uf)
    assert torch.equal(ckpts, traj[::segment])
    traj_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, True)
    tol_u = 8 * n_steps * EPS32 * float(uf_p.abs().max())
    assert float((traj - traj_p).abs().max()) <= tol_u
    assert float((uf - uf_p).abs().max()) <= tol_u
    lib = load_library()
    for steps, threads, tile in FWD_OTHER_PLANS:
        other = dg_rhs.fwd_fused_plan(k, min(steps, n_steps), threads)
        if tile:
            other = other._replace(tile=tile, n_tiles=-(-k // tile))
        every = 3 if steps == 8 else 1
        store = torch.empty((-(-n_steps // every), *u0.shape), device=device)
        got, n_cuda = dg_rhs._k1_launch(lib, u0, 0.1, n_steps, store, every, ops, other)
        assert n_cuda == -(-n_steps // other.segment)
        assert torch.equal(got, uf) and torch.equal(store, traj[::every])
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops)
    lam0_r, eta_r = dg_rhs.adj_est_recompute(ckpts, lam, 0.1, segment, ops)
    assert torch.equal(lam0_r, lam0) and torch.equal(eta_r, eta)
    if b == 1 and not graded:
        seg_kt = max(d for d in (1, 3, 7) if n_steps % d == 0)
        kt = dg_tiled.tile_plan(k, disc.np_, seg_kt, 10 * seg_kt + 10, k)
        traj_kt, uf_kt = dg_tiled.tiled_fwd_seg(u0[:, 0].contiguous(), 0.1, n_steps // seg_kt,
                                                kt, ops)
        assert torch.equal(uf_kt, uf[:, 0]) and torch.equal(traj_kt, traj[:, :, 0])


def test_fused_forward_refuses_what_it_does_not_take(device):
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    disc = startup_1d(2, 0.0, 2 * np.pi, 600)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, device)
    u0 = torch.zeros((3, 1, 600), device=device)
    lib = load_library()
    FP = dg_rhs.FusedPlan
    for plan in (FP(4, 19, 100, 6, 512),  # ghosts under 5·s_f on a tiled mesh
                 FP(33, 0, 600, 1, 1024),  # past the inflow table
                 FP(4, 0, 600, 1, 512)):  # a window past the CTA
        with pytest.raises(RuntimeError, match="K1 plan"):
            dg_rhs._k1_launch(lib, u0, 0.0, 8, None, 1, ops, plan)


@pytest.mark.parametrize("n_order,k,b,graded,n_steps", [
    (1, 24, 1, False, 13), (2, 300, 3, True, 37), (2, 10_000, 1, False, 70),
    (2, 3000, 8, False, 45), (7, 900, 1, True, 19), (7, 2000, 8, True, 13)])
def test_fused_adjoint_kernel(device, n_order, k, b, graded, n_steps):
    """KA fused over s_f steps a launch: within the float32 bound above of
    its plain version (8·n_steps·ε·max|λ_end|); every other plan (narrow and
    widest windows, s_f 4 to 32, 512 and 1024 threads, one tile with no
    ghosts where the mesh fits) the same bits; ⌈n_steps/s_f⌉ CUDA launches
    on each, one wrapper launch counted."""
    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_rhs.kernel_ops(disc, A, 0.5 * (0.75 / A) * xmin, device)
    lam = torch.tensor(np.random.default_rng(k).normal(size=(disc.np_, b, k)),
                       dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    before = dg_rhs.adj_march.launches
    lam0 = dg_rhs.adj_march(lam, n_steps, ops)
    torch.cuda.synchronize()
    plan = dg_rhs.adjoint_plan(k, b, disc.np_, n_steps, sms)
    assert dg_rhs.adj_march.launches == before + 1
    assert dg_rhs.adj_march.cuda_launches == -(-n_steps // plan.segment)
    want = dg_rhs.adj_march_plain(lam, n_steps, ops)
    assert float((lam0 - want).abs().max()) <= 8 * n_steps * EPS32 * float(lam.abs().max())
    others = [dg_rhs.fwd_fused_plan(k, min(st, n_steps), th)
              for st, th in ((4, 512), (8, 1024), (16, 512), (32, 1024))]
    others.append(dg_rhs.fwd_fused_plan(k, min(4, n_steps))._replace(tile=50, n_tiles=-(-k // 50)))
    if k <= 1024:
        others.append(dg_rhs.FusedPlan(min(32, n_steps), 0, k, 1, 1024))
    for other in others:
        got, n_cuda = dg_rhs._ka_launch(lam, n_steps, ops, other)
        assert n_cuda == -(-n_steps // other.segment), other
        assert torch.equal(got, lam0), other


def test_fused_adjoint_refuses_what_it_does_not_take(device):
    disc = startup_1d(2, 0.0, 2 * np.pi, 600)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, device)
    lam = torch.zeros((3, 1, 600), device=device)
    FP = dg_rhs.FusedPlan
    for plan in (FP(4, 19, 100, 6, 512),  # ghosts under 5·s_f on a tiled mesh
                 FP(33, 0, 600, 1, 1024),  # past s_f = 32
                 FP(4, 0, 600, 1, 512),  # a window past the CTA
                 FP(4, 20, 100, 6, 256)):  # a CTA size the kernel is not built for
        with pytest.raises(RuntimeError, match="KA plan"):
            dg_rhs._ka_launch(lam, 8, ops, plan)
    with pytest.raises(ValueError, match="B=70000"):
        dg_rhs._ka_launch(torch.zeros((3, 70_000, 1), device=device), 8, ops, FP(4, 0, 1, 1, 512))
    with pytest.raises(ValueError):
        dg_rhs.adj_march(lam[:, :, :500].contiguous(), 8, ops)


def test_new_advection_kernels_refuse_what_they_do_not_take(device):
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_tiled

    disc = startup_1d(2, 0.0, 2 * np.pi, 64)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, device)
    u64 = torch.zeros((3, 1, 64), dtype=torch.float64, device=device)
    with pytest.raises(TypeError):
        dg_rhs.fwd_march_ckpt(u64, 0.0, 8, 4, ops)
    with pytest.raises(TypeError):
        dg_rhs.adj_march(u64, 8, ops)
    with pytest.raises(ValueError):  # on the CPU, operands on the card
        dg_rhs.adj_est_recompute(torch.zeros((2, 3, 1, 64)), torch.zeros((3, 1, 64)), 0.0, 4, ops)
    traj = torch.zeros((4, 3, 1, 64), device=device)
    with pytest.raises(RuntimeError, match="fused plan"):  # ghosts under 10·s_f + 10
        dg_rhs._k2_launch(traj, traj[0], traj[0], 0.0, ops, dg_rhs.FusedPlan(4, 49, 100, 1, 512))
    with pytest.raises(RuntimeError, match="fused plan"):  # a step before the march's first
        dg_rhs._k2_launch(traj, traj[0], traj[0], 0.0, ops, dg_rhs.fused_plan(64, 4), n_first=-1)
    with pytest.raises(ValueError, match="B=70000"):
        dg_rhs._check_grid(70_000)
    plan = dg_tiled.tile_plan(64, 3, 1, 20, 64)
    with pytest.raises(TypeError):
        dg_tiled.tiled_fwd_seg(u64[:, 0], 0.0, 2, plan, ops)
    with pytest.raises(ValueError):  # not contiguous
        dg_tiled.tiled_fwd_seg(torch.zeros((64, 3), device=device).T, 0.0, 2, plan, ops)


@pytest.mark.parametrize("n_order,k,dt,segment", [(1, 24, 2e-4, 4), (2, 64, 2e-4, 4),
                                                  (7, 24, 5e-5, 2), (7, 1000, 5e-5, 2)])
def test_mxu_kernels_match_their_plain_version(device, n_order, k, dt, segment):
    """KM1/KM2 against their plain version (the same float32 operations in
    the same order): bit-equal expected, held to the bounds above; and
    against the stored K1/K2 pipeline at tests/test_pallas_mxu.py's
    tolerances, at its steps (KM forms the stage times in float32 as the TPU
    kernel, K1/K2 in double: at the CFL step, where η reaches 1e-4 at Np =
    2, the two η differ by ~2e-7, past that file's atol 1e-7)."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu

    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    b, n_seg = 8, 4
    run = dg_mxu.make_cuda_fwd_adj_estimate_grid_mxu(disc, A, dt, segment=segment,
                                                     n_segments=n_seg, batch=b, device=device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    before = (dg_mxu.km_fwd_traj.launches, dg_mxu.km_adj_est.launches)
    got = run(u0, 0.1, lam)
    torch.cuda.synchronize()
    assert (dg_mxu.km_fwd_traj.launches, dg_mxu.km_adj_est.launches) == (
        before[0] + 1, before[1] + 1)
    flat = (disc.np_, b * k)
    traj_p, uf_p = dg_mxu.km_fwd_traj_plain(u0.reshape(flat), 0.1, run.ops)
    lam0_p, eta_p = dg_mxu.km_adj_est_plain(traj_p, uf_p, lam.reshape(flat), 0.1, run.ops)
    n = run.n_steps
    tol = (8 * n * EPS32 * float(uf_p.abs().max()), 8 * n * EPS32 * float(lam.abs().max()),
           8 * n * disc.np_ * EPS32 * float(lam.abs().max()) * float(uf_p.abs().max()))
    for g, p, t in zip(got, (uf_p, lam0_p, eta_p), tol):
        assert float((g.reshape(p.shape) - p).abs().max()) <= t
    # the fused KM1 and KM2 run the plain version's float32 operations in its order
    assert torch.equal(got[0].reshape(flat), uf_p)
    assert torch.equal(got[1].reshape(flat), lam0_p) and torch.equal(got[2].reshape(-1), eta_p)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    s_f = dg_mxu.km_rev_plan(k, b, disc.np_, n, sms).segment
    assert dg_mxu.km_adj_est.cuda_launches == -(-n // s_f)
    s_f = dg_mxu.km_fwd_plan(k, b, disc.np_, n, sms).segment
    assert dg_mxu.km_fwd_traj.cuda_launches == -(-n // s_f)
    want = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(
        disc, A, dt, n, b, device, store_trajectory=True)(u0, 0.1, lam)
    for g, w, (rtol, atol) in zip(got, want, ((2e-4, 1e-6), (2e-3, 2e-5), (5e-3, 1e-7))):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_order,k", [(1, 300), (2, 1000), (5, 200), (7, 1000)])
def test_mxu_reverse_on_every_plan(device, n_order, k):
    """KM2 on every plan km_rev_plan searches (s_f 4 and 8, each CTA size
    built for Np, the widest tiles and a third of them) and on narrow tiles,
    13 steps (a remainder): each the plain version's bits, in ⌈13/s_f⌉ CUDA
    launches; the 1024-thread CTA refused at Np ≥ 7."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu

    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    b, n = 3, 13
    dt = 0.375 / A * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_mxu.mxu_ops(disc, A, dt, n, 1, b, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.concatenate([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device).repeat(1, b).contiguous()
    traj, uf = dg_mxu.km_fwd_traj(u0, 0.0, ops)
    want = dg_mxu.km_adj_est_plain(traj, uf, lam, 0.0, ops)
    plans = []
    for s_f in (4, 8):
        for threads in (512, 1024) if disc.np_ <= 6 else (512,):
            widest = dg_rhs.fused_plan(k, s_f, threads)
            third = max(widest.tile // 3, 1)
            plans += [widest, widest._replace(tile=third, n_tiles=-(-k // third))]
    plans.append(dg_rhs.fused_plan(k, 4, 512)._replace(tile=7, n_tiles=-(-k // 7)))
    for plan in plans:
        lam0, eta, n_cuda = dg_mxu._km2_launch(traj, uf, lam, 0.0, ops, plan)
        torch.cuda.synchronize()
        assert n_cuda == -(-n // plan.segment)
        assert torch.equal(lam0, want[0]) and torch.equal(eta, want[1]), plan
    if disc.np_ > 6:
        with pytest.raises(RuntimeError, match="dg_mxu_rev failed"):
            dg_mxu._km2_launch(traj, uf, lam, 0.0, ops, dg_rhs.fused_plan(k, 4, 1024))


@pytest.mark.parametrize("n_order,k", [(1, 300), (2, 1000), (5, 200), (7, 1000)])
def test_mxu_forward_on_every_plan(device, n_order, k):
    """KM1 on every plan km_fwd_plan searches (s_f 4, 8 and 13 at 13 steps,
    512- and 1024-thread CTAs, the untiled CTA where K fits, every tiling)
    and on narrow tiles: each the plain version's bits (trajectory and
    u_final), in ⌈13/s_f⌉ CUDA launches; a window one ghost short of 5·s_f
    refused."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu

    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    b, n = 3, 13
    dt = 0.375 / A * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_mxu.mxu_ops(disc, A, dt, n, 1, b, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.concatenate([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    want = dg_mxu.km_fwd_traj_plain(u0, 0.0, ops)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plans = list(dg_rhs._window_plans(k, b, n, sms))
    plans.append(dg_rhs.fwd_fused_plan(k, 4, 512)._replace(tile=7, n_tiles=-(-k // 7)))
    for plan in plans:
        traj, uf, n_cuda = dg_mxu._km1_launch(u0, 0.0, ops, plan)
        torch.cuda.synchronize()
        assert n_cuda == -(-n // plan.segment)
        assert torch.equal(traj, want[0]) and torch.equal(uf, want[1]), plan
    with pytest.raises(RuntimeError, match="dg_mxu_fwd failed"):
        dg_mxu._km1_launch(u0, 0.0, ops, dg_rhs.FusedPlan(4, 19, 100, -(-k // 100), 512))


def test_sharded_pipelines_at_one_rank_are_the_tiled_bits(device):
    """No process group: both sharded factories run KT1/KT2 per segment on
    the whole mesh and give the single-process tiled pipeline's bits."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_sharded, dg_tiled
    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    disc = startup_1d(2, 0.0, 2 * np.pi, 4096)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt = 0.5 * (0.75 / A) * xmin
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    want = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
        disc, A, dt, segment=4, n_segments=4, chunks=4, device=device)(u0, 0.0, lam)
    grid = make_rank_grid()
    before = dg_tiled.tiled_fwd_seg.launches, dg_tiled.tiled_rev_seg.launches
    for make in (dg_sharded.make_cuda_fwd_adj_estimate_sharded_blocked,
                 dg_sharded.make_cuda_fwd_adj_estimate_tiled_grid_sharded):
        got = make(disc, A, dt, grid, segment=4, n_segments=4, device=device)(u0, 0.0, lam)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (dg_tiled.tiled_fwd_seg.launches - before[0],
            dg_tiled.tiled_rev_seg.launches - before[1]) == (8, 8)


# ----------------------------- a caller's callables traced into functors

def _logistic(u, t):  # u(1 − u) + 0.1·cos(2t), in no registry; u stays in (0, 1)
    return u * (1 - u) + 0.1 * torch.cos(2 * t)


def _inverse(u, t):  # g_u = 1/u (J = ∫log u), singular at H1's zero padding nodes
    return 1.0 / u


def test_traced_fd_kernels_match_their_plain_versions(device):
    """F1 (f and its f_u), F2 (Van der Pol; its Jacobian's literal 0.0
    skipped) and F3 on traced functors (ops/cuda/functor.py), each within
    fd_kernel_tolerance of its plain version, the bound with teeth."""
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=device)
    s, rf = 8, 4
    f_u = lambda u, t: 1 - 2 * u  # noqa: E731
    u0 = torch.tensor(rng.uniform(0.2, 0.8, 2048), **f32)
    run = fe.make_cuda_fd_ensemble(f=_logistic, f_u=f_u, n_steps=s, ref_factor=rf, dt=0.25,
                                   device=device)
    stats = {}
    want = fe.fd_ensemble_plain(u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf)
    assert float((run(u0) - want).abs().max()) <= tol and bool((want.abs() > tol).any())
    u0v = torch.tensor(rng.uniform(-1.5, 1.5, (2048, 2)), **f32)
    run = fe.make_cuda_fd_ensemble_vec(
        f_comps=lambda us, t: (us[1], (1.0 - us[0] * us[0]) * us[1] - us[0]),
        jac_comps=lambda us, t: ((0.0, 1.0), (-2.0 * us[0] * us[1] - 1.0, 1.0 - us[0] * us[0])),
        d=2, n_steps=s, ref_factor=rf, dt=0.25, device=device)
    stats = {}
    want = fe.fd_ensemble_vec_plain(u0v, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf, d=2)
    assert float((run(u0v) - want).abs().max()) <= tol and bool((want.abs() > tol).any())
    dt_b = torch.tensor(rng.uniform(0.05, 0.4, (256, s)), **f32)
    dt_b[::3, -2:] = 0.0  # zero-width padding steps
    u0 = u0[:256].contiguous()
    run = fe.make_cuda_fd_estimate_per_member(f=_logistic, f_u=f_u, n_steps=s, ref_factor=rf,
                                              device=device)
    err, _ = run(dt_b, u0)
    stats = {}
    want, _ = fe.fd_estimate_per_member_plain(dt_b, u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf)
    assert float((err - want).abs().max()) <= tol and bool((want.abs() > tol).any())
    assert bool((err[dt_b == 0] == 0).all())


@pytest.mark.parametrize("mode", ["solve", "reconstruct"])
def test_traced_dg_kernels_match_their_plain_versions(device, mode):
    """D1 and H1 on a traced f (f_u derived on Dual<float>) and g_u = 1/u
    within their per-element bounds; g_u stays finite at H1's padding."""
    rng = np.random.default_rng(4)
    f32 = dict(dtype=torch.float32, device=device)
    b, k = 256, 6
    t = np.full((b, k + 1), 2.0)
    ns = np.ones((b, k), np.int64)
    for m in range(b):
        live = int(rng.integers(2, k + 1))
        t[m, : live + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, live - 1)), [2.0]])
        ns[m, :live] = rng.integers(1, 4, live)
    times, y0 = torch.tensor(t, **f32), torch.tensor(rng.uniform(0.2, 0.8, b), **f32)
    run = ds.make_cuda_dg_estimate_ensemble(ops_p=dg_time_operators(1), ops_a=dg_time_operators(2),
                                            f=_logistic, n_elements=k, newton_iters=6,
                                            g_u=_inverse, device=device)
    want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
    tol = ds.dg_kernel_tolerance(times, y0, want, run.plan)
    for name, g, w in zip(("u", "v", "err"), run(times, y0), want):
        assert bool(((g - w).abs().double() <= tol[name]).all()), name
    assert bool((want[2].abs() > tol["err"]).any())
    mops = dg_time_operators_mixed(5)
    run = hm.make_cuda_dg_estimate_hp_per_member(
        mops=mops, interp=dg_adjoint_interp_mixed(mops), f=_logistic, n_elements=k,
        n_max_user=3, fine_offset=2, adjoint_mode=mode, rad=dg_radau_interp_mixed(mops),
        g_u=_inverse, device=device)
    ns = torch.tensor(ns, device=device)
    got = run(times, ns, y0)
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, want, run.plan)
    for name, g, w in zip(("u_c", "u_f", "v", "err"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert bool(((g - w).abs().double() <= tol[name]).all()), name
    assert bool((want[3].abs() > tol["err"]).any())


def test_untraceable_callables_raise_on_the_card(device):
    """A reduction is no elementwise op: every entry point raises, nothing
    launches, nothing falls back to the plain version."""
    def bad(u, t):
        return torch.sum(u) * u

    before = (fe.fd_ensemble.launches, ds.dg_estimate_ensemble.launches)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        fe.make_cuda_fd_ensemble(f=bad, f_u=bad, n_steps=4, ref_factor=2, dt=0.1, device=device)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        ds.make_cuda_dg_estimate_ensemble(ops_p=dg_time_operators(1),
                                          ops_a=dg_time_operators(2), f=_logistic, g_u=bad,
                                          device=device)
    assert (fe.fd_ensemble.launches, ds.dg_estimate_ensemble.launches) == before


# ------------------------------------------ high order: Np 9-16 (N = 8-15)


def _high_inputs(disc, b, device, seed):
    """Phased sines with 0.5·U(−1, 1) nodal noise and a noisy J = ∫u
    cotangent, (Np, B, K) float32 (η above its bound: chip_smoke.py's
    high_inputs)."""
    rng = np.random.default_rng(seed)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = np.stack([np.sin(disc.x + p) + 0.5 * rng.uniform(-1, 1, disc.x.shape) for p in phases], 1)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy()
    lam = np.stack([lam * (1 + 0.5 * rng.uniform(-1, 1, lam.shape)) for _ in range(b)], 1)
    return (torch.tensor(u0, dtype=torch.float32, device=device),
            torch.tensor(lam, dtype=torch.float32, device=device))


def _advec_tolerances(n_steps, np_, u, lam):
    """chip_smoke.py's tolerances (Np/8 above Np = 8)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import tolerances

    return tolerances(n_steps, np_, u, lam)


@pytest.mark.parametrize("n_order,k,b", [(8, 300, 3), (11, 70, 2), (15, 1000, 1)])
def test_high_order_advection_kernels(device, n_order, k, b):
    """K1 (trajectory and checkpoints), K2, K2r and KA at Np 9, 12 and 16 on
    the plans the wrappers pick (K2 on 512 threads): within chip_smoke.py's
    tolerances of their plain versions (Np/8 above Np = 8) with teeth; K2r
    K2's bits and the checkpoints the trajectory's; ⌈n_steps/s_f⌉ CUDA
    launches; narrower tiles the same bits. Uniform meshes at the driver's
    step 0.75·x_min/a: on a graded mesh, or at half the step, η lies below
    its bound."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    ops = dg_rhs.kernel_ops(disc, A, 0.75 / A * xmin, device)
    u0, lam = _high_inputs(disc, b, device, n_order)
    n_steps, segment, np_ = 13, 1, disc.np_
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    traj, uf = dg_rhs.fwd_march(u0, 0.1, n_steps, ops, store_trajectory=True)
    plan = dg_rhs.forward_plan(k, b, np_, n_steps, 1, sms)
    assert dg_rhs.stored_plan(k, b, np_, n_steps, sms).threads == 512
    assert dg_rhs.fwd_march.cuda_launches == -(-n_steps // plan.segment)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops)
    ckpts, uf_c = dg_rhs.fwd_march_ckpt(u0, 0.1, n_steps, segment, ops)
    lam0_r, eta_r = dg_rhs.adj_est_recompute(ckpts, lam, 0.1, segment, ops)
    lam_a = dg_rhs.adj_march(lam, n_steps, ops)
    torch.cuda.synchronize()
    assert torch.equal(ckpts, traj) and torch.equal(uf_c, uf)
    assert torch.equal(lam0_r, lam0) and torch.equal(eta_r, eta)
    traj_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, True)
    lam0_p, eta_p = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.1, ops)
    lam_ap = dg_rhs.adj_march_plain(lam, n_steps, ops)
    tol = _advec_tolerances(n_steps, np_, uf_p, lam)
    for got, want, key in ((traj, traj_p, "u"), (uf, uf_p, "u"), (lam0, lam0_p, "lam"),
                           (eta, eta_p, "eta"), (lam_a, lam_ap, "lam")):
        assert float((got - want).abs().max()) <= tol[key], key
        assert bool((want.abs() > tol[key]).any()), key
    lib = load_library()
    narrow = dg_rhs.fwd_fused_plan(k, 1, 512)._replace(tile=7, n_tiles=-(-k // 7))
    store = torch.empty_like(traj)
    got, n_cuda = dg_rhs._k1_launch(lib, u0, 0.1, n_steps, store, 1, ops, narrow)
    assert n_cuda == n_steps and torch.equal(got, uf) and torch.equal(store, traj)
    assert torch.equal(dg_rhs._ka_launch(lam, n_steps, ops, narrow)[0], lam_a)
    narrow_r = dg_rhs.fused_plan(k, 1, 512)._replace(tile=5, n_tiles=-(-k // 5))
    assert all(torch.equal(x, y) for x, y in
               zip(dg_rhs._k2_launch(traj, uf, lam, 0.1, ops, narrow_r)[:2], (lam0, eta)))


@pytest.mark.parametrize("n_order,k", [(8, 48), (11, 300), (15, 100)])
def test_high_order_burgers_kernel(device, n_order, k):
    """B1 at Np 9, 12 and 16 on the plans the wrapper picks (512 threads;
    the ring at K = 48): float64 within 1e-12·|plain| + 1e-13, float32
    before the shock within 8·n_steps·ε₃₂·max|u0|, for the three limiters."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    dt = 0.3 * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    u0 = np.stack([(0.5 + 0.05 * j) * np.sin(disc.x) for j in range(4)], axis=1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for limiter in ("n", "1", "none"):
        tab = cb.burgers_tables(disc, dt, limiter, device)
        for dtype in (torch.float64, torch.float32):
            x = torch.tensor(u0, dtype=dtype, device=device)
            plan = cb.burgers_plan(k, 4, disc.np_, 24, limiter, dtype == torch.float64, sms)
            assert plan.threads == 512
            got = cb.burgers_march(x, 24, tab)
            want = cb.burgers_march_plain(x, 24, tab)
            bound = (1e-12 * want.abs() + 1e-13 if dtype == torch.float64
                     else 8 * 24 * EPS32 * float(x.abs().max()))
            assert bool(((got - want).abs() <= bound).all()), (limiter, dtype)
            assert cb.burgers_march.cuda_launches == -(-24 // plan.segment)


def test_high_order_kernels_refuse_what_they_do_not_take(device):
    """At Np 9: K1 and KA with ghosts short of 5·s_f, K2 short of 10·s_f +
    10, B1 float64 on 1024 threads; Np 17 before any launch."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    disc = startup_1d(8, 0.0, 2 * np.pi, 600)
    ops = dg_rhs.kernel_ops(disc, A, 1e-4, device)
    u0 = torch.zeros((9, 1, 600), device=device)
    lib = load_library()
    short = dg_rhs.FusedPlan(2, 9, 400, 2, 512)
    with pytest.raises(RuntimeError, match="K1 plan out of range"):
        dg_rhs._k1_launch(lib, u0, 0.0, 4, None, 1, ops, short)
    with pytest.raises(RuntimeError, match="KA plan out of range"):
        dg_rhs._ka_launch(u0, 4, ops, short)
    with pytest.raises(RuntimeError, match="fused plan out of range"):
        dg_rhs._k2_launch(torch.zeros((4, 9, 1, 600), device=device), u0, u0, 0.0, ops,
                          dg_rhs.FusedPlan(1, 19, 400, 2, 512))
    tab = cb.burgers_tables(disc, 1e-4, "n", device)
    with pytest.raises(RuntimeError, match="plan refused"):
        cb._b1_launch(u0.double(), 4, tab, cb.BurgersPlan(1, 10, 12, 50, 1024))
    with pytest.raises(ValueError, match="MAX_NP = 16"):
        dg_rhs.kernel_ops(startup_1d(16, 0.0, 2 * np.pi, 8), A, 1e-4, device)
