"""F2 at d = 5-15 (ops/cuda/fd_ensemble.py): the vector FD signal on the
states JAX's ``make_pallas_fd_ensemble_vec`` takes past the register
design, on the CPU.

- The plain version on traced Lorenz-96 (chip_smoke.py ``lorenz96``: d = 5
  at 8 steps, d = 8 at 3 steps, rf 4) and the dense d = 15 system
  (``dense_system``, every Jacobian entry live, 1 step at rf 3) against
  JAX's kernel in interpret mode on 20,480 ICs (its multiple) in float64 at
  tests/test_pallas.py:537's rtol 1e-9, atol 1e-13: the same float64
  quantities in another operation order. Fewer steps and a smaller rf
  than phase 44's: XLA's compile of the interpreted kernel grows faster than its
  length on the CPU (d = 5: 5.1 s at 6 steps, 6.9 s at 8, past 300 s at
  16; d = 15 at 1 step: 6.6 s at rf 4, 20 s at rf 8, past 300 s at rf 16).
- The limits: every (d, n_steps) that JAX's scoped-VMEM check admits
  (fd_ensemble.py:326-334, d = 5 up to 18 steps ... d = 15 at 1) gets a
  launch whose shared memory fits a block, at any rf: the register design
  where a node's table fits F2_REG_ROW, else the window design; d = 16, and
  for the card a step count past its shared memory, raise a ValueError
  naming the limit before any build or launch; on the CPU the plain version
  takes that step count.
- The tolerance has teeth at every d of the cases: float32 plain entries
  lie above fd_kernel_tolerance(…, d), so an err of 0 fails, and the
  float64 plain version lies within it.
- The generated functors of Lorenz-96 (d = 8) and the dense system
  (d = 15) built by g++ as ``OdeTracedVec`` against a stub
  ``cuda_runtime.h`` (one build): f and the Jacobian within a few float32
  ulps of the callables, ``nonzero`` Lorenz-96's 4-a-row pattern.

The kernels themselves run on a GPU only (chip_smoke.py phase 44,
tests/test_torch_cuda.py)."""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.ops.pallas.fd_ensemble import make_pallas_fd_ensemble_vec
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import functor

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the systems phase 44 runs)

CSRC = Path(functor.__file__).resolve().parents[2] / "csrc"
# (system, d, steps, rf, dt): chip_smoke.py WIDE_CASES, and JAX's shorter ones
CASES = {f"{name}-{d}": (name, d, s, rf, dt) for _, name, d, s, rf, dt in chip_smoke.WIDE_CASES}
JAX_CASES = {"lorenz96-5": ("lorenz96", 5, 8, 4, 0.0125),
             "lorenz96-8": ("lorenz96", 8, 3, 4, 0.0125),
             "dense-15": ("dense", 15, 1, 3, 0.1)}


def _system(name, d, xp=None):
    return chip_smoke.lorenz96(d) if name == "lorenz96" else chip_smoke.dense_system(d, xp)


def _run(name, d, s, rf, dt):
    comps, jac = _system(name, d)
    return fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=s,
                                        ref_factor=rf, dt=dt, device="cpu")


_jax_admitted = chip_smoke.jax_admitted_steps


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_plain_matches_the_pallas_kernel_in_float64(case):
    name, d, s, rf, dt = JAX_CASES[case]
    u0s = chip_smoke.wide_u0(name, 20_480, d)
    comps, jac = _system(name, d, jnp)
    want = np.asarray(make_pallas_fd_ensemble_vec(comps, jac, d, s, rf, dt=dt,
                                                  interpret=True)(jnp.asarray(u0s)))
    run = _run(name, d, s, rf, dt)
    assert f"OdeTracedVec<{d}," in run.plan.functors.header
    assert run.plan.functors.nnz == (4 * d if name == "lorenz96" else d * d)
    got = run(torch.tensor(u0s, dtype=torch.float64))
    assert got.shape == (s, 20_480)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-13)


def test_jax_admits_what_its_vmem_check_reads():
    """JAX's scoped-VMEM check read out: d = 5 up to 18 steps, 6 up to 14, 8
    up to 9, 10 up to 5, 12 up to 3, 15 at 1, 16 never."""
    assert {d: _jax_admitted(d) for d in (5, 6, 8, 10, 12, 15, 16)} == {
        5: 18, 6: 14, 8: 9, 10: 5, 12: 3, 15: 1, 16: 0}


@pytest.mark.parametrize("rf", [1, 4, 16, 64])
def test_every_jax_admitted_pair_gets_a_launch_that_fits(rf):
    """At every d of 5-15 and every step count JAX admits there, dense (d²
    live entries) or Lorenz-96's 4d, at 102,400 and 4,096 ICs: the register
    design where a node's table 2d + nnz is at most F2_REG_ROW, else a
    window launch of G >= d lanes and W = 8 in 64-thread CTAs; either fits
    a block."""
    for d in range(5, 16):
        for s in range(1, _jax_admitted(d) + 1):
            for nnz in (4 * d, d * d):
                assert s <= fe.f2_max_steps(rf, d, nnz)
                for n_ics in (102_400, 4096):
                    launch = fe.f2_plan(n_ics, s, rf, fe.H100_SMS, d, nnz)
                    assert fe.f2_smem(launch, s, rf, d, nnz) <= fe.MAX_SMEM
                    if fe.f2_registers(d, nnz):
                        assert launch == fe.fd_ens_plan(n_ics, s, rf, fe.H100_SMS, d)
                        continue
                    assert launch == fe.FdVecLaunch(8 if d <= 8 else 16, 64, 8)


@pytest.mark.parametrize("d,steps", [(5, 18), (8, 9), (10, 5), (15, 1)])
def test_the_entry_point_takes_jax_admitted_pairs(d, steps):
    """make_cuda_fd_ensemble_vec takes JAX's largest step count at d (the
    dense system's d², Lorenz-96's 4d live entries), and its plan's launch
    fits a block; the rows are odd."""
    for name in ("lorenz96", "dense"):
        run = _run(name, d, steps, 4, 0.0125)
        kf = run.plan.functors
        launch = fe.f2_plan(20_480, steps, 4, fe.H100_SMS, d, kf.nnz)
        assert fe.f2_smem(launch, steps, 4, d, kf.nnz) <= fe.MAX_SMEM
        assert fe.vec_row(d, kf.nnz) % 2 == 1
        assert fe.vec_row(d, kf.nnz) - (2 * d + kf.nnz) in (0, 1)


def test_the_designs_by_node_table():
    """The register design keeps d <= 4 (fd_ens_plan's launch, U = 4) and
    takes the tables that held in registers on the card (Lorenz-96 up to
    d = 8, the dense system up to d = 6); the window design the rest."""
    for d in (2, 3, 4):
        assert fe.f2_registers(d, d * d)
        assert fe.f2_plan(102_400, 16, 4, fe.H100_SMS, d, d * d) == fe.fd_ens_plan(
            102_400, 16, 4, fe.H100_SMS, d)
    assert [fe.f2_registers(d, 4 * d) for d in (5, 6, 8, 9, 15)] == [True] * 3 + [False] * 2
    assert [fe.f2_registers(d, d * d) for d in (5, 6, 7, 15)] == [True, True, False, False]
    assert fe.f2_plan(102_400, 1, 16, fe.H100_SMS, 15, 225) == fe.FdVecLaunch(16, 64, 8)
    assert fe.f2_plan(102_400, 9, 4, fe.H100_SMS, 8, 64) == fe.FdVecLaunch(8, 64, 8)
    # a trajectory past the register plan's CTA takes one IC a CTA
    assert fe.f2_plan(102_400, 5000, 4, fe.H100_SMS, 5, 20) == fe.REG_LEAST


def test_d16_and_steps_past_shared_memory_raise_naming_the_limit():
    comps, jac = chip_smoke.lorenz96(16)
    with pytest.raises(ValueError, match="at most d=15"):
        fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=16, n_steps=1,
                                     ref_factor=4, dt=0.01, device="cpu")
    most = fe.f2_max_steps(16, 15, 225)
    assert most > 1000  # far past JAX's one step at d = 15
    assert fe.vec_window_smem(fe.VEC_LEAST, most, 16, 15, 225) <= fe.MAX_SMEM
    assert fe.vec_window_smem(fe.VEC_LEAST, most + 1, 16, 15, 225) > fe.MAX_SMEM
    comps, jac = chip_smoke.lorenz96(5)  # the register design: one IC's trajectory
    most5 = fe.f2_max_steps(4, 5, 20)
    assert fe.ens_smem(fe.REG_LEAST, most5, 4, 5) <= fe.MAX_SMEM
    # refused for the card before any build or launch (here, before the
    # missing card is named)
    with pytest.raises(ValueError, match=f"at most {most5} steps"):
        fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=5, n_steps=most5 + 1,
                                     ref_factor=4, dt=1e-4, device="cuda")
    comps, jac = chip_smoke.dense_system(15)
    with pytest.raises(ValueError, match=f"at most {most} steps"):
        fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=15, n_steps=most + 1,
                                     ref_factor=16, dt=1e-4, device="cuda")
    run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=15, n_steps=most,
                                       ref_factor=16, dt=1e-4, device="cpu")
    launch = fe.f2_plan(4, most, 16, fe.H100_SMS, 15, 225)
    assert fe.vec_window_smem(launch, most, 16, 15, 225) <= fe.MAX_SMEM
    assert run.plan.n_steps == most


def test_the_cpu_plain_version_takes_steps_past_the_card_limit(monkeypatch):
    """The limit is the card's: at device='cpu' the entry point takes a step
    count past it and the plain version runs it. At the real limit (11,621
    steps at d = 5, rf 4) the plan alone; with a block of 1 KiB (a limit of
    a few dozen steps) the run too, against the card's refusal there."""
    comps, jac = chip_smoke.lorenz96(5)
    most = fe.f2_max_steps(4, 5, 20)
    run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=5, n_steps=most + 1,
                                       ref_factor=4, dt=1e-4, device="cpu")
    assert run.plan.n_steps == most + 1
    monkeypatch.setattr(fe, "MAX_SMEM", 1024)
    most = fe.f2_max_steps(4, 5, 20)
    assert 1 <= most < 64
    with pytest.raises(ValueError, match=f"at most {most} steps"):
        fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=5, n_steps=most + 1,
                                     ref_factor=4, dt=0.0125, device="cuda")
    run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=5, n_steps=most + 1,
                                       ref_factor=4, dt=0.0125, device="cpu")
    u0 = torch.tensor(chip_smoke.wide_u0("lorenz96", 8, 5), dtype=torch.float64)
    err = run(u0)
    assert err.shape == (most + 1, 8) and bool(torch.isfinite(err).all())
    assert float(err.abs().max()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_the_tolerance_has_teeth(case):
    """At 64 ICs of the case's own draws, float32 plain entries lie above
    fd_kernel_tolerance(…, d) (an err of 0 fails) and the float64 plain
    version lies within it."""
    name, d, s, rf, dt = CASES[case]
    run = _run(name, d, s, rf, dt)
    u0 = torch.tensor(chip_smoke.wide_u0(name, 64, d), dtype=torch.float32)
    stats = {}
    err = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
    tol = fe.fd_kernel_tolerance(stats, rf, d)
    assert int((err.abs() > tol).sum()) >= 32
    err64 = fe.fd_ensemble_vec_plain(u0.double(), run.plan)
    assert float((err.double() - err64).abs().max()) <= tol


STUB = """#pragma once
#include <cmath>
#define __host__
#define __device__
#define __forceinline__ inline
"""


@pytest.fixture(scope="module")
def gxx_vec():
    """One g++ build of Lorenz-96 at d = 8 and the dense system at d = 15 as
    OdeTracedVec (their generated headers' structs): extern "C"
    ``l96(u, f, jac, n)``, ``dense(u, f, jac, n)`` and ``l96_nonzero(m, i)``."""
    import tempfile

    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the generated functors on the CPU"
    root = Path(tempfile.mkdtemp(prefix="fd_vec_wide_"))
    (root / "stub").mkdir()
    (root / "stub" / "cuda_runtime.h").write_text(STUB)
    kinds = {"l96": (8, chip_smoke.lorenz96(8)), "dense": (15, chip_smoke.dense_system(15))}
    structs, body = {}, ['#include "odes.cuh"', "using namespace aoa;", 'extern "C" {']
    for kind, (d, (comps, jac)) in kinds.items():
        tf, tj = functor.trace(comps, d), functor.trace(jac, d, jacobian=True)
        structs.update({functor.struct_name(x): functor.cuda_struct(x) for x in (tf, tj)})
        ode = f"OdeTracedVec<{d}, {functor.struct_name(tf)}, {functor.struct_name(tj)}>"
        body.append(f"void {kind}(const float* u, float* f, float* jac, int n) {{ OdeConsts k{{}}; "
                    f"for (int i = 0; i < n; ++i) {ode}::pair(u + {d} * i, 0.f, k, f + {d} * i, "
                    f"jac + {d * d} * i); }}")
        body.append(f"int {kind}_nonzero(int m, int i) {{ return {ode}::nonzero(m, i); }}")
    body.append("}")
    (root / "aoa_user_functors.cuh").write_text("\n".join(structs.values()))
    (root / "vec.cpp").write_text("\n".join(body) + "\n")
    out = root / "libvec.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-DAOA_USER_FUNCTORS", "-I", str(root / "stub"), "-I", str(root), "-I", str(CSRC),
         str(root / "vec.cpp"), "-o", str(out)],
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    yield ctypes.CDLL(str(out))
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("kind", ["l96", "dense"])
def test_gxx_vector_functor_matches_the_callables_in_float32(gxx_vec, kind):
    d = 8 if kind == "l96" else 15
    comps, jac = chip_smoke.lorenz96(8) if kind == "l96" else chip_smoke.dense_system(15)
    us = chip_smoke.wide_u0("lorenz96" if kind == "l96" else "dense", 33, d).astype(np.float32)
    f, j = np.zeros_like(us), np.zeros((33, d * d), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    getattr(gxx_vec, kind)(ptr(us), ptr(f), ptr(j), ctypes.c_int(33))
    ut = tuple(torch.from_numpy(us[:, c]) for c in range(d))
    t = torch.zeros((), dtype=torch.float32)
    want_f = torch.stack([torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32), (33,))
                          for x in comps(ut, t)], dim=-1).numpy()
    want_j = torch.stack([torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32), (33,))
                          for row in jac(ut, t) for x in row], dim=-1).numpy()
    # a sum of d float32 products (and sin/cos by libm against torch): a few
    # ulps of its largest term
    scale_f = np.abs(us).max() * (np.abs(us).max() if kind == "l96" else 1.5)
    assert np.abs(f - want_f).max() <= 8 * d * np.finfo(np.float32).eps * scale_f
    np.testing.assert_allclose(j, want_j, rtol=4 * np.finfo(np.float32).eps, atol=0)
    if kind == "l96":
        live = [[bool(gxx_vec.l96_nonzero(m, i)) for i in range(8)] for m in range(8)]
        assert live == [[i in {m, (m + 1) % 8, (m - 1) % 8, (m - 2) % 8} for i in range(8)]
                        for m in range(8)]
    else:
        assert all(gxx_vec.dense_nonzero(m, i) for m in range(15) for i in range(15))
