#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's main path (adjoint_ode_adaptivity_tpu_torch) phase by
phase and prints what each phase found on its own line. Any failing phase
raises, and the script exits non-zero; nothing is caught.

0. The card's name and power limit (nvidia-smi); exit 1 without a CUDA
   device. TF32 is switched off and checked.
1. Build the CUDA kernels from csrc/ with nvcc (cached by source hash).
2. Each kernel against its plain PyTorch version on the same inputs, float32:
   (a) graded mesh N=2, K=24, B=8; (b) N=7, K=24, B=8; (c) K=10^4, N=2, B=8;
   after phase 3, (d) the last graded mesh of the adaptive study at B=1.
3. The main path through its entry point, ``drivers.advec_dg.main(["--adapt",
   "--kernel", "cuda", ...])``, with the kernels' launch counts; the same study
   with ``--kernel torch`` (float32 eager on the card); each mesh of the CUDA
   study replayed through the eager engine; the refinement decisions of both
   engines on a configuration whose indicator lies above float32 roundoff;
   one ``--estimate --kernel cuda`` run; and the driver's plain march
   (``--kernel cuda --k 512``, K1 at B=1) with its launch count.
4. The headline pipeline (K=10^4, N=2, 2048 steps, B=8, stored trajectory),
   timed with CUDA events for the kernels and for their plain versions; and
   K1 at the plain march's shape against its plain version, timed likewise.
5. The float64 effectivity identity Ση = J(u_dt) − J(u_dt/2) on the
   headline mesh and step (B=1), on bench.py's effectivity problem
   (u0 = sin(800x), J over [π, π+1], 64 steps), through the plain path, to
   1e-10 relative.
6. Each FD kernel (csrc/fd_ensemble.cu) against its plain version, float32:
   (a) sin(u) at 102,400 ICs, 16 steps, rf 4, trig libm and fast; (b) a
   graded dt vector; (c) gaussian_mixture, and the other scalar ODEs at
   4,096 ICs; (d) the d=2 harmonic oscillator at 102,400 ICs; (e) the
   per-member kernel at B=1024, 43 steps, padded tails, both conventions.
7. The FD paths through their entry points: ``drivers.fd_adaptive.main(
   ["--ensemble", "1024", "--engine", "cuda", "--device-loop", "--tol", "0",
   "--maxit", "40"])`` with the per-member kernel's launch count, every
   iteration's grid replayed through the plain version and the torch
   engine; the ensemble refinement signal through make_cuda_fd_ensemble(_vec);
   and the single-run fd_adaptive default.
8. CUDA-event times of each FD kernel and its plain version at the phase-6
   shapes, and of the B=1024 study with each engine.
9. The DG slab kernel (csrc/dg_slab.cu) against its plain version, float32:
   (a) order 1 at bench.py's shapes (B=16,384, K=16, t in [0, 2], y0 ~
   U(0.5, 2) seed 1, 5 Newton steps), libm and fast trig; (b) orders 2 and
   4 (Cramer and elimination) at B=1024; (c) per-member partitions with
   zero-width tails, whose contributions are exactly 0; (d) t*sin(u) and
   gaussian_mixture at 4,096 members; (e) B=102,400, seed 3.
10. The DG-in-time paths through their entry points: ``drivers.dg_adaptive.
   main(["--ensemble", "1024", "--per-member", "--device-loop"])`` with the
   kernel's launch count, every iteration's partitions replayed through the
   plain version (float32) and the torch engine (float64), the decisions
   compared where the top-two margin clears the float32 bound;
   ``--ensemble 1024`` on the shared partition; and the single-run default
   ``dg_adaptive --maxit 30`` in float64 on the card against ``--device cpu``.
11. CUDA-event times of the DG slab kernel and its plain version at 9(a)
   (libm and fast), 9(e) and 9(c), and of the B=1024 ensemble and per-member
   studies (bench.py's k0 4, maxit 10, tol 0, 8 Newton steps) with each
   engine.
12. The hp kernel (csrc/dg_slab_mixed.cu) against its plain version,
   float32, in both adjoint modes: (a) bench.py's hp shape (B=512, seed 5,
   per-member partitions over K=15 slabs with zero-width tails, orders 1..3,
   stack np_max 6, 8 Newton steps); (b) B=4096, seed 6; (c) np_max 8 at
   B=1024; (d) t*sin(u) and gaussian_mixture at B=4096; (e) uniform orders
   1..3 against the DG slab kernel on the same Gauss rule. Tails contribute
   exactly 0.
13. The hp paths through their entry points: the main path ``drivers.
   dg_adaptive.main(["--hp", "hp", "--ensemble", "512", "--seed", "5",
   "--per-member", "--device-loop", ...])`` (bench.py's hp study) with the
   kernel's launch count, every iteration replayed through the plain
   version (float32) and the torch engine (float64), decisions compared
   where the top-two margin clears the float32 bound; the same with
   ``--adjoint reconstruct``; the shared-partition ensemble signal; and the
   float64 single run ``--hp p --k0 4 --n-max 4 --tol 1e-9`` on the card
   against ``--device cpu``.
14. CUDA-event times of the hp kernel and its plain version at 12(a) and
   12(b) in each adjoint mode, and of the B=512 and B=4096 per-member hp
   studies with each engine; a torch.profiler trace of one B=512 study (the
   device's busy share, the kernel's share of it, the host's launches,
   synchronisations and copies).

The line before the last is a JSON object with each kernel's launches on
its path, error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "adjoint_ode_adaptivity_tpu_torch"
A = 6.283185307179586  # 2π
HEADLINE = dict(n_order=2, k=10_000, n_steps=2048, batch=8)
EFFECTIVITY_STEPS = 64  # bench.py:410's effectivity run on the headline mesh
SOURCES = {
    "fwd_march": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_est_stored": f"{PACKAGE}/csrc/dg_rhs.cu",
    "fd_ensemble": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "fd_ensemble_vec": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "fd_estimate_per_member": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "dg_estimate_ensemble": f"{PACKAGE}/csrc/dg_slab.cu",
    "dg_estimate_hp_per_member": f"{PACKAGE}/csrc/dg_slab_mixed.cu",
}
TPU_KERNELS = {
    "fwd_march": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:981",
    "adj_est_stored": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:1108",
    "fd_ensemble": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:61",
    "fd_ensemble_vec": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:201",
    "fd_estimate_per_member": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:357",
    "dg_estimate_ensemble": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab.py:92",
    "dg_estimate_hp_per_member": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab_mixed.py:99",
}
# the JAX package's benchmark shapes: the ensemble refinement signal and its
# d=2 sibling (utils/flops.py:100-104) and the per-member study (bench.py:824-833)
FD_ENSEMBLE = dict(n_ics=102_400, n_steps=16, rf=4, dt=2.0 / 16)
FD_STUDY = dict(b=1024, maxit=40, n_steps0=2, t1=2.0, rf=4)
FD_PM_STEPS = FD_STUDY["n_steps0"] + FD_STUDY["maxit"] + 1  # max_nodes − 1
EPS32 = 2.0**-23
# the JAX package's DG-slab benchmark shapes: the ensemble pipeline
# (bench.py:589-608), its 102,400-member scale (bench.py:785-807) and the
# B=1024 adaptive studies (bench.py:696-780)
DG_SLAB = dict(b=16_384, k=16, t1=2.0, newton_iters=5, seed=1)
DG_SLAB_BIG = dict(b=102_400, seed=3)
DG_STUDY = dict(b=1024, k0=4, maxit=10, tol=0.0, newton_iters=8, seed=2)
# the JAX package's hp benchmark (bench.py:853-1006): the per-member hp study
# at B = 512 (y0 ~ U(0.5, 2) seed 5) and B = 4096 (seed 6), k0 4, orders
# 1..3 (stack n_max 5, np_max 6), maxit 10, tol 0, 8 Newton steps, sin u on [0, 2]
HP_STUDY = dict(b=512, seed=5, k0=4, n_max=3, fo=2, maxit=10, newton_iters=8, t1=2.0)
HP_BIG = dict(b=4096, seed=6)
HP_K = HP_STUDY["k0"] + HP_STUDY["maxit"] + 1
HP_ARGV = ["--hp", "hp", "--ensemble", "512", "--seed", "5", "--k0", "4", "--order", "1",
           "--n-max", "3", "--maxit", "10", "--tol", "0", "--newton-iters", "8"]
# one H100 SXM at its full power limit (NVIDIA data sheet, dense FP32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mesh(n_order, k, graded):
    import numpy as np

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** (1.6 if graded else 1.0)
    return startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)


def cfl_step(disc):
    import numpy as np

    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    return 0.5 * (0.75 / A) * xmin  # bench.py's CFL-stable step


def phased_states(disc, batch, device, dtype):
    """B phase-shifted sine ICs as (Np, B, K) (bench.py's batched ICs)."""
    import numpy as np
    import torch

    phases = np.linspace(0.0, 2 * np.pi, batch, endpoint=False)
    u0 = np.stack([np.sin(disc.x + p) for p in phases], axis=1)
    return torch.tensor(u0, dtype=dtype, device=device)


def batched_cotangent(disc, batch, device, dtype):
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import (
        terminal_integral_cotangent,
    )

    lam = terminal_integral_cotangent(disc, dtype, device)
    return lam[:, None, :].expand(disc.np_, batch, disc.k).contiguous()


def tolerances(n_steps, np_, u, lam):
    """float32 kernel vs plain, same tables, different operation order:
    a few ulp per step of the largest state (u), cotangent (λ), and of
    max|λ|·max|u| per node and step for η (a sum of differences of O(1)
    states)."""
    eps = 2.0**-23
    umax, lmax = float(u.abs().max()), float(lam.abs().max())
    return {
        "u": 8 * n_steps * eps * umax,
        "lam": 8 * n_steps * eps * lmax,
        "eta": 8 * n_steps * np_ * eps * umax * lmax,
    }


def compare_case(name, disc, batch, n_steps, device, errs):
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = phased_states(disc, batch, device, torch.float32)
    lam = batched_cotangent(disc, batch, device, torch.float32)
    traj, uf = dg_rhs.fwd_march(u0, 0.0, n_steps, ops, store_trajectory=True)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)
    torch.cuda.synchronize()
    traj_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, True)
    # K2 against its plain version on the SAME inputs (the kernel's trajectory)
    lam0_p, eta_p = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)
    tol = tolerances(n_steps, disc.np_, uf_p, lam)
    e = {
        "traj": float((traj - traj_p).abs().max()),
        "u_final": float((uf - uf_p).abs().max()),
        "lam0": float((lam0 - lam0_p).abs().max()),
        "eta": float((eta - eta_p).abs().max()),
    }
    for x in (traj, uf, lam0, eta):
        assert bool(torch.isfinite(x).all()), f"{name}: non-finite kernel output"
    say("2", f"{name}: Np={disc.np_} K={disc.k} B={batch} steps={n_steps} | "
             f"K1 traj {e['traj']:.3e} u_final {e['u_final']:.3e} (tol {tol['u']:.3e}) | "
             f"K2 lam0 {e['lam0']:.3e} (tol {tol['lam']:.3e}) eta {e['eta']:.3e} "
             f"(tol {tol['eta']:.3e}; max|eta| {float(eta_p.abs().max()):.3e})")
    assert e["traj"] <= tol["u"] and e["u_final"] <= tol["u"], f"{name}: K1 disagrees"
    assert e["lam0"] <= tol["lam"] and e["eta"] <= tol["eta"], f"{name}: K2 disagrees"
    errs["fwd_march"] = max(errs["fwd_march"], e["traj"], e["u_final"])
    errs["adj_est_stored"] = max(errs["adj_est_stored"], e["lam0"], e["eta"])


def eager_estimate(vx, n_steps, dt, device, dtype):
    """The ``engine="torch"`` estimate of one adaptive-loop iteration."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import advec_fwd_adj_estimate
    from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    disc = startup_1d(2, 0.0, 2 * np.pi, len(vx) - 1, vx=vx)
    ops = advec_operators(disc, a=A, dtype=dtype, device=device)
    u0 = torch.as_tensor(np.sin(disc.x), dtype=dtype, device=device)
    res = advec_fwd_adj_estimate(ops, disc, u0, dt, n_steps, segment=max(n_steps // 8, 1))
    return float(res.j_value), res.eta.double().cpu().numpy(), disc


def phase3(device):
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adapt.advec_loop import run_adaptive_advec
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    argv = ["--adapt", "--kernel", "cuda", "--k", "512", "--order", "2",
            "--final-time", "0.25", "--maxit", "4"]
    dg_rhs.reset_launch_counts()
    t0 = time.perf_counter()
    hist = advec_dg.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd_march": dg_rhs.fwd_march.launches,
                "adj_est_stored": dg_rhs.adj_est_stored.launches}
    say("3", f"main path --adapt --kernel cuda: {len(hist)} iterations, K "
             f"{len(hist[0].vx) - 1} -> {len(hist[-1].vx) - 1}, steps "
             f"{[r.n_steps for r in hist]}, wall {wall:.3f} s, wrapper launches {launches}")
    assert all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}"
    assert len(hist) == 5 and len(hist[-1].vx) - 1 == 516
    for r in hist:
        assert np.isfinite(r.j_value) and np.all(np.isfinite(r.eta))

    hist_t = advec_dg.main([a if a != "cuda" else "torch" for a in argv])
    same = [bool(np.array_equal(a.vx, b.vx)) for a, b in zip(hist, hist_t)]
    say("3", f"--kernel torch (float32 eager) vertex history equal per iteration: {same}; "
             f"Σeta cuda {[f'{r.est_total:+.3e}' for r in hist]} "
             f"torch {[f'{r.est_total:+.3e}' for r in hist_t]}")

    # Replay every mesh of the CUDA study through the eager engine (float32,
    # same card). J is a sum of O(1) states: its float32 roundoff is ~ a few
    # ulp per step·Σ|λ|. η at this size is float32 roundoff (the float64
    # signal sits below it, printed next), so it is held to the noise bound.
    eps = 2.0**-23
    for it, r in enumerate(hist):
        j_t, eta_t, disc = eager_estimate(r.vx, r.n_steps, r.dt, device, torch.float32)
        lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy()
        tol_j = 8 * np.sqrt(r.n_steps) * eps * float(np.sum(np.abs(lam)))
        tol_eta = 8 * np.sqrt(r.n_steps) * disc.np_ * eps * float(np.max(np.abs(lam)))
        dj, de = abs(r.j_value - j_t), float(np.max(np.abs(r.eta - eta_t)))
        say("3", f"replay it {it} K={disc.k}: |dJ| {dj:.3e} (tol {tol_j:.3e}) "
                 f"max|d eta| {de:.3e} (tol {tol_eta:.3e}) argmax cuda "
                 f"{int(np.argmax(np.abs(r.eta)))} torch {int(np.argmax(np.abs(eta_t)))}")
        assert dj <= tol_j and de <= tol_eta, f"replay it {it}: cuda vs torch engine"
    _, eta64, _ = eager_estimate(hist[0].vx, hist[0].n_steps, hist[0].dt, device,
                                 torch.float64)
    say("3", f"it 0 float64 eta: max {np.max(np.abs(eta64)):.3e} at element "
             f"{int(np.argmax(np.abs(eta64)))}, Σ {np.sum(eta64):+.3e}; float32 cuda "
             f"eta max|eta - eta64| {np.max(np.abs(hist[0].eta - eta64)):.3e}")

    # refinement decisions where the indicator sits above float32 roundoff:
    # tests/test_advec.py::TestAdaptiveAdvecPallasEngine's configuration
    kw = dict(n_order=2, k0=8, final_time=0.05, maxit=2, tol=1e-12, device=device)
    hc = run_adaptive_advec(lambda x: np.sin(3 * x), engine="cuda", **kw)
    ht = run_adaptive_advec(lambda x: np.sin(3 * x), engine="torch", dtype=torch.float32, **kw)
    assert len(hc) == len(ht)
    for a, b in zip(hc, ht):
        np.testing.assert_array_equal(a.vx, b.vx)
        np.testing.assert_allclose(a.eta, b.eta, rtol=5e-3, atol=2e-7)
    say("3", f"sin(3x) K0=8 study: cuda and torch vertex histories equal over "
             f"{len(hc)} iterations (K -> {len(hc[-1].vx) - 1}), eta within rtol 5e-3 atol 2e-7")

    err = advec_dg.main(["--estimate", "--kernel", "cuda", "--k", "512"])
    assert np.isfinite(err) and err < 1e-2
    say("3", f"--estimate --kernel cuda --k 512: march max error {err:.3e}")

    # the driver's plain march: K1 at B = 1 with no trajectory, the port of
    # the TPU's _forward_kernel (dg_rhs.py:270)
    dg_rhs.reset_launch_counts()
    err = advec_dg.main(["--kernel", "cuda", "--k", "512"])
    march = {"fwd_march": dg_rhs.fwd_march.launches,
             "adj_est_stored": dg_rhs.adj_est_stored.launches}
    say("3", f"--kernel cuda --k 512 (march only): max error {err:.3e}, wrapper launches {march}")
    assert np.isfinite(err) and err < 1e-2
    assert march == {"fwd_march": 1, "adj_est_stored": 0}, march
    return launches, hist[-1].vx


def phase4(device, errs):
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
    disc = mesh(n_order, k, graded=False)
    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = phased_states(disc, b, device, torch.float32)
    lam = batched_cotangent(disc, b, device, torch.float32)
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, b, device)
    out = {}

    def pipeline():
        out["k"] = run(u0, 0.0, lam)

    t_pipe = cuda_ms(pipeline, runs=5)
    t_k1 = cuda_ms(lambda: out.update(k1=dg_rhs.fwd_march(u0, 0.0, n_steps, ops, True)), 5)
    traj, uf = out.pop("k1")
    t_k2 = cuda_ms(lambda: out.update(k2=dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)), 5)
    del traj, uf
    t_p1 = cuda_ms(lambda: out.update(p1=dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, True)),
                   runs=3, warmup=0)
    traj_p, uf_p = out.pop("p1")
    t_p2 = cuda_ms(lambda: out.update(p2=dg_rhs.adj_est_stored_plain(traj_p, uf_p, lam, 0.0, ops)),
                   runs=3, warmup=0)
    del traj_p
    uf_k, lam0_k, eta_k = out["k"]
    lam0_p, eta_p = out["p2"]
    tol = tolerances(n_steps, disc.np_, uf_p, lam)
    e = (float((uf_k - uf_p).abs().max()), float((lam0_k - lam0_p).abs().max()),
         float((eta_k - eta_p).abs().max()))
    say("4", f"kernel vs plain at the headline: u_final {e[0]:.3e} (tol {tol['u']:.3e}) "
             f"lam0 {e[1]:.3e} (tol {tol['lam']:.3e}) eta {e[2]:.3e} (tol {tol['eta']:.3e})")
    assert e[0] <= tol["u"] and e[1] <= tol["lam"] and e[2] <= tol["eta"]
    errs["fwd_march"] = max(errs["fwd_march"], e[0])
    errs["adj_est_stored"] = max(errs["adj_est_stored"], e[1], e[2])

    dof_steps = b * disc.np_ * k * 2 * n_steps
    cuda_launches = 25 * n_steps
    say("4", f"K={k} N={n_order} steps={n_steps} B={b} dt={dt:.6e}: kernel pipeline "
             f"{t_pipe:.3f} ms (median of 5) = {dof_steps / (t_pipe / 1e3):.4e} "
             f"fwd+adjoint DoF-steps/s [{cuda_launches} CUDA launches, "
             f"{t_pipe * 1e3 / cuda_launches:.2f} us each]; K1 {t_k1:.3f} ms, K2 {t_k2:.3f} ms")
    say("4", f"plain PyTorch pipeline {t_p1 + t_p2:.3f} ms (fwd {t_p1:.3f} + adj {t_p2:.3f}, "
             f"median of 3) = {dof_steps / ((t_p1 + t_p2) / 1e3):.4e} DoF-steps/s; "
             f"kernel speed-up {(t_p1 + t_p2) / t_pipe:.2f}x")

    ops_half = dg_rhs.kernel_ops(disc, A, dt / 2, device)
    _, uf_half = dg_rhs.fwd_march(u0, 0.0, 2 * n_steps, ops_half)
    j = torch.sum(lam * uf_k, dim=(0, 2))
    j_half = torch.sum(lam * uf_half, dim=(0, 2))
    sum_eta = eta_k.sum(dim=1)
    for m in (0, b - 1):
        say("4", f"member {m}: sum_eta {float(sum_eta[m]):+.6e}  gap J(u_dt)-J(u_dt/2) "
                 f"{float(j[m] - j_half[m]):+.6e} (float32; phase 5 checks the identity in float64)")
    for x in (uf_k, lam0_k, eta_k, uf_half):
        assert bool(torch.isfinite(x).all())
    return {"fwd_march": (t_k1, t_p1), "adj_est_stored": (t_k2, t_p2)}


def march_times(device, errs):
    """K1 as the advec_dg march (the TPU's _forward_kernel, dg_rhs.py:270):
    B = 1, no trajectory, at the driver's ``--kernel cuda --k 512`` defaults
    (N = 2, T = 2, cfl 0.75); the kernel against its plain version."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.advec import cfl_dt
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_order, k = 2, 512
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    dt, n_steps = cfl_dt(disc, A, 0.75, 2.0)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = torch.tensor(np.sin(disc.x)[:, None, :], dtype=torch.float32, device=device)
    out = {}
    ms = cuda_ms(lambda: out.update(k=dg_rhs.fwd_march(u0, 0.0, n_steps, ops)[1]), runs=5)
    plain_ms = cuda_ms(lambda: out.update(p=dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops)[1]),
                       runs=3, warmup=0)
    e = float((out["k"] - out["p"]).abs().max())
    tol = 8 * n_steps * EPS32 * float(out["p"].abs().max())
    b_ms, b_by = march_bound(n_order, k, n_steps)
    say("4", f"K1 as the advec_dg march (_forward_kernel, dg_rhs.py:270) K={k} N={n_order} "
             f"B=1 steps={n_steps}: kernel {ms:.3f} ms (median of 5, {5 * n_steps} CUDA "
             f"launches); plain {plain_ms:.3f} ms (median of 3); bound {b_ms:.5f} ms ({b_by}); "
             f"max|kernel - plain| {e:.3e} (tol {tol:.3e})")
    assert e <= tol, "K1 at B = 1 disagrees with its plain version"
    errs["fwd_march"] = max(errs["fwd_march"], e)


def phase5(device):
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_order, k, n_steps = HEADLINE["n_order"], HEADLINE["k"], EFFECTIVITY_STEPS
    disc = mesh(n_order, k, graded=False)
    dt = cfl_step(disc)
    f64 = torch.float64
    # bench.py's effectivity problem: u0 = sin(800x) keeps the time-error gap
    # far above float64 roundoff; J = ∫ u(T) over x in [π, π+1]
    u0 = torch.tensor(np.sin(800 * disc.x)[:, None, :], dtype=f64, device=device)
    xc = disc.x.mean(axis=0)
    window = torch.tensor((xc >= np.pi) & (xc <= np.pi + 1.0), dtype=f64, device=device)
    lam = batched_cotangent(disc, 1, device, f64) * window
    t0 = time.perf_counter()
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    traj, uf = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, True)
    _, eta = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)
    del traj
    _, uf_half = dg_rhs.fwd_march_plain(u0, 0.0, 2 * n_steps,
                                        dg_rhs.kernel_ops(disc, A, dt / 2, device))
    gap = float(torch.sum(lam * uf) - torch.sum(lam * uf_half))
    est = float(eta.sum())
    rel = abs(est - gap) / abs(gap)
    say("5", f"float64 plain path K={k} N={n_order} steps={n_steps} B=1: sum_eta {est:+.12e} "
             f"gap {gap:+.12e} |abs err| {abs(est - gap):.3e} |rel err| {rel:.3e} (limit 1e-10) [{time.perf_counter() - t0:.1f} s]")
    assert rel <= 1e-10, rel


# ------------------------------------------------------------------ FD strand


def fd_tol(stats, rf, d=1):
    """float32 kernel vs plain version on the same inputs: the residual
    r = u_j − (u_{j−1} + f·dt_f) is a difference of O(max|u|) values, so each
    fine node's r·v carries a few ulp of max|u|·max|v| (FMA contraction in the
    kernel, none in the plain version); a block sums rf nodes and d
    components."""
    return 8 * rf * d * EPS32 * float(stats["u"]) * float(stats["v"])


def j_tol(stats, n_steps, t_max):
    """J = Σ u_n²·dt_n: a few ulp of max|u|²·T per step."""
    return 8 * n_steps * EPS32 * float(stats["u"]) ** 2 * t_max


def fd_check(label, kname, got, want, tol, errs):
    import torch

    assert bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output"
    e = float((got.double() - want.double()).abs().max())
    say("6", f"{label}: max|kernel - plain| {e:.3e} (tol {tol:.3e}; max|plain| "
             f"{float(want.abs().max()):.3e})")
    assert e <= tol, f"{label}: kernel disagrees with its plain version"
    errs[kname] = max(errs.get(kname, 0.0), e)


def fd_inputs(device):
    """The phase-6 inputs at the JAX package's benchmark shapes, from seeds:
    u0 ~ U(−3, 3) seed 0 (bench.py:508-510); the d=2 states ~ U(−1, 1) seed 21
    (bench.py:1297-1300); the per-member study's u0 ~ U(0.5, 2) seed 0
    (bench.py:824-833) on random grids of 2..43 active steps over [0, 2]
    with padded zero-width tails."""
    import numpy as np
    import torch

    n, b, s = FD_ENSEMBLE["n_ics"], FD_STUDY["b"], FD_PM_STEPS
    f32 = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(5)
    times = np.full((b, s + 1), FD_STUDY["t1"])
    for m, n_act in enumerate(rng.integers(2, s + 1, b)):
        times[m, : n_act + 1] = np.concatenate(
            [[0.0], np.sort(rng.uniform(0.0, FD_STUDY["t1"], n_act - 1)), [FD_STUDY["t1"]]])
    return {
        "u0": torch.tensor(np.random.default_rng(0).uniform(-3, 3, n), **f32),
        "u0_vec": torch.tensor(np.random.default_rng(21).uniform(-1, 1, (n, 2)), **f32),
        "u0_pm": torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, b), **f32),
        "dt_pm": torch.tensor(np.diff(times, axis=1), **f32).contiguous(),
        # a graded (nonuniform) coarse grid over [0, 2]
        "dt_graded": np.diff(2.0 * np.linspace(0.0, 1.0, FD_ENSEMBLE["n_steps"] + 1) ** 1.5),
    }


def phase6(device, errs, inp):
    """Each FD kernel against its plain version on the card, float32."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n, s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_ics", "n_steps", "rf", "dt"))
    u0 = inp["u0"]

    def ensemble(label, ode, step, trig="libm", x=u0):
        run = fe.make_cuda_fd_ensemble(ode, s, rf, step, trig=trig, device=device)
        got = run(x)
        torch.cuda.synchronize()
        stats = {}
        want = fe.fd_ensemble_plain(x, run.plan, stats)
        fd_check(label, "fd_ensemble", got, want, fd_tol(stats, rf), errs)

    for trig in ("libm", "fast"):
        ensemble(f"(a) sin(u) {n} ICs, uniform dt, trig={trig}", "du/dt=sin(u)", dt, trig)
    ensemble("(b) sin(u), graded dt vector", "du/dt=sin(u)", inp["dt_graded"])
    ensemble("(c) gaussian_mixture (time-dependent RHS)", "gaussian_mixture", dt)
    for ode in ("du/dt=u", "du/dt=cos(2*pi*u)", "du/dt=10cos(u)", "du/dt=t*sin(u)"):
        ensemble(f"(c') {ode} at 4096 ICs", ode, dt, x=u0[:4096] / 3)

    run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    got = run(inp["u0_vec"])
    torch.cuda.synchronize()
    stats = {}
    want = fe.fd_ensemble_vec_plain(inp["u0_vec"], run.plan, stats)
    fd_check(f"(d) harmonic_oscillator d=2, {n} ICs", "fd_ensemble_vec", got, want,
             fd_tol(stats, rf, d=2), errs)

    dt_pm, u0_pm = inp["dt_pm"], inp["u0_pm"]
    t_max = float(dt_pm.double().sum(1).max())
    for ode in ("du/dt=sin(u)", "gaussian_mixture"):
        for conv in ("strided", "block"):
            run = fe.make_cuda_fd_estimate_per_member(ode, FD_PM_STEPS, rf, conv, device=device)
            err_k, j_k = run(dt_pm, u0_pm)
            torch.cuda.synchronize()
            stats = {}
            err_p, j_p = fe.fd_estimate_per_member_plain(dt_pm, u0_pm, run.plan, stats)
            label = f"(e) per-member {ode} B={u0_pm.shape[0]} {FD_PM_STEPS} steps {conv}"
            fd_check(label + " err", "fd_estimate_per_member", err_k, err_p,
                     fd_tol(stats, rf), errs)
            fd_check(label + " J", "fd_estimate_per_member", j_k, j_p,
                     j_tol(stats, FD_PM_STEPS, t_max), errs)
            # zero-width padded steps contribute exactly 0
            pad = dt_pm == 0
            assert bool((err_k[pad] == 0).all()), "padding steps must contribute exactly 0"

    # the wrappers refuse what the kernels do not take; nothing falls back
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, device=device)
    for bad, exc in ((u0.double(), TypeError), (u0[::2], ValueError)):
        try:
            run(bad)
        except exc:
            continue
        raise AssertionError(f"the kernel wrapper took a {bad.dtype} stride-{bad.stride()} input")
    say("6", "float64 and non-contiguous inputs raise; no plain-version fallback on the card")


def study_u0s():
    """The driver's ensemble: U(u0/2, 2·u0) with u0 = 1, seed 0 (as bench.py:824-833)."""
    import numpy as np

    return np.random.default_rng(0).uniform(0.5, 2.0, FD_STUDY["b"])


def phase7(device, errs, inp):
    """The FD paths through their entry points: the per-member study via the
    fd_adaptive driver (per-member kernel), the ensemble refinement signal
    via its entry points (F1, F1 fast, F2), and the single-run default."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.drivers import fd_adaptive
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    b, maxit, rf = FD_STUDY["b"], FD_STUDY["maxit"], FD_STUDY["rf"]
    argv = ["--ensemble", str(b), "--engine", "cuda", "--device-loop", "--tol", "0",
            "--maxit", str(maxit)]
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    hist = fd_adaptive.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fd_estimate_per_member": fe.fd_estimate_per_member.launches}
    say("7", f"main path fd_adaptive {' '.join(argv)}: {len(hist)} iterations, steps "
             f"{hist[0].n_active.max()} -> [{hist[-1].n_active.min()}..{hist[-1].n_active.max()}], "
             f"wall {wall:.3f} s, wrapper launches {launches}")
    assert launches["fd_estimate_per_member"] > 0, "the per-member kernel was not launched"
    assert len(hist) == maxit + 1
    for r in hist:
        assert np.all(np.isfinite(r.err_steps)) and np.all(np.isfinite(r.j_coarse))

    # replay every iteration's grid through the plain version (float32, same
    # card), and through the torch engine's iteration on the same grids
    u0s = torch.tensor(study_u0s(), dtype=torch.float32, device=device)
    plan = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", FD_PM_STEPS, rf,
                                               device=device).plan
    step = euler_step(odes.get_ode("du/dt=sin(u)").f)
    worst = {"err": 0.0, "tol_err": 0.0, "j": 0.0, "tol_j": 0.0, "torch": 0.0}
    decided = agree = 0
    for r in hist:
        times = torch.tensor(r.times, dtype=torch.float32, device=device)
        stats = {}
        err_p, j_p = fe.fd_estimate_per_member_plain(torch.diff(times, dim=1), u0s, plan, stats)
        n_act = torch.tensor(r.n_active, device=device)
        err_t = fd_loop.estimate_per_member(step, times, n_act, u0s, ref_factor=rf)[0]
        err_k = torch.tensor(r.err_steps, device=device)
        tol_e = fd_tol(stats, rf)
        tol_j = j_tol(stats, FD_PM_STEPS, FD_STUDY["t1"])
        e_err = float((err_k - err_p).abs().max())
        e_j = float((torch.tensor(r.j_coarse, device=device) - j_p).abs().max())
        assert e_err <= tol_e and e_j <= tol_j, (e_err, tol_e, e_j, tol_j)
        for key, val in (("err", e_err), ("tol_err", tol_e), ("j", e_j), ("tol_j", tol_j),
                         ("torch", float((err_k - err_t).abs().max()))):
            worst[key] = max(worst[key], val)
        # refinement decisions where the top-two margin clears the noise
        top2 = torch.topk(err_p, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 4 * tol_e
        picks = [torch.argmax(x, dim=1) for x in (err_k, err_p, err_t)]
        same = (picks[0] == picks[1]) & (picks[1] == picks[2])
        decided += int(clear.sum())
        agree += int((same & clear).sum())
    errs["fd_estimate_per_member"] = max(errs["fd_estimate_per_member"], worst["err"], worst["j"])
    say("7", f"replay of {len(hist)} grids through the plain version: max|d err| "
             f"{worst['err']:.3e} (tol <= {worst['tol_err']:.3e}), max|d J| {worst['j']:.3e} "
             f"(tol <= {worst['tol_j']:.3e}); torch engine on the same grids: max|d err| "
             f"{worst['torch']:.3e} (not bounded: another operation order)")
    say("7", f"refinement decisions with a top-two margin > 4x tol: {decided} of "
             f"{len(hist) * b} member-iterations; kernel, plain and torch engine agree on {agree}")
    assert agree == decided, "a decision above the float32 noise differs between engines"

    # the ensemble refinement signal through its entry points
    n, s, dt = FD_ENSEMBLE["n_ics"], FD_ENSEMBLE["n_steps"], FD_ENSEMBLE["dt"]
    sig = {}
    fe.reset_launch_counts()
    for trig in ("libm", "fast"):
        run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, trig=trig, device=device)
        sig[trig] = run(inp["u0"]).mean(dim=1)
    vec = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    sig["vec"] = vec(inp["u0_vec"]).mean(dim=1)
    torch.cuda.synchronize()
    launches["fd_ensemble"] = fe.fd_ensemble.launches
    launches["fd_ensemble_vec"] = fe.fd_ensemble_vec.launches
    for key, x in sig.items():
        assert x.shape == (s,) and bool(torch.isfinite(x).all()), key
    stats = {}
    ref64 = fe.fd_ensemble_plain(inp["u0"].double(), run.plan, stats).mean(dim=1)
    d64 = float((sig["libm"].double() - ref64).abs().max())
    top2 = torch.topk(ref64, 2).values
    say("7", f"ensemble signal ({n} ICs, {s} steps, rf {rf}): argmax libm "
             f"{int(sig['libm'].argmax())} fast {int(sig['fast'].argmax())} float64 plain "
             f"{int(ref64.argmax())} (top-two margin {float(top2[0] - top2[1]):.3e}); "
             f"max|signal - float64| {d64:.3e}; d=2 signal argmax {int(sig['vec'].argmax())}; "
             f"wrapper launches {launches}")
    assert d64 <= fd_tol(stats, rf), "the float32 signal is off its float64 plain version"
    if float(top2[0] - top2[1]) > fd_tol(stats, rf):  # the signal's decision is above the noise
        assert int(sig["libm"].argmax()) == int(sig["fast"].argmax()) == int(ref64.argmax())
    assert all(launches[k] > 0 for k in ("fd_ensemble", "fd_ensemble_vec"))

    # the single-run default: sin(u), J = ∫u², maxit 40, torch on the card
    t0 = time.perf_counter()
    single = fd_adaptive.main([])
    torch.cuda.synchronize()
    e0, e1 = float(single[0].err_total), float(single[-1].err_total)
    say("7", f"fd_adaptive default (single run, float32 on the card): {len(single)} iterations, "
             f"sum(err) {e0:.4e} -> {e1:.4e}, wall {time.perf_counter() - t0:.2f} s")
    assert np.isfinite(e1) and e1 < e0
    return launches


def study_times(device):
    """Phase 8 for the study: the B = 1024, maxit 40 per-member study
    (device loop) with the cuda and the torch engine, CUDA events around
    the loop call."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    ode = odes.get_ode("du/dt=sin(u)")
    kw = dict(n_steps0=FD_STUDY["n_steps0"], tol=0.0, maxit=FD_STUDY["maxit"],
              dtype=torch.float32, device=device, device_loop=True, ode=ode)

    def study(engine):
        fd_loop.run_adaptive_fd_per_member(euler_step(ode.f), study_u0s(), (0.0, FD_STUDY["t1"]),
                                           engine=engine, **kw)

    before = fe.fd_estimate_per_member.launches
    ms_cuda = cuda_ms(lambda: study("cuda"), runs=5)
    per_study = (fe.fd_estimate_per_member.launches - before) / 6
    ms_torch = cuda_ms(lambda: study("torch"), runs=1, warmup=0)
    its = FD_STUDY["maxit"] + 1
    say("8", f"per-member study B={FD_STUDY['b']} maxit {FD_STUDY['maxit']} (device loop): "
             f"engine cuda {ms_cuda:.3f} ms (median of 5; {per_study:g} kernel launches per "
             f"study, {ms_cuda / its:.3f} ms per iteration, "
             f"{FD_STUDY['b'] * its / (ms_cuda / 1e3):.4e} member-iterations/s); engine torch "
             f"{ms_torch:.1f} ms (one run); speed-up {ms_torch / ms_cuda:.1f}x")
    return ms_cuda, ms_torch


def fd_times(device, inp):
    """Phase 8 for the kernels: CUDA events, one warm-up, median of 5, each
    FD kernel and its plain version at the phase-6 shapes. Returns
    {name: (kernel ms, plain ms)}."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n, s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_ics", "n_steps", "rf", "dt"))
    u0, u0v, dt_pm, u0_pm = inp["u0"], inp["u0_vec"], inp["dt_pm"], inp["u0_pm"]
    sin_ = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, device=device)
    fast = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, trig="fast", device=device)
    vec = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    pm = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", FD_PM_STEPS, rf, device=device)
    cases = {
        "fd_ensemble": (lambda: sin_(u0), lambda: fe.fd_ensemble_plain(u0, sin_.plan),
                        fe.fd_ensemble, n),
        "fd_ensemble trig=fast": (lambda: fast(u0), lambda: fe.fd_ensemble_plain(u0, fast.plan),
                                  fe.fd_ensemble, n),
        "fd_ensemble_vec": (lambda: vec(u0v), lambda: fe.fd_ensemble_vec_plain(u0v, vec.plan),
                            fe.fd_ensemble_vec, n),
        "fd_estimate_per_member": (lambda: pm(dt_pm, u0_pm),
                                   lambda: fe.fd_estimate_per_member_plain(dt_pm, u0_pm, pm.plan),
                                   fe.fd_estimate_per_member, FD_STUDY["b"]),
    }
    bounds = fd_bounds()
    times = {}
    for name, (kern, plain, wrapper, n_ic) in cases.items():
        before = wrapper.launches
        ms = cuda_ms(kern, runs=5)
        per_call = (wrapper.launches - before) / 6
        plain_ms = cuda_ms(plain, runs=5)
        b_ms, b_by = bounds[name.split()[0]]
        say("8", f"{name}: kernel {ms:.4f} ms = {n_ic / (ms / 1e3):.4e} ICs/s "
                 f"({per_call:g} launch per call); plain {plain_ms:.3f} ms = "
                 f"{n_ic / (plain_ms / 1e3):.4e} ICs/s; kernel speed-up {plain_ms / ms:.1f}x; "
                 f"bound {b_ms:.5f} ms ({b_by}), kernel at {b_ms / ms:.2%} of it")
        times[name] = (ms, plain_ms)
    return times


def fd_bounds():
    """Least time on the card for each FD kernel at the phase-6/8 shapes:
    the larger of bytes (each input read once, each output written once)
    over 3.35 TB/s and FP32 operations over 67 TFLOP/s, counting an FMA as
    2 and each sin, cos or exp as 1 (the least a special-function unit can
    take). The (f, f_u) pair costs what its functor does: sin and cos for
    sin(u); one product (−4·u₀) for the harmonic oscillator, whose Jacobian
    is constant. Per IC, a fine node costs 15.25 (d=1) or 27.5 (d=2)
    operations at rf 4."""
    n, s, rf = FD_ENSEMBLE["n_ics"], FD_ENSEMBLE["n_steps"], FD_ENSEMBLE["rf"]
    b, sp = FD_STUDY["b"], FD_PM_STEPS
    grid = 4 * (2 * s + 2 * s * rf)

    def node_ops(d, pair):  # interpolation, v update, residual, r·v per component; the pair
        return d * (3 * (rf - 1) / rf + 6 + 3 + 2) + pair

    sin_node, harmonic_node = node_ops(1, pair=2), node_ops(2, pair=1)
    work = {
        "fd_ensemble": (4 * n + 4 * s * n + grid, n * (3 * s + s * rf * sin_node + s)),
        "fd_ensemble_vec": (8 * n + 4 * s * n + grid, n * (5 * s + s * rf * harmonic_node + s)),
        # + J (3/step), t (1/step), fine times and widths (3/node)
        "fd_estimate_per_member": (4 * b + 8 * sp * b + 4 * b,
                                   b * (7 * sp + sp * rf * (sin_node + 3) + sp)),
    }
    return {k: bound(*v) for k, v in work.items()}


def bound(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def dg_bounds():
    """The same for K1 and K2 at the headline (K = 10^4, N = 2, B = 8, 2048
    steps, stored trajectory). One LSRK stage costs 2Np² + 9Np + 4
    operations per column (volume product, lift, stage update); K1 runs 5
    stages a step, K2 20 (two dt/2 steps and two transposed dt/2 steps) plus
    the η accumulation. K1 writes the trajectory; K2 reads it. D1 at
    bench.py's DG-slab shape (phase 9(a)), counted by :func:`dg_slab_bound`."""
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators

    n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
    np_ = n_order + 1
    cols, state = b * k, 4 * (n_order + 1) * b * k
    stage = stage_ops(np_)
    geom = 3 * 4 * k
    return {
        "fwd_march": bound(state + geom + n_steps * state + state,
                           n_steps * 5 * stage * cols),
        "adj_est_stored": bound(n_steps * state + 2 * state + geom + state + 4 * cols,
                                n_steps * (20 * stage + 3 * np_) * cols),
        "dg_estimate_ensemble": dg_slab_bound(
            1, DG_SLAB["k"], DG_SLAB["b"], DG_SLAB["newton_iters"],
            dg_time_operators(1).phi.shape[0], dg_time_operators(2).phi.shape[0]),
    }


def stage_ops(np_):
    """FP32 operations of one LSRK stage per column (see dg_bounds)."""
    return 2 * np_ * np_ + 9 * np_ + 4


def march_bound(n_order, k, n_steps):
    """K1 as the advec_dg march: B = 1, no trajectory; u0 and the geometry
    read once, u_final written once, 5 stages a step."""
    np_ = n_order + 1
    state = 4 * np_ * k
    return bound(2 * state + 3 * 4 * k, n_steps * 5 * stage_ops(np_) * k)


# ------------------------------------------------------------ DG-in-time strand


def dg_tol(plain, k, ops_p, ops_a):
    """float32 kernel vs plain version on the same inputs: each element's
    Newton and adjoint solves amplify the roundoff of their assembly (FMA
    contraction in the kernel, none in the plain version) by the slab
    system's condition κ (that of the zero-width system Sᵀ + B, resp.
    −Sᵀ − e_L e_Lᵀ: 1 at order 1, 5.4 at order 4), and the inflow carries
    it through the K elements. err_k = vᵀres sums Na products of an
    O(max|v|) weight with a difference of O(max|u|) values, and is local:
    a shift of the states carried in through the inflow moves Sᵀu_h, the
    outflow and the inflow term alike and cancels in the residual (to
    O(h·f_u)), so its bound has no K factor. The err bound is also the
    noise a refinement decision must clear."""
    import numpy as np

    a_p = ops_p.stiff.T.copy()
    a_p[-1, -1] -= 1.0
    a_a = -ops_a.stiff.T.copy()
    a_a[0, 0] -= 1.0
    kp, ka = float(np.linalg.cond(a_p)), float(np.linalg.cond(a_a))
    umax, vmax = (float(x.abs().max()) for x in plain[:2])
    return {"u": 8 * k * kp * EPS32 * umax, "v": 8 * k * ka * EPS32 * vmax,
            "err": 8 * ka * ops_a.np_ * EPS32 * umax * vmax}


def dg_case(label, device, errs, ode="du/dt=sin(u)", n=1, k=DG_SLAB["k"], b=DG_SLAB["b"],
            seed=DG_SLAB["seed"], newton_iters=DG_SLAB["newton_iters"], trig="libm",
            per_member=False):
    """One phase-9 comparison: D1 against its plain version on the card."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    rng = np.random.default_rng(seed)
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    if per_member:  # random partitions of [0, 2] with zero-width tails
        t = np.full((b, k + 1), DG_SLAB["t1"])
        for m, n_act in enumerate(rng.integers(2, k - 3, b)):
            t[m, : n_act + 1] = np.concatenate(
                [[0.0], np.sort(rng.uniform(0.0, DG_SLAB["t1"], n_act - 1)), [DG_SLAB["t1"]]])
    else:
        t = np.linspace(0.0, DG_SLAB["t1"], k + 1)
    times = torch.tensor(t, dtype=torch.float32, device=device)
    ops_p, ops_a = dg_time_operators(n), dg_time_operators(n + 1)
    run = ds.make_cuda_dg_estimate_ensemble(ode, ops_p, ops_a, k, newton_iters, trig=trig,
                                            device=device)
    got = run(times, y0)
    torch.cuda.synchronize()
    want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
    tol = dg_tol(want, k, ops_p, ops_a)
    e = {}
    for name, g, w in zip(("u", "v", "err"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), f"{label}: {name}"
        e[name] = float((g - w).abs().max())
    smem = k * ops_p.np_ * 128 * 4 <= 48 * 1024
    say("9", f"{label}: {ode} order {n} K={k} B={b} newton {newton_iters} trig={trig} "
             f"{'per-member' if per_member else 'shared'} times, states in "
             f"{'shared memory' if smem else 'the u output'} | u {e['u']:.3e} (tol "
             f"{tol['u']:.3e}) v {e['v']:.3e} (tol {tol['v']:.3e}) err {e['err']:.3e} (tol "
             f"{tol['err']:.3e}; max|err| {float(want[2].abs().max()):.3e})")
    assert all(e[x] <= tol[x] for x in e), f"{label}: the DG slab kernel disagrees"
    if per_member:  # a trailing zero-width slab contributes exactly 0
        pad = torch.diff(times, dim=1) == 0
        assert bool(pad.any()) and bool((got[2][pad] == 0).all()), "padding must contribute 0"
        say("9", f"{label}: {int(pad.sum())} zero-width padding slabs, every contribution "
                 f"exactly 0")
    errs["dg_estimate_ensemble"] = max(errs.get("dg_estimate_ensemble", 0.0), *e.values())
    return run, times, y0


def phase9(device, errs):
    """The DG slab kernel against its plain version on the card, float32."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    cases = {}
    for trig in ("libm", "fast"):
        cases[trig] = dg_case(f"(a) bench shapes, {trig}", device, errs, trig=trig)
    dg_case("(b) order 2 (Cramer)", device, errs, n=2, b=1024, newton_iters=8)
    dg_case("(b') order 4 (pivoted elimination)", device, errs, n=4, k=24, b=1024,
            newton_iters=8)
    cases["study"] = dg_case("(c) per-member partitions", device, errs,
                             k=DG_STUDY["k0"] + DG_STUDY["maxit"] + 1, b=DG_STUDY["b"],
                             newton_iters=DG_STUDY["newton_iters"], per_member=True)
    for ode in ("du/dt=t*sin(u)", "gaussian_mixture"):
        dg_case(f"(d) {ode}", device, errs, ode=ode, b=4096)
    cases["big"] = dg_case("(e) 102,400 members", device, errs, b=DG_SLAB_BIG["b"],
                           seed=DG_SLAB_BIG["seed"])
    run, times, y0 = cases["libm"]
    for bad in (lambda: run(times.double(), y0), lambda: run(times, y0[::2])):
        try:
            bad()  # float64, then a non-contiguous operand
        except ValueError:
            continue
        raise AssertionError("the DG slab wrapper took an input it must refuse")
    try:
        run(times, y0[:0])  # an empty grid: the launch is refused
    except RuntimeError as exc:
        say("9", f"float64 and non-contiguous inputs raise; a refused launch raises ({exc})")
    else:
        raise AssertionError("a refused launch did not raise")
    torch.cuda.synchronize()
    ds.reset_launch_counts()
    return cases


def dg_decisions(err_a, err_b, noise):
    """Members whose top-two |err| margin (of ``err_b``) clears 4x the noise,
    and how many of them both sides refine at the same element."""
    import torch

    top2 = torch.topk(err_b.abs(), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4 * noise
    same = torch.argmax(err_a.abs(), dim=1) == torch.argmax(err_b.abs(), dim=1)
    return int(clear.sum()), int((same & clear).sum())


def phase10(device, errs):
    """The DG-in-time paths through their entry points."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive
    from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import dg_estimate_batched
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    argv = ["--ensemble", "1024", "--per-member", "--device-loop"]
    ds.reset_launch_counts()
    t0 = time.perf_counter()
    hist = dg_adaptive.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dg_estimate_ensemble": ds.dg_estimate_ensemble.launches}
    last = hist[-1]
    say("10", f"main path dg_adaptive {' '.join(argv)}: {len(hist)} iterations, K "
              f"{hist[0].n_active.max()} -> [{last.n_active.min()}..{last.n_active.max()}], "
              f"{last.n_refining} of 1024 still refining, wall {wall:.3f} s, wrapper launches "
              f"{launches}")
    assert launches["dg_estimate_ensemble"] > 0, "the DG slab kernel was not launched"
    for r in hist:
        assert np.all(np.isfinite(r.err)) and np.all(np.isfinite(r.j))

    # replay every iteration's partitions: the plain version (float32, same
    # card, bounded) and the torch engine in float64 (decisions only)
    sin = odes.get_ode("du/dt=sin(u)")
    y0s = np.random.default_rng(0).uniform(0.5, 2.0, 1024)
    k = hist[0].times.shape[1] - 1
    ops_p, ops_a = dg_time_operators(1), dg_time_operators(2)
    plan = ds.make_cuda_dg_estimate_ensemble(sin, ops_p, ops_a, k, 8, device=device).plan
    y32 = torch.tensor(y0s.astype(np.float32), device=device)
    y64 = torch.tensor(y0s.astype(np.float32).astype(np.float64), device=device)
    worst = {"err": 0.0, "tol": 0.0}
    decided = agree = decided64 = agree64 = 0
    for r in hist:
        times = torch.tensor(r.times, dtype=torch.float32, device=device)
        plain = ds.dg_estimate_ensemble_plain(times, y32, plan)
        tol = dg_tol(plain, k, ops_p, ops_a)
        err_k = torch.tensor(r.err, dtype=torch.float32, device=device)
        e = float((err_k - plain[2]).abs().max())
        assert e <= tol["err"], (e, tol["err"])
        worst["err"], worst["tol"] = max(worst["err"], e), max(worst["tol"], tol["err"])
        d, a = dg_decisions(err_k, plain[2], tol["err"])
        decided, agree = decided + d, agree + a
        err64 = dg_estimate_batched(ops_p, ops_a, sin.f, times.double(), y64, f_u=sin.f_u,
                                    newton_iters=8)[2]
        d, a = dg_decisions(err_k.double(), err64, tol["err"])
        decided64, agree64 = decided64 + d, agree64 + a
    errs["dg_estimate_ensemble"] = max(errs["dg_estimate_ensemble"], worst["err"])
    say("10", f"replay of {len(hist)} iterations' partitions through the plain version: max|d err| "
              f"{worst['err']:.3e} (tol <= {worst['tol']:.3e}); decisions with a top-two margin > "
              f"4x the err bound: {decided} of {len(hist) * 1024} member-iterations, "
              f"kernel and plain agree on {agree}; against the float64 torch engine {decided64} "
              f"clear it, agreement on {agree64}")
    assert agree == decided and agree64 == decided64, "a decision above the float32 noise differs"

    ens = dg_adaptive.main(["--ensemble", "1024"])
    torch.cuda.synchronize()
    say("10", f"dg_adaptive --ensemble 1024 (shared partition, cuda engine): {len(ens)} iterations, "
              f"K {len(ens[0].times) - 1} -> {len(ens[-1].times) - 1}, mean Adj-W Res "
              f"{ens[0].est_total_mean:+.4e} -> {ens[-1].est_total_mean:+.4e}")
    assert np.isfinite(ens[-1].est_total_mean) and len(ens[-1].times) > len(ens[0].times)

    t0 = time.perf_counter()
    card = dg_adaptive.main(["--maxit", "30"])
    wall = time.perf_counter() - t0
    cpu = dg_adaptive.main(["--maxit", "30", "--device", "cpu"])
    assert len(card) == len(cpu)
    diff = 0.0
    for a, b in zip(card, cpu):
        assert np.array_equal(a.times, b.times)
        for f in ("u", "v", "err"):
            diff = max(diff, float(np.max(np.abs(getattr(a, f) - getattr(b, f)))))
        for f in ("j_coarse", "j_fine", "est_total"):
            diff = max(diff, abs(getattr(a, f) - getattr(b, f)))
    say("10", f"dg_adaptive --maxit 30 (float64 on the card): {len(card)} iterations, K="
              f"{len(card[-1].times) - 1}, Σerr {card[0].est_total:+.4e} -> "
              f"{card[-1].est_total:+.4e}, wall {wall:.2f} s; equal partitions to --device cpu, "
              f"max value difference {diff:.3e} (limit 1e-12)")
    assert diff <= 1e-12
    return launches


def solve_ops(m):
    """FP32 operations of one m×m solve by elimination (a division per row)
    and back substitution, the least count, whatever the kernel runs (Cramer
    for m ≤ 4 costs more, and the bound does not charge that choice)."""
    elim = sum((m - c - 1) * (1 + 2 * (m - c - 1) + 2) for c in range(m))
    return elim + sum(2 * (m - i - 1) + 1 for i in range(m))


def dg_slab_bound(n, k, b, newton_iters, nqp, nqa, per_member=False):
    """Least time on the card for one D1 call: the larger of bytes (times
    and y0 read once, u, v and err written once) over 3.35 TB/s and FP32
    operations over 67 TFLOP/s, counted from the kernel's loops — an FMA
    as 2, a division or a sin or cos as 1, the (f, f_u) pair of sin u as 2.
    Per member-element: newton_iters × (Nq_p points of 2Np² + 4Np + 4, the
    residual and Jacobian assembly, one Np×Np solve) and the order-(n+1)
    sweep (Nq_a points of 2Na² + 2Na + 2Np + 4, the assembly, one Na×Na
    solve and vᵀres)."""
    np_, na = n + 1, n + 2
    fwd = newton_iters * (nqp * (2 * np_ * np_ + 4 * np_ + 4) + 4 * np_ * np_ + 3 * np_ + 1
                          + solve_ops(np_))
    adj = (2 * na * np_ + nqa * (2 * na * na + 2 * na + 2 * np_ + 4) + 2 * na * na + na + 1
           + solve_ops(na) + na * (2 * na + 5))
    n_bytes = 4 * ((k + 1) * (b if per_member else 1) + b + b * k * (np_ + na + 1))
    return bound(n_bytes, b * k * (fwd + adj))


def dg_times(device, cases):
    """Phase 11: CUDA events, one warm-up, median of 5, D1 and its plain
    version at 9(a) (libm and fast), 9(e) and 9(c) (one iteration of the
    per-member study); the B=1024 studies with each engine. Returns
    (kernel ms, plain ms) at 9(a) libm for the kernel line."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    out = {}
    for key, label in (("libm", "9(a) libm"), ("fast", "9(a) trig=fast"), ("big", "9(e)"),
                       ("study", "9(c), the studies' shape")):
        run, times, y0 = cases[key]
        b, k = y0.shape[0], run.plan.n_elements
        ms = cuda_ms(lambda: run(times, y0), runs=5)
        plain_ms = cuda_ms(lambda: ds.dg_estimate_ensemble_plain(times, y0, run.plan), runs=5)
        b_ms, b_by = dg_slab_bound(1, k, b, run.plan.newton_iters, run.plan.ops_p.phi.shape[0],
                                   run.plan.ops_a.phi.shape[0], per_member=times.dim() == 2)
        say("11", f"dg_estimate_ensemble {label} B={b} K={k}: kernel {ms:.4f} ms = "
                  f"{b * k * 2 / (ms / 1e3):.4e} slab-solves/s; plain {plain_ms:.3f} ms; kernel "
                  f"speed-up {plain_ms / ms:.1f}x; bound {b_ms:.5f} ms ({b_by}), kernel at "
                  f"{b_ms / ms:.2%} of it")
        out[label] = (ms, plain_ms)

    sin = odes.get_ode("du/dt=sin(u)")
    y0s = np.random.default_rng(DG_STUDY["seed"]).uniform(0.5, 2.0, DG_STUDY["b"])
    kw = dict(f_u=sin.f_u, k0=DG_STUDY["k0"], maxit=DG_STUDY["maxit"], tol=DG_STUDY["tol"],
              newton_iters=DG_STUDY["newton_iters"], ode=sin, device_loop=True,
              dtype=torch.float32, device=device)
    its = DG_STUDY["maxit"] + 1
    for name in ("run_adaptive_dg_ensemble", "run_adaptive_dg_per_member"):
        loop = getattr(dg_loop, name)
        ms_cuda = cuda_ms(lambda: loop(sin.f, y0s, (0.0, 2.0), engine="cuda", **kw), runs=5)
        ms_torch = cuda_ms(lambda: loop(sin.f, y0s, (0.0, 2.0), engine="torch", **kw), runs=1,
                           warmup=0)
        say("11", f"{name} B={DG_STUDY['b']} k0 {DG_STUDY['k0']} maxit {DG_STUDY['maxit']} "
                  f"(device loop, float32): engine cuda {ms_cuda:.3f} ms (median of 5; "
                  f"{ms_cuda / its:.3f} ms per iteration); engine torch {ms_torch:.1f} ms (one "
                  f"run); speed-up {ms_torch / ms_cuda:.1f}x")
    return out["9(a) libm"]


# ------------------------------------------------------------ hp DG-in-time


def hp_inputs(device, b, k, n_user, seed, uniform=None):
    """y0 ~ U(0.5, 2) from ``default_rng(seed)`` (the driver's and bench.py's
    draw), then per-member partitions of [0, 2] with 2..k live slabs whose
    interior nodes lie on a 2⁻¹⁰ grid (distinct, exact in float32),
    zero-width tails at t = 2, and orders 1..n_user (or ``uniform`` on every
    slab)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    y0 = rng.uniform(0.5, 2.0, b)
    t = np.full((b, k + 1), HP_STUDY["t1"])
    ns = np.full((b, k), uniform or 1, np.int64)
    for m, n_act in enumerate(rng.integers(2, k + 1, b)):
        inner = np.sort(rng.choice(np.arange(1, 2048), n_act - 1, replace=False)) / 1024
        t[m, : n_act + 1] = np.concatenate([[0.0], inner, [HP_STUDY["t1"]]])
        if uniform is None:
            ns[m, :n_act] = rng.integers(1, n_user + 1, n_act)
    return (torch.tensor(t, dtype=torch.float32, device=device), torch.tensor(ns, device=device),
            torch.tensor(y0, dtype=torch.float32, device=device))


def hp_kernel(ode, n_user, fo, k, mode, device):
    from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
        dg_adjoint_interp_mixed,
        dg_radau_interp_mixed,
    )
    from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    mops = dg_time_operators_mixed(n_user + fo)
    return hm.make_cuda_dg_estimate_hp_per_member(
        ode, mops, dg_adjoint_interp_mixed(mops), k, n_max_user=n_user, fine_offset=fo,
        newton_iters=HP_STUDY["newton_iters"], adjoint_mode=mode,
        rad=dg_radau_interp_mixed(mops), device=device)


def hp_case(label, device, errs, ode="du/dt=sin(u)", n_user=HP_STUDY["n_max"], fo=HP_STUDY["fo"],
            b=HP_STUDY["b"], k=HP_K, seed=HP_STUDY["seed"], mode="solve", uniform=None):
    """One phase-12 comparison: H1 against its plain version on the card."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    times, ns, y0 = hp_inputs(device, b, k, n_user, seed, uniform)
    run = hp_kernel(ode, n_user, fo, k, mode, device)
    got = run(times, ns, y0)
    torch.cuda.synchronize()
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, want, run.plan)
    e = {}
    for name, g, w in zip(("u_c", "u_f", "v"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), f"{label}: {name}"
        e[name] = float((g - w).abs().max())
    bounds = {"u_c": tol["u"], "u_f": tol["u"], "v": tol["v"]}
    d_err = (got[3] - want[3]).abs().double()
    tail = times[:, :-1] == HP_STUDY["t1"]  # the trailing zero-width slabs
    assert bool(tail.any()) and bool((got[3][tail] == 0).all()), f"{label}: a tail contributed"
    # the err bound is per element: report the worst share of it, and how
    # many elements an err of 0 would fail
    share = float((d_err / tol["err"].clamp_min(1e-300)).max())
    teeth = int((want[3].abs() > tol["err"]).sum())
    say("12", f"{label}: {ode} n_max_user {n_user} fo {fo} (np_max {run.plan.mops.np_max}) K={k} "
              f"B={b} {mode} | " + " ".join(f"{x} {e[x]:.3e} (tol {bounds[x]:.3e})" for x in e)
        + f" err {float(d_err.max()):.3e} (per-element tol <= {float(tol['err'].max()):.3e}, worst "
          f"{share:.2%} of it); max|err| {float(want[3].abs().max()):.3e}, above its tol on "
          f"{teeth} elements; {int(tail.sum())} tail slabs, each contribution exactly 0")
    assert all(e[x] <= bounds[x] for x in e) and bool((d_err <= tol["err"]).all()), (
        f"{label}: the hp kernel disagrees")
    assert teeth > 0, f"{label}: the err bound cannot tell an err of 0 from the plain version's"
    e["err"] = float(d_err.max())
    errs["dg_estimate_hp_per_member"] = max(errs["dg_estimate_hp_per_member"], *e.values())
    return run, (times, ns, y0), got, tol


def phase12(device, errs):
    """The hp kernel against its plain version on the card, float32, both
    adjoint modes; at uniform orders against D1."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    cases = {}
    for mode in ("solve", "reconstruct"):
        cases["a", mode] = hp_case("(a) bench shape", device, errs, mode=mode)
        cases["b", mode] = hp_case("(b)", device, errs, b=HP_BIG["b"], seed=HP_BIG["seed"],
                                   mode=mode)
        hp_case("(c) np_max 8", device, errs, n_user=5, b=1024, seed=7, mode=mode)
        for ode in ("du/dt=t*sin(u)", "gaussian_mixture"):
            hp_case(f"(d) {ode}", device, errs, ode=ode, b=HP_BIG["b"], seed=8, mode=mode)
    # (e) uniform orders: H1 is D1 at order n on the same Gauss rule
    n_gq = 3 * (HP_STUDY["n_max"] + HP_STUDY["fo"]) + 6
    for n in (1, 2, 3):
        run, (times, ns, y0), got, tol = hp_case(f"(e) uniform order {n}", device, errs,
                                                 seed=10 + n, uniform=n)
        d1 = ds.make_cuda_dg_estimate_ensemble(
            "du/dt=sin(u)", dg_time_operators(n, n_gq), dg_time_operators(n + 1, n_gq), HP_K,
            HP_STUDY["newton_iters"], device=device)(times, y0)
        torch.cuda.synchronize()
        d_err = (got[3] - d1[2]).abs().double()
        e = (float((got[0][..., : n + 1] - d1[0]).abs().max()),
             float((got[2][..., : n + 2] - d1[1]).abs().max()), float(d_err.max()))
        pads = (float(got[0][..., n + 1:].abs().max()), float(got[2][..., n + 2:].abs().max()))
        say("12", f"(e) order {n}: H1 vs D1 (same Gauss rule) u {e[0]:.3e} (tol {tol['u']:.3e}) "
                  f"v {e[1]:.3e} (tol {tol['v']:.3e}) err {e[2]:.3e} (per-element tol, worst "
                  f"{float((d_err / tol['err'].clamp_min(1e-300)).max()):.2%} of it); padded "
                  f"nodes max |u| {pads[0]:.1e} |v| {pads[1]:.1e}")
        assert e[0] <= tol["u"] and e[1] <= tol["v"] and bool((d_err <= tol["err"]).all())
        assert max(pads) == 0
    hp_refusals(cases["a", "solve"])
    return cases


def hp_refusals(case):
    """The hp wrapper on the card refuses what the kernel does not take."""
    import torch

    run, (times, ns, y0), _, _ = case
    for bad, exc in ((lambda: run(times.double(), ns, y0.double()), TypeError),
                     (lambda: run(times, ns, torch.cat([y0, y0])[::2]), ValueError)):
        try:
            bad()  # float64, then a non-contiguous operand
        except exc:
            continue
        raise AssertionError("the hp wrapper took an input it must refuse")
    say("12", "float64 and non-contiguous inputs raise; no plain-version fallback on the card")


def hp_replay(hist, mode, device, errs):
    """Every iteration's partitions and orders of a per-member study through
    the plain version (float32, held to H1's per-element bound) and the
    torch engine (float64, decisions only): the p/h decisions of members
    whose top-two |err| margin clears 4x the member's largest bound."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import dg_estimate_mixed
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    sin = odes.get_ode("du/dt=sin(u)")
    plan = hp_kernel(sin, HP_STUDY["n_max"], HP_STUDY["fo"], HP_K, mode, device).plan
    y32 = np.random.default_rng(HP_STUDY["seed"]).uniform(0.5, 2.0, HP_STUDY["b"]).astype(
        np.float32)
    y0, y64 = (torch.tensor(y32, dtype=d, device=device) for d in (torch.float32, torch.float64))
    out = dict(decided=0, agree=0, decided64=0, agree64=0, err=0.0, share=0.0, tol=0.0)
    for r in hist:
        times = torch.tensor(r.times, dtype=torch.float32, device=device)
        ns = torch.tensor(r.ns, dtype=torch.int64, device=device)
        plain = hm.dg_estimate_hp_per_member_plain(times, ns, y0, plan)
        tol = hm.hp_kernel_tolerance(times, ns, y0, plain, plan)["err"]
        err_k = torch.tensor(r.err, dtype=torch.float32, device=device)
        d_err = (err_k - plain[3]).abs().double()
        assert bool((d_err <= tol).all()), (float(d_err.max()), float(tol.max()))
        out["err"], out["tol"] = max(out["err"], float(d_err.max())), max(out["tol"],
                                                                          float(tol.max()))
        out["share"] = max(out["share"], float((d_err / tol.clamp_min(1e-300)).max()))
        err64 = dg_estimate_mixed(plan.mops, plan.interp, sin.f, times.double(), ns, y64,
                                  fine_offset=HP_STUDY["fo"], adjoint_mode=mode, rad=plan.rad,
                                  f_u=sin.f_u, newton_iters=HP_STUDY["newton_iters"])[3]
        noise = tol.amax(dim=1)
        for key, (d, a) in (("", dg_decisions(err_k, plain[3], noise)),
                            ("64", dg_decisions(err_k.double(), err64, noise))):
            out["decided" + key] += d
            out["agree" + key] += a
    errs["dg_estimate_hp_per_member"] = max(errs["dg_estimate_hp_per_member"], out["err"])
    assert out["decided"] > 0, "no decision of the study clears the float32 bound"
    assert out["agree"] == out["decided"] and out["agree64"] == out["decided64"], out
    return out


def phase13(device, errs):
    """The hp paths through their entry points."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    b, its = HP_STUDY["b"], HP_STUDY["maxit"] + 1
    launches = None
    for mode in ("solve", "reconstruct"):
        argv = HP_ARGV + ["--per-member", "--device-loop", "--adjoint", mode]
        hm.reset_launch_counts()
        t0 = time.perf_counter()
        hist = dg_adaptive.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = hm.dg_estimate_hp_per_member.launches
        last = hist[-1]
        say("13", f"{'main path ' if launches is None else ''}dg_adaptive {' '.join(argv)}: "
                  f"{len(hist)} iterations, K {hist[0].n_active.max()} -> [{last.n_active.min()}.."
                  f"{last.n_active.max()}], max order {last.ns.max()}, {last.n_refining} of {b} "
                  f"refining, mean |est| {np.abs(hist[0].est_total).mean():.3e} -> "
                  f"{np.abs(last.est_total).mean():.3e}, wall {wall:.3f} s, H1 launches {n_launch}")
        assert n_launch == its and len(hist) == its, (n_launch, len(hist))
        for r in hist:
            assert np.all(np.isfinite(r.err)) and np.all(np.isfinite(r.j_coarse))
        if launches is None:
            launches = {"dg_estimate_hp_per_member": n_launch}
        rep = hp_replay(hist, mode, device, errs)
        say("13", f"replay ({mode}) of {len(hist)} iterations through the plain version: max|d err| "
                  f"{rep['err']:.3e} (per-element tol <= {rep['tol']:.3e}, worst "
                  f"{rep['share']:.2%} of it); decisions with a top-two margin > 4x the member's "
                  f"largest err bound: {rep['decided']} of {len(hist) * b} member-iterations, "
                  f"kernel and plain agree on {rep['agree']}; against the float64 torch engine "
                  f"{rep['decided64']} clear it, agreement on {rep['agree64']}")

    hm.reset_launch_counts()
    ens = dg_adaptive.main(HP_ARGV)
    torch.cuda.synchronize()
    say("13", f"dg_adaptive {' '.join(HP_ARGV)} (shared partition, cuda engine): {len(ens)} "
              f"iterations, K {len(ens[0].ns)} -> {len(ens[-1].ns)}, orders "
              f"{ens[-1].ns.min()}..{ens[-1].ns.max()}, mean Adj-W Res {ens[0].est_total:+.4e} -> "
              f"{ens[-1].est_total:+.4e}, H1 launches {hm.dg_estimate_hp_per_member.launches}")
    assert len(ens) == its and hm.dg_estimate_hp_per_member.launches == its
    assert all(np.isfinite(r.est_total) and np.all(np.isfinite(r.u)) for r in ens)

    argv = ["--hp", "p", "--k0", "4", "--order", "1", "--n-max", "4", "--tol", "1e-9"]
    with redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        card = dg_adaptive.main(argv)
        wall = time.perf_counter() - t0
        cpu = dg_adaptive.main(argv + ["--device", "cpu"])
    assert len(card) == len(cpu)
    diff = 0.0
    for a, c in zip(card, cpu):
        assert np.array_equal(a.times, c.times) and np.array_equal(a.ns, c.ns)
        for f in ("u", "v", "err"):
            diff = max(diff, float(np.max(np.abs(getattr(a, f) - getattr(c, f)))))
        for f in ("j_coarse", "j_fine", "est_total"):
            diff = max(diff, abs(getattr(a, f) - getattr(c, f)))
    say("13", f"dg_adaptive {' '.join(argv)} (float64 on the card): {len(card)} iterations, "
              f"orders {card[-1].ns.tolist()}, est {card[0].est_total:.4e} -> "
              f"{card[-1].est_total:.4e}, wall {wall:.2f} s; equal partitions and orders to "
              f"--device cpu, max value difference {diff:.3e} (limit 1e-12)")
    assert diff <= 1e-12 and abs(card[-1].est_total) < 1e-9
    return launches


def dg_hp_bound(times, ns, newton_iters, fo, nq, np_max, adjoint_mode):
    """Least time on the card for one H1 call: the larger of bytes (times,
    ns and y0 read once; u_c, u_f, v (B, K, np_max) and err written once)
    over 3.35 TB/s and FP32 operations over 67 TFLOP/s, counted as in
    dg_slab_bound at each LIVE (positive-width) member-element's own orders
    — coarse p = n+1 nodes, fine n+fo+1, adjoint n+2 (its system n+1 nodes
    in the reconstruct mode, plus the Radau lift) — not the padded np_max,
    so the bound does not depend on the padding. A Newton step at p nodes:
    Nq points of 2p² + 5p + 4, the assembly 4p² + 3p, one p×p solve and
    the update."""
    import numpy as np

    t, n = times.double().cpu().numpy(), ns.cpu().numpy()
    b, k = n.shape
    n = n[np.diff(t, axis=1) > 0]
    solve = np.vectorize(solve_ops)

    def march(p):
        return newton_iters * (nq * (2 * p * p + 5 * p + 4) + 4 * p * p + 4 * p + solve(p))

    pc, pf, pa = n + 1, n + fo + 1, n + 2
    ps = pa if adjoint_mode == "solve" else pc
    adj = (2 * pa * pc + nq * (2 * pc + 4 + 2 * pa + ps + 2 * ps * ps) + 2 * ps * ps + 2 * ps
           + solve(ps) + pa * (2 * pa + 6))
    if adjoint_mode == "reconstruct":
        adj = adj + 2 * pa * pc + 2 * pa * pa
    n_ops = float(np.sum(march(pc) + march(pf) + adj))
    n_bytes = 4 * (b * (k + 1) + b * k + b + 3 * b * k * np_max + b * k)
    return bound(n_bytes, n_ops)


def hp_times(device, cases):
    """Phase 14: CUDA events, one warm-up, median of 5, H1 and its plain
    version at 12(a) and 12(b) in each adjoint mode; the B = 512 and 4096
    per-member studies (device loop) with each engine. Returns (kernel ms,
    plain ms, bound) at 12(a) solve for the kernel line."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    out = {}
    for key in (("a", "solve"), ("a", "reconstruct"), ("b", "solve"), ("b", "reconstruct")):
        run, (times, ns, y0), _, _ = cases[key]
        plan = run.plan
        ms = cuda_ms(lambda: run(times, ns, y0), runs=5)
        plain_ms = cuda_ms(lambda: hm.dg_estimate_hp_per_member_plain(times, ns, y0, plan), runs=5)
        b_ms, b_by = dg_hp_bound(times, ns, plan.newton_iters, plan.fine_offset,
                                 plan.mops.rq.shape[0], plan.mops.np_max, plan.adjoint_mode)
        b = y0.shape[0]
        say("14", f"dg_estimate_hp_per_member 12({key[0]}) {key[1]} B={b} K={HP_K}: kernel "
                  f"{ms:.4f} ms = {b * HP_K / (ms / 1e3):.4e} member-elements/s; plain "
                  f"{plain_ms:.3f} ms; kernel speed-up {plain_ms / ms:.1f}x; bound {b_ms:.6f} ms "
                  f"({b_by}), kernel at {b_ms / ms:.2%} of it")
        out[key] = (ms, plain_ms, (b_ms, b_by))

    sin = odes.get_ode("du/dt=sin(u)")
    kw = dict(f_u=sin.f_u, k0=HP_STUDY["k0"], n0=1, n_max=HP_STUDY["n_max"], mode="hp", tol=0.0,
              maxit=HP_STUDY["maxit"], newton_iters=HP_STUDY["newton_iters"], ode=sin,
              device_loop=True, dtype=torch.float32, device=device)
    its = HP_STUDY["maxit"] + 1
    for b, seed in ((HP_STUDY["b"], HP_STUDY["seed"]), (HP_BIG["b"], HP_BIG["seed"])):
        y0s = np.random.default_rng(seed).uniform(0.5, 2.0, b).astype(np.float32)

        def study(engine, y0s=y0s):
            hp_loop.run_adaptive_dg_hp_per_member(sin.f, y0s, (0.0, HP_STUDY["t1"]),
                                                  engine=engine, **kw)

        ms_cuda = cuda_ms(lambda: study("cuda"), runs=5)
        ms_torch = cuda_ms(lambda: study("torch"), runs=1, warmup=0)
        say("14", f"run_adaptive_dg_hp_per_member B={b} k0 {HP_STUDY['k0']} n_max "
                  f"{HP_STUDY['n_max']} maxit {HP_STUDY['maxit']} (device loop, float32): engine "
                  f"cuda {ms_cuda:.3f} ms (median of 5; {ms_cuda / its:.3f} ms per iteration); "
                  f"engine torch {ms_torch:.1f} ms (one run); speed-up {ms_torch / ms_cuda:.1f}x")
        if b == HP_STUDY["b"]:
            study_trace(lambda: study("cuda"), "hp_kernel")
    return out["a", "solve"]


def study_trace(run, kernel):
    """One warm run of ``run`` under torch.profiler: the wall under the
    profiler, the device time summed over the kernels it ran, the device's
    busy share of the wall, ``kernel``'s share of the device time, and the
    host's stream synchronisations and copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    total = sum(dev_ms(e) for e in events)
    mine = sum(dev_ms(e) for e in events if kernel in e.key)
    n_mine = sum(e.count for e in events if kernel in e.key)
    calls = {k: sum(e.count for e in events if e.key == k)
             for k in ("cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync")}
    say("14", f"torch.profiler over one warm study: wall {wall:.3f} ms under the profiler, device "
              f"busy {total:.3f} ms ({total / wall:.1%} of the wall, idle {1 - total / wall:.1%}); "
              f"{kernel} {mine:.3f} ms in {n_mine} launches ({mine / max(total, 1e-12):.1%} of the "
              f"device time); host calls {calls}")


def instance_name(mangled: str) -> str:
    """A kernel instance's readable name from its mangled one, e.g.
    dg_estimate_kernel<4, OdeSin<Libm>>."""
    import re

    m = re.search(r"([a-z_]+_kernel)I(?:Li(\d+)E)?N3aoa(\d+)", mangled)
    if m is None:
        return mangled
    ode = mangled[m.end(): m.end() + int(m.group(3))]
    trig = next((t for t in ("FastTrig", "Libm") if t in mangled), None)
    args = ([m.group(2)] if m.group(2) else []) + [f"{ode}<{trig}>" if trig else ode]
    return f"{m.group(1)}<{', '.join(args)}>"


def main() -> int:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"nvidia-smi failed: {exc}", file=sys.stderr)
        return 1
    print(smi.splitlines()[0], flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke test runs only on a GPU", file=sys.stderr)
        return 1
    if not (ROOT / PACKAGE).is_dir():
        print(f"{PACKAGE}/ not found beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    device = torch.device("cuda")
    say("0", f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; TF32 off")

    import numpy as np

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    t0 = time.perf_counter()
    lib = load_library()
    log = lib.build_log.splitlines()
    regs = [ln.split()[4] for ln in log if "registers" in ln]
    spills, name = [], ""
    for ln in log:
        if "Function properties for" in ln:
            name = ln.split(" for ", 1)[1].strip()
        elif "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{instance_name(name)} ({ln.strip()})")
    say("1", f"kernels built in {time.perf_counter() - t0:.2f} s ({lib.path.name}); "
             f"{len(regs)} kernel instances, registers {sorted(set(regs), key=int)}, "
             f"spilling instances {len(spills)}: {spills}")

    errs = {name: 0.0 for name in TPU_KERNELS}
    compare_case("(a) graded", mesh(2, 24, graded=True), 8, 64, device, errs)
    compare_case("(b) N=7", mesh(7, 24, graded=False), 8, 64, device, errs)
    compare_case("(c) headline shapes", mesh(2, 10_000, graded=False), 8, 64, device, errs)

    launches, last_vx = phase3(device)
    compare_case("(d) adaptive study's last mesh",
                 startup_1d(2, 0.0, 2 * np.pi, len(last_vx) - 1, vx=last_vx), 1, 64, device, errs)
    times = phase4(device, errs)
    march_times(device, errs)
    phase5(device)

    inp = fd_inputs(device)
    phase6(device, errs, inp)
    launches.update(phase7(device, errs, inp))
    times.update(fd_times(device, inp))
    study_times(device)

    cases = phase9(device, errs)
    launches.update(phase10(device, errs))
    times["dg_estimate_ensemble"] = dg_times(device, cases)

    hp_cases = phase12(device, errs)
    launches.update(phase13(device, errs))
    hp_ms, hp_plain_ms, hp_bound = hp_times(device, hp_cases)
    times["dg_estimate_hp_per_member"] = (hp_ms, hp_plain_ms)

    bounds = {**dg_bounds(), **fd_bounds(), "dg_estimate_hp_per_member": hp_bound}
    # no single PyTorch call computes any of these pipelines: library_ms is null
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name in TPU_KERNELS
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
