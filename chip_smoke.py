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
   and one ``--estimate --kernel cuda`` run.
4. The headline pipeline (K=10^4, N=2, 2048 steps, B=8, stored trajectory),
   timed with CUDA events for the kernels and for their plain versions.
5. The float64 effectivity identity Ση = J(u_dt) − J(u_dt/2) on the
   headline mesh and step (B=1), on bench.py's effectivity problem
   (u0 = sin(800x), J over [π, π+1], 64 steps), through the plain path, to
   1e-10 relative.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is
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
SOURCE = f"{PACKAGE}/csrc/dg_rhs.cu"
TPU_KERNELS = {
    "fwd_march": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:981",
    "adj_est_stored": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:1108",
}


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
        lam = terminal_integral_cotangent(disc, torch.float64).numpy()
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
    spills = [ln for ln in log if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    say("1", f"kernels built in {time.perf_counter() - t0:.2f} s ({lib.path.name}); "
             f"{len(regs)} kernel instances, registers {sorted(set(regs), key=int)}, "
             f"spilling instances {len(spills)}")

    errs = {"fwd_march": 0.0, "adj_est_stored": 0.0}
    compare_case("(a) graded", mesh(2, 24, graded=True), 8, 64, device, errs)
    compare_case("(b) N=7", mesh(7, 24, graded=False), 8, 64, device, errs)
    compare_case("(c) headline shapes", mesh(2, 10_000, graded=False), 8, 64, device, errs)

    launches, last_vx = phase3(device)
    compare_case("(d) adaptive study's last mesh",
                 startup_1d(2, 0.0, 2 * np.pi, len(last_vx) - 1, vx=last_vx), 1, 64, device, errs)
    times = phase4(device, errs)
    phase5(device)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": TPU_KERNELS[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("fwd_march", "adj_est_stored")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
