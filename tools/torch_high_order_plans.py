#!/usr/bin/env python3
"""The advection and Burgers kernels' plans above Np = 8, measured on one GPU:
K1 (fwd_fused, no store), K2 (rev_fused), KA (adj_fused) and B1
(burgers_fused, float32 ΠN) at K = 10⁴, B = 8, 256 steps and Np 9, 12 and
16, every candidate plan the plan functions search timed (K2 also at s_f 1
and 2 and on 1024 threads; CUDA events, median of 2 after a warm-up); per
kernel, Np and CTA size a least-squares fit of

    ms = n_steps · warps · step_us + launches · launch_us

(warps: the busiest SM's, CTAs dealt round-robin), and across
Np the fit step_us = c0 + c2·Np²: at 512 threads the constants of
ops/cuda/dg_rhs.py's and ops/cuda/burgers.py's cost models above Np = 8. Also prints the registers
and spills nvcc reported for every instance at Np ≥ 9, the sweep's time of
the plan each plan function picks beside the fastest, and times the
headline pipeline (K1 storing every step, then K2; 2048 steps) and B1 at
2048 steps at each Np through the wrappers.

    python3 tools/torch_high_order_plans.py [--out FILE]

Needs an NVIDIA GPU; builds the kernels of this checkout. ``--out`` writes
every timing as JSON.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
NPS = (9, 12, 16)
SWEEP = dict(k=10_000, b=8, n_steps=256)
HEADLINE = dict(k=10_000, b=8, n_steps=2048)
REV_STEPS = (1, 2, 4, 8)


def warps_of(k, b, plan, sms, window):
    return -(-plan.n_tiles * b // sms) * -(-window // 32)


def fit(rows):
    """(step_us, launch_us) by least squares over rows of (step-warps,
    launches, ms)."""
    a = np.array([[r[0], r[1]] for r in rows], dtype=float)
    y = np.array([r[2] * 1e3 for r in rows], dtype=float)
    return tuple(float(x) for x in np.linalg.lstsq(a, y, rcond=None)[0])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, load_library

    device = torch.device("cuda")
    lib = load_library()
    for line in cs.kernel_registers(lib.build_log, cs.HIGH_KERNELS):
        if int(re.findall(r"\d+", line.split("<", 1)[1])[0]) >= 9:
            print(f"[registers] {line}", flush=True)
    sms = dg_rhs._sm_count(device)
    k, b, n = SWEEP["k"], SWEEP["b"], SWEEP["n_steps"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    record = {"card": card, "sweep": {}}
    fits = {}
    for np_ in NPS:
        disc = cs.mesh(np_ - 1, k, graded=False)
        ops = dg_rhs.kernel_ops(disc, cs.A, cs.cfl_step(disc), device)
        u0, lam = cs.high_inputs(disc, b, device, seed=200 + np_)
        traj = torch.empty((n, *u0.shape), dtype=torch.float32, device=device)
        uf, _ = dg_rhs._k1_launch(lib, u0, 0.0, n, traj, 1, ops,
                                  dg_rhs.fwd_fused_plan(k, 4, 512))
        dt_b = cs.BURGERS["cfl"] * float(np.min(np.abs(disc.x[0] - disc.x[1])))
        tab = cb.burgers_tables(disc, dt_b, "n", device)
        u_b = cs.burgers_ics(disc, b, device, torch.float32)
        rev = [p for s in REV_STEPS for t in dg_rhs.FUSED_THREADS
               for p in dg_rhs._tilings(k, b, sms, dg_rhs.fused_plan(k, s, t))]
        runs = {
            "K1": (list(dg_rhs._window_plans(k, b, n, sms)),
                   lambda p: dg_rhs._k1_launch(lib, u0, 0.0, n, None, 1, ops, p)),
            "KA": (list(dg_rhs._window_plans(k, b, n, sms)),
                   lambda p: dg_rhs._ka_launch(lam, n, ops, p)),
            "K2": (rev, lambda p: dg_rhs._k2_launch(traj, uf, lam, 0.0, ops, p)),
            "B1": (list(cb._plans(k, b, np_, n, "n", False, sms)),
                   lambda p: cb._b1_launch(u_b, n, tab, p)),
        }
        for name, (plans, call) in runs.items():
            rows = []
            for plan in plans:
                window = (cb.window_of(k, plan) if name == "B1"
                          else min(plan.tile + 2 * plan.ghost, k))
                ms = cs.cuda_ms(lambda: call(plan), runs=2)
                rows.append((plan, n * warps_of(k, b, plan, sms, window),
                             -(-n // plan.segment), ms))
            by_threads = {}
            for plan, sw, nl, ms in rows:
                by_threads.setdefault(plan.threads, []).append((sw, nl, ms))
            fits[(name, np_)] = {t: fit(r) for t, r in by_threads.items()}
            best = min(rows, key=lambda r: r[3])
            print(f"[sweep] {name} Np={np_} K={k} B={b} steps={n}: {len(rows)} plans, fastest "
                  f"{best[3]:.3f} ms (s_f={best[0].segment} W={best[0].ghost} L={best[0].tile} "
                  f"tiles={best[0].n_tiles} threads={best[0].threads}); fit (step_us, launch_us) "
                  f"by CTA size {fits[(name, np_)]}", flush=True)
            record["sweep"][f"{name} Np={np_}"] = [
                [p.segment, p.ghost, p.tile, p.n_tiles, p.threads, sw, nl, ms]
                for p, sw, nl, ms in rows]
        del traj
    for name in ("K1", "KA", "K2", "B1"):
        for threads in (512, 1024):
            pts = [(np_, fits[(name, np_)][threads]) for np_ in NPS
                   if threads in fits[(name, np_)]]
            if len(pts) < 2:
                continue
            a = np.array([[1.0, p ** 2] for p, _ in pts])
            c = np.linalg.lstsq(a, np.array([f[0] for _, f in pts]), rcond=None)[0]
            launch = float(np.mean([f[1] for _, f in pts]))
            print(f"[fit] {name} {threads} threads: step_us = {c[0]:.5f} + {c[1]:.6f}·Np², "
                  f"launch_us {launch:.2f} (per Np: "
                  + ", ".join(f"{p}: {f[0]:.4f}/{f[1]:.1f}" for p, f in pts) + ")", flush=True)
    # the plans the plan functions pick at the sweep's shape, against the fastest measured
    for np_ in NPS:
        picked = {"K1": dg_rhs.forward_plan(k, b, np_, n, None, sms),
                  "KA": dg_rhs.adjoint_plan(k, b, np_, n, sms),
                  "K2": dg_rhs.stored_plan(k, b, np_, n, sms),
                  "B1": cb.burgers_plan(k, b, np_, n, "n", False, sms)}
        line = []
        for name, plan in picked.items():
            rows = record["sweep"][f"{name} Np={np_}"]
            ms = next(r[7] for r in rows if tuple(r[:5]) == tuple(plan))
            line.append(f"{name} {ms:.3f} ms on s_f={plan.segment} L={plan.tile} "
                        f"threads={plan.threads} ({ms / min(r[7] for r in rows):.3f}x the fastest)")
        print(f"[picked] Np={np_}: " + "; ".join(line), flush=True)
    kh, bh, nh = HEADLINE["k"], HEADLINE["b"], HEADLINE["n_steps"]
    for np_ in NPS:
        disc = cs.mesh(np_ - 1, kh, graded=False)
        ops = dg_rhs.kernel_ops(disc, cs.A, cs.cfl_step(disc), device)
        u0 = cs.phased_states(disc, bh, device, torch.float32)
        lam = cs.batched_cotangent(disc, bh, device, torch.float32)
        t_pipe = cs.cuda_ms(lambda: dg_rhs.adj_est_stored(
            *dg_rhs.fwd_march(u0, 0.0, nh, ops, True), lam, 0.0, ops), runs=3)
        dt_b = cs.BURGERS["cfl"] * float(np.min(np.abs(disc.x[0] - disc.x[1])))
        tab = cb.burgers_tables(disc, dt_b, "n", device)
        u_b = cs.burgers_ics(disc, bh, device, torch.float32)
        t_b = cs.cuda_ms(lambda: cb.burgers_march(u_b, nh, tab), runs=3)
        print(f"[headline] Np={np_} K={kh} B={bh} steps={nh}: K1 trajectory + K2 {t_pipe:.3f} "
              f"ms, B1 ΠN float32 {t_b:.3f} ms (median of 3)", flush=True)
        record[f"headline Np={np_}"] = [t_pipe, t_b]
    if args.out:
        Path(args.out).write_text(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
