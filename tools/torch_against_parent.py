#!/usr/bin/env python3
"""A kernel of this checkout against another checkout's, in turns in one
process, on one GPU.

    python3 tools/torch_against_parent.py PARENT_ROOT --kernel kt1|f1|f2

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``). The parent's sources are built with nvcc
into build/parent_<kernel>/ by tools/torch_d1_kt2_against_parent.py's
loader.

- ``--kernel kt1``: the parent's ``dg_tiled_fwd`` is the launch-a-segment
  KT1 (csrc/dg_tiled.cu), C signature (np, nk, n_segments, seg, tile_l,
  ghost, seg_first, t0, dt, a, rk, tables, rx, fsl, fsr, u0, traj, u_final,
  ubuf, stream). At chip_smoke.py's TILED_ROWS (K = 10⁵, segment 8, 256
  steps; K = 10⁶, segment 16, 64 steps) on the tiled_grid factory's tile
  plan: the parent's kernel and this ``tiled_fwd_seg`` (K1's fused kernel at
  B = 1), whole and one segment a call from the global step offset (the
  sharded composition's calls), the same trajectory and u_final bits,
  timed in turns (CUDA events, median of 5 each way), with the CUDA
  launches and the share of KT1's bound.
- ``--kernel f1``: the parent's ``fd_ensemble`` is the one-thread-an-IC F1,
  C signature (ode_id, fast_trig, n_u, n_t, consts, n, n_steps, rf, grid,
  u0, err, stream), and its ``fd_estimate_per_member`` F3 has this
  checkout's C signature. At chip_smoke.py's F1_CASES (FD_ENSEMBLE's
  102,400 ICs, 16 steps, rf 4, in both trig modes; 4,096 ICs): the parent's
  F1 as its wrapper called it (a Stream object for the handle, the
  constants' address taken a call) and this wrapper (fd_ens_plan's launch), each within
  fd_kernel_tolerance of the plain version, timed in turns through the
  call (CUDA events), on the device alone (20 calls queued behind a sleep)
  and on the host clock (µs a call to enqueue); F3 at the per-member
  study's shape (B = 1024, 43 steps) the same way, the parent's host work
  around this kernel; and the SASS instruction count of every
  fd_ensemble_kernel instance of both (cuobjdump), the libm and fast-trig
  paths side by side.
- ``--kernel f2``: the parent's ``fd_ensemble_vec`` is the one-thread-an-IC
  F2, C signature (ode_id, n, n_steps, rf, grid, u0, err, stream) on
  component-major (d, n) states. At chip_smoke.py's F2_CASES (102,400 and
  4,096 ICs, the harmonic oscillator, 16 steps, rf 4): the parent's F2 as
  its wrapper called it (a transposed copy of the states a call) and this
  wrapper (fd_ens_plan's launch for d = 2, the states as given), each within
  fd_kernel_tolerance(…, d=2) of the plain version, timed in turns through
  the call (CUDA events), on the device alone (20 calls queued behind a
  sleep) and on the host clock; and the SASS instruction count of every
  fd_ensemble_vec_kernel instance of both.

Exits 1 on any difference.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def build(parent: Path, kernel: str):
    from torch_d1_kt2_against_parent import nvcc_shared

    out = ROOT / "build" / f"parent_{kernel}" / "libparent.so"
    csrc = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    src = {"kt1": "dg_tiled.cu", "f1": "fd_ensemble.cu", "f2": "fd_ensemble.cu"}[kernel]
    if nvcc_shared(out, [csrc / src]).wait():
        raise SystemExit("nvcc failed")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    par = ctypes.CDLL(str(out))
    if kernel == "kt1":
        par.dg_tiled_fwd.argtypes = [i] * 7 + [d] * 3 + [p] * 10
    elif kernel == "f2":
        par.fd_ensemble_vec.argtypes = [i] * 4 + [p] * 4
    else:
        par.fd_ensemble.argtypes = [i, i, i, i, p, i, i, i, p, p, p, p]
        par.fd_estimate_per_member.argtypes = ([i, i, i, p, i, i, i, i, ctypes.c_float]
                                               + [i] * 3 + [p] * 5)
    return par, out


def turns_line(turns: dict, fmt: str = ".4f") -> str:
    return " | ".join(f"{name} {statistics.mean(t):{fmt}} ({t[0]:{fmt}} / {t[1]:{fmt}})"
                      for name, t in turns.items())


# ----------------------------------------------------------------------- KT1


def parent_kt1(par, u0, t0, n_segments, plan, ops, first_segment=0):
    """One call of the parent's KT1 as its wrapper made it: (traj, u_final)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import _RK

    traj = torch.empty((n_segments * plan.segment, *u0.shape), dtype=torch.float32,
                       device=u0.device)
    u_final = torch.empty_like(u0)
    ubuf = torch.empty((2, u0.numel()), dtype=torch.float32, device=u0.device)
    rx, fsl, fsr = ops.geom32
    code = par.dg_tiled_fwd(
        ops.np_, ops.k, n_segments, plan.segment, plan.tile, plan.ghost, first_segment,
        float(t0), ops.dt, ops.a, _RK.ctypes.data, ops.full.packed.ctypes.data, rx.data_ptr(),
        fsl.data_ptr(), fsr.data_ptr(), u0.data_ptr(), traj.data_ptr(), u_final.data_ptr(),
        ubuf.data_ptr(), torch.cuda.current_stream(u0.device).cuda_stream)
    if code != 0:
        raise SystemExit(f"dg_tiled_fwd returned {code}")
    return traj, u_final


def kt1_half(par, device) -> bool:
    import numpy as np
    import torch

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    ok = True
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for k, seg, chunks, n_steps in cs.TILED_ROWS:
        disc = startup_1d(2, 0.0, 2 * np.pi, k)
        dt = cs.cfl_step(disc)
        ops = dg_rhs.kernel_ops(disc, cs.A, dt, device)
        u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
        plan = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
            disc, cs.A, dt, segment=seg, n_segments=n_steps // seg, chunks=chunks,
            device=device).plan
        n_seg = n_steps // seg
        out = {}

        def by_segment(fwd):
            def run():
                u, parts = u0, []
                for s in range(n_seg):
                    traj, u = fwd(u, s)
                    parts.append(traj)
                out[fwd.__name__] = (torch.cat(parts), u)
            return run

        def par_seg(u, s):
            return parent_kt1(par, u, 0.0, 1, plan, ops, s)

        def this_seg(u, s):
            return dg_tiled.tiled_fwd_seg(u, 0.0, 1, plan, ops, s)

        turns = cs.in_turns({
            "parent": lambda: out.update(parent=parent_kt1(par, u0, 0.0, n_seg, plan, ops)),
            "this": lambda: out.update(this=dg_tiled.tiled_fwd_seg(u0, 0.0, n_seg, plan, ops)),
            "parent a segment a call": by_segment(par_seg),
            "this a segment a call": by_segment(this_seg)})
        n_cuda = dg_tiled.tiled_fwd_seg.cuda_launches
        fused = dg_rhs.forward_plan(k, 1, disc.np_, n_steps, 1, sms)
        ref = out["parent"]
        same = {key: all(bool(torch.equal(x, y)) for x, y in zip(v, ref))
                for key, v in (("this", out["this"]), ("parent a segment a call", out["par_seg"]),
                               ("this a segment a call", out["this_seg"]))}
        ok &= all(same.values())
        b_ms, b_by = cs.advec_bounds(disc.np_, k, n_steps)["tiled_fwd_seg"]
        this_ms = statistics.mean(turns["this"])
        print(f"KT1 K={k} N=2 segment={seg} steps={n_steps}: parent on {plan.n_tiles} tiles of "
              f"{plan.tile} + 2x{plan.ghost} ({n_seg} launches), this on K1's s_f="
              f"{fused.segment} {fused.n_tiles} CTAs of {fused.tile} + 2x{fused.ghost} on "
              f"{fused.threads} threads ({n_cuda} CUDA launches a whole call); ms in turns: "
              f"{turns_line(turns, '.3f')}; "
              f"this at {b_ms / this_ms:.2%} of the {b_ms:.4f} ms bound ({b_by}); bits equal to "
              f"the parent's whole call: {same}", flush=True)
        del out
        torch.cuda.empty_cache()
    return ok


# ------------------------------------------------------------------------ F1


def parent_f1(par, u0s, plan):
    """One call of the parent's F1 as its wrapper made it: err (n_steps, n)."""
    import torch

    n = u0s.shape[0]
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0s.device)
    code = par.fd_ensemble(
        plan.functors.ode_id, int(plan.trig == "fast"), *plan.n_modes, plan.consts.ctypes.data, n,
        plan.n_steps, plan.rf, plan.grid32.data_ptr(), u0s.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(u0s.device).cuda_stream)
    if code != 0:
        raise SystemExit(f"fd_ensemble returned {code}")
    return err


def parent_f3_call(dt_b, u0s, plan):
    """This checkout's F3 kernel with the parent wrapper's host work (a
    Stream object for the handle, the constants' address taken a call)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    lib = load_library()
    b, n_steps = u0s.shape[0], plan.n_steps
    launch = fe.fd_pm_plan(b, n_steps, plan.rf)
    out = torch.empty(b * (n_steps + 1), dtype=torch.float32, device=u0s.device)
    err, j_val = out[: b * n_steps].view(b, n_steps), out[b * n_steps:]
    code = lib.lib.fd_estimate_per_member(
        plan.functors.ode_id, *plan.n_modes, plan.consts.ctypes.data, b, plan.n_steps,
        plan.rf, int(plan.convention == "block"), plan.t0, launch.lanes, launch.threads,
        fe.pm_window(launch, plan.n_steps, plan.rf), dt_b.data_ptr(), u0s.data_ptr(),
        err.data_ptr(), j_val.data_ptr(), torch.cuda.current_stream(u0s.device).cuda_stream)
    lib.check(code, "fd_estimate_per_member", lib.lib.fd_error_string)
    return err, j_val


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call takes to enqueue (no synchronisation
    between calls; the queue holds them all)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def sass_counts(lib_path: Path, name: str) -> dict:
    """SASS instructions of each instance of kernel ``name`` in a shared
    library (cuobjdump -sass), by readable instance name."""
    import chip_smoke as cs

    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not cuobjdump.exists():
        return {"cuobjdump": "not found"}
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            mangled = ln.split("Function :", 1)[1].strip()
            cur = cs.instance_name(mangled) if name in mangled else None
            if cur:
                counts[cur] = 0
        elif cur and ln.strip().startswith("/*") and "*/" in ln and ";" in ln:
            counts[cur] += 1
    return counts


def f1_half(par, par_path, device) -> bool:
    import torch

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    inp = cs.fd_inputs(device)
    s, rf, dt = (cs.FD_ENSEMBLE[k] for k in ("n_steps", "rf", "dt"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ok = True
    for trig, n in cs.F1_CASES:
        u0 = inp["u0"][:n].contiguous()
        run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, trig=trig, device=device)
        stats = {}
        want = fe.fd_ensemble_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf)
        out = {}
        calls = {"parent": lambda: out.update(parent=parent_f1(par, u0, run.plan)),
                 "this": lambda: out.update(this=run(u0))}
        turns = cs.in_turns(calls)
        queued = {key: cs.queued_ms(fn) for key, fn in calls.items()}
        queued.update({f"{key} again": cs.queued_ms(fn) for key, fn in reversed(calls.items())})
        host = {key: host_us(fn) for key, fn in calls.items()}
        errs = {key: float((got - want).abs().max()) for key, got in out.items()}
        ok &= max(errs.values()) <= tol and bool((want.abs() > tol).any())
        print(f"F1 {n} ICs {s} steps rf {rf} trig={trig} (this on "
              f"{fe.fd_ens_plan(n, s, rf, sms)}): ms a call through the call, in turns: "
              f"{turns_line(turns)}; on the device alone (20 calls queued behind a sleep): "
              f"{', '.join(f'{k} {v:.4f}' for k, v in queued.items())}; host µs a call to "
              f"enqueue: {', '.join(f'{k} {v:.1f}' for k, v in host.items())}; max|err - plain| "
              f"{errs} (tol {tol:.3e})", flush=True)

    dt_pm, u0_pm = inp["dt_pm"], inp["u0_pm"]
    pm = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", cs.FD_PM_STEPS, cs.FD_STUDY["rf"],
                                             "block", device=device)
    out = {}
    calls = {"parent's host work": lambda: out.update(parent=parent_f3_call(dt_pm, u0_pm, pm.plan)),
             "this": lambda: out.update(this=pm(dt_pm, u0_pm))}
    turns = cs.in_turns(calls)
    host = {key: host_us(fn) for key, fn in calls.items()}
    same = all(bool(torch.equal(x, y)) for x, y in zip(out["parent"], out["this"]))
    ok &= same
    print(f"F3 B={u0_pm.shape[0]} {cs.FD_PM_STEPS} steps block, one kernel: ms a call through "
          f"the call, in turns: {turns_line(turns)}; host µs a call to enqueue: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in host.items())}; the same bits: {same}",
          flush=True)
    print(f"SASS instructions of fd_ensemble_kernel: parent {sass_counts(par_path, 'fd_ensemble_kernel')}; "
          f"this {sass_counts(load_library().path, 'fd_ensemble_kernel')}", flush=True)
    return ok


# ------------------------------------------------------------------------ F2


def parent_f2(par, u0s, plan):
    """One call of the parent's F2 as its wrapper made it (the states
    transposed to (d, n) a call): err (n_steps, n)."""
    import torch

    n = u0s.shape[0]
    u0t = u0s.T.contiguous()
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0s.device)
    code = par.fd_ensemble_vec(plan.functors.ode_id, n, plan.n_steps, plan.rf, plan.grid_ptr,
                               u0t.data_ptr(), err.data_ptr(),
                               torch._C._cuda_getCurrentRawStream(u0s.device.index))
    if code != 0:
        raise SystemExit(f"fd_ensemble_vec returned {code}")
    return err


def f2_half(par, par_path, device) -> bool:
    import torch

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    inp = cs.fd_inputs(device)
    s, rf, dt = (cs.FD_ENSEMBLE[k] for k in ("n_steps", "rf", "dt"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ok = True
    for n in cs.F2_CASES:
        u0 = inp["u0_vec"][:n].contiguous()
        run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf, d=2)
        out = {}
        calls = {"parent": lambda: out.update(parent=parent_f2(par, u0, run.plan)),
                 "this": lambda: out.update(this=run(u0))}
        turns = cs.in_turns(calls)
        queued = {key: cs.queued_ms(fn) for key, fn in calls.items()}
        queued.update({f"{key} again": cs.queued_ms(fn) for key, fn in reversed(calls.items())})
        host = {key: host_us(fn) for key, fn in calls.items()}
        errs = {key: float((got - want).abs().max()) for key, got in out.items()}
        ok &= max(errs.values()) <= tol and bool((want.abs() > tol).any())
        print(f"F2 {n} ICs {s} steps rf {rf} d=2 (this on {fe.fd_ens_plan(n, s, rf, sms, 2)}): "
              f"ms a call through the call, in turns: {turns_line(turns)}; on the device alone "
              f"(20 calls queued behind a sleep): "
              f"{', '.join(f'{k} {v:.4f}' for k, v in queued.items())}; host µs a call to "
              f"enqueue: {', '.join(f'{k} {v:.1f}' for k, v in host.items())}; max|err - plain| "
              f"{errs} (tol {tol:.3e})", flush=True)
    print(f"SASS instructions of fd_ensemble_vec_kernel: parent "
          f"{sass_counts(par_path, 'fd_ensemble_vec_kernel')}; "
          f"this {sass_counts(load_library().path, 'fd_ensemble_vec_kernel')}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_root", type=Path)
    ap.add_argument("--kernel", choices=("kt1", "f1", "f2"), required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    load_library()
    par, par_path = build(args.parent_root.resolve(), args.kernel)
    device = torch.device("cuda")
    if args.kernel == "kt1":
        ok = kt1_half(par, device)
    else:
        ok = (f1_half if args.kernel == "f1" else f2_half)(par, par_path, device)
    print("all checks passed" if ok else "A CHECK FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
