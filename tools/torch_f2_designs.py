#!/usr/bin/env python3
"""F2's two designs measured on one GPU, at FD_ENSEMBLE's 102,400 ICs.

1. The register design widened: user libraries of Lorenz-96 and of the
   dense system (chip_smoke.py ``lorenz96``, ``dense_system``) at d = 5, 6
   and 8, each built from a copy of csrc/fd_ensemble.cu whose
   ``kVecRegRow`` is 1000 (every node table in registers) and whose
   ``vec_ahead`` is U = 1, 2 and 4 nodes a lane (:func:`variant_library`):
   the registers and spill bytes ptxas reported for each
   ``fd_ensemble_vec_kernel`` instance, and the device time of each
   (fd_ens_plan's launch).
2. The window design (``fd_ensemble_vec_window_kernel``) on the same
   functors at every G in {8, 16, 32} (G >= d), W in {G/2, G, 2G} and CTA
   size in {64, 128, 256} that fits a block, and at d = 2, 3 and 4
   (chip_smoke.py phase 42's traced Van der Pol, rigid body and coupled
   oscillators, the production library) at every G >= d up to 16 and W in
   {G, 2G, 4G} beside the register design's launch.
3. Per system, the fastest window launch and the fastest register instance
   in turns on the device (A B B A, each a median of 5 runs of 20 calls
   queued behind a sleep), and whether the two give the same bits.

Every output is held against the plain version at fd_kernel_tolerance.

    python3 tools/torch_f2_designs.py [--out FILE]

Needs an NVIDIA GPU; builds the kernels of this checkout (~19 user
libraries, in parallel). ``--out`` writes every number as JSON.
"""
import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
N_ICS = 102_400
WIDE = ((5, 16), (6, 14), (8, 8))  # (d, steps): JAX admits d = 6 up to 14 steps
RF, DT = 4, 0.0125
AHEADS = (1, 2, 4)
# the two constants of csrc/fd_ensemble.cu that the variants rewrite
REG_ROW = "constexpr int kVecRegRow = 48;"
AHEAD = "__host__ __device__ constexpr int vec_ahead(int d) { return d <= 4 ? kEnsAhead : 1; }"


def variant_library(kf, u):
    """The user library of ``kf`` (a vector KernelFunctors) with F2's
    register cap lifted to 1000 floats and U = ``u`` nodes a lane: a copy
    of csrc/fd_ensemble.cu with its two constants rewritten, compiled with
    the package's nvcc flags into ``build/torch_kernels/f2_designs/``."""
    from adjoint_ode_adaptivity_tpu_torch.ops import cuda as oc

    src = (oc.CSRC_DIR / "fd_ensemble.cu").read_text()
    for old, new in ((REG_ROW, "constexpr int kVecRegRow = 1000;"),
                     (AHEAD, f"__host__ __device__ constexpr int vec_ahead(int) {{ return {u}; }}")):
        assert src.count(old) == 1, f"csrc/fd_ensemble.cu no longer holds {old!r}"
        src = src.replace(old, new)
    key = hashlib.sha256((src + kf.header).encode()).hexdigest()[:16]
    inc = oc.BUILD_DIR / "f2_designs" / key
    out = inc / f"libaoa_f2-{key}.so"
    t0 = time.perf_counter()
    if not out.exists():
        inc.mkdir(parents=True, exist_ok=True)
        (inc / "aoa_user_functors.cuh").write_text(kf.header)
        (inc / "fd_ensemble.cu").write_text(src)
        oc._build(out, [inc / "fd_ensemble.cu"],
                  ("-DAOA_USER_FUNCTORS", "-I", str(inc), "-I", str(oc.CSRC_DIR)))
    return oc._loaded(out, t0)


def variant_launch(lib, u0, plan, launch):
    """One fd_ensemble_vec call of a variant library on ``launch`` (the
    register design's FdEnsLaunch): err (n_steps, n_ics)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n = u0.shape[0]
    err = torch.empty((plan.n_steps, n), dtype=torch.float32, device=u0.device)
    code = lib.lib.fd_ensemble_vec(plan.functors.ode_id, n, plan.n_steps, plan.rf, launch.lanes,
                                   launch.threads, 0, plan.grid_ptr, u0.data_ptr(),
                                   err.data_ptr(), fe._stream(u0.device))
    lib.check(code, "fd_ensemble_vec", lib.lib.fd_error_string)
    return err


def dev_turns(fns: dict, runs: int = 5) -> dict:
    """Device ms a call of each version, A B … B A, each a median of
    ``runs`` queued_ms readings; name -> (first, second)."""
    import chip_smoke as cs

    order = list(fns) + list(reversed(list(fns)))
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(statistics.median(cs.queued_ms(fns[k]) for _ in range(runs)))
    return {k: tuple(v) for k, v in out.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    names = ("fd_ensemble_vec_kernel", "fd_ensemble_vec_window_kernel")

    systems = {}  # key -> (d, steps, rf, dt, run, u0)
    for name in ("lorenz96", "dense"):
        for d, steps in WIDE:
            comps, jac = cs.wide_system(name, d)
            run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=steps,
                                               ref_factor=RF, dt=DT, device="cpu")
            systems[f"{name} d={d}"] = (d, steps, RF, DT, run,
                                        torch.tensor(cs.wide_u0(name, N_ICS, d), **f32))
    comps, jac = cs.dense_system(15)  # chip_smoke.py phase 44(c): the window design alone
    run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=15, n_steps=1,
                                       ref_factor=16, dt=0.1, device="cpu")
    systems["dense d=15"] = (15, 1, 16, 0.1, run,
                             torch.tensor(cs.wide_u0("dense", N_ICS, 15), **f32))
    s, rf, dt = (cs.FD_ENSEMBLE[k] for k in ("n_steps", "rf", "dt"))
    narrow = {2: ("Van der Pol", cs.vdp_comps, cs.vdp_jac),
              **{d: v for d, v in cs.USER_VECTOR_D.items()}}
    for d, (label, comps, jac) in narrow.items():
        run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=s,
                                           ref_factor=rf, dt=dt, device="cpu")
        u0 = np.random.default_rng(40 + d).uniform(-1.5, 1.5, (N_ICS, d))
        systems[f"{label} d={d}"] = (d, s, rf, dt, run, torch.tensor(u0, **f32))

    builds = {}
    for key, (d, *_, run, _u0) in systems.items():
        kf = run.plan.functors
        builds[(key, 0)] = (lambda kf=kf: kf.library())  # the production library
        if 4 < d <= 8:
            for u in AHEADS:
                builds[(key, u)] = (lambda kf=kf, u=u: variant_library(kf, u))
    with ThreadPoolExecutor(8) as pool:
        libs = dict(zip(builds, pool.map(lambda build: build(), builds.values())))
    report = {"card": smi, "n_ics": N_ICS, "systems": {}}
    for key, (d, steps, rf_, dt_, run, u0) in systems.items():
        plan = fe._plan(run.plan.functors, steps, rf_, dt=dt_, device=dev)
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf_, d)
        nnz = plan.functors.nnz
        rec = {"d": d, "steps": steps, "rf": rf_, "nnz": nnz, "tol": tol, "register": {},
               "window": {}}
        outs, fns = {}, {}
        reg_launch = fe.fd_ens_plan(N_ICS, steps, rf_, sms, d)
        for (k2, u), lib in libs.items():
            if k2 != key or (u == 0) != (d <= 4):
                continue
            u = u or 4  # the production library: U = 4 at d <= 4
            regs = cs.kernel_registers(lib.build_log, names)
            spill = [r for r in regs if r.startswith("fd_ensemble_vec_kernel")]
            spills = any(" 0 bytes spill stores" not in r for r in spill)
            rec["register"][u] = {"ptxas": spill, "build_s": lib.build_seconds,
                                  "spills": spills}
            rec["window_ptxas"] = [r for r in regs if "window" in r]
            print(f"{key} U={u}: built in {lib.build_seconds:.1f} s; {'; '.join(regs)}",
                  flush=True)
            if spills:
                continue
            fn = (lambda lib=lib: (fe._f2_launch(u0, plan, reg_launch) if d <= 4
                                   else variant_launch(lib, u0, plan, reg_launch)))
            out = fn()
            torch.cuda.synchronize()
            e = float((out - want).abs().max())
            ms = statistics.median(cs.queued_ms(fn) for _ in range(5))
            rec["register"][u].update(ms=ms, err=e)
            outs[f"register U={u}"], fns[f"register U={u}"] = out, fn
            print(f"  register U={u} {reg_launch}: {ms:.4f} ms on the device; max|err| {e:.3e} "
                  f"(tol {tol:.3e})", flush=True)
            assert e <= tol, (key, u, e, tol)
        lib = libs[(key, 0)]
        if d > 8:
            rec["window_ptxas"] = cs.kernel_registers(lib.build_log, names)
            print(f"{key}: built in {lib.build_seconds:.1f} s; {'; '.join(rec['window_ptxas'])}",
                  flush=True)
        top = 16 if d <= 4 else 32  # G = 32 at d <= 4 idles 28 lanes of the chain
        for g in (x for x in fe.PM_LANES if d <= x <= top and (d <= 4 or x >= 8)):
            for w in ((g, 2 * g, 4 * g) if d <= 4 else (max(g // 2, 1), g, 2 * g)):
                for th in (64, 128, 256):
                    launch = fe.FdVecLaunch(g, th, w)
                    if th < g or fe.vec_window_smem(launch, steps, rf_, d, nnz) > fe.MAX_SMEM:
                        continue
                    fn = (lambda launch=launch: fe._f2_launch(u0, plan, launch))
                    out = fn()
                    torch.cuda.synchronize()
                    e = float((out - want).abs().max())
                    ms = statistics.median(cs.queued_ms(fn) for _ in range(5))
                    tag = f"window G={g} W={w} T={th}"
                    rec["window"][tag] = {"ms": ms, "err": e}
                    outs[tag], fns[tag] = out, fn
                    print(f"  {tag}: {ms:.4f} ms on the device; max|err| {e:.3e}", flush=True)
                    assert e <= tol, (key, tag, e, tol)
        best_w = min(rec["window"], key=lambda t: rec["window"][t]["ms"])
        best_r = min((t for t in fns if t.startswith("register")), default=None,
                     key=lambda t: rec["register"][int(t.split("=")[1])]["ms"])
        plan_w = fe.vec_window_plan(steps, rf_, d, nnz)
        plan_tag = f"window G={plan_w.lanes} W={plan_w.window} T={plan_w.threads}"
        pick = dict.fromkeys([best_w, plan_tag] + ([best_r] if best_r else []))
        turns = dev_turns({t: fns[t] for t in pick if t in fns})
        rec["turns"] = turns
        rec["same_bits"] = {t: bool(torch.equal(outs[t], outs[best_w])) for t in pick if t in outs}
        print(f"{key}: in turns on the device (ms, A B B A) " + ", ".join(
            f"{t} {v[0]:.4f} / {v[1]:.4f}" for t, v in turns.items())
            + f"; bits equal to {best_w}: {rec['same_bits']}", flush=True)
        report["systems"][key] = rec
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
