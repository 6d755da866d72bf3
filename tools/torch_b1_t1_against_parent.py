#!/usr/bin/env python3
"""B1 (burgers_march) and T1 (resblock_epoch_grad) of this checkout against
another checkout's, on one GPU.

    python3 tools/torch_b1_t1_against_parent.py PARENT_ROOT [b1|t1]

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``) whose ``burgers_march_f32/_f64`` is the
one-CTA-per-member B1, C signature (np, nb, nk, n_steps, limiter, tables,
geom, u0, u_out, ubuf, rbuf, avg, stream), and whose ``resblock_epoch_grad``
is the two-launch T1, (S, F, B, mixed, p, dt, u0, tgt, wts, n_active, ramp,
inv_b, traj, gcot, loss_m, loss, grads, stream). Its burgers.cu and
train_fused.cu are built with nvcc into build/parent_b1_t1/; this
checkout's kernels come from ``load_library``. A second argument runs one
of the two halves.

- B1: both on the same states at burgers_dg's shape (K = 48, N = 4, B = 1,
  7,500 steps across the shock), bench.py's rows (K = 10⁴, N = 2, B = 8 and
  1, 2048 steps), graded meshes with all three limiters in float32 and
  float64, and shapes with several tiles; this one on the wrapper's plan
  and on every widest plan (s_f 2-16, 512 and 1024 threads) and the ring
  where a CTA holds the mesh: the output must be the parent's bits.
- T1: both on the same inputs at the variable_params path's S = 2 and 5
  and bench.py's S = 10 (F = 500, B = 8192), masked, mixed, weighted and
  at ragged B: each within resblock_kernel_tolerance of the float64 plain
  version, this one bit-identical on a repeat call.
- Times in turns (parent, this, this, parent; CUDA events, median of 5):
  B1 at burgers_dg's shape and bench.py's rows; T1 at S = 2, 5 and 10.
- Where the time goes: B1's ring (one CTA for the mesh, N = 4, 2000 steps)
  by K and limiter, µs a stage; T1 at S = 2, 5 and 10, the device time a
  call by kernel (torch.profiler) and, at S = 2, the host time a call of
  the wrapper and of its parts (400 calls on the host clock).

Exits 1 on any difference.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# (n_order, K, B, graded, n_steps, limiter, float64, dt)
B1_CASES = [(4, 48, 1, False, 7500, "n", False, 2e-4), (2, 10_000, 8, False, 2048, "n", False, None),
            (2, 10_000, 1, False, 2048, "n", False, None), (4, 48, 8, True, 64, "n", False, 5e-5),
            (4, 48, 8, True, 64, "1", True, 5e-5), (4, 48, 8, True, 64, "none", False, 5e-5),
            (7, 700, 3, True, 45, "1", False, None), (7, 700, 3, True, 45, "n", True, None),
            (2, 2000, 2, False, 100, "none", False, None), (1, 1500, 5, True, 37, "n", True, None),
            (3, 5000, 2, False, 300, "n", False, None)]
B1_TIMED = [(4, 48, 1, False, 7500, "n", False, 2e-4), (2, 10_000, 8, False, 2048, "n", False, None),
            (2, 10_000, 1, False, 2048, "n", False, None)]
# (S, B, variant)
T1_CASES = [(2, 8192, "plain"), (5, 8192, "plain"), (10, 8192, "plain"), (10, 8192, "masked"),
            (10, 8192, "mixed"), (10, 8192, "weighted"), (4, 3000, "plain"), (3, 1000, "mixed"),
            (6, 77, "masked")]
T1_TIMED = [2, 5, 10]


def build_parent(parent: Path) -> ctypes.CDLL:
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import ARCH_FLAGS, _nvcc

    csrc = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "parent_b1_t1"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libparent_b1_t1.so"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib), str(csrc / "burgers.cu"), str(csrc / "train_fused.cu")]
    subprocess.run(cmd, check=True)
    dll = ctypes.CDLL(str(lib))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("burgers_march_f32", "burgers_march_f64"):
        getattr(dll, name).argtypes = [i] * 5 + [p] * 8
        getattr(dll, name).restype = i
    dll.resblock_epoch_grad.argtypes = [i] * 4 + [p] * 6 + [d] * 2 + [p] * 6
    dll.resblock_epoch_grad.restype = i
    return dll


def in_turns(runs: dict) -> dict:
    import torch

    times = {name: [] for name in runs}
    for name in ("parent", "this", "this", "parent"):
        runs[name]()
        ms = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            runs[name]()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        times[name].append(statistics.median(ms))
    return times


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def check_b1(parent, device, sms) -> bool:
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    def parent_b1(u0, n_steps, tab):
        f64 = u0.dtype == torch.float64
        packed = tab.packed if f64 else tab.packed.astype(np.float32)
        geom = tab.geom.to(u0.dtype).contiguous()
        out, work = torch.empty_like(u0), torch.empty((2, *u0.shape), dtype=u0.dtype, device=device)
        avg = torch.empty(u0.shape[1:], dtype=u0.dtype, device=device)
        entry = parent.burgers_march_f64 if f64 else parent.burgers_march_f32
        code = entry(tab.np_, u0.shape[1], tab.k, n_steps, cb.LIMITER_IDS[tab.limiter],
                     packed.ctypes.data_as(ctypes.c_void_p), geom.data_ptr(), u0.data_ptr(),
                     out.data_ptr(), work[0].data_ptr(), work[1].data_ptr(), avg.data_ptr(),
                     stream())
        assert code == 0, code
        return out

    def setup(n_order, k, b, graded, limiter, f64, dt):
        vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
        disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
        if dt is None:
            dt = 0.3 * float(np.min(np.abs(disc.x[0] - disc.x[1])))
        tab = cb.burgers_tables(disc, dt, limiter, device)
        u0 = np.stack([(0.5 + 0.05 * j) * np.sin(disc.x) + (0.5 if k == 48 and b == 1 else 0.0)
                       for j in range(b)], axis=1)
        return tab, torch.tensor(u0, dtype=torch.float64 if f64 else torch.float32,
                                 device=device)

    ok = True
    for n_order, k, b, graded, n_steps, limiter, f64, dt in B1_CASES:
        tab, u0 = setup(n_order, k, b, graded, limiter, f64, dt)
        want = parent_b1(u0, n_steps, tab)
        mine = cb.burgers_plan(k, b, tab.np_, n_steps, limiter, f64, sms)
        plans = {"wrapper": mine}
        for threads in ((512,) if f64 else cb.CTA_THREADS):
            if k <= threads:
                plans[f"ring {threads}"] = cb.BurgersPlan(n_steps, 0, k, 1, threads)
            for steps in (2, 4, 8, 16):
                try:
                    plans[f"s_f={steps} {threads}"] = cb.burgers_fused_plan(
                        k, min(steps, n_steps), threads, limiter)
                except ValueError:
                    pass
        for name, plan in plans.items():
            got, n_cuda = cb._b1_launch(u0, n_steps, tab, plan)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"B1 Np={tab.np_} K={k} B={b} graded={graded} steps={n_steps} limiter "
                  f"{limiter} {'float64' if f64 else 'float32'} {name} {tuple(plan)}: {n_cuda} "
                  f"CUDA launches; bit-equal to the parent's: {same}"
                  + ("" if same else f" (max|d| {float((got - want).abs().max()):.3e})"),
                  flush=True)
            ok &= same and n_cuda == -(-n_steps // plan.segment)
    for n_order, k, b, graded, n_steps, limiter, f64, dt in B1_TIMED:
        tab, u0 = setup(n_order, k, b, graded, limiter, f64, dt)
        t = in_turns({"parent": lambda: parent_b1(u0, n_steps, tab),
                      "this": lambda: cb.burgers_march(u0, n_steps, tab)})
        plan = cb.burgers_plan(k, b, tab.np_, n_steps, limiter, f64, sms)
        print(f"B1 times K={k} N={n_order} B={b} steps={n_steps}: parent "
              f"{t['parent'][0]:.4f} / {t['parent'][1]:.4f} ms, this {t['this'][0]:.4f} / "
              f"{t['this'][1]:.4f} ms on {tuple(plan)} "
              f"(model {cb._cost(k, b, tab.np_, n_steps, plan, sms) / 1e3:.4f} ms)", flush=True)
    for limiter in ("n", "1", "none"):
        for k in (16, 48, 128, 512):
            tab, u0 = setup(4, k, 1, False, limiter, False, 2e-4 * 48 / k)
            ring = cb.BurgersPlan(2000, 0, k, 1, 512)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            cb._b1_launch(u0, 2000, tab, ring)
            start.record()
            cb._b1_launch(u0, 2000, tab, ring)
            end.record()
            torch.cuda.synchronize()
            print(f"B1 ring N=4 K={k} limiter {limiter}: {start.elapsed_time(end) / 10:.4f} us "
                  f"a stage (2000 steps, one CTA of {-(-k // 32) * 32} threads)", flush=True)
    return ok


def host_us(fn, n=400) -> float:
    """µs a call of ``fn`` on the host clock over ``n`` back-to-back calls
    (the device's queue drains after)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, names, calls=20) -> dict:
    """µs a launch on the device of each kernel in ``names`` over ``calls``
    calls of ``fn`` under torch.profiler (per launch it recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        evs = [e for e in prof.key_averages() if name in e.key]
        us = sum(e.self_cuda_time_total if getattr(e, "self_device_time_total", None) is None
                 else e.self_device_time_total for e in evs)
        out[name] = us / max(sum(e.count for e in evs), 1)
    return out


def check_t1(parent, device, sms) -> bool:
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.models import ResBlockSimple
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    f = 500

    def inputs(s_steps, b, variant):
        gen = torch.Generator().manual_seed(s_steps)
        ps = [ResBlockSimple(f).init_params(gen) for _ in range(s_steps)]
        packed = tf.pack_params({k: torch.stack([q[k] for q in ps]) for k in ps[0]}, s_steps,
                                f).to(device)
        rng = np.random.default_rng(b + s_steps)
        dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
        u0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
        tg = (torch.stack([torch.sin(u0 * (1 + 0.1 * n)) for n in range(s_steps + 1)])
              if variant == "mixed" else torch.sin(u0) + 0.3).contiguous()
        kw = {"mixed": variant == "mixed"}
        if variant == "masked":
            kw["n_active"] = torch.tensor(rng.integers(0, f + 1, s_steps), dtype=torch.int32,
                                          device=device)
        if variant == "mixed":
            kw["ramp_weight"] = 0.1
        if variant == "weighted":
            kw["weights"] = torch.tensor(rng.uniform(size=b) < 0.7, dtype=torch.float32,
                                         device=device)
        return packed, dt, u0, tg, kw, 1.0 if variant == "weighted" else 1.0 / b

    def parent_t1(packed, dt, u0, tg, kw, inv_b):
        s_steps, b = dt.shape[0], u0.shape[0]
        loss, grads = torch.empty((1,), device=device), torch.empty_like(packed)
        traj = torch.empty((s_steps + 1, b), device=device)
        gcot, loss_m = torch.empty((s_steps, b), device=device), torch.empty((b,), device=device)
        w, na = kw.get("weights"), kw.get("n_active")

        def run():
            code = parent.resblock_epoch_grad(
                s_steps, f, b, int(kw["mixed"]), packed.data_ptr(), dt.data_ptr(), u0.data_ptr(),
                tg.data_ptr(), None if w is None else w.data_ptr(),
                None if na is None else na.data_ptr(), float(kw.get("ramp_weight") or 0.0),
                inv_b, traj.data_ptr(), gcot.data_ptr(), loss_m.data_ptr(), loss.data_ptr(),
                grads.data_ptr(), stream())
            assert code == 0, code
            return loss[0], grads

        return run

    def within(packed, dt, u0, tg, kw, inv_b, loss, g, reduce_terms=None):
        """Within resblock_kernel_tolerance at ``reduce_terms`` (default: this
        kernel's order); the worst entry's share of its bound."""
        d64 = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
               for k, v in kw.items()}
        l64, g64 = tf.resblock_epoch_grad_plain(packed.double(), dt.double(), u0.double(),
                                                tg.double(), inv_b=inv_b, **d64)
        tol = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b,
                                           reduce_terms=reduce_terms, **kw)
        d = (g.double() - g64).abs()
        share = float((d / tol["grads"].clamp_min(1e-300)).max())
        inside = bool((d <= tol["grads"]).all()) and abs(float(loss) - float(l64)) <= tol["loss"]
        return inside, share

    ok = True
    for s_steps, b, variant in T1_CASES:
        packed, dt, u0, tg, kw, inv_b = inputs(s_steps, b, variant)
        l_old, g_old = parent_t1(packed, dt, u0, tg, kw, inv_b)()
        # the parent's order: ⌈B/32⌉ members a lane, then a 5-level warp tree
        in_old, sh_old = within(packed, dt, u0, tg, kw, inv_b, l_old, g_old, -(-b // 32) + 5)
        loss, g = tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw)
        loss2, g2 = tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw)
        torch.cuda.synchronize()
        same = torch.equal(g, g2) and torch.equal(loss, loss2)
        plan = tf.resblock_plan(b, sms)
        inside, share = within(packed, dt, u0, tg, kw, inv_b, loss, g)
        print(f"T1 S={s_steps} F={f} B={b} {variant}: plan {tuple(plan)}; within "
              f"resblock_kernel_tolerance {inside} (worst {share:.2%} of its entry's bound; "
              f"parent {in_old}, {sh_old:.2%}); repeat call bit-identical {same}", flush=True)
        ok &= inside and same
    for s_steps in T1_TIMED:
        packed, dt, u0, tg, kw, inv_b = inputs(s_steps, 8192, "plain")
        t = in_turns({"parent": parent_t1(packed, dt, u0, tg, kw, inv_b),
                      "this": lambda: tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b,
                                                             **kw)})
        print(f"T1 times S={s_steps} F={f} B=8192: parent {t['parent'][0]:.4f} / "
              f"{t['parent'][1]:.4f} ms, this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms",
              flush=True)
        if s_steps == 2:  # the host clock before this loop's profiler sessions
            host_parts(packed, dt, u0, tg, inv_b, device, sms)
        dev = device_us(lambda: tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw),
                        ("resblock_tile_kernel", "resblock_reduce_kernel"))
        print(f"T1 S={s_steps} on the device: tile kernel {dev['resblock_tile_kernel']:.2f} us, "
              f"reduction {dev['resblock_reduce_kernel']:.2f} us a call", flush=True)
    return ok


def host_parts(packed, dt, u0, tg, inv_b, device, sms) -> None:
    """The host time a T1 call takes, the wrapper and its parts."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    plan = tf.resblock_plan(u0.shape[0], sms)
    parts = {
        "the wrapper": lambda: tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b),
        "_t1_launch (the C call, its allocation and views)": lambda: tf._t1_launch(
            packed, dt, u0, tg, None, None, None, inv_b, False, plan),
        "the four input checks": lambda: [tf._check("u0s", u0, u0.shape, torch.float32,
                                                    u0.device) for _ in range(4)],
        "one allocation": lambda: torch.empty((3001,), device=device),
    }
    print("T1 S=2 host time a call: " + "; ".join(f"{name} {host_us(fn):.1f} us"
                                                  for name, fn in parts.items()), flush=True)


def main() -> int:
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    only = sys.argv[2] if len(sys.argv) == 3 else None
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = build_parent(Path(sys.argv[1]))
    load_library()
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ok = True
    if only in (None, "b1"):
        ok &= check_b1(parent, device, sms)
    if only in (None, "t1"):
        ok &= check_t1(parent, device, sms)
    print(f"all the same: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
