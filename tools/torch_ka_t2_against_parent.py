#!/usr/bin/env python3
"""KA (dg_adj_march) and T2 (dense_epoch_grad) of this checkout against
another checkout's, on one GPU.

    python3 tools/torch_ka_t2_against_parent.py PARENT_ROOT

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``) whose ``dg_adj_march`` is the per-stage KA,
C signature (np, nb, nk, n_steps, rk, tables, rx, fsl, fsr, lam_end, lam0,
lubuf, lrbuf, stream), and whose ``dense_epoch_grad`` is the one-block-per-
tile T2, (L, widths, bm, S, B, theta, theta_t, dt, u0, tgt, inv_b, traj,
loss_m, part, loss, grads, stream). Its dg_rhs.cu and train_dense_fused.cu
are built with nvcc into build/parent_ka_t2/; this checkout's kernels come
from ``load_library``.

- KA: both on the same λ at Np 2, 3 and 8, B 1 and 8, uniform and graded
  meshes, step counts that s_f does not divide, on the wrapper's plan and
  on three others: λ0 must be the same bits.
- T2: both on the same inputs at (100, 500) B = 512 S = 2, B = 8192 S = 10,
  B = 1000 S = 5 and smaller chains: each within dense_kernel_tolerance of
  the float64 plain version (the parent's at its own block tile, this one's
  at its plan), this one bit-identical on a repeat call.
- Times in turns (parent, this, this, parent; CUDA events, median of 5):
  KA at K = 10⁴, N = 2, B = 1, 2048 steps; T2 at B = 512, S = 2 and B =
  8192, S = 10.

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
A = 6.283185307179586
# (n_order, K, B, graded, n_steps)
KA_CASES = [(1, 24, 1, False, 13), (1, 3000, 8, True, 100), (2, 10_000, 1, False, 2048),
            (2, 10_000, 8, False, 77), (2, 1000, 1, True, 13), (2, 512, 8, True, 300),
            (7, 700, 1, False, 45), (7, 2000, 8, True, 19)]
# (sizes, B, S)
T2_CASES = [((100, 500), 512, 2), ((100, 500), 8192, 10), ((100, 500), 1000, 5),
            ((8, 16), 50, 5), ((3, 6, 5), 70, 5), ((12,), 33, 5), ((64,) * 8, 300, 3)]


def build_parent(parent: Path) -> ctypes.CDLL:
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import ARCH_FLAGS, _nvcc

    csrc = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "parent_ka_t2"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libparent_ka_t2.so"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib), str(csrc / "dg_rhs.cu"), str(csrc / "train_dense_fused.cu")]
    subprocess.run(cmd, check=True)
    dll = ctypes.CDLL(str(lib))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    dll.dg_adj_march.argtypes = [i] * 4 + [p] * 10
    dll.dg_adj_march.restype = i
    dll.dense_epoch_grad.argtypes = [i, p] + [i] * 3 + [p] * 5 + [d] + [p] * 6
    dll.dense_epoch_grad.restype = i
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


def main() -> int:
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.models import ResNetBlock
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, load_library
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = build_parent(Path(sys.argv[1]))
    load_library()
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_ka(lam, n_steps, ops):
        lam0 = torch.empty_like(lam)
        work = torch.empty((4, lam.numel()), device=device)
        rx, fsl, fsr = ops.geom32
        code = parent.dg_adj_march(
            ops.np_, lam.shape[1], ops.k, n_steps, dg_rhs._RK.ctypes.data,
            ops.full.packed.ctypes.data, rx.data_ptr(), fsl.data_ptr(), fsr.data_ptr(),
            lam.data_ptr(), lam0.data_ptr(), work[0].data_ptr(), work[2].data_ptr(), stream())
        assert code == 0, code
        return lam0

    def ka_setup(n_order, k, b, graded):
        vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
        disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
        xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
        ops = dg_rhs.kernel_ops(disc, A, 0.5 * (0.75 / A) * xmin, device)
        lam = torch.tensor(np.random.default_rng(k + b).normal(size=(disc.np_, b, k)),
                           dtype=torch.float32, device=device)
        return ops, lam

    ok = True
    for n_order, k, b, graded, n_steps in KA_CASES:
        ops, lam = ka_setup(n_order, k, b, graded)
        want = parent_ka(lam, n_steps, ops)
        plans = {"wrapper": dg_rhs.adjoint_plan(k, b, ops.np_, n_steps, sms),
                 **{f"s_f={min(st, n_steps)} {th} widest": dg_rhs.fwd_fused_plan(
                     k, min(st, n_steps), th) for st, th in ((4, 512), (16, 1024), (32, 1024))}}
        for name, plan in plans.items():
            got, n_cuda = dg_rhs._ka_launch(lam, n_steps, ops, plan)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"KA Np={ops.np_} K={k} B={b} graded={graded} steps={n_steps} {name} "
                  f"{tuple(plan)}: {n_cuda} CUDA launches (parent {5 * n_steps}); lam0 "
                  f"bit-equal to the parent's: {same}", flush=True)
            ok &= same and n_cuda == -(-n_steps // plan.segment)

    def t2_inputs(sizes, b, s_steps):
        params = ResNetBlock(sizes).init_params(torch.Generator().manual_seed(3), device=device)
        rng = np.random.default_rng(b + s_steps)
        dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32, device=device)
        u0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
        return params, dt, u0, (torch.sin(u0) + 0.3).contiguous()

    def parent_t2(params, sizes, dt, u0, tr):
        theta = td.pack_dense(params, sizes, device)
        p = [td.pad4(s) for s in sizes]
        parts_t = [theta[off: off + shape[0] * shape[1]].view(shape).T.reshape(-1)
                   for name, off, shape in td.dense_layout(sizes)
                   if name.endswith("kernel") and len(shape) == 2]
        theta_t = (torch.cat(parts_t) if parts_t else torch.zeros(1, device=device)).contiguous()
        width = sum(p) + 3
        bm = next(m for m in (64, 32, 16) if m * width * 4 <= 200 * 1024)
        b, s_steps = u0.shape[0], dt.shape[0]
        widths = np.array(p, dtype=np.int32)
        traj = torch.empty((s_steps + 1, b), device=device)
        loss_m = torch.empty((b,), device=device)
        part = torch.zeros((-(-b // bm), theta.numel()), device=device)
        loss = torch.empty((1,), device=device)
        grads = torch.empty_like(theta)

        def run():
            part.zero_()
            code = parent.dense_epoch_grad(
                len(sizes), widths.ctypes.data, bm, s_steps, b, theta.data_ptr(),
                theta_t.data_ptr(), dt.data_ptr(), u0.data_ptr(), tr.data_ptr(), 1.0 / b,
                traj.data_ptr(), loss_m.data_ptr(), part.data_ptr(), loss.data_ptr(),
                grads.data_ptr(), stream())
            assert code == 0, code
            return loss[0].clone(), grads.clone()

        return run, bm

    def within(label, params, sizes, dt, u0, tr, flat, loss, bm, c):
        got = td.unpack_dense(flat, sizes)
        p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
        l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double())
        tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, block_members=bm, cluster=c)
        share = 0.0
        inside = abs(float(loss) - float(l64)) <= tol["loss"]
        for k in g64:
            for q in g64[k]:
                d = (got[k][q].double() - g64[k][q]).abs()
                bnd = tol["grads"][k][q]
                inside &= bool((d <= bnd).all())
                share = max(share, float((d / bnd.clamp_min(1e-300)).max()))
        print(f"  {label}: within dense_kernel_tolerance {inside}, worst {share:.2%} of its "
              f"entry's bound", flush=True)
        return inside

    for sizes, b, s_steps in T2_CASES:
        params, dt, u0, tr = t2_inputs(sizes, b, s_steps)
        run_parent, bm_old = parent_t2(params, sizes, dt, u0, tr)
        l_old, f_old = run_parent()
        theta = td.pack_dense(params, sizes, device)
        plan = td.dense_plan(sizes, b, sms)
        l_new, f_new = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        l_new2, f_new2 = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        torch.cuda.synchronize()
        repeat = torch.equal(f_new, f_new2) and torch.equal(l_new, l_new2)
        print(f"T2 {sizes} B={b} S={s_steps}: parent one block of {bm_old} a tile; this "
              f"{tuple(plan)}; max|this - parent| {float((f_new - f_old).abs().max()):.3e} "
              f"(max|grad| {float(f_old.abs().max()):.3e}); repeat bit-identical {repeat}",
              flush=True)
        ok &= repeat
        ok &= within("parent", params, sizes, dt, u0, tr, f_old, l_old, bm_old, 1)
        ok &= within("this", params, sizes, dt, u0, tr, f_new, l_new, plan.block_members,
                     plan.cluster)

    ops, lam = ka_setup(2, 10_000, 1, False)
    plan = dg_rhs.adjoint_plan(10_000, 1, ops.np_, 2048, sms)
    t = in_turns({"parent": lambda: parent_ka(lam, 2048, ops),
                  "this": lambda: dg_rhs._ka_launch(lam, 2048, ops, plan)})
    print(f"KA K=10000 N=2 B=1 steps=2048: parent {t['parent'][0]:.3f} / {t['parent'][1]:.3f} "
          f"ms (10240 CUDA launches), this {t['this'][0]:.3f} / {t['this'][1]:.3f} ms on "
          f"{tuple(plan)} (in turns, median of 5 each)", flush=True)
    for sizes, b, s_steps in (((100, 500), 512, 2), ((100, 500), 8192, 10)):
        params, dt, u0, tr = t2_inputs(sizes, b, s_steps)
        run_parent, bm_old = parent_t2(params, sizes, dt, u0, tr)
        theta = td.pack_dense(params, sizes, device)
        plan = td.dense_plan(sizes, b, sms)
        t = in_turns({"parent": run_parent,
                      "this": lambda: td._t2_launch(theta, sizes, dt, u0, tr, plan)})
        print(f"T2 {sizes} B={b} S={s_steps}: parent {t['parent'][0]:.4f} / "
              f"{t['parent'][1]:.4f} ms, this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms on "
              f"{tuple(plan)} (in turns, median of 5 each)", flush=True)
    print(f"all KA bit-equal and all T2 within tolerance: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
