#!/usr/bin/env python3
"""D1 and H1 with J = ∫u (goal id 0) and T2 in float32 against another
checkout's, on one GPU: the kernels that gained a goal functor (D1, H1) and
a bf16 tensor-core mode (T2) must keep their earlier bits on the modes they
had.

    python3 tools/torch_goal_bf16_against_parent.py PARENT_ROOT

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``) whose C entries take no goal id and no bf16
flag: ``dg_estimate_ensemble`` (ode_id, fast_trig, n_u, n_t, consts, tables,
n_tables, np_p, nqp, nqa, nb, k_el, newton_iters, per_member, lanes,
threads, times, y0, u, v, err, stream), ``dg_estimate_hp_per_member``
(ode_id, n_u, n_t, consts, tables, n_tables, np_max, nq, n_stack,
fine_offset, reconstruct, lanes, threads, nb, k_el, newton_iters, times,
ns, y0, uc, uf, v, err, stream) and ``dense_epoch_grad`` (L, widths, bm,
cluster, S, B, theta, dt, u0, tgt, inv_b, traj, loss_m, part, loss, grads,
stream). Its three sources are built with nvcc into
build/parent_goal_bf16/; this checkout's kernels come from ``load_library``.

- D1 (sin u, order 1) at chip_smoke.py's D1_GOAL_CASES (the per-member
  study's shape, B = 1024, K = 15, per-member partitions with zero-width
  tails, 8 Newton steps; bench.py's, B = 16,384, K = 16, 5 steps), on every
  (G, CTA size) of LANES × CTA_THREADS;
- H1 (sin u, orders 1..3, np_max 6) at B = 512 (seed 5) and 4096 (seed 6),
  K = 15, both adjoint modes, on every (G, CTA size);
- T2 in float32 at (100, 500): B = 8192 S = 10 and B = 512 S = 2 on every
  (BM, C) the kernel takes.

Every pair must be the same bits. Then the wrappers' launches are timed in
turns against the parent's (parent, this, this, parent; CUDA events, median
of 5), and the parent's outputs on chip_smoke.py phase 38's inputs are
printed as the digests of its PARENT_DIGESTS (D1 and H1 at the wrapper's
launch, T2 over every plan). Exits 1 on any difference.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
HP_CASES = [(512, 5), (4096, 6)]
T2_CASES = [(8192, 10), (512, 2)]


def build_parent(parent: Path) -> ctypes.CDLL:
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import ARCH_FLAGS, _nvcc

    csrc = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "parent_goal_bf16"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libparent_goal_bf16.so"
    jobs, objs = [], []
    for name in ("dg_slab", "dg_slab_mixed", "train_dense_fused"):
        obj = out_dir / f"{name}.o"
        objs.append(str(obj))
        jobs.append(subprocess.Popen([_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                                      "-fPIC", "-c", str(csrc / f"{name}.cu"), "-o", str(obj)]))
    if any(j.wait() for j in jobs):
        raise SystemExit("nvcc failed on the parent's sources")
    subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(lib), *objs], check=True)
    dll = ctypes.CDLL(str(lib))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    dll.dg_estimate_ensemble.argtypes = [i] * 4 + [p] * 2 + [i] * 10 + [p] * 6
    dll.dg_estimate_hp_per_member.argtypes = [i] * 3 + [p] * 2 + [i] * 11 + [p] * 8
    dll.dense_epoch_grad.argtypes = [i, p] + [i] * 4 + [p] * 4 + [d] + [p] * 6
    for fn in (dll.dg_estimate_ensemble, dll.dg_estimate_hp_per_member, dll.dense_epoch_grad):
        fn.restype = i
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

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = build_parent(Path(sys.argv[1]))
    load_library()
    device = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ok = True
    digests = {}

    def parent_d1(times, y0, plan, launch):
        b, k = y0.shape[0], plan.n_elements
        u = torch.empty((k, plan.ops_p.np_, b), device=device)
        v = torch.empty((k, plan.ops_a.np_, b), device=device)
        err = torch.empty((k, b), device=device)
        code = parent.dg_estimate_ensemble(
            plan.functors.ode_id, int(plan.trig == "fast"), *plan.n_modes, plan.consts.ctypes.data,
            plan.tables.data_ptr(), plan.tables.numel(), plan.ops_p.np_, plan.ops_p.phi.shape[0],
            plan.ops_a.phi.shape[0], b, k, plan.newton_iters, int(times.dim() == 2),
            launch.lanes, launch.threads, times.data_ptr(), y0.data_ptr(), u.data_ptr(),
            v.data_ptr(), err.data_ptr(), stream())
        assert code == 0, code
        return u.permute(2, 0, 1), v.permute(2, 0, 1), err.T

    for label, b, k, newton, per_member, seed in cs.D1_GOAL_CASES:
        times, y0 = cs.goal_d1_inputs(device, b, k, per_member, seed)
        run = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", dg_time_operators(1),
                                                dg_time_operators(2), k, newton, device=device)
        same = 0
        launches = [ds.D1Launch(g, th) for g in ds.LANES for th in ds.CTA_THREADS]
        for launch in launches:
            mine = ds._d1_launch(times, y0, run.plan, launch)
            theirs = parent_d1(times, y0, run.plan, launch)
            torch.cuda.synchronize()
            same += all(torch.equal(x, y) for x, y in zip(mine, theirs))
        nq = max(run.plan.ops_p.phi.shape[0], run.plan.ops_a.phi.shape[0])
        wrap = ds.d1_plan(b, 2, nq)
        digests[f"D1 {b}"] = cs.digest(parent_d1(times, y0, run.plan, wrap))
        times_ms = in_turns({"parent": lambda: parent_d1(times, y0, run.plan, wrap),
                             "this": lambda: ds._d1_launch(times, y0, run.plan, wrap)})
        print(f"D1 J=int(u) {label} B={b} K={k}: {same} of {len(launches)} (G, CTA) launches "
              f"bit-equal to the parent's; on {tuple(wrap)} parent "
              f"{statistics.mean(times_ms['parent']):.4f} ms, this "
              f"{statistics.mean(times_ms['this']):.4f} ms (in turns {times_ms})", flush=True)
        ok &= same == len(launches)

    def parent_h1(times, ns, y0, plan, launch):
        b, k, np_m = y0.shape[0], plan.n_elements, plan.mops.np_max
        outs = [torch.empty((k, np_m, b), device=device) for _ in range(3)]
        err = torch.empty((k, b), device=device)
        t_k, ns_k = times.T.contiguous(), ns.T.to(torch.int32).contiguous()
        code = parent.dg_estimate_hp_per_member(
            plan.functors.ode_id, *plan.n_modes, plan.consts.ctypes.data, plan.tables.data_ptr(),
            plan.tables.numel(), np_m, plan.mops.rq.shape[0], plan.mops.n_max, plan.fine_offset,
            int(plan.adjoint_mode == "reconstruct"), launch.lanes, launch.threads, b, k,
            plan.newton_iters, t_k.data_ptr(), ns_k.data_ptr(), y0.data_ptr(),
            *(x.data_ptr() for x in outs), err.data_ptr(), stream())
        assert code == 0, code
        return (*(x.permute(2, 0, 1) for x in outs), err.T)

    for b, seed in HP_CASES:
        inputs = cs.hp_inputs(device, b, cs.HP_K, cs.HP_STUDY["n_max"], seed)
        for mode in ("solve", "reconstruct"):
            run = cs.hp_kernel("du/dt=sin(u)", cs.HP_STUDY["n_max"], cs.HP_STUDY["fo"], cs.HP_K,
                               mode, device)
            launches = [hm.HpLaunch(g, th) for g in (1, 2, 4, 8, 16, 32) for th in hm.CTA_THREADS]
            same = 0
            for launch in launches:
                mine = hm._h1_launch(*inputs, run.plan, launch)
                theirs = parent_h1(*inputs, run.plan, launch)
                torch.cuda.synchronize()
                same += all(torch.equal(x, y) for x, y in zip(mine, theirs))
            wrap = hm.hp_plan(b, run.plan.mops.np_max, run.plan.mops.rq.shape[0])
            digests[f"H1 {b} {mode}"] = cs.digest(parent_h1(*inputs, run.plan, wrap))
            times_ms = in_turns({"parent": lambda: parent_h1(*inputs, run.plan, wrap),
                                 "this": lambda: hm._h1_launch(*inputs, run.plan, wrap)})
            print(f"H1 J=int(u) B={b} {mode}: {same} of {len(launches)} (G, CTA) launches "
                  f"bit-equal to the parent's; on {tuple(wrap)} parent "
                  f"{statistics.mean(times_ms['parent']):.4f} ms, this "
                  f"{statistics.mean(times_ms['this']):.4f} ms (in turns {times_ms})", flush=True)
            ok &= same == len(launches)

    sizes = cs.NN_T2["sizes"]

    def parent_t2(theta, dt, u0, tr, plan):
        b, s_steps = u0.shape[0], dt.shape[0]
        widths = np.array([td.pad4(x) for x in sizes], dtype=np.int32)
        traj = torch.empty((plan.cluster, s_steps + 1, b), device=device)
        loss_m = torch.empty((b,), device=device)
        part = torch.zeros((plan.n_tiles, td.pad4(theta.numel())), device=device)
        loss = torch.empty((1,), device=device)
        grads = torch.empty_like(theta)
        code = parent.dense_epoch_grad(
            len(sizes), widths.ctypes.data, plan.block_members, plan.cluster, s_steps, b,
            theta.data_ptr(), dt.data_ptr(), u0.data_ptr(), tr.data_ptr(), 1.0 / b,
            traj.data_ptr(), loss_m.data_ptr(), part.data_ptr(), loss.data_ptr(),
            grads.data_ptr(), stream())
        assert code == 0, code
        return loss[0], grads

    for b, s_steps in T2_CASES:
        params, dt, u0, tr = cs.nn_t2_inputs(device, s_steps)
        u0, tr = u0[:b].contiguous(), tr[:b].contiguous()
        theta = td.pack_dense(params, sizes, device)
        plans = [td.DensePlan(bm, c, -(-b // bm), td.dense_smem_bytes(sizes, bm, c))
                 for bm, c in td._feasible(sizes)]
        same, outs = 0, []
        for plan in plans:
            mine = td._t2_launch(theta, sizes, dt, u0, tr, plan)
            theirs = parent_t2(theta, dt, u0, tr, plan)
            torch.cuda.synchronize()
            same += all(torch.equal(x, y) for x, y in zip(mine, theirs))
            outs += theirs
        digests[f"T2 {b} {s_steps}"] = cs.digest(outs)
        wrap = td.dense_plan(sizes, b, td._sm_count(device))
        times_ms = in_turns({"parent": lambda: parent_t2(theta, dt, u0, tr, wrap),
                             "this": lambda: td._t2_launch(theta, sizes, dt, u0, tr, wrap)})
        print(f"T2 float32 {sizes} B={b} S={s_steps}: {same} of {len(plans)} (BM, C) plans "
              f"bit-equal to the parent's; on ({wrap.block_members}, {wrap.cluster}) parent "
              f"{statistics.mean(times_ms['parent']):.4f} ms, this "
              f"{statistics.mean(times_ms['this']):.4f} ms (in turns {times_ms})", flush=True)
        ok &= same == len(plans)
    print(f"the parent's digests on phase 38's inputs: {digests}", flush=True)
    print(f"every pair bit-equal: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
