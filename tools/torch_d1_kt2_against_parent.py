#!/usr/bin/env python3
"""D1 (dg_estimate_ensemble) and KT2 (tiled_rev_seg) of this checkout
against another checkout's, and D1's folded tables read from constant
memory against this checkout's shared-memory copy, on one GPU.

    python3 tools/torch_d1_kt2_against_parent.py PARENT_ROOT

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``) whose ``dg_estimate_ensemble`` is the
one-thread-a-member D1, C signature (ode_id, fast_trig, n_u, n_t, consts,
host tables, n_tables, np_p, nqp, nqa, nb, k_el, newton_iters, per_member,
(K+1, B) times, y0, u, v, err, stream), and whose ``dg_tiled_rev`` is the
launch-a-segment KT2, (np, nk, n_segments, seg, tile_l, ghost, seg_first,
t0, dt, a, rk, half_tables, rx, fsl, fsr, traj, u_final, lam_end, lam0,
eta, lbuf, stream). Its dg_slab.cu and dg_tiled.cu are built with nvcc into
build/parent_d1_kt2/, beside a copy of this checkout's dg_slab.cu whose
kernel reads the tables from ``__constant__`` memory (copied there before
each launch) instead of a shared-memory copy a CTA.

- D1 at the per-member study's shape (B = 1024, K = 15, per-member
  partitions with zero-width tails, 8 Newton steps), bench.py's (B =
  16,384, K = 16, 5 steps) and B = 102,400: the parent, this wrapper
  (d1_plan's launch), this kernel on one lane a member, and the
  constant-memory copy on every G of LANES and 32, each within
  dg_kernel_tolerance of the plain version, timed in turns (CUDA events,
  median of 5 each way).
- KT2 at K = 10⁶, N = 2, segment 16, 64 steps (chip_smoke.py's tiled row)
  on KT1's trajectory: the parent's launch-a-segment kernel on the tiled
  plan and this tiled_rev_seg, the same bits, timed in turns.

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
# (label, B, K, newton_iters, per-member partitions, seed)
D1_CASES = [("the per-member study's shape", 1024, 15, 8, True, 2),
            ("bench.py's shape", 16_384, 16, 5, False, 1), ("B = 102,400", 102_400, 16, 5, False, 3)]
KT2_ROW = dict(k=1_000_000, segment=16, chunks=25, n_steps=64)


def constant_copy(src: str) -> str:
    """This checkout's dg_slab.cu with the kernel reading its tables from
    ``__constant__`` memory, copied there from the device buffer on the
    launch's stream."""
    edits = [
        ("constexpr long kSmemCap = 48 * 1024;",
         "constexpr long kSmemCap = 48 * 1024;\n__constant__ float c_tab[kMaxTables];"),
        ("  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tables[i];\n"
         "  __syncthreads();\n  const float* tab = smem;\n  float* ustore = smem + n_tab;",
         "  const float* tab = c_tab;\n  float* ustore = smem;"),
        ("  const long tab_bytes = static_cast<long>(n_tab) * sizeof(float);",
         "  const long tab_bytes = 0;"),
        ("  const OdeConsts kc = pack_consts(n_u, n_t, consts);",
         "  const cudaError_t e = cudaMemcpyToSymbolAsync(c_tab, tables, n_tables * sizeof(float), "
         "0, cudaMemcpyDeviceToDevice, s);\n  if (e != cudaSuccess) return static_cast<int>(e);\n"
         "  const OdeConsts kc = pack_consts(n_u, n_t, consts);"),
    ]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"dg_slab.cu changed: cannot make the constant-memory copy ({old[:40]})")
        src = src.replace(old, new)
    return src


def nvcc_shared(out: Path, sources, include: Path | None = None) -> subprocess.Popen:
    """Start nvcc building ``sources`` into the shared library ``out``
    (the port's sm_90a flags, -O3), ``include`` on the include path; the
    caller waits."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import ARCH_FLAGS, _nvcc

    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    inc = [f"-I{include}"] if include is not None else []
    return subprocess.Popen([_nvcc(), *flags, *inc, "-o", str(out), *map(str, sources)])


def build(parent: Path):
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import CSRC_DIR

    out_dir = ROOT / "build" / "parent_d1_kt2"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "dg_slab_constant.cu").write_text(constant_copy((CSRC_DIR / "dg_slab.cu").read_text()))
    csrc = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    jobs = [
        nvcc_shared(out_dir / "libparent.so", [csrc / "dg_slab.cu", csrc / "dg_tiled.cu"]),
        nvcc_shared(out_dir / "libconst.so", [out_dir / "dg_slab_constant.cu"], CSRC_DIR),
    ]
    if any(j.wait() for j in jobs):
        raise SystemExit("nvcc failed")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    par = ctypes.CDLL(str(out_dir / "libparent.so"))
    par.dg_estimate_ensemble.argtypes = [i] * 4 + [p] * 2 + [i] * 8 + [p] * 6
    par.dg_tiled_rev.argtypes = [i] * 7 + [d] * 3 + [p] * 12
    const = ctypes.CDLL(str(out_dir / "libconst.so"))
    const.dg_estimate_ensemble.argtypes = [i] * 4 + [p] * 2 + [i] * 10 + [p] * 6
    return par, const


def d1_inputs(b, k, per_member, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    if per_member:
        t = np.full((b, k + 1), 2.0)
        for m, n_act in enumerate(rng.integers(2, k - 3, b)):
            t[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.0, 2.0, n_act - 1)),
                                                [2.0]])
    else:
        t = np.linspace(0.0, 2.0, k + 1)
    return torch.tensor(t, dtype=torch.float32, device=device), y0


def d1_on(lib, times, y0, plan, *, host_tables=False, launch=None):
    """One launch of a D1 library (the parent's: host tables, (K+1, B)
    per-member times; else this checkout's C signature): (u, v, err)."""
    import torch

    b, k = y0.shape[0], plan.n_elements
    pm = times.dim() == 2
    u = torch.empty((k, plan.ops_p.np_, b), dtype=torch.float32, device=y0.device)
    v = torch.empty((k, plan.ops_a.np_, b), dtype=torch.float32, device=y0.device)
    err = torch.empty((k, b), dtype=torch.float32, device=y0.device)
    head = (plan.ode.kernel_id, int(plan.trig == "fast"), *plan.n_modes, plan.consts.ctypes.data)
    shape = (plan.ops_p.np_, plan.ops_p.phi.shape[0], plan.ops_a.phi.shape[0], b, k,
             plan.newton_iters, int(pm))
    stream = torch.cuda.current_stream(y0.device).cuda_stream
    if host_tables:
        t = times.T.contiguous() if pm else times
        code = lib.dg_estimate_ensemble(*head, plan.tables32.ctypes.data, plan.tables32.size,
                                        *shape, t.data_ptr(), y0.data_ptr(), u.data_ptr(),
                                        v.data_ptr(), err.data_ptr(), stream)
    else:
        code = lib.dg_estimate_ensemble(*head, plan.tables.data_ptr(), plan.tables.numel(), *shape,
                                        launch.lanes, launch.threads, times.data_ptr(),
                                        y0.data_ptr(), u.data_ptr(), v.data_ptr(), err.data_ptr(),
                                        stream)
    if code != 0:
        raise SystemExit(f"dg_estimate_ensemble returned {code}")
    return u.permute(2, 0, 1), v.permute(2, 0, 1), err.T


def d1_half(par, const, device) -> bool:
    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    ok = True
    for label, b, k, iters, pm, seed in D1_CASES:
        times, y0 = d1_inputs(b, k, pm, seed, device)
        run = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", dg_time_operators(1),
                                                dg_time_operators(2), k, iters, device=device)
        plan = run.plan
        want = ds.dg_estimate_ensemble_plain(times, y0, plan)
        tol = ds.dg_kernel_tolerance(times, y0, want, plan)
        mine = ds.d1_plan(b, 2, max(plan.ops_p.phi.shape[0], plan.ops_a.phi.shape[0]))
        out = {}
        fns = {"parent": lambda: out.update(parent=d1_on(par, times, y0, plan, host_tables=True)),
               "this": lambda: out.update(this=run(times, y0)),
               "this, one lane": lambda: out.update(one=ds._d1_launch(
                   times, y0, plan, ds.D1Launch(1, ds.D1_THREADS)))}
        for g in (*ds.LANES, 32):
            launch = ds.D1Launch(g, ds.D1_THREADS)
            fns[f"constant memory G={g}"] = (lambda key=f"c{g}", launch=launch: out.update(
                {key: d1_on(const, times, y0, plan, launch=launch)}))
            fns[f"shared memory G={g}"] = (lambda key=f"s{g}", launch=launch: out.update(
                {key: ds._d1_launch(times, y0, plan, launch)}))
        turns = cs.in_turns(fns)
        for key, got in out.items():
            _, share = cs.d1_shares(got, want, tol)
            if max(share.values()) > 1.0:
                print(f"D1 {label} {key}: outside dg_kernel_tolerance {share}")
                ok = False
        rows = " | ".join(f"{name} {statistics.mean(t):.4f} ({t[0]:.4f} / {t[1]:.4f})"
                          for name, t in turns.items())
        print(f"D1 {label} B={b} K={k} (this wrapper on {mine}), ms in turns: {rows}", flush=True)
    return ok


def kt2_half(par, device) -> bool:
    import numpy as np
    import torch

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    c = KT2_ROW
    disc = startup_1d(2, 0.0, 2 * np.pi, c["k"])
    dt = cs.cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, cs.A, dt, device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    tiled = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
        disc, cs.A, dt, segment=c["segment"], n_segments=c["n_steps"] // c["segment"],
        chunks=c["chunks"], device=device)
    plan = tiled.plan
    traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.0, c["n_steps"] // c["segment"], plan, ops)
    out = {}

    def parent():
        lam0 = torch.empty_like(lam)
        eta = torch.zeros(c["k"], dtype=torch.float32, device=device)
        lbuf = torch.empty((2, lam.numel()), dtype=torch.float32, device=device)
        rx, fsl, fsr = ops.geom32
        code = par.dg_tiled_rev(
            disc.np_, c["k"], c["n_steps"] // plan.segment, plan.segment, plan.tile, plan.ghost, 0,
            0.0, ops.dt, ops.a, dg_rhs._RK.ctypes.data, ops.half.packed.ctypes.data,
            rx.data_ptr(), fsl.data_ptr(), fsr.data_ptr(), traj.data_ptr(), uf.data_ptr(),
            lam.data_ptr(), lam0.data_ptr(), eta.data_ptr(), lbuf.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            raise SystemExit(f"dg_tiled_rev returned {code}")
        out["parent"] = (lam0, eta)

    turns = cs.in_turns({"parent": parent, "this": lambda: out.update(
        this=dg_tiled.tiled_rev_seg(traj, uf, lam, 0.0, plan, ops))})
    same = all(bool(torch.equal(x, y)) for x, y in zip(out["parent"], out["this"]))
    print(f"KT2 K={c['k']} segment {c['segment']} {c['n_steps']} steps: parent (a launch a "
          f"segment, {plan.n_tiles} tiles of {plan.tile} + 2x{plan.ghost}) "
          f"{statistics.mean(turns['parent']):.3f} ms ({turns['parent'][0]:.3f} / "
          f"{turns['parent'][1]:.3f}), this ({dg_tiled.tiled_rev_seg.cuda_launches} CUDA launches "
          f"of K2's kernel) {statistics.mean(turns['this']):.3f} ms ({turns['this'][0]:.3f} / "
          f"{turns['this'][1]:.3f}); lam0 and eta the same bits: {same}", flush=True)
    return same


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
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
    par, const = build(Path(sys.argv[1]).resolve())
    device = torch.device("cuda")
    ok = d1_half(par, const, device)
    ok = kt2_half(par, device) and ok
    print("all checks passed" if ok else "A CHECK FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
