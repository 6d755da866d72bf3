#!/usr/bin/env python3
"""K1 (dg_fwd_march) of this checkout against another checkout's, on one GPU.

    python3 tools/torch_k1_against_parent.py PARENT_ROOT

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``) whose ``dg_fwd_march`` has the C signature of
the per-stage K1: (np, nb, nk, n_steps, store_every, t0, dt, a, rk, tables,
rx, fsl, fsr, u0, store, u_final, ubuf, rbuf, stream). Its dg_rhs.cu is
built alone with nvcc into build/parent_k1/; this checkout's kernels come
from ``load_library``. Both run on the same inputs in every mode (the
trajectory, checkpoints, a store_every that does not divide n_steps, no
store) at Np 2, 3 and 8, B 1, 3 and 8, uniform and graded meshes; the stored
states and u_final must be the same bits. Then both are timed in turns
(parent, this, this, parent; CUDA events, median of 5) at the headline (K =
10⁴, N = 2, B = 8, 2048 steps, the trajectory) and at the advec_dg march
(K = 512, B = 1, 5,462 steps, no store). Exits 1 on any difference.
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
# (n_order, K, B, graded, n_steps, store_every or None)
CASES = [
    (1, 24, 1, False, 13, 1), (1, 24, 1, False, 13, None), (2, 1000, 3, True, 26, 13),
    (2, 1000, 3, True, 26, 3), (2, 10_000, 8, False, 200, 1), (2, 10_000, 8, False, 200, 4),
    (2, 3000, 8, True, 192, 64), (2, 512, 1, False, 700, None), (7, 500, 3, True, 9, 1),
    (7, 2000, 8, False, 39, 13), (7, 900, 1, True, 17, None),
]


def build_parent(parent: Path) -> ctypes.CDLL:
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import ARCH_FLAGS, _nvcc

    src = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc" / "dg_rhs.cu"
    out_dir = ROOT / "build" / "parent_k1"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libparent_k1.so"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib), str(src)]
    subprocess.run(cmd, check=True)
    dll = ctypes.CDLL(str(lib))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    dll.dg_fwd_march.argtypes = [i] * 5 + [d] * 3 + [p] * 11
    dll.dg_fwd_march.restype = i
    return dll


def main() -> int:
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, load_library

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    parent = build_parent(Path(sys.argv[1]))
    lib = load_library()
    device = torch.device("cuda")

    def parent_k1(u0, t0, n_steps, store, every, ops):
        u_final = torch.empty_like(u0)
        work = torch.empty((4, u0.numel()), device=device)
        rx, fsl, fsr = ops.geom32
        code = parent.dg_fwd_march(
            ops.np_, u0.shape[1], ops.k, n_steps, every, float(t0), ops.dt, ops.a,
            dg_rhs._RK.ctypes.data, ops.full.packed.ctypes.data, rx.data_ptr(), fsl.data_ptr(),
            fsr.data_ptr(), u0.data_ptr(), None if store is None else store.data_ptr(),
            u_final.data_ptr(), work[0].data_ptr(), work[2].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return u_final

    def setup(n_order, k, b, graded):
        vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
        disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
        xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
        ops = dg_rhs.kernel_ops(disc, A, 0.5 * (0.75 / A) * xmin, device)
        phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
        u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                          dtype=torch.float32, device=device)
        return ops, u0

    ok = True
    for n_order, k, b, graded, n_steps, every in CASES:
        ops, u0 = setup(n_order, k, b, graded)
        slots = -(-n_steps // every) if every else 0
        stores = [torch.full((slots, *u0.shape), float("nan"), device=device) if every else None
                  for _ in range(2)]
        want = parent_k1(u0, 0.3, n_steps, stores[0], every or 1, ops)
        got, n_cuda = dg_rhs._k1_launch(lib, u0, 0.3, n_steps, stores[1], every or 1, ops)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and (every is None or torch.equal(stores[0], stores[1]))
        plan = dg_rhs.forward_plan(k, b, ops.np_, n_steps, every,
                                   torch.cuda.get_device_properties(device).multi_processor_count)
        print(f"Np={ops.np_} K={k} B={b} graded={graded} steps={n_steps} store_every={every}: "
              f"plan {tuple(plan)}, {n_cuda} CUDA launches (parent {5 * n_steps}); stored "
              f"states and u_final bit-equal to the parent's: {same}", flush=True)
        ok &= same

    for label, (n_order, k, b, n_steps, traj) in (("headline", (2, 10_000, 8, 2048, True)),
                                                  ("advec_dg march", (2, 512, 1, 5462, False))):
        ops, u0 = setup(n_order, k, b, False)
        store = torch.empty((n_steps, *u0.shape), device=device) if traj else None
        runs = {"parent": lambda: parent_k1(u0, 0.0, n_steps, store, 1, ops),
                "this": lambda: dg_rhs._k1_launch(lib, u0, 0.0, n_steps, store, 1, ops)}
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
        print(f"{label} K={k} B={b} steps={n_steps} trajectory={traj}: parent "
              f"{times['parent'][0]:.3f} / {times['parent'][1]:.3f} ms, this "
              f"{times['this'][0]:.3f} / {times['this'][1]:.3f} ms (in turns, median of 5 each)",
              flush=True)
    print(f"all bit-equal: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
