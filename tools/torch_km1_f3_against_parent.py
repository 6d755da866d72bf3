#!/usr/bin/env python3
"""KM1 (km_fwd_traj) and F3 (fd_estimate_per_member) of this checkout
against another checkout's, on one GPU.

    python3 tools/torch_km1_f3_against_parent.py PARENT_ROOT

PARENT_ROOT holds another version of ``adjoint_ode_adaptivity_tpu_torch/
csrc`` (for example ``git archive <commit> adjoint_ode_adaptivity_tpu_torch/
csrc | tar -x -C PARENT_ROOT``) whose ``dg_mxu_fwd`` is the launch-a-stage
KM1, C signature (np, n, nk, n_steps, rk, tables, inflow, u0, traj,
u_final, ubuf, rbuf, stream), and whose ``fd_estimate_per_member`` is the
one-thread-a-member F3, (ode_id, n_u, n_t, consts, nb, n_steps, rf, block,
t0, (n_steps, B) dt, u0, (n_steps, B) err, j, stream). Its dg_mxu.cu and
fd_ensemble.cu are built with nvcc into build/parent_km1_f3/ by
tools/torch_d1_kt2_against_parent.py's loader.

- KM1 at chip_smoke.py's MXU_ROWS (N = 7, K = 10⁴, B = 8, 256 steps; N =
  2, 2048 steps): the parent's kernel and this wrapper (km_fwd_plan's
  launches), the same trajectory and u_final bits, timed in turns (CUDA
  events, median of 5 each way).
- F3 at chip_smoke.py's phase 6(e) shape (B = 1024, 43 steps, rf 4, padded
  tails), sin u in both conventions: the parent's call as its wrapper made
  it (the widths transposed to (n_steps, B), err returned transposed), this
  wrapper (fd_pm_plan's launch) and this kernel on one lane a member, each
  within fd_kernel_tolerance of the plain version, timed in turns.
- The per-member FD study (B = 1024, maxit 40, device loop) in turns on
  the parent's kernel and on this wrapper.

Exits 1 on any difference.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def build(parent: Path):
    from torch_d1_kt2_against_parent import nvcc_shared

    out = ROOT / "build" / "parent_km1_f3" / "libparent.so"
    csrc = parent / "adjoint_ode_adaptivity_tpu_torch" / "csrc"
    if nvcc_shared(out, [csrc / "dg_mxu.cu", csrc / "fd_ensemble.cu"]).wait():
        raise SystemExit("nvcc failed")
    p, i = ctypes.c_void_p, ctypes.c_int
    par = ctypes.CDLL(str(out))
    par.dg_mxu_fwd.argtypes = [i] * 4 + [p] * 9
    par.fd_estimate_per_member.argtypes = [i, i, i, p, i, i, i, i, ctypes.c_float] + [p] * 5
    return par


def km1_half(par, device) -> bool:
    import torch

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import _RK

    ok = True
    for n_order, seg, n_steps in cs.MXU_ROWS:
        disc = cs.mesh(n_order, 10_000, graded=False)
        km, _, u0, _ = cs.mxu_run(disc, cs.cfl_step(disc), seg, n_steps, device)
        ops = km.ops
        u0 = u0.reshape(ops.np_, ops.n)
        out = {}

        def parent():
            inflow = dg_mxu.fwd_inflow(0.0, ops)
            traj = torch.empty((n_steps, *u0.shape), dtype=torch.float32, device=device)
            uf = torch.empty_like(u0)
            work = torch.empty((4, u0.numel()), dtype=torch.float32, device=device)
            code = par.dg_mxu_fwd(ops.np_, ops.n, ops.k, n_steps, _RK.ctypes.data,
                                  ops.full.packed.ctypes.data, inflow.ctypes.data, u0.data_ptr(),
                                  traj.data_ptr(), uf.data_ptr(), work[0].data_ptr(),
                                  work[2].data_ptr(), torch.cuda.current_stream(device).cuda_stream)
            if code != 0:
                raise SystemExit(f"dg_mxu_fwd returned {code}")
            out["parent"] = (traj, uf)

        def this():
            out["this"] = dg_mxu.km_fwd_traj(u0, 0.0, ops)

        turns = cs.in_turns({"parent": parent, "this": this})
        same = all(bool(torch.equal(x, y)) for x, y in zip(out["parent"], out["this"]))
        ok &= same
        print(f"KM1 N={n_order} K=10000 B=8 {n_steps} steps: parent (a launch a stage, "
              f"{5 * n_steps} launches) {statistics.mean(turns['parent']):.3f} ms "
              f"({turns['parent'][0]:.3f} / {turns['parent'][1]:.3f}), this "
              f"({dg_mxu.km_fwd_traj.cuda_launches} CUDA launches on "
              f"{dg_mxu.km_fwd_plan(ops.k, ops.b, ops.np_, n_steps)}) "
              f"{statistics.mean(turns['this']):.3f} ms ({turns['this'][0]:.3f} / "
              f"{turns['this'][1]:.3f}); trajectory and u_final the same bits: {same}", flush=True)
        del out
        torch.cuda.empty_cache()
    return ok


def parent_f3(par, dt_b, u0s, plan):
    """One call of the parent's F3 as its wrapper made it: ``(err (B,
    n_steps), j)``."""
    import torch

    b = u0s.shape[0]
    dt_t = dt_b.T.contiguous()
    err = torch.empty((plan.n_steps, b), dtype=torch.float32, device=u0s.device)
    j = torch.empty((b,), dtype=torch.float32, device=u0s.device)
    code = par.fd_estimate_per_member(
        plan.functors.ode_id, *plan.n_modes, plan.consts.ctypes.data, b, plan.n_steps, plan.rf,
        int(plan.convention == "block"), plan.t0, dt_t.data_ptr(), u0s.data_ptr(), err.data_ptr(),
        j.data_ptr(), torch.cuda.current_stream(u0s.device).cuda_stream)
    if code != 0:
        raise SystemExit(f"fd_estimate_per_member returned {code}")
    return err.T, j


def f3_half(par, device) -> bool:
    import numpy as np
    import torch

    import chip_smoke as cs
    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    inp = cs.fd_inputs(device)
    dt_pm, u0_pm = inp["dt_pm"], inp["u0_pm"]
    rf, ok = cs.FD_STUDY["rf"], True
    for conv in ("strided", "block"):
        run = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", cs.FD_PM_STEPS, rf, conv,
                                                  device=device)
        stats = {}
        want = fe.fd_estimate_per_member_plain(dt_pm, u0_pm, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf)
        out = {}
        turns = cs.in_turns({
            "parent": lambda: out.update(parent=parent_f3(par, dt_pm, u0_pm, run.plan)),
            "this": lambda: out.update(this=run(dt_pm, u0_pm)),
            "this, one lane": lambda: out.update(one=fe._f3_launch(dt_pm, u0_pm, run.plan,
                                                                   fe.FdPmLaunch(1, 128)))})
        errs = {key: float((got[0] - want[0]).abs().max()) for key, got in out.items()}
        ok &= max(errs.values()) <= tol and bool((want[0].abs() > tol).any())
        rows = " | ".join(f"{name} {statistics.mean(t):.4f} ({t[0]:.4f} / {t[1]:.4f})"
                          for name, t in turns.items())
        print(f"F3 B={u0_pm.shape[0]} {cs.FD_PM_STEPS} steps {conv} (this wrapper on "
              f"{fe.fd_pm_plan(u0_pm.shape[0], cs.FD_PM_STEPS, rf)}), ms in turns: {rows}; "
              f"max|err - plain| {errs} (tol {tol:.3e})", flush=True)

    ode = odes.get_ode("du/dt=sin(u)")
    kw = dict(n_steps0=cs.FD_STUDY["n_steps0"], tol=0.0, maxit=cs.FD_STUDY["maxit"],
              dtype=torch.float32, device=device, device_loop=True, ode=ode)
    hist = {}

    def study(key):
        hist[key] = fd_loop.run_adaptive_fd_per_member(
            euler_step(ode.f), cs.study_u0s(), (0.0, cs.FD_STUDY["t1"]), engine="cuda", **kw)

    def on_parent():
        with mock.patch.object(fe, "_f3_launch",
                               lambda dt_b, u0s, plan, launch: parent_f3(par, dt_b, u0s, plan)):
            study("parent")

    turns = cs.in_turns({"parent": on_parent, "this": lambda: study("this")}, runs=3)
    same_grids = all(np.array_equal(a.times, b.times) for a, b in zip(hist["parent"], hist["this"]))
    print(f"FD per-member study B={cs.FD_STUDY['b']} maxit {cs.FD_STUDY['maxit']} (device loop), "
          f"ms in turns (median of 3 each): parent {statistics.mean(turns['parent']):.3f} "
          f"({turns['parent'][0]:.3f} / {turns['parent'][1]:.3f}), this "
          f"{statistics.mean(turns['this']):.3f} ({turns['this'][0]:.3f} / "
          f"{turns['this'][1]:.3f}); the same grids every iteration: {same_grids}", flush=True)
    return ok


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
    par = build(Path(sys.argv[1]).resolve())
    device = torch.device("cuda")
    ok = km1_half(par, device)
    ok = f3_half(par, device) and ok
    print("all checks passed" if ok else "A CHECK FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
