"""Spatial DG advection demo — the utils/One_code.mlx Advec1D driver.

Marches u_t + a·u_x = 0 on [0, 2π] (u0 = sin x, inflow BC −sin(a·t)) with
the LSRK4(5) DG march, optionally slope-limited after every step; reports
the error vs the exact solution and (optionally) the fwd+adjoint error
estimate, or runs the goal-oriented h-adaptive loop.

Usage:
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.advec_dg --k 10 --order 2
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.advec_dg --adapt --kernel cuda

``--device`` defaults to ``cuda`` and raises when no GPU is present; it
never carries on on the CPU. ``--device cpu`` allows only ``--kernel
torch``; so does ``--limiter n|1`` (the CUDA march has no limiter, as the
JAX driver's Pallas march has none).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--order", type=int, default=2)
    p.add_argument("--a", type=float, default=2 * np.pi)
    p.add_argument("--final-time", type=float, default=2.0)
    p.add_argument("--cfl", type=float, default=0.75)
    p.add_argument("--limiter", choices=["none", "n", "1"], default="none")
    p.add_argument("--estimate", action="store_true", help="run fwd+adjoint AWR")
    p.add_argument(
        "--adapt", action="store_true",
        help="run the goal-oriented element h-adaptivity loop (bisect the "
        "worst element by adjoint-weighted step-doubling error) instead of "
        "a single march",
    )
    p.add_argument("--maxit", type=int, default=8)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--x64", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="--adapt only: torch.save each iteration; resume if present")
    p.add_argument(
        "--kernel", choices=["torch", "cuda"], default="torch",
        help="cuda = the hand-written float32 CUDA kernels (needs a GPU); "
        "torch = the eager path",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if args.kernel == "cuda" and (device.type != "cuda" or args.x64):
        p.error("--kernel cuda requires --device cuda and float32 (no --x64)")
    if args.kernel == "cuda" and args.limiter != "none":
        p.error("--kernel cuda requires --limiter none")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available "
            "(use --device cpu with --kernel torch)"
        )
    # the eager path's (Np,Np)@(Np,K) products must run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from adjoint_ode_adaptivity_tpu_torch.march.advec import (
        advec_march,
        advec_operators,
        cfl_dt,
    )
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    dtype = torch.float64 if args.x64 else torch.float32

    if args.adapt:
        from adjoint_ode_adaptivity_tpu_torch.adapt.advec_loop import (
            run_adaptive_advec,
        )

        hist = run_adaptive_advec(
            lambda x: np.sin(x), n_order=args.order, k0=args.k, a=args.a,
            final_time=args.final_time, cfl=args.cfl / 2, maxit=args.maxit,
            tol=args.tol, dtype=dtype, engine=args.kernel, device=device,
            checkpoint_dir=args.checkpoint_dir,
        )
        for it, r in enumerate(hist):
            print(
                f"it {it:3d}  K={len(r.vx) - 1:5d}  J={r.j_value:+.10e}  "
                f"sum_eta={r.est_total:+.6e}"
            )
        print(
            f"finished after {len(hist)} iterations; "
            f"final |sum_eta| = {abs(hist[-1].est_total):.6e}"
        )
        return hist

    disc = startup_1d(args.order, 0.0, 2 * np.pi, args.k)
    ops = advec_operators(disc, a=args.a, dtype=dtype, device=device)
    u0 = torch.as_tensor(np.sin(disc.x), dtype=dtype, device=device)
    dt, n_steps = cfl_dt(disc, args.a, args.cfl, args.final_time)
    print(f"K={args.k} N={args.order} dt={dt:.3e} steps={n_steps}")

    post = None
    if args.limiter != "none":
        from adjoint_ode_adaptivity_tpu_torch.march.burgers import (
            burgers_operators,
            limiter_fn,
        )

        post = limiter_fn(burgers_operators(disc, dtype, device), args.limiter)

    if args.kernel == "cuda":
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import (
            make_cuda_advec_march,
        )

        u = make_cuda_advec_march(disc, args.a, dt, n_steps, device)(u0, 0.0)
    else:
        u = advec_march(ops, u0, dt, n_steps, post_stage=post)
    exact = np.sin(disc.x - args.a * args.final_time)
    err = float(np.max(np.abs(u.cpu().numpy() - exact)))
    print(f"max |u - exact| at T={args.final_time}: {err:.6e}")

    if args.estimate:
        from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import (
            advec_fwd_adj_estimate,
            terminal_integral_cotangent,
        )

        n8 = max(8, (n_steps // 8) * 8)
        dt8 = args.final_time / n8
        if args.kernel == "cuda":
            from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import (
                make_cuda_fwd_adj_estimate_single,
            )

            pipe = make_cuda_fwd_adj_estimate_single(disc, args.a, dt8, n8, device)
            lam = terminal_integral_cotangent(disc, dtype, device)
            uf, _lam0, eta = pipe(u0, 0.0, lam)
            j_value, sum_eta = torch.sum(lam * uf), torch.sum(eta)
        else:
            res = advec_fwd_adj_estimate(
                ops, disc, u0, dt8, n8, segment=max(n8 // 8, 1)
            )
            j_value, sum_eta = res.j_value, torch.sum(res.eta)
        print(f"J = {float(j_value):+.10e}  Σeta = {float(sum_eta):+.6e}")
    return err


if __name__ == "__main__":
    main()
