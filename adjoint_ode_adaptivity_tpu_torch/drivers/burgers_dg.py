"""Nonlinear conservation-law demo: Burgers with minmod slope limiting.

Marches u_t + (u²/2)_x = 0 on [0, 2π] (periodic, u0 = 0.5 + sin x, which
breaks into a shock at t = 1) with nodal DG, the local Lax–Friedrichs flux
and LSRK4(5), limiting after every stage; prints whether the final state is
finite and its range.

Usage:
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.burgers_dg --k 48 --order 4
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.burgers_dg --kernel cuda

``--kernel torch`` (default) is the eager march in float64; ``--kernel cuda``
the hand-written float32 kernel B1 (one launch for the whole march).
``--device`` defaults to ``cuda`` and raises when no GPU is present; it never
carries on on the CPU. ``--device cpu`` allows only ``--kernel torch``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=48)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--final-time", type=float, default=1.5)
    p.add_argument("--dt", type=float, default=2e-4)
    p.add_argument("--limiter", choices=["n", "1", "none"], default="n")
    p.add_argument(
        "--x64", action="store_true", default=None,
        help="force float64 (the default for --kernel torch; an error with cuda)",
    )
    p.add_argument("--plot", action="store_true")
    p.add_argument(
        "--kernel", choices=["torch", "cuda"], default="torch",
        help="cuda = the hand-written float32 CUDA kernel B1 (needs a GPU); "
        "torch = the eager march",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if args.kernel == "cuda" and (device.type != "cuda" or args.x64):
        p.error("--kernel cuda requires --device cuda and float32 (no --x64)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available "
            "(use --device cpu with --kernel torch)"
        )
    # the eager march's (Np,Np)@(Np,K) products must run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from adjoint_ode_adaptivity_tpu_torch.march.burgers import (
        burgers_march,
        burgers_operators,
    )
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    dtype = torch.float32 if args.kernel == "cuda" else torch.float64
    disc = startup_1d(args.order, 0.0, 2 * np.pi, args.k)
    u0 = torch.as_tensor(0.5 + np.sin(disc.x), dtype=dtype, device=device)
    n_steps = int(round(args.final_time / args.dt))
    if args.kernel == "cuda":
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda.burgers import (
            make_cuda_burgers_march_single,
        )

        run = make_cuda_burgers_march_single(disc, args.dt, n_steps, args.limiter, device)
        u = run(u0)
    else:
        ops = burgers_operators(disc, dtype, device)
        u = burgers_march(ops, u0, args.dt, n_steps, limiter=args.limiter)
    finite = bool(torch.isfinite(u).all())
    print(
        f"Burgers K={args.k} N={args.order} T={args.final_time} "
        f"limiter={args.limiter}: finite={finite} "
        f"range=[{float(u.min()):+.4f}, {float(u.max()):+.4f}]"
    )
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(np.asarray(disc.x).T.ravel(), u.cpu().numpy().T.ravel(), lw=1)
        ax.set_xlabel("x")
        ax.set_ylabel("u")
        fig.savefig("burgers.png")
        print("wrote burgers.png")
    return u


if __name__ == "__main__":
    main()
