"""Adaptive FD-in-time driver — the Main_finite_difference.py experiment.

Usage:
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.fd_adaptive \\
        --ode "du/dt=sin(u)" --functional "J=int(u^2)" --tol 1e-5 --maxit 40
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.fd_adaptive \\
        --ensemble 1024 --tol 0 --maxit 40 --device-loop

``--device`` defaults to ``cuda`` and raises when no GPU is present; it
never carries on on the CPU. ``--device cpu`` allows only ``--engine
torch``. With ``--ensemble`` the estimate engine defaults to ``cuda`` on
the card (the per-member kernel, one launch per iteration) and switches to
``torch``, saying so, where the kernel cannot run the study (another
functional, an ODE without a device functor, ``--x64``); an explicit
``--engine cuda`` there raises instead. ``--plot`` writes one frame per
iteration of the single greedy run to ``CASE/CASE_{it}.png`` (matplotlib,
imported only then), and ``--animate`` joins them into ``CASE/CASE.mp4``;
the backtrack schedule ignores both, saying so, as the JAX driver does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _default_engine(args, ode, device) -> str:
    """The ``--ensemble`` engine when ``--engine`` is not given: ``cuda``
    on the card where the kernel can run the study, else ``torch`` (and a
    line saying why)."""
    if device.type != "cuda":
        return "torch"
    why = None
    if args.functional != "J=int(u^2)":
        why = f"the cuda engine supports J=int(u^2) only, not {args.functional}"
    elif ode.kernel_id is None:
        why = f"{ode.name} has no CUDA functor"
    elif args.x64:
        why = "the cuda engine is float32 (--x64 given)"
    if why is None:
        return "cuda"
    print(f"{why}; using engine torch")
    return "torch"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--case", default="FD_nonlinear_u_sq",
                   help="name of the run and of the --plot frames' directory")
    p.add_argument("--ode", default="du/dt=sin(u)")
    p.add_argument("--functional", default="J=int(u^2)")
    p.add_argument("--u0", type=float, default=1.0)
    p.add_argument("--t0", type=float, default=0.0)
    p.add_argument("--t1", type=float, default=2.0)
    p.add_argument("--n-steps0", type=int, default=2)
    p.add_argument("--ref-factor", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--maxit", type=int, default=40)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="torch.save each iteration; resume if present (greedy schedule only)")
    p.add_argument("--animate", action="store_true")
    p.add_argument(
        "--device-loop", action="store_true",
        help="run a fixed trip of maxit+1 iterations with the stopping tests on the "
             "device and one fetch at the end (greedy schedule only)",
    )
    p.add_argument("--x64", action="store_true")
    p.add_argument("--schedule", default="greedy", choices=["greedy", "backtrack"],
                   help="greedy: always bisect the argmax; backtrack: undo+block "
                        "inserts that increased the total estimate")
    p.add_argument("--coarsen-tol", type=float, default=None,
                   help="backtrack schedule only: merge adjacent step pairs whose "
                        "combined contribution is below this")
    p.add_argument(
        "--ensemble", type=int, default=0,
        help="B>0: per-member ensemble — B initial conditions drawn U(u0/2, 2*u0) "
             "with --seed, each adapting its own time grid and freezing at --tol",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--engine", choices=["torch", "cuda"], default=None,
        help="--ensemble only: estimate engine (default: cuda on the card — the "
             "whole per-member fwd+adjoint+indicator in one kernel launch)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if args.engine == "cuda" and (device.type != "cuda" or args.x64):
        p.error("--engine cuda requires --device cuda and float32 (no --x64)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available "
            "(use --device cpu with --engine torch)"
        )

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.functionals import get_functional
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step

    ode = odes.get_ode(args.ode)
    functional = get_functional(args.functional)  # an unknown name raises KeyError here
    step = euler_step(ode.f)
    dtype = torch.float64 if args.x64 else torch.float32
    t_span = (args.t0, args.t1)
    common = dict(n_steps0=args.n_steps0, functional_name=args.functional,
                  ref_factor=args.ref_factor, tol=args.tol, maxit=args.maxit,
                  dtype=dtype, device=device)

    if args.ensemble > 0:
        rng = np.random.default_rng(args.seed)
        u0s = rng.uniform(args.u0 / 2.0, 2.0 * args.u0, args.ensemble)
        engine = args.engine or _default_engine(args, ode, device)
        history = fd_loop.run_adaptive_fd_per_member(
            step, u0s, t_span, engine=engine, ode=ode, checkpoint_dir=args.checkpoint_dir,
            device_loop=args.device_loop, **common,
        )
        for it, r in enumerate(history):
            print(
                f"it {it:3d}  steps [{r.n_active.min()}..{r.n_active.max()}]"
                f"  J_mean={r.j_coarse.mean():+.10e}  "
                f"mean sum(err)={r.err_total.mean():.6e}  "
                f"refining={r.n_refining}/{args.ensemble}"
            )
        print(f"finished after {len(history)} iterations "
              f"(B={args.ensemble}, per-member, engine={engine})")
        return history

    if args.schedule == "backtrack" and (args.plot or args.animate):
        print("--plot/--animate are not supported with --schedule backtrack; ignoring")
        args.plot = args.animate = False
    plot_state = {"bar_ylim": None}
    if args.plot:
        from adjoint_ode_adaptivity_tpu_torch.utils.plotting import fresh_case_dir, plot_iteration

        fresh_case_dir(args.case)
        x_plot = np.linspace(args.t0, args.t1, 500)
        x_t = torch.tensor(x_plot, dtype=torch.float64)
        exact_fwd = ode.exact_fwd(x_t, args.u0).numpy() if ode.exact_fwd else None
        exact_adj = None
        if ode.exact_fwd is not None and functional.g_u is not None:
            exact_adj = odes.exact_adjoint_rk4(ode, functional.g_u, x_t, args.u0, args.t1,
                                               functional.terminal).numpy()

    if args.schedule == "backtrack":
        history = fd_loop.run_adaptive_fd_backtrack_padded(
            step, args.u0, t_span, coarsen_tol=args.coarsen_tol, **common
        )
        for r in history:
            print(f"it {r['it']:3d}  steps {r['n_steps']:4d}  "
                  f"sum(err)={r['total']:.6e}  {r['action']}")
        print(f"finished after {len(history)} iterations; final Σerr = "
              f"{history[-1]['total']:.6e}")
        return history

    def callback(result):
        n_act = int(result.n_steps_used)
        it = int(result.state.it) - 1
        print(
            f"it {it:3d}  steps {n_act:4d}  "
            f"J={float(result.j_coarse):+.10e}  sum(err)={float(result.err_total):.6e}"
        )
        if args.plot:
            rf = args.ref_factor
            t_pre = result.times_used.cpu().numpy()[: n_act + 1]
            dt = np.diff(t_pre)
            t_fine = np.concatenate([[t_pre[0]], t_pre[0] + np.cumsum(np.repeat(dt / rf, rf))])
            plot_state["bar_ylim"] = plot_iteration(
                args.case, it, t_pre, result.u.cpu().numpy()[: n_act + 1], t_fine,
                result.v.cpu().numpy()[: len(dt) * rf + 1],
                result.err_steps.cpu().numpy()[:n_act], exact_t=x_plot, exact_fwd=exact_fwd,
                exact_adj=exact_adj, bar_ylim=plot_state["bar_ylim"],
            )

    history = fd_loop.run_adaptive_fd(
        step, args.u0, t_span, callback=callback, checkpoint_dir=args.checkpoint_dir,
        device_loop=args.device_loop, **common,
    )
    print(f"finished after {len(history)} iterations; final Σerr = "
          f"{float(history[-1].err_total):.6e}")
    if args.plot and args.animate:
        from adjoint_ode_adaptivity_tpu_torch.utils.plotting import animate_case

        print("wrote", animate_case(args.case))
    return history


if __name__ == "__main__":
    main()
