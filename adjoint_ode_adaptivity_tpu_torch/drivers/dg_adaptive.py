"""Adaptive DG-in-time driver — the matlab/MAIN.m experiment.

Per iteration, prints the effectivity telemetry exactly as the reference:
JuH−Juh (coarse minus fine functional), JuH−Ju (vs exact when available),
and the adjoint-weighted residual sum — all to %.10e (MAIN.m:55-76).

Usage:
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.dg_adaptive --maxit 30
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.dg_adaptive \\
        --ensemble 1024 --per-member --device-loop
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.dg_adaptive \\
        --hp p --k0 4 --n-max 4 --tol 1e-9

``--device`` defaults to ``cuda`` and raises when no GPU is present; it
never carries on on the CPU. ``--device cpu`` allows only ``--engine
torch``. With ``--ensemble`` the engine defaults to ``cuda`` on the card
(the DG slab kernel, or with ``--hp`` the hp kernel, one launch per
iteration, float32) and switches to ``torch``, saying so, where the kernel
cannot run the study (an ODE without a device functor, an explicit
``--x64``); an explicit ``--engine cuda`` there raises instead. Float64
(``--x64``) is on by default for the single run and the torch engine.

``--hp {h,p,hp,smooth}`` runs the hp-adaptive loop on the mixed per-element
order solvers (``--order`` the starting order, ``--n-max`` the p cap,
``--smooth-theta`` the smooth mode's decay threshold, ``--newton-iters`` a
fixed Newton count): one run, the ensemble-mean signal with ``--ensemble``,
or one partition and order vector per member with ``--per-member``. The
single run takes the torch engine; ``--engine cuda`` needs ``--ensemble``.

``--dp`` shards the ``--ensemble`` members over the ranks of a torchrun
launch (``parallel.init_dp_grid`` on a ``data`` axis; one rank without
torchrun) through the loops' ``mesh=``: the DG ensemble and per-member
loops and, with ``--hp``, the hp ensemble and per-member loops (the hp
single run refuses it, as the JAX driver does). B must divide over the
ranks. Every rank runs the same study and holds the global history; rank 0
alone prints. Two ranks on the CPU:

    torchrun --nproc-per-node 2 -m adjoint_ode_adaptivity_tpu_torch.drivers.dg_adaptive \
        --dp --device cpu --ensemble 8 --per-member --maxit 4

``--plot`` writes one frame per iteration of the single run and of the
``--hp`` single run or ensemble signal (member 0's nodal values) to
``CASE/CASE_{i}.png`` (matplotlib, imported only then; rank 0 alone under
``--dp``); the other ensemble studies draw none, as in the JAX driver.
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
    if ode.kernel_id is None:
        why = f"{ode.name} has no CUDA functor"
    elif args.x64:
        why = "the cuda engine is float32 (--x64 given)"
    if why is None:
        return "cuda"
    print(f"{why}; using engine torch")
    return "torch"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--case", default="dg_nonlinear",
                   help="name of the run and of the --plot frames' directory")
    p.add_argument("--ode", default="du/dt=sin(u)")
    p.add_argument("--y0", type=float, default=1.0)
    p.add_argument("--t0", type=float, default=0.0)
    p.add_argument("--t1", type=float, default=2.0)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--k0", type=int, default=2)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--maxit", type=int, default=30)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="torch.save each iteration; resume if present")
    p.add_argument("--x64", action=argparse.BooleanOptionalAction, default=None,
                   help="float64 (default: on for the single run and the torch engine; the "
                        "cuda engine is float32)")
    p.add_argument("--adjoint", choices=["solve", "reconstruct"], default="solve",
                   help="adjoint at order n+1: direct march (adj_march) or "
                        "Radau reconstruction from an order-n solve (adj_rec)")
    p.add_argument("--padded", action=argparse.BooleanOptionalAction, default=None,
                   help="fixed-shape padded partitions (default: on with --device-loop)")
    p.add_argument(
        "--ensemble", type=int, default=0,
        help="B>0: ensemble-mean refinement signal over B initial conditions drawn "
             "U(y0/2, 2*y0) with seed --seed (Main_variable_params.py:330-341's signal "
             "applied to the MATLAB strand; batched pipeline, padded partition)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--engine", choices=["torch", "cuda"], default=None,
        help="--ensemble only: pipeline engine (default: cuda on the card — the whole "
             "fwd + adjoint + AWR pipeline in one kernel launch per iteration)",
    )
    p.add_argument("--dp", action="store_true",
                   help="--ensemble only: shard the members over the ranks of a torchrun launch "
                        "(a 'data' axis; B must divide over the ranks)")
    p.add_argument(
        "--per-member", action="store_true",
        help="--ensemble only: every member adapts its OWN partition (bisects its own "
             "argmax, freezes at --tol independently) — the reference's one-adaptive-job-"
             "per-IC farm (Submit_schedule_frontera)",
    )
    p.add_argument(
        "--hp", choices=["h", "p", "hp", "smooth"], default=None,
        help="hp-adaptive loop on the mixed per-element-order solvers (dg_march.m's latent "
             "Ns-vector capability): raise the ORDER at the argmax element ('p'), bisect it "
             "('h' — children inherit the order), p-until-saturated-then-h ('hp'), or decide "
             "p-vs-h from the element's modal decay ('smooth' — see --smooth-theta); --order "
             "sets the starting order, --n-max the p cap",
    )
    p.add_argument("--smooth-theta", type=float, default=0.3,
                   help="--hp smooth only: p-refine when the argmax element's top Legendre mode "
                        "holds at most this fraction of the modal energy, else bisect")
    p.add_argument("--newton-iters", type=int, default=None,
                   help="--hp only: fixed Newton iteration count (default: to tolerance; the "
                        "cuda engine's default is 8)")
    p.add_argument("--n-max", type=int, default=4, help="--hp only: maximum per-element order")
    p.add_argument(
        "--device-loop", action="store_true",
        help="run a fixed trip of maxit+1 iterations with the stopping test as a device "
             "mask and one fetch at the end; applies to the single-run padded loop and "
             "to --ensemble",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.dp and args.hp is not None and args.ensemble <= 0:
        p.error("--dp requires --ensemble with --hp")
    device = torch.device(args.device)
    if args.engine == "cuda" and (device.type != "cuda" or args.x64):
        p.error("--engine cuda requires --device cuda and float32 (no --x64)")
    if args.hp is not None and args.engine == "cuda" and args.ensemble <= 0:
        p.error("--hp --engine cuda requires --ensemble (the kernel runs an ensemble)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available "
            "(use --device cpu with --engine torch)"
        )
    mesh, say = None, print
    if args.dp and args.ensemble > 0:
        from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import init_dp_grid

        mesh, device = init_dp_grid({"data": -1}, device)
        if mesh.rank != 0:
            say = _quiet
        say(f"dp over {mesh.world} devices")

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop

    ode = odes.get_ode(args.ode)
    j_exact = None
    if ode.exact_fwd is not None:
        # J = ∫u dt via dense quadrature on the exact solution
        tq = np.linspace(args.t0, args.t1, 20001)
        uq = ode.exact_fwd(torch.tensor(tq, dtype=torch.float64), args.y0).numpy()
        j_exact = np.trapezoid(uq, tq)

    def callback(r):
        k = len(r.times) - 1
        print(f"-- it with K={k}")
        print("JuH-Juh")
        print(f"{r.effectivity_gap:.10e}")
        if j_exact is not None:
            print("JuH-Ju")
            print(f"{r.j_coarse - j_exact:.10e}")
        print("Adj-W Res")
        print(f"{r.est_total:.10e}")

    if args.hp is not None:
        return _hp_main(args, ode, device, j_exact, mesh, say)

    if args.ensemble > 0:
        engine = args.engine or _default_engine(args, ode, device)
        x64 = engine == "torch" if args.x64 is None else args.x64
        dtype = torch.float64 if x64 else torch.float32
        rng = np.random.default_rng(args.seed)
        y0s = rng.uniform(args.y0 / 2.0, 2.0 * args.y0, args.ensemble).astype(
            np.float64 if x64 else np.float32)
        common = dict(f_u=ode.f_u, n_order=args.order, k0=args.k0, tol=args.tol,
                      maxit=args.maxit, newton_iters=8, engine=engine, ode=ode,
                      checkpoint_dir=args.checkpoint_dir, device_loop=args.device_loop,
                      mesh=mesh, dtype=dtype, device=device)
        if args.per_member:
            history = dg_loop.run_adaptive_dg_per_member(ode.f, y0s, (args.t0, args.t1),
                                                         **common)
            for it, r in enumerate(history):
                say(
                    f"-- it {it} K=[{r.n_active.min()}..{r.n_active.max()}]"
                    f"  J_mean={r.j.mean():.10e}  "
                    f"mean |Adj-W Res|={np.abs(r.est_total).mean():.10e}  "
                    f"refining={r.n_refining}/{args.ensemble}"
                )
            mode = "per-member, device-loop" if args.device_loop else "per-member"
            say(f"finished after {len(history)} iterations "
                f"(B={args.ensemble}, {mode}, engine={engine})")
            return history
        history = dg_loop.run_adaptive_dg_ensemble(ode.f, y0s, (args.t0, args.t1), **common)
        for it, r in enumerate(history):
            say(
                f"-- it {it} K={len(r.times) - 1}  "
                f"J_mean={r.j_mean:.10e}  "
                f"mean Adj-W Res={r.est_total_mean:.10e}"
            )
        say(f"finished after {len(history)} iterations "
            f"(B={args.ensemble}, engine={engine})")
        return history

    padded = args.device_loop if args.padded is None else args.padded
    history = dg_loop.run_adaptive_dg(
        ode.f, args.y0, (args.t0, args.t1), f_u=ode.f_u, n_order=args.order, k0=args.k0,
        tol=args.tol, maxit=args.maxit, callback=callback, padded=padded,
        adjoint_mode=args.adjoint, checkpoint_dir=args.checkpoint_dir,
        device_loop=args.device_loop,
        dtype=torch.float32 if args.x64 is False else torch.float64, device=device,
    )
    print(f"finished after {len(history)} iterations, "
          f"K={len(history[-1].times) - 1} elements")
    if args.plot:
        _plot_frames(args.case, history)
    return history


def _plot_frames(case: str, history, hp: bool = False) -> None:
    """One frame per iteration, ``case/case_{i}.png``: |err| bars per
    element over each element's nodal primal and adjoint (the live nodes of
    each element's order with ``hp``; member 0 of an ensemble)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from adjoint_ode_adaptivity_tpu_torch.utils.plotting import fresh_case_dir

    fresh_case_dir(case)
    for i, r in enumerate(history):
        fig, ax1 = plt.subplots(figsize=(10, 7))
        mids = (r.times[:-1] + r.times[1:]) / 2
        ax1.bar(mids, np.abs(r.err), np.diff(r.times), color=[0.466, 0.674, 0.188])
        ax1.set_ylabel("Error Contribution")
        ax2 = ax1.twinx()
        u_p = r.u[0] if r.u.ndim == 3 else r.u
        v_p = r.v[0] if r.v.ndim == 3 else r.v
        for kk in range(u_p.shape[0]):
            # live nodes only: padded entries beyond an element's order are zeros
            npk = int(r.ns[kk]) + 1 if hp else u_p.shape[1]
            npa = npk + 1 if hp else v_p.shape[1]
            tk = np.linspace(r.times[kk], r.times[kk + 1], npk)
            ax2.plot(tk, u_p[kk, :npk], "g--*", linewidth=2)
            ta = np.linspace(r.times[kk], r.times[kk + 1], npa)
            ax2.plot(ta, v_p[kk, :npa], "r--*", linewidth=2)
        ax2.set_ylabel("Solution")
        fig.savefig(f"{case}/{case}_{i}.png")
        plt.close(fig)
    print(f"wrote {len(history)} frames to {case}/")


def _quiet(*_args, **_kw) -> None:
    """``print`` on the ranks other than 0 under ``--dp``."""


def _hp_main(args, ode, device, j_exact, mesh=None, say=print):
    """The ``--hp`` branch: the single run (torch engine, float64 unless
    ``--no-x64``), the ensemble-mean signal or the per-member study, its
    members over ``mesh``'s ranks (``--dp``); ``say`` prints."""
    from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop

    engine = "torch"
    if args.ensemble > 0:
        engine = args.engine or _default_engine(args, ode, device)
    x64 = engine == "torch" if args.x64 is None else args.x64
    dtype = torch.float64 if x64 else torch.float32
    hp_y0 = args.y0
    if args.ensemble > 0:
        rng = np.random.default_rng(args.seed)
        hp_y0 = rng.uniform(args.y0 / 2.0, 2.0 * args.y0, args.ensemble).astype(
            np.float64 if x64 else np.float32)
    common = dict(f_u=ode.f_u, k0=args.k0, n0=args.order, n_max=args.n_max, mode=args.hp,
                  tol=args.tol, maxit=args.maxit, adjoint_mode=args.adjoint,
                  newton_iters=args.newton_iters, engine=engine, ode=ode,
                  smooth_theta=args.smooth_theta, checkpoint_dir=args.checkpoint_dir,
                  device_loop=args.device_loop, mesh=mesh, dtype=dtype, device=device)
    if args.ensemble > 0 and args.per_member:
        # every member its own partition AND order vector
        history = hp_loop.run_adaptive_dg_hp_per_member(ode.f, hp_y0, (args.t0, args.t1),
                                                        **common)
        for it, r in enumerate(history):
            say(
                f"-- it {it} K=[{r.n_active.min()}..{r.n_active.max()}]"
                f" max order={r.ns.max()}"
                f" mean |est|={np.abs(r.est_total).mean():.10e}"
                f" refining={r.n_refining}/{args.ensemble}"
            )
        say(f"finished after {len(history)} iterations "
            f"(per-member hp, B={args.ensemble}, mode={args.hp})")
        return history

    # the exact-J comparison only makes sense for a single IC (the
    # ensemble's mean J is not the scalar y0's functional)
    hp_j_exact = j_exact if args.ensemble == 0 else None

    def hp_callback(r):
        say(f"-- it with K={len(r.ns)} ns={r.ns.tolist()}")
        say("JuH-Juh")
        say(f"{r.effectivity_gap:.10e}")
        if hp_j_exact is not None:
            say("JuH-Ju")
            say(f"{r.j_coarse - hp_j_exact:.10e}")
        say("Adj-W Res")
        say(f"{r.est_total:.10e}")

    history = hp_loop.run_adaptive_dg_hp(ode.f, hp_y0, (args.t0, args.t1),
                                         callback=hp_callback, **common)
    last = history[-1]
    say(f"finished after {len(history)} iterations "
        f"(mode={args.hp}, K={len(last.ns)}, "
        f"orders {last.ns.min()}..{last.ns.max()})")
    if args.plot and say is print:
        _plot_frames(args.case, history, hp=True)
    return history


if __name__ == "__main__":
    main()
