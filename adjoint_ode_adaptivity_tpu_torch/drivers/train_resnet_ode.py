"""Train ResNet-as-integrator networks through the differentiable solver
with adjoint-driven depth (time) and width (neuron) adaptivity.

One driver covers the reference's five NN experiment families:

  --method recurrent        Main_FD_with_net.py   (shared Dense chain,
                            shuffled batches, terminal MSE)
  --method variable_params  Main_variable_params.py (per-step params,
                            ensemble refinement signal, noise insertion)
  --method new_loss         Main_new_loss.py      (trapezoid trajectory loss
                            + ramped terminal loss)
  --method detect           Main_no_matrix_detect_complex.py (plateau-gated
                            refinement, Gaussian-mixture ODE)
  --method width            Main_width_ref.py     (width-vs-depth policy)

Usage:
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.train_resnet_ode \\
        --method variable_params --seed 1 --epochs 200 --maxit 5

``--device`` defaults to ``cuda`` and raises when no GPU is present; it
never carries on on the CPU. On the card every method trains through its
hand-written kernel, T1 (ops/cuda/train_fused) for the per-step methods and
T2 (ops/cuda/train_dense_fused) for ``recurrent``, at any ``--n-train`` and
minibatch; a shape a kernel refuses raises. ``--train-engine torch`` takes
autograd instead (``auto`` on the CPU); ``auto`` on the card and ``cuda``
mean the kernel, and ``cuda`` on the CPU runs the kernels' plain versions,
as the JAX package's ``pallas`` engine runs its interpret mode there.

``--dp`` shards the training members over the ranks of a torchrun launch
(``parallel.init_dp_grid``; one rank without torchrun): each rank runs its
fused step on its block of the members and the loss and gradients are
summed over the ranks (``train.loop``'s ``mesh=``), so every rank holds the
same parameters and reaches the same refined grid. The fused engine only,
not ``--method recurrent`` (the JAX driver's rules); ``--n-train`` must
divide over the ranks. Rank 0 alone prints and writes the JSONL, the
checkpoints and ``meta.json``. Two ranks on the CPU:

    torchrun --nproc-per-node 2 -m adjoint_ode_adaptivity_tpu_torch.drivers.train_resnet_ode \
        --dp --device cpu --train-engine cuda --epochs 20 --maxit 2

The initial parameters and data are drawn from ``torch.Generator``s seeded
by ``--seed`` (not JAX's streams); :func:`train` takes them, so a caller
can feed its own.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import models, odes
from adjoint_ode_adaptivity_tpu_torch.adapt.policy import plateau_detect, should_refine_depth
from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march_per_step
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import RankGrid, barrier, init_dp_grid
from adjoint_ode_adaptivity_tpu_torch.train import checkpoint as ckpt
from adjoint_ode_adaptivity_tpu_torch.train import loop
from adjoint_ode_adaptivity_tpu_torch.train.adaptive import ensemble_refinement_signal
from adjoint_ode_adaptivity_tpu_torch.train.data import make_batches, rk4_truth
from adjoint_ode_adaptivity_tpu_torch.train.metrics import MetricsLogger
from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

DEFAULT_ODE = {
    "recurrent": "du/dt=t*sin(u)",
    "variable_params": "du/dt=10cos(u)",
    "new_loss": "du/dt=cos(2*pi*u)",
    "detect": "gaussian_mixture",
    "width": "du/dt=10cos(u)",
}


class Draws(NamedTuple):
    """The random draws the run makes after its start, each keyed by an
    integer as the JAX driver keys them: ``permutation(key, n)`` shuffles
    the recurrent method's minibatches (key = epoch), ``normal(key, shape,
    dtype, device)`` gives the unit normals of a noise insertion (key = the
    new node count)."""

    permutation: Callable
    normal: Callable


def torch_draws() -> Draws:
    def gen(key):
        return torch.Generator().manual_seed(int(key))

    return Draws(lambda key, n: torch.randperm(n, generator=gen(key)),
                 lambda key, shape, dtype, device: torch.randn(
                     tuple(shape), generator=gen(key), dtype=dtype).to(device))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--method", default="variable_params", choices=sorted(DEFAULT_ODE))
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--node", type=int, default=1, help="accepted for parity; unused")
    p.add_argument("--ode", default=None, help="override the method's default ODE")
    p.add_argument("--hidden", default=None,
                   help="--method recurrent: comma-separated Dense-chain hidden widths "
                        "(reference config '100,500'); default: one layer of --width")
    p.add_argument("--n-steps", type=int, default=2)
    p.add_argument("--t1", type=float, default=1.0)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--width-capacity", type=int, default=0,
                   help="padded neuron capacity for --method width (0 = width + maxit + 4)")
    p.add_argument("--ref-factor", type=int, default=4)
    p.add_argument("--epochs", type=int, default=200, help="epochs per outer iteration")
    p.add_argument("--maxit", type=int, default=5, help="outer refinement iterations")
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-test", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--ref-tol", type=float, default=5e-5, help="plateau tolerance")
    p.add_argument("--width-tol", type=float, default=5e-5, help="bin-loss tolerance")
    p.add_argument("--depth-rel-tol", type=float, default=0.1,
                   help="width-vs-depth plateau tolerance: refine depth when the relative "
                        "loss improvement over the epoch window falls below this; 0 forces "
                        "width growth")
    p.add_argument("--train-engine", default="auto", choices=["auto", "torch", "cuda"],
                   help="cuda = the fused training-epoch kernels (T1 per-step ResBlockSimple, "
                        "T2 the recurrent Dense chain; their plain versions on the CPU); "
                        "torch = autograd; auto = cuda on the card, torch on the CPU")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--dp", action="store_true",
                   help="shard the training members over the ranks of a torchrun launch (fused "
                        "engine only: per-rank fused epoch kernels, summed gradients; n-train "
                        "must divide over the ranks)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--jsonl", default=None, help="metrics JSONL path")
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--quiet", action="store_true")
    return p


def hidden_sizes(args) -> tuple:
    return (tuple(int(s) for s in args.hidden.split(",")) if args.hidden else (args.width,))


def capacity_of(args) -> int:
    if args.method == "width":
        return args.width_capacity or (args.width + args.maxit + 4)
    return args.width


def make_net(args, capacity: int):
    if args.method == "width":
        return models.ResBlockSimpleMasked(capacity)
    if args.method == "recurrent":
        return models.ResNetBlock(hidden_sizes(args))
    return models.ResBlockSimple(args.width)


def initial_draws(args, device):
    """(p1, u0_train, u0_test) from ``torch.Generator(seed)``, float32: one
    step's parameters (the width method's at its capacity, the width-``width``
    draw in its active prefix), ICs ~ U(−3, 3), and the test set [u0_train[0],
    −5, 4·N(0, 1)...] (the JAX driver's layout)."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.method == "width":
        p_simple = models.ResBlockSimple(args.width).init_params(gen)
        p1 = models.masked_params_from_simple(p_simple, capacity_of(args))
    else:
        p1 = make_net(args, args.width).init_params(gen)
    u0_train = torch.rand(args.n_train, generator=gen) * 6.0 - 3.0
    u0_test = torch.cat([u0_train[:1], torch.tensor([-5.0]),
                         4.0 * torch.randn(args.n_test - 2, generator=gen)])
    to = lambda x: x.to(device)  # noqa: E731
    return tree_map(to, p1), to(u0_train), to(u0_test)


def _ode(args):
    name = args.ode or DEFAULT_ODE[args.method]
    return odes.gaussian_mixture_ode() if name == "gaussian_mixture" else odes.get_ode(name)


def _insert_times(t: torch.Tensor, idx: int) -> torch.Tensor:
    mid = torch.mean(t[idx - 1: idx + 1])[None]
    return torch.cat([t[:idx], mid, t[idx:]])


def _fused(args, device) -> bool:
    """Whether the run trains through the fused kernels (module docstring)."""
    return args.train_engine == "cuda" or (args.train_engine == "auto"
                                          and device.type == "cuda")


def refuse_dp(args, device) -> None:
    """The JAX driver's ``--dp`` rules: the fused engine, not the shared chain."""
    if args.method == "recurrent":
        raise SystemExit("--dp is only supported with the fused engines "
                         "(methods variable_params/new_loss/detect/width)")
    if not _fused(args, device):
        raise SystemExit("--dp requires the fused engine (per-step ResBlockSimple method, "
                         "--train-engine cuda, or auto on the card)")


def train(args, p1, u0_train, u0_test, *, draws: Draws | None = None, device=None,
          mesh: RankGrid | None = None):
    """The run after the draws: ``p1`` one step's parameters (flax names,
    the width method's at its capacity), ``u0_train``/``u0_test`` the ICs,
    on ``device``, in their own dtypes (the data's dtype is the march's;
    the parameters keep theirs). ``mesh`` (``--dp``): the rank grid whose
    ``data`` axis shards the training members; every rank passes the same
    draws. Returns (state, times)."""
    draws = draws or torch_draws()
    device = torch.device(device or u0_train.device)
    lead = mesh is None or mesh.rank == 0  # prints and writes the files
    if mesh is not None:
        refuse_dp(args, device)
        d = mesh.axis_size("data")
        if args.n_train % d:
            raise SystemExit(f"--dp: n-train={args.n_train} must divide over the {d} ranks")
    dtype = u0_train.dtype
    ode = _ode(args)
    logger = MetricsLogger(f"ResNetODE_{args.method}_{args.seed}",
                           wandb_project=args.wandb_project if lead else None,
                           wandb_config={"problem": "ResNet", "method": args.method},
                           jsonl_path=args.jsonl if lead else None,
                           verbose=not args.quiet and lead)
    n_steps = args.n_steps
    t = torch.tensor(np.linspace(0.0, args.t1, n_steps + 1), dtype=dtype, device=device)
    dt = torch.diff(t)
    use_masked = args.method == "width"
    use_mixed = args.method == "new_loss"
    use_shared = args.method == "recurrent"
    capacity = capacity_of(args)
    net = make_net(args, capacity)
    n_active = (torch.full((n_steps,), args.width, dtype=torch.int32, device=device)
                if use_masked else None)
    tx = loop.Adam(args.lr)
    stack = lambda p, s: tree_map(lambda l: torch.stack([l] * s), p)  # noqa: E731
    state = loop.create_train_state(p1 if use_shared else stack(p1, n_steps), tx)
    span = (0.0, args.t1)
    true_train = rk4_truth(ode.f, u0_train, span, n_sub=256)
    true_test = rk4_truth(ode.f, u0_test, span, n_sub=256)
    batch_size = max(8, args.n_train // 16)
    use_fused = _fused(args, device)
    dp = dict(mesh=mesh)

    def nodes(dt):
        return torch.cat([torch.zeros_like(dt[:1]), torch.cumsum(dt, 0)])

    if use_mixed:
        traj_train = rk4_truth(ode.f, u0_train, span, n_sub=256, save_times=nodes(dt))

    def make_step(s, dt_now):
        if use_shared:
            if use_fused:
                return loop.make_shared_train_step_fused(tx, dt_now, hidden_sizes(args),
                                                         device=device)
            return loop.make_shared_train_step(net, tx, dt_now)
        if not use_fused:
            if use_mixed:
                return loop.make_mixed_loss_train_step(net, tx)
            if use_masked:
                return loop.make_per_step_masked_train_step(net, tx)
            return loop.make_per_step_train_step(net, tx)
        if use_mixed:
            return loop.make_mixed_loss_train_step_fused(tx, s, args.width, device=device, **dp)
        if use_masked:
            return loop.make_per_step_masked_train_step_fused(tx, s, capacity, device=device,
                                                              **dp)
        return loop.make_per_step_train_step_fused(tx, s, args.width, device=device, **dp)

    train_step = make_step(n_steps, dt)
    ep_total, it = 0, 0
    min_loss = torch.tensor(1e10, dtype=dtype, device=device)
    err_total = np.inf

    if args.resume and args.checkpoint_dir and ckpt.latest_step(args.checkpoint_dir) is not None:
        last = ckpt.latest_step(args.checkpoint_dir)
        meta_path = Path(args.checkpoint_dir) / "meta.json"
        ck_steps, ck_capacity = n_steps, capacity
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            ck_steps, ck_capacity = int(meta["n_steps"]), int(meta.get("capacity", capacity))
        try:
            ck_net, ck_p1 = net, p1
            if use_masked and ck_capacity != capacity:
                ck_net = make_net(args, ck_capacity)
                ck_p1 = ck_net.init_params(device=device)  # a shape template only
            tpl_params = ck_p1 if use_shared else stack(ck_p1, ck_steps)
            tpl = {"params": tpl_params, "exp_avg": tpl_params, "exp_avg_sq": tpl_params,
                   "opt_step": 0, "it": 0,
                   "times": torch.zeros(ck_steps + 1, dtype=dtype, device=device)}
            if use_masked:
                tpl["n_active"] = torch.zeros(ck_steps, dtype=torch.int32, device=device)
            restored = ckpt.restore_checkpoint(args.checkpoint_dir, tpl, last)
            net, capacity = ck_net, ck_capacity
            opt = loop.AdamState(int(restored["opt_step"]), restored["exp_avg"],
                                 restored["exp_avg_sq"])
            state = loop.TrainState(restored["params"], opt, 0)
            t = restored["times"]
            dt = torch.diff(t)
            it = int(restored["it"]) + 1
            n_steps = len(dt)
            if use_masked:
                n_active = restored["n_active"]
            train_step = make_step(n_steps, dt)
            if use_mixed:
                traj_train = rk4_truth(ode.f, u0_train, span, n_sub=256, save_times=nodes(dt))
            if lead:
                print(f"resumed from checkpoint step {last} (outer it {it})")
        except (ValueError, KeyError, RuntimeError) as e:
            if lead:
                print(f"resume failed ({type(e).__name__}: {e}); starting fresh")

    masked_step = lambda u, tt, d, pm: net(pm[0], u, tt, d, pm[1])  # noqa: E731
    per_step = lambda u, tt, d, p: net(p, u, tt, d)  # noqa: E731
    while err_total > args.tol and it <= args.maxit:
        loss_hist = torch.zeros((args.epochs,), dtype=dtype, device=device)
        ep, refine = 0, False
        while True:
            if use_mixed:
                state, loss = train_step(state, dt, u0_train, traj_train, it)
            elif use_shared:
                perm = draws.permutation(ep + ep_total, u0_train.shape[0])
                u0_b, true_b = make_batches(u0_train, true_train, batch_size, perm=perm)
                for b in range(u0_b.shape[0]):
                    state, loss = train_step(state, u0_b[b], true_b[b])
            elif use_masked:
                state, loss = train_step(state, dt, n_active, u0_train, true_train)
            else:
                state, loss = train_step(state, dt, u0_train, true_train)
            if use_masked:
                err = loop.evaluate_masked(net, state.params, n_active, dt, u0_test, true_test)
            else:
                err = loop.evaluate(net, state.params, dt, u0_test, true_test,
                                    per_step=not use_shared)
            logger.log({"Epoch": ep + ep_total, "Loss": loss, "Error": err, "Refinements": it})
            loss_hist = torch.cat([loss_hist[1:], loss.reshape(1).to(dtype)])
            ep += 1
            if args.method == "detect":
                if ep >= args.epochs:
                    refine, min_loss = plateau_detect(loss_hist, min_loss, args.ref_tol)
                    refine = bool(refine)
                if refine or ep >= 20 * args.epochs:
                    break
            elif ep >= args.epochs:
                break
        ep_total += ep

        # --- refinement signal (ensemble-averaged adjoint indicator)
        sig_n = min(args.n_train, 128)
        with torch.no_grad():
            if use_shared:
                sig = (per_step, tree_map(lambda l: l.expand((len(dt),) + l.shape), state.params))
            elif use_masked:
                sig = (masked_step, (state.params, n_active))
            else:
                sig = (per_step, state.params)
            err_steps = ensemble_refinement_signal(sig[0], sig[1], dt, args.ref_factor,
                                                   u0_train[:sig_n], true_train[:sig_n])
        err_total = float(torch.sum(err_steps))
        idx = int(torch.argmax(err_steps)) + 1

        # --- adapt
        grow_depth = True
        if args.method == "width":
            grow_depth = bool(should_refine_depth(loss_hist, args.depth_rel_tol))
        if grow_depth:
            t = _insert_times(t, idx)
            dt = torch.diff(t)
            if not use_shared:
                mode = "noise" if args.method == "variable_params" else "copy_left"
                noise = lambda shape, dt_, dev, key=len(t): draws.normal(key, shape, dt_, dev)  # noqa: E731
                new_params = models.insert_step_params(state.params, idx, mode=mode, noise=noise)
                state = loop.create_train_state(new_params, tx)
                if use_masked:
                    n_active = models.insert_step_params(n_active, idx)
            n_steps += 1
            train_step = make_step(n_steps, dt)
            what = f"depth insert at {idx}"
        else:
            # adaptWidth over every step's parameters in place
            # (Main_width_ref.py:225-312): trained weights kept, grown steps
            # get fresh moments, nothing changes shape
            with torch.no_grad():
                u_arr = forward_march_per_step(masked_step, u0_train[:sig_n, None], dt,
                                               (state.params, n_active))[..., 0].T
                grown, n_active_new, inserted = models.grow_width_all_steps(
                    state.params, n_active, u_arr, true_train[:sig_n], tol=args.width_tol)
            if bool(torch.any(inserted)):
                state = state._replace(params=grown,
                                       opt_state=models.zero_step_moments(state.opt_state,
                                                                          inserted))
                n_active = n_active_new
                what = (f"width grow at steps {np.flatnonzero(inserted.cpu().numpy()).tolist()}"
                        f" -> n_active={n_active.cpu().tolist()}")
            else:
                what = "no growth (below tol)"
        if use_mixed:
            traj_train = rk4_truth(ode.f, u0_train, span, n_sub=256, save_times=nodes(dt))

        if lead:
            print(f"outer it {it}: err_total={err_total:.4e}  {what}  (n_steps={len(dt)})")

        if args.checkpoint_dir:
            if lead:
                opt = state.opt_state
                ck = {"params": state.params, "exp_avg": opt.exp_avg,
                      "exp_avg_sq": opt.exp_avg_sq, "opt_step": opt.step, "times": t, "it": it}
                if use_masked:
                    ck["n_active"] = n_active
                ckpt.save_checkpoint(args.checkpoint_dir, it, ck)
                (Path(args.checkpoint_dir) / "meta.json").write_text(
                    json.dumps({"n_steps": int(len(dt)), "capacity": int(capacity)}))
            if mesh is not None:
                barrier(mesh)  # a rank that resumes next reads rank 0's files
        it += 1

    logger.finish()
    return state, t


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    grid = None
    if args.dp:
        refuse_dp(args, device)
        grid, device = init_dp_grid({"data": -1}, device)
        if grid.rank == 0:
            print(f"dp over {grid.world} devices")
    p1, u0_train, u0_test = initial_draws(args, device)
    return train(args, p1, u0_train, u0_test, device=device, mesh=grid)


if __name__ == "__main__":
    main()
