"""One rank of the CPU checks of the port's data- and pipeline-parallel
pieces (tests/test_torch_parallel_dp.py).

    python tests/torch_dp_ranks.py OUT

runs as one rank of a torchrun launch: with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment it
joins the gloo group through ``parallel.init_dp_grid``, as the drivers'
``--dp`` does; without them it is the only rank. It reads the inputs that
the test drew with JAX from OUT/inputs.pkl, runs every case below on grids
of that group (the hp loops' and the fused train steps' ``mesh=`` on a
``data`` axis, ``pipeline_march`` on a ``pipe`` axis and on a 2 × 2 ``data``
× ``pipe`` grid at four ranks, both drivers with ``--dp``) and writes what
it got to OUT/rank{RANK}.pkl. It imports torch, NumPy and the port, never
jax.
"""
from __future__ import annotations

import contextlib
import io
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPAN = (0.0, 2.0)
# the hp loops at the JAX tests' settings: tests/test_dg_mixed.py:528 (the
# shared-partition ensemble), :613 (per member, device loop) and
# tests/test_pallas_hp.py:317 (per member through the kernel, B = 16)
HP = {
    "hp_ensemble": (np.linspace(0.6, 1.9, 8),
                    dict(k0=3, n0=1, n_max=3, mode="hp", tol=0.0, maxit=3)),
    "hp_per_member": (np.linspace(0.3, 2.8, 8),
                      dict(k0=3, n0=1, n_max=3, mode="h", tol=0.0, maxit=3)),
    "hp_kernel": (np.linspace(0.6, 1.8, 16),
                  dict(k0=3, n0=1, n_max=3, mode="hp", tol=0.0, maxit=3, newton_iters=8,
                       engine="cuda")),
    # the smooth mode's mean solution rides the same all-reduce
    "hp_smooth": (np.linspace(0.6, 1.9, 8),
                  dict(k0=3, n0=1, n_max=3, mode="smooth", tol=0.0, maxit=3)),
}
# the fused train steps at tests/test_pallas_train.py's S and F, two steps,
# B = 1024 distinct members (the JAX tests tile 256; distinct members give
# each rank a different share of the gradient, so that a dropped or doubled
# share shows)
TRAIN_STEPS = ("t1", "t1_mixed", "t1_masked", "t2")
N_TRAIN_STEPS = 2
LR = 1e-3


def _sin():
    from adjoint_ode_adaptivity_tpu_torch import odes

    return odes.get_ode("du/dt=sin(u)")


def _dtype(cfg):
    return torch.float32 if cfg.get("engine") == "cuda" else torch.float64


def run_hp(name, grid, **kw):
    """The hp case ``name`` (its loop, settings updated by ``kw``) under
    ``grid`` (``mesh=None`` when None); the history as a list of dicts."""
    from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop

    sin = _sin()
    y0s, cfg = HP[name]
    cfg = {**cfg, **kw}
    dtype = _dtype(cfg)
    run = (hp_loop.run_adaptive_dg_hp_per_member if "per_member" in name or name == "hp_kernel"
           else hp_loop.run_adaptive_dg_hp)
    hist = run(sin.f, y0s.astype(np.float32 if dtype == torch.float32 else np.float64), SPAN,
               f_u=sin.f_u, ode=sin, mesh=grid, dtype=dtype, device="cpu", **cfg)
    return [r._asdict() for r in hist]


def hp_cases(grid, out_dir: Path, world: int) -> dict:
    out = {}
    for name in HP:
        for device_loop in (False, True):
            out[f"{name}/{device_loop}"] = run_hp(name, grid, device_loop=device_loop)
            if world == 1:
                out[f"{name}/{device_loop}/unsharded"] = run_hp(name, None,
                                                                device_loop=device_loop)
    for name in ("hp_ensemble", "hp_per_member"):
        # two iterations (maxit 1), saved by rank 0, then resumed on every
        # rank to the study's maxit
        ck = str(out_dir / f"ckpt_{name}")
        run_hp(name, grid, maxit=1, checkpoint_dir=ck)
        out[f"{name}/resumed"] = run_hp(name, grid, checkpoint_dir=ck)
    refusals = []
    if world > 1:
        from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop

        sin = _sin()
        for run in (hp_loop.run_adaptive_dg_hp, hp_loop.run_adaptive_dg_hp_per_member):
            try:
                run(sin.f, np.ones(world + 1), SPAN, mesh=grid, maxit=1, device="cpu")
            except ValueError as exc:
                refusals.append(str(exc))
    out["hp_refusals"] = refusals
    return out


def _torch_tree(tree):
    from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _numpy_tree(tree):
    from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def run_train(kind, inp, grid):
    """Two steps of the fused train step ``kind`` on the CPU (the kernels'
    plain versions) under ``grid``: (losses, final params)."""
    from adjoint_ode_adaptivity_tpu_torch.train import loop

    case = inp[kind]
    params = _torch_tree(case["params"])
    dt = torch.from_numpy(case["dt"])
    u0, tg = torch.from_numpy(case["u0"]), torch.from_numpy(case["target"])
    tx = loop.Adam(LR)
    state = loop.create_train_state(params, tx)
    s, f = dt.shape[0], case.get("features")
    dp = dict(device="cpu", mesh=grid)
    losses = []
    if kind == "t1":
        step = loop.make_per_step_train_step_fused(tx, s, f, **dp)
        for _ in range(N_TRAIN_STEPS):
            state, loss = step(state, dt, u0, tg)
            losses.append(float(loss))
    elif kind == "t1_mixed":
        step = loop.make_mixed_loss_train_step_fused(tx, s, f, **dp)
        for it in range(N_TRAIN_STEPS):
            state, loss = step(state, dt, u0, tg, it)
            losses.append(float(loss))
    elif kind == "t1_masked":
        step = loop.make_per_step_masked_train_step_fused(tx, s, f, **dp)
        n_active = torch.from_numpy(case["n_active"])
        for _ in range(N_TRAIN_STEPS):
            state, loss = step(state, dt, n_active, u0, tg)
            losses.append(float(loss))
    else:
        step = loop.make_shared_train_step_fused(tx, dt, tuple(case["sizes"]), **dp)
        for _ in range(N_TRAIN_STEPS):
            state, loss = step(state, u0, tg)
            losses.append(float(loss))
    return losses, _numpy_tree(state.params)


@contextlib.contextmanager
def faulty_sum(kind):
    """The train steps' sum over the ranks with rank 1's share dropped
    (``drop``) or rank 0's counted twice (``twice``): what the checks must
    tell from the right sum."""
    from adjoint_ode_adaptivity_tpu_torch.train import loop

    real = loop.all_gather

    def gather(x, grid, axis, dim=0):
        parts = real(x, grid, axis, dim)
        return parts[:1] if kind == "drop" else torch.cat([parts, parts[:1]])

    loop.all_gather = gather
    try:
        yield
    finally:
        loop.all_gather = real


def train_cases(grid, inp, world: int) -> dict:
    out = {}
    for kind in TRAIN_STEPS:
        out[f"{kind}/mesh"] = run_train(kind, inp, grid)
        if world == 1:
            out[f"{kind}/unsharded"] = run_train(kind, inp, None)
        if world == 2:
            for fault in ("drop", "twice"):
                with faulty_sum(fault):
                    out[f"{kind}/{fault}"] = run_train(kind, inp, grid)
    return out


def pipeline_cases(world: int, inp) -> dict:
    """``pipeline_march`` on a ``pipe`` axis of every rank (and on a 2 × 2
    ``data`` × ``pipe`` grid at four ranks) at tests/test_parallel.py's
    settings."""
    from adjoint_ode_adaptivity_tpu_torch import models
    from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march_per_step
    from adjoint_ode_adaptivity_tpu_torch.parallel import (
        all_reduce_sum,
        make_rank_grid,
        pipeline_march,
    )

    pipe = make_rank_grid({"pipe": world})
    out = {}

    def step_sin(u, t, dt, p):
        return u + dt * (torch.sin(p["w"] * u) + 0.1 * t + p["b"])

    c = inp["pipe_finals"]
    params = {k: torch.from_numpy(v) for k, v in c["params"].items()}
    dt, u0s = torch.from_numpy(c["dt"]), torch.from_numpy(c["u0s"])
    out["finals"] = pipeline_march(step_sin, pipe)(params, dt, u0s, t0=0.25).numpy()
    if world == 1:  # the single-process march, microbatch by microbatch
        out["finals/sequential"] = torch.stack([
            forward_march_per_step(step_sin, u0s[j], dt, params, t0=0.25)[-1]
            for j in range(u0s.shape[0])]).numpy()

    def step_tanh(u, t, dt, p):
        return u + dt * torch.tanh(p["w"] * u + p["b"])

    c = inp["pipe_grads"]
    params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in c["params"].items()}
    dt, u0s = torch.from_numpy(c["dt"]), torch.from_numpy(c["u0s"])
    loss = torch.sum(pipeline_march(step_tanh, pipe)(params, dt, u0s) ** 2)
    loss.backward()
    out["grads/loss"] = float(loss.detach())
    out["grads/own"] = {k: v.grad.numpy().copy() for k, v in params.items()}
    out["grads"] = {k: all_reduce_sum(v.grad, pipe).numpy() for k, v in params.items()}

    c = inp["pipe_resnet"]
    net = models.ResBlockSimple(c["width"])
    stacked = {k: torch.from_numpy(v) for k, v in c["params"].items()}

    def step_net(u, t, dt, p):  # (mb,) scalar states as (mb, 1)
        return net(p, u[:, None], t, dt)[:, 0]

    dt, u0s = torch.from_numpy(c["dt"]), torch.from_numpy(c["u0s"])
    out["resnet"] = pipeline_march(step_net, pipe)(stacked, dt, u0s).numpy()

    s_bad = world + 1  # does not divide over the ranks
    if world > 1:
        try:
            pipeline_march(lambda u, t, dt, p: u, pipe)(
                {"w": torch.zeros(s_bad)}, torch.ones(s_bad), torch.zeros(2, 3))
        except ValueError as exc:
            out["mismatch"] = str(exc)

    if world == 4:
        def step_w(u, t, dt, p):
            return u + dt * torch.tanh(p["w"] * u)

        grid = make_rank_grid({"data": 2, "pipe": 2})
        c = inp["pipe_data"]
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in c["params"].items()}
        dt, u0s = torch.from_numpy(c["dt"]), torch.from_numpy(c["u0s"])
        finals = pipeline_march(step_w, grid, axis="pipe", data_axis="data")(params, dt, u0s)
        torch.sum(finals ** 2).backward()
        out["data_pipe"] = finals.detach().numpy()
        # each rank's share: its steps and its block of the members
        out["data_pipe/grads"] = {k: all_reduce_sum(v.grad, grid).numpy()
                                  for k, v in params.items()}
    return out


DG_ARGV = {
    # tests/test_drivers.py:288-303's ensemble run, then the per-member and
    # both hp branches at small sizes
    "ensemble": ["--ensemble", "16", "--maxit", "2", "--tol", "0"],
    "per_member": ["--ensemble", "8", "--per-member", "--k0", "3", "--maxit", "12", "--tol",
                   "1e-4", "--device-loop"],
    "hp_ensemble": ["--hp", "hp", "--ensemble", "8", "--k0", "3", "--n-max", "3", "--maxit",
                    "2", "--tol", "0"],
    "hp_per_member": ["--hp", "hp", "--ensemble", "8", "--per-member", "--k0", "3", "--n-max",
                      "3", "--maxit", "2", "--tol", "0"],
}
# tests/test_drivers.py:223-241's run
TRAIN_ARGV = ["--method", "variable_params", "--epochs", "2", "--maxit", "1", "--n-train",
              "1024", "--n-test", "4", "--width", "4", "--quiet", "--seed", "3",
              "--train-engine", "cuda"]


def driver_cases(out_dir: Path, world: int, rank: int) -> dict:
    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive, train_resnet_ode

    out = {}
    for name, argv in DG_ARGV.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hist = dg_adaptive.main(argv + ["--device", "cpu", "--dp"])
        out[f"dg/{name}"] = ([r._asdict() for r in hist], buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, t = train_resnet_ode.main(TRAIN_ARGV + [
            "--device", "cpu", "--dp", "--jsonl", str(out_dir / "train.jsonl"),
            "--checkpoint-dir", str(out_dir / "train_ckpt")])
    out["train"] = (t.numpy(), _numpy_tree(state.params), buf.getvalue())
    out["train/jsonl_lines"] = (len((out_dir / "train.jsonl").read_text().splitlines())
                                if rank == 0 else None)
    if world > 1:
        try:
            train_resnet_ode.main(TRAIN_ARGV + ["--device", "cpu", "--dp", "--n-train",
                                                str(512 * world + 1)])
        except SystemExit as exc:
            out["train/refusal"] = str(exc)
    return out


def main(out_dir: str) -> None:
    import torch.distributed as dist

    from adjoint_ode_adaptivity_tpu_torch.parallel import init_dp_grid

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    with open(out_dir / "inputs.pkl", "rb") as fh:
        inp = pickle.load(fh)
    try:
        grid, device = init_dp_grid({"data": -1}, "cpu")
        assert grid.world == world and grid.rank == rank and device.type == "cpu"
        out = {"grid": (grid.names, grid.sizes, grid.backend)}
        out.update(hp_cases(grid, out_dir, world))
        out.update(train_cases(grid, inp, world))
        out.update(pipeline_cases(world, inp))
        out.update(driver_cases(out_dir, world, rank))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_dir / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main(sys.argv[1])
