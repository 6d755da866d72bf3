"""One rank of the member-sharded port's CPU checks (tests/test_torch_parallel_ensemble.py).

    python tests/torch_ensemble_ranks.py STORE WORLD RANK OUT

joins a gloo process group of WORLD ranks through the FileStore STORE (no
process group at WORLD 1), runs the ensemble functions of parallel/ensemble.py
and the three loops' ``mesh=`` on a rank grid of one ``data`` axis, and
writes what it got to OUT/rank{RANK}.pkl: every rank holds the global
results (the functions' outputs gathered in member order, the loops' global
histories). It imports torch, NumPy and the port, never jax, so each rank
starts in a few seconds; the inputs come from the seeds below, which the
test shares.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the functions' inputs: B = 8 members, float64
FN_B = 8
FN_SEED = 11
FN_A = 0.7  # the replicated extra of the per-member function
FN_DT = 0.25  # the replicated step of the refinement signal
FN_STEPS = 6
# the loops: B = 8 members (every world of 1, 2 and 4 ranks divides it),
# tests/test_pallas_dg_slab.py's and tests/test_device_loop.py's settings cut
# to a few iterations
LOOP_B = 8
LOOP_SEED = 6
DG_ENSEMBLE = dict(k0=2, maxit=3, tol=0.0, newton_iters=8)
DG_PER_MEMBER = dict(k0=3, maxit=2, tol=0.0, newton_iters=8)
FD_PER_MEMBER = dict(n_steps0=2, tol=0.15, maxit=4)
SPAN = (0.0, 2.0)
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def fn_inputs():
    rng = np.random.default_rng(FN_SEED)
    return rng.uniform(-2.0, 2.0, FN_B), rng.uniform(0.5, 1.5, FN_B)


def loop_y0s():
    return np.random.default_rng(LOOP_SEED).uniform(0.5, 2.0, LOOP_B)


def member_fn(u0, a):
    """One member's outputs: (sin(a·u0), u0²)."""
    return torch.stack([torch.sin(a * u0), u0 * u0])


def step_errors(u0, dt):
    """One IC's per-step indicator: forward Euler on u' = sin u, the local
    error |u''|·dt²/2 = |sin u · cos u|·dt²/2 at each step's start."""
    u, out = u0, []
    for _ in range(FN_STEPS):
        out.append(torch.abs(torch.sin(u) * torch.cos(u)) * (0.5 * dt * dt))
        u = u + dt * torch.sin(u)
    return torch.stack(out)


def run_functions(grid) -> dict:
    from adjoint_ode_adaptivity_tpu_torch.parallel import (
        all_gather,
        ensemble_batched,
        ensemble_mean,
        ensemble_refinement_signal,
        ensemble_vmap,
    )

    u0, w = (torch.tensor(x) for x in fn_inputs())
    a = torch.tensor(FN_A, dtype=torch.float64)
    out = {}
    for vectorize in (True, False):
        local = ensemble_vmap(member_fn, grid, vectorize=vectorize)(u0, a)
        out[f"vmap_{vectorize}"] = all_gather(local, grid, "data").numpy()
    local = ensemble_batched(lambda u, s, ww: u * s + ww, grid, shard_extras={1})(u0, a, w)
    out["batched"] = all_gather(local, grid, "data").numpy()
    out["mean"] = ensemble_mean(member_fn, grid)(u0, a).numpy()
    mean_err, arg = ensemble_refinement_signal(step_errors, grid)(u0, FN_DT)
    out["signal"], out["argmax"] = mean_err.numpy(), int(arg)
    return out


SETTINGS = {"dg_ensemble": DG_ENSEMBLE, "dg_per_member": DG_PER_MEMBER,
            "fd_per_member": FD_PER_MEMBER}


def run_loop(name, grid, dtype, **kw):
    """The loop ``name`` under ``grid`` (``mesh=None`` when grid is None),
    torch engine on the CPU, with its settings updated by ``kw``; its
    history as a list of dicts."""
    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step

    sin = odes.get_ode("du/dt=sin(u)")
    common = dict(mesh=grid, dtype=dtype, device="cpu", **{**SETTINGS[name], **kw})
    if name == "dg_ensemble":
        hist = dg_loop.run_adaptive_dg_ensemble(sin.f, loop_y0s(), SPAN, f_u=sin.f_u, **common)
    elif name == "dg_per_member":
        hist = dg_loop.run_adaptive_dg_per_member(sin.f, loop_y0s(), SPAN, f_u=sin.f_u,
                                                  **common)
    else:
        hist = fd_loop.run_adaptive_fd_per_member(euler_step(sin.f), loop_y0s(), SPAN, **common)
    return [r._asdict() for r in hist]


def run_cases(grid, out_dir: Path) -> dict:
    """Every case on this rank: name -> the global result."""
    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop

    out = {"functions": run_functions(grid)}
    for name in SETTINGS:
        for tag, dtype in DTYPES.items():
            for device_loop in (False, True):
                out[f"{name}/{tag}/{device_loop}"] = run_loop(name, grid, dtype,
                                                              device_loop=device_loop)
        # float64, stopped after two iterations (maxit 1), then resumed to the full maxit
        ck = str(out_dir / f"ckpt_{name}")
        run_loop(name, grid, torch.float64, maxit=1, checkpoint_dir=ck)
        out[f"{name}/resumed"] = run_loop(name, grid, torch.float64, checkpoint_dir=ck)
    # a B that does not divide over the ranks (world > 1)
    sin = odes.get_ode("du/dt=sin(u)")
    y = np.ones(grid.world + 1)
    refusals = []
    for call in (dg_loop.run_adaptive_dg_ensemble, dg_loop.run_adaptive_dg_per_member,
                 fd_loop.run_adaptive_fd_per_member):
        if grid.world == 1:
            break
        try:
            call(sin.f, y, SPAN, mesh=grid, maxit=1, device="cpu")
        except ValueError as exc:
            refusals.append(str(exc))
    out["refusals"] = refusals
    return out


def main(store: str, world: int, rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
    try:
        out = run_cases(make_rank_grid({"data": world}), Path(out_dir))
    finally:
        if world > 1:
            dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
