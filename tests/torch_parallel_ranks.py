"""One rank of the element-sharded port's CPU checks (tests/test_torch_parallel.py).

    python tests/torch_parallel_ranks.py STORE WORLD RANK OUT

joins a gloo process group of WORLD ranks through the FileStore STORE
(no process group at WORLD 1), runs every case of :data:`CASES` on its share
of the elements and writes its outputs to OUT/rank{RANK}.npz. It imports
torch, NumPy and the port, never jax, so each rank starts in a few seconds;
:func:`problem` builds the same inputs from seeds in the ranks and in the
test that compares them.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent  # noqa: E402
from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators  # noqa: E402
from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d  # noqa: E402

A = 2 * np.pi
# float64 dg_shard cases (tests/test_parallel.py's march: K=64, N=2, dt 5e-4,
# 50 steps) and the pipeline at K=64, 16 steps, segment 4
SHARD_MARCH = dict(k=64, n_order=2, dt=5e-4, n_steps=50)
SHARD_PIPE = dict(k=64, n_order=2, n_steps=16, segment=4, seed=3)
# the sharded factories at tests/test_pallas_sharded.py's sizes:
# (name, factory, K, segment, n_segments, chunks at one rank)
FACTORY_CASES = (
    ("blocked", "sharded_blocked", 640, 2, 4, None),
    ("grid", "tiled_grid_sharded", 3072, 1, 3, 16),
    ("grid_seg2", "tiled_grid_sharded", 2048, 2, 2, 8),
)


def problem(k: int, n_order: int = 2, dtype=torch.float32, seed: int = 1):
    """tests/test_pallas_sharded.py's problem (u0 = sin x, the CFL step
    0.5·(0.75/a)·x_min) with seeded perturbations: u0 + 0.05·N(0, 1) and J's
    cotangent weighted by U(0.5, 1.5). Returns ``(disc, dt, u0, lam)``."""
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    rng = np.random.default_rng(seed)
    u0 = np.sin(disc.x) + 0.05 * rng.standard_normal(disc.x.shape)
    w = rng.uniform(0.5, 1.5, disc.x.shape)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy() * w
    return (disc, 0.5 * (0.75 / A) * xmin, torch.tensor(u0, dtype=dtype),
            torch.tensor(lam, dtype=dtype))


def run_cases(grid) -> dict:
    """Every case on this rank's share: name -> array."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_sharded
    from adjoint_ode_adaptivity_tpu_torch.parallel import dg_shard, shard_along

    out = {}
    c = SHARD_MARCH
    disc = startup_1d(c["n_order"], 0.0, 2 * np.pi, c["k"])
    ops = advec_operators(disc, a=A, dtype=torch.float64, device="cpu")
    u0 = shard_along(torch.tensor(np.sin(disc.x)), grid, "space", dim=1)
    out["march"] = dg_shard.advec_march_sharded(ops, grid, u0, c["dt"], c["n_steps"]).numpy()

    c = SHARD_PIPE
    disc, dt, u0, lam = problem(c["k"], c["n_order"], torch.float64, c["seed"])
    ops = advec_operators(disc, a=A, dtype=torch.float64, device="cpu")
    res = dg_shard.advec_fwd_adj_estimate_sharded(
        ops, grid, shard_along(u0, grid, "space", 1), shard_along(lam, grid, "space", 1), dt,
        c["n_steps"], segment=c["segment"], t0=0.1)
    for key, x in zip(("u_final", "lam0", "eta", "j"), res):
        out[f"pipe_{key}"] = x.numpy()

    for name, factory, k, seg, n_seg, chunks in FACTORY_CASES:
        disc, dt, u0, lam = problem(k)
        kw = {} if chunks is None else {"chunks": chunks // grid.axis_size("space")}
        make = getattr(dg_sharded, f"make_cuda_fwd_adj_estimate_{factory}")
        run = make(disc, A, dt, grid, segment=seg, n_segments=n_seg, device="cpu", **kw)
        res = run(shard_along(u0, grid, "space", 1).contiguous(), 0.0,
                  shard_along(lam, grid, "space", 1).contiguous())
        for key, x in zip(("u_final", "lam0", "eta", "j"), res):
            out[f"{name}_{key}"] = x.numpy()
    return out


def main(store: str, world: int, rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
    try:
        out = run_cases(make_rank_grid({"space": world}))
    finally:
        if world > 1:
            dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
