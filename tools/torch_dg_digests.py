#!/usr/bin/env python3
"""The register-design advection and Burgers kernels' bits of a checkout, on
one GPU: digests of K1 (the trajectory and u_final), K2 (λ0, η), K2r (the
checkpoints, λ0, η), KA (λ0) and B1 (float32 ΠN and float64 Π¹) at every
order the register design serves, N = 1-7 (Np 2-8), through the wrappers
(the plans their plan functions pick), computed with the package of the
checkout at ROOT.

    python3 tools/torch_dg_digests.py ROOT [--time]

ROOT is a checkout with ``adjoint_ode_adaptivity_tpu_torch/`` (for example
``git archive <commit> | tar -x -C build/parent``); its kernels build into
ROOT/build/torch_kernels/. Prints one JSON object, the keys of
chip_smoke.py's ``PARENT_DIGESTS`` for these kernels; phase 43 computes the
same digests with :func:`digests` on its own checkout and asserts that the
kernels keep the pinned parent's bits. ``--time`` prints, instead, chip_smoke.py
phase 4's timings of the headline (K = 10⁴, B = 8, 2048 steps, N = 2 and 7:
the stored pipeline, K1 alone, K2 alone, each the median of 5 CUDA-event
runs after a warm-up) and B1's at the same shape (ΠN, float32): run it on
two checkouts in turns (A, B, B, A) in one call to compare them.
"""
import hashlib
import json
import sys

import numpy as np

# a graded mesh of K elements (several tiles of every plan), B members, the
# CFL step; 24 steps (K2r: checkpoint segment 4); B1 at dt = 0.3·x_min
CASE = dict(k=3000, b=3, n_steps=24, segment=4, b1_k=2000, b1_b=2, b1_steps=32)
ORDERS = tuple(range(1, 8))


def digest(tensors) -> str:
    """sha256 (16 hex digits) of the tensors' bytes in order (chip_smoke.py's)."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(device) -> dict:
    """``{"K1 N=n": …, "K2 N=n": …, "K2r N=n": …, "KA N=n": …, "B1 N=n f32": …,
    "B1 N=n f64": …}`` for n in ORDERS, with the package already on sys.path."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    a, c = 2 * np.pi, CASE
    out = {}
    for n in ORDERS:
        vx = 2 * np.pi * np.linspace(0.0, 1.0, c["k"] + 1) ** 1.6
        disc = startup_1d(n, 0.0, 2 * np.pi, c["k"], vx=vx)
        dt = 0.375 / a * float(np.min(np.abs(disc.x[0] - disc.x[1])))
        rng = np.random.default_rng(n)
        u0 = np.stack([np.sin(disc.x + p) + 0.5 * rng.uniform(-1, 1, disc.x.shape)
                       for p in rng.uniform(0, 2 * np.pi, c["b"])], axis=1)
        lam = rng.uniform(-1, 1, u0.shape) * float(disc.jac.max())
        u0 = torch.tensor(u0, dtype=torch.float32, device=device)
        lam = torch.tensor(lam, dtype=torch.float32, device=device)
        ops = dg_rhs.kernel_ops(disc, a, dt, device)
        traj, uf = dg_rhs.fwd_march(u0, 0.1, c["n_steps"], ops, store_trajectory=True)
        out[f"K1 N={n}"] = digest([traj, uf])
        out[f"K2 N={n}"] = digest(dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops))
        ckpts, _ = dg_rhs.fwd_march_ckpt(u0, 0.1, c["n_steps"], c["segment"], ops)
        out[f"K2r N={n}"] = digest([ckpts, *dg_rhs.adj_est_recompute(ckpts, lam, 0.1,
                                                                     c["segment"], ops)])
        out[f"KA N={n}"] = digest([dg_rhs.adj_march(lam, c["n_steps"], ops)])
        disc_b = startup_1d(n, 0.0, 2 * np.pi, c["b1_k"])
        dt_b = 0.3 * float(np.min(np.abs(disc_b.x[0] - disc_b.x[1])))
        ics = np.stack([(0.5 + 0.05 * j) * np.sin(disc_b.x) + 0.1 * rng.uniform(-1, 1, disc_b.x.shape)
                        for j in range(c["b1_b"])], axis=1)
        for lim, dtype, tag in (("n", torch.float32, "f32"), ("1", torch.float64, "f64")):
            tab = cb.burgers_tables(disc_b, dt_b, lim, device)
            u = cb.burgers_march(torch.tensor(ics, dtype=dtype, device=device), c["b1_steps"], tab)
            out[f"B1 N={n} {tag}"] = digest([u])
    return out


def times(device) -> dict:
    """ms of the headline pipeline, K1 and K2 at N = 2 and 7 and of B1 at
    N = 2 (phase 4's and phase 33's shapes), median of 5 after a warm-up."""
    import statistics

    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    def ms(fn):
        fn()
        got = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            got.append(start.elapsed_time(end))
        return statistics.median(got)

    a, k, b, n = 2 * np.pi, 10_000, 8, 2048
    out, res = {}, {}
    for n_order in (2, 7):
        disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
        dt = 0.5 * 0.75 / a * float(np.min(np.abs(disc.x[0] - disc.x[1])))
        ops = dg_rhs.kernel_ops(disc, a, dt, device)
        u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in
                                    np.linspace(0, 2 * np.pi, b, endpoint=False)], axis=1),
                          dtype=torch.float32, device=device)
        lam = terminal_integral_cotangent(disc, torch.float32, device)
        lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
        run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, a, dt, n, b, device,
                                                             store_trajectory=True)
        res[f"pipeline N={n_order}"] = ms(lambda: out.update(r=run(u0, 0.0, lam)))
        res[f"K1 N={n_order}"] = ms(lambda: out.update(k1=dg_rhs.fwd_march(u0, 0.0, n, ops, True)))
        traj, uf = out.pop("k1")
        res[f"K2 N={n_order}"] = ms(lambda: dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops))
        del traj, uf
        out.clear()
    disc = startup_1d(2, 0.0, 2 * np.pi, k)
    tab = cb.burgers_tables(disc, 0.3 * float(np.min(np.abs(disc.x[0] - disc.x[1]))), "n", device)
    u = torch.tensor(np.stack([(0.5 + 0.05 * j) * np.sin(disc.x) for j in range(b)], axis=1),
                     dtype=torch.float32, device=device)
    res["B1 N=2"] = ms(lambda: cb.burgers_march(u, n, tab))
    return res


def main(root: str, timing: bool) -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(json.dumps(times(device) if timing else digests(device)), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or (len(sys.argv) == 3 and sys.argv[2] != "--time"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], len(sys.argv) == 3))
