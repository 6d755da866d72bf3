"""High-order DG advection on the CPU against the JAX package's Pallas
kernels: the stored-trajectory pipeline at N = 8 (Np = 9) in interpret mode
against the plain versions (ops/cuda/dg_rhs.py) in float32.

Both fold their tables in float32 and sum in other orders, as the kernel and
its plain version do, so the two agree within chip_smoke.py's
``tolerances``, which
has teeth: entries of the plain output lie above it. Interpret mode at
Np = 9 costs ~17 s a call here, so the case is the least that still runs
the pipeline's segment loop: K = 8, B = 1, two segments of one step.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import tolerances  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi


def test_plain_matches_pallas_interpret_f32():
    from adjoint_ode_adaptivity_tpu.ops.pallas.dg_rhs import (
        make_pallas_fwd_adj_estimate_grid_batched,
    )

    k, b, seg, nseg = 8, 1, 1, 2
    disc_j = jax_startup_1d(8, 0.0, 2 * np.pi, k)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    dt = 0.5 * 0.75 / A * float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    rng = np.random.default_rng(3)
    # a sine with unit nodal noise: its stiff modes lift η above the bound
    u0 = (np.sin(disc.x) + rng.uniform(-1, 1, disc.x.shape))[:, None, :].astype(np.float32)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy()
    lam = (lam * (1 + 0.5 * rng.uniform(-1, 1, lam.shape)))[:, None, :].astype(np.float32)
    pallas = make_pallas_fwd_adj_estimate_grid_batched(
        disc_j, A, dt, segment=seg, n_segments=nseg, batch=b, interpret=True,
        store_trajectory=True)
    want = pallas(jnp.asarray(u0), jnp.float32(0.0), jnp.asarray(lam))
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, seg * nseg, b, "cpu",
                                                         store_trajectory=True)
    got = run(torch.tensor(u0), 0.0, torch.tensor(lam))
    tol = tolerances(seg * nseg, disc.np_, got[0], torch.tensor(lam))
    for g, w, key in zip(got, want, ("u", "lam", "eta")):
        assert g.dtype == torch.float32
        assert float((g - torch.tensor(np.array(w))).abs().max()) <= tol[key], key
        assert bool((g.abs() > tol[key]).any()), key  # teeth: an output of 0 fails
