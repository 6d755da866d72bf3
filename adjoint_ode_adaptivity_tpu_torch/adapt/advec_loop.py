"""Goal-oriented element h-adaptivity for the DG advection problem.

Closes the estimate→refine loop over *elements*: march forward + adjoint,
localise the adjoint-weighted step-doubling error per element, bisect the
element with the largest |η|, rebuild the (now non-uniform) discretization,
repeat. Counterpart of the JAX package's ``adapt/advec_loop.py``.

η_k is the per-element contribution of the TIME-integration error to the
goal J = ∫ u(x, T) dx. dt is CFL-coupled to the smallest element, so
bisecting the worst element both shrinks dt globally and re-localises the
estimate. Operator construction is host-side float64 NumPy per iteration.

Engines: ``"torch"`` runs the eager path (adjoint/advec.py) in ``dtype`` on
``device``; ``"cuda"`` runs the hand-written kernels (ops/cuda/dg_rhs.py),
float32 only, and needs a CUDA ``device``: the stored-trajectory pipeline
while the trajectory fits in the card's free memory, the recompute pipeline
past it (:func:`choose_storage`).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import (
    advec_fwd_adj_estimate,
    terminal_integral_cotangent,
)
from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import pick_chunk, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import startup_1d

__all__ = ["AdvecAdaptResult", "choose_storage", "run_adaptive_advec"]

CHECKPOINT_FILE = "advec_adapt.pt"


class _EstimateResult(NamedTuple):
    j_value: torch.Tensor
    eta: torch.Tensor


# device states beside the stored trajectory: the kernels' work buffers
# (4 + 8), u_final, λ0 and η, with room to spare
STORED_EXTRA_STATES = 16


def choose_storage(n_steps: int, np_: int, b: int, k: int, free_bytes: int) -> tuple[bool, int]:
    """``(store, segment)`` for one estimate of n_steps steps on (Np, B, K)
    float32 states with ``free_bytes`` of device memory free: the stored
    trajectory when it fits, else the recompute pipeline, as the JAX loop
    falls back from its stored pipeline when a stored segment no longer
    fits (its adapt/advec_loop.py ``_build_pallas_pipeline``; the TPU's
    scoped-VMEM model is replaced by the card's free memory). The segment
    is ``pick_chunk(n_steps)``."""
    state_bytes = 4 * np_ * b * k
    store = (n_steps + STORED_EXTRA_STATES) * state_bytes <= free_bytes
    return store, pick_chunk(n_steps)


def _free_device_bytes(device) -> int:
    return torch.cuda.mem_get_info(device)[0]


def _cuda_estimate(disc, a, dt, n_steps, u0_fn, device) -> _EstimateResult:
    """One fwd+adjoint+estimate solve through the CUDA kernels (float32,
    B = 1) on the loop's non-uniform mesh; stored or recompute by the card's
    free memory (:func:`choose_storage`), which give the same bits."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import (
        make_cuda_fwd_adj_estimate_single,
    )

    store, segment = choose_storage(n_steps, disc.np_, 1, disc.k, _free_device_bytes(device))
    run = make_cuda_fwd_adj_estimate_single(disc, a, dt, n_steps, device,
                                            store_trajectory=store, segment=segment)
    u0 = torch.as_tensor(u0_fn(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    uf, _lam0, eta = run(u0.contiguous(), 0.0, lam)
    return _EstimateResult(j_value=torch.sum(lam * uf), eta=eta)


class AdvecAdaptResult(NamedTuple):
    vx: np.ndarray  # mesh vertices this iteration
    j_value: float  # J = ∫u(T) dx on this mesh
    eta: np.ndarray  # per-element contributions
    est_total: float
    n_steps: int = 0  # the CFL-derived march this iteration ran
    dt: float = 0.0


def _save(checkpoint_dir: str, vx: np.ndarray, history: list[AdvecAdaptResult]) -> None:
    """Write the loop state atomically (torch.save of tensors and floats)."""
    path = Path(checkpoint_dir)
    path.mkdir(parents=True, exist_ok=True)
    state = {
        "vx": torch.from_numpy(np.array(vx)),
        "history": [
            {
                "vx": torch.from_numpy(np.array(r.vx)),
                "j_value": r.j_value,
                "eta": torch.from_numpy(np.array(r.eta)),
                "est_total": r.est_total,
                "n_steps": r.n_steps,
                "dt": r.dt,
            }
            for r in history
        ],
    }
    tmp = path / f"{CHECKPOINT_FILE}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path / CHECKPOINT_FILE)


def _restore(checkpoint_dir: str):
    """(vx, history) from the checkpoint, or None when there is none."""
    path = Path(checkpoint_dir) / CHECKPOINT_FILE
    if not path.exists():
        return None
    raw = torch.load(path, weights_only=True)
    history = [
        AdvecAdaptResult(
            vx=h["vx"].numpy(),
            j_value=float(h["j_value"]),
            eta=h["eta"].numpy(),
            est_total=float(h["est_total"]),
            n_steps=int(h["n_steps"]),
            dt=float(h["dt"]),
        )
        for h in raw["history"]
    ]
    return raw["vx"].numpy(), history


def run_adaptive_advec(
    u0_fn: Callable,  # u0_fn(x) -> initial condition (NumPy)
    *,
    n_order: int = 2,
    k0: int = 10,
    a: float = 2 * np.pi,
    x_span: tuple[float, float] = (0.0, 2 * np.pi),
    final_time: float = 0.25,
    cfl: float = 0.375,
    maxit: int = 10,
    tol: float = 1e-10,
    dtype=torch.float64,
    engine: str = "torch",
    device="cuda",
    checkpoint_dir: str | None = None,
) -> list[AdvecAdaptResult]:
    """Adaptive element bisection driven by the adjoint-weighted
    step-doubling indicator, for J = ∫ u(x, T) dx.

    ``engine="cuda"`` runs the CUDA kernels on the (non-uniform)
    per-iteration mesh in float32 (``dtype`` is not read); ``"torch"``
    honours ``dtype`` (float64 for tight-tolerance studies). ``device``
    defaults to the card and raises when there is none; pass ``"cpu"`` to
    run the torch engine on the CPU. ``checkpoint_dir`` saves the loop
    after every iteration and resumes from it when a checkpoint is present."""
    if engine not in ("torch", "cuda"):
        raise ValueError(engine)
    device = require_device(device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    vx = np.linspace(x_span[0], x_span[1], k0 + 1)
    history: list[AdvecAdaptResult] = []
    if checkpoint_dir is not None:
        restored = _restore(checkpoint_dir)
        if restored is not None:
            vx, history = restored
            if abs(history[-1].est_total) < tol:
                return history
    for _ in range(len(history), maxit + 1):
        disc = startup_1d(n_order, x_span[0], x_span[1], len(vx) - 1, vx=vx)
        # CFL from the smallest element
        xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
        dt_c = cfl / a * xmin
        n_steps = max(8, int(np.ceil(final_time / dt_c / 8)) * 8)
        dt = final_time / n_steps
        if engine == "cuda":
            res = _cuda_estimate(disc, a, dt, n_steps, u0_fn, device)
        else:
            ops = advec_operators(disc, a=a, dtype=dtype, device=device)
            u0 = torch.as_tensor(u0_fn(disc.x), dtype=dtype, device=device)
            res = advec_fwd_adj_estimate(
                ops, disc, u0, dt, n_steps, segment=max(n_steps // 8, 1)
            )
        eta = res.eta.cpu().numpy()
        result = AdvecAdaptResult(
            vx=vx.copy(),
            j_value=float(res.j_value),
            eta=eta,
            est_total=float(np.sum(eta)),
            n_steps=n_steps,
            dt=float(dt),
        )
        history.append(result)
        done = abs(result.est_total) < tol
        if not done:
            worst = int(np.argmax(np.abs(eta)))
            mid = 0.5 * (vx[worst] + vx[worst + 1])
            vx = np.insert(vx, worst + 1, mid)
        if checkpoint_dir is not None:
            _save(checkpoint_dir, vx, history)
        if done:
            break
    return history
