"""Adaptive DG-in-time refinement loops — the matlab/MAIN.m driver.

Counterpart of the JAX package's ``adapt/dg_loop.py``. Per iteration: coarse
DG solve (order n), fine solve (n+2) for the effectivity report, adjoint at
n+1, per-element adjoint-weighted residual, bisection of the element with
the largest |contribution| (MAIN.m:137-141), repeat.

- :func:`run_adaptive_dg` — one initial condition; dynamic partitions (one
  element more per iteration) or padded ones (``padded=True``: zero-width
  slabs up to ``k0 + maxit + 1`` elements; a zero-width slab solve is an
  exact identity, its adjoint inert and its contribution exactly zero, so
  refinement changes data, never shapes).
- :func:`run_adaptive_dg_ensemble` — B initial conditions share one padded
  partition, refined at the ensemble-mean |contribution|
  (Main_variable_params.py:330-341's signal on the MATLAB strand).
- :func:`run_adaptive_dg_per_member` — every member owns its padded
  partition, bisects its own worst element and freezes once |Σerr| < tol
  (the reference's one-adaptive-job-per-IC farm).

The ensemble loops take ``engine="torch"`` (march/dg_batched.py) or
``engine="cuda"``: each iteration's whole fwd + adjoint + AWR pipeline in one
launch of the DG slab kernel (ops/cuda/dg_slab.py), in float32. It runs the
ODE ``ode`` (a registry entry's functor; an ``ODEProblem`` without a
``kernel_id`` is traced) or, with ``ode=None``, the loop's own ``f`` and
``f_u`` traced into a device functor (``f_u=None`` derived by forward
mode), as the JAX package's Pallas engine takes ``f``; ``g_u`` is ``None``
(J = ∫u), a registry functional's g_u, or any elementwise callable, traced.
The trace and the user library's build happen once a study. A callable
outside the tracer's op set raises (ops/cuda/functor.py). On a CPU device
it runs the kernel's plain version.

``device_loop=True`` runs a fixed trip of ``maxit + 1`` iterations (fewer
when resumed) with the stopping tests as device masks (|Σerr| < tol for the
single run, |mean Σerr| < tol for the ensemble, per-member ``refining``);
one fetch at the end says which iterations belong to the history, the rest
are dropped, and the history is bit-identical to the host loop's. The
single run's Newton solves still read a norm per step (march/dg_time.py).

``mesh=`` (the ensemble loops): a :class:`~..parallel.mesh.RankGrid` whose
``mesh_axis`` (default ``"data"``) shards the members over ranks, as the
JAX package's ``mesh=`` shards them over devices; B must divide over the
axis. Each rank runs its block of members through the same estimate (the
cuda engine's D1, or the torch engine). The ensemble loop does so by
:func:`~..parallel.ensemble.ensemble_batched` on the replicated partition
and sums its means (the per-element |err|, J and Σerr) over the ranks in
one all-reduce an iteration, so every rank takes the same bisection and
the same stop; the per-member loop keeps only its block's partitions and
gathers its diagnostics in member order (once at the end with
``device_loop``), the stop (no member refining) global. Every rank returns
the global history; at one rank it is the unsharded loop's, bit for bit.
With ``checkpoint_dir`` rank 0 writes the gathered state and every rank
resumes from it.

Entry points run on the card unless the caller passes ``device="cpu"``; a
CUDA device that is not there raises. Checkpoints are ``torch.save`` files
(fd_loop's atomic save); a resumed run continues the history. Not ported:
``iteration=`` (a jit-reuse hook that eager torch does not need).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.adapt.fd_loop import (
    _atomic_save,
    _load,
    _member_grid,
    _save_rank0,
)
from adjoint_ode_adaptivity_tpu_torch.adapt.policy import _insert
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_time import (
    dg_adjoint_march,
    dg_adjoint_reconstruct,
    dg_awr_from_adjoint,
    dg_element_functional,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import (
    dg_adjoint_march_batched,
    dg_element_functional_batched,
    dg_march_batched,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_march, dg_time_operators
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.parallel.ensemble import ensemble_batched
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import (
    RankGrid,
    all_gather,
    all_reduce_sum,
    shard_along,
)

__all__ = [
    "DGAdaptResult",
    "run_adaptive_dg",
    "DGEnsembleAdaptResult",
    "run_adaptive_dg_ensemble",
    "DGPerMemberAdaptResult",
    "run_adaptive_dg_per_member",
]

CHECKPOINT_FILE = "dg_adapt.pt"
ENSEMBLE_CHECKPOINT_FILE = "dg_adapt_ensemble.pt"
PER_MEMBER_CHECKPOINT_FILE = "dg_adapt_per_member.pt"


def _bisect(times: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Padded bisection along the last axis: the midpoint of element
    argmax(err) inserted, the last node dropped (zero-width padding slabs
    contribute exactly zero and never win the argmax)."""
    return _insert(times, torch.argmax(err, dim=-1, keepdim=True) + 1)


def _to_saved(record: dict) -> dict:
    """A history record with its arrays as tensors (torch.load's
    weights_only mode takes tensors and Python numbers)."""
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in record.items()}


def _from_saved(record: dict) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in record.items()}


# ---------------------------------------------------------------- single run


class DGAdaptResult(NamedTuple):
    times: np.ndarray  # partition at this iteration
    u: np.ndarray  # (K, Np) coarse primal
    v: np.ndarray  # (K, Np+1) adjoint
    err: np.ndarray  # (K,) element contributions
    j_coarse: float
    j_fine: float
    effectivity_gap: float  # JuH − Juh (MAIN.m:55-64)
    est_total: float  # Σ err (MAIN.m:75-76)


def _make_dg_iteration(f, f_u, g, g_u, ops_p, ops_a, ops_f, adjoint_mode="solve"):
    """The per-iteration pipeline ``iteration(times, y0) -> (u, v, err,
    j_coarse, j_fine, times_new)`` on a (possibly padded) partition.

    ``adjoint_mode``: 'solve' marches the adjoint directly at order n+1
    (adj_march.m); 'reconstruct' solves it at the primal's order and lifts
    it to n+1 through Radau collocation (adj_rec.m) before weighting the
    residual."""
    if adjoint_mode not in ("solve", "reconstruct"):
        raise ValueError(f"adjoint_mode={adjoint_mode!r}: 'solve' or 'reconstruct'")

    def iteration(times, y0):
        res_p = dg_march(ops_p, f, times, y0, f_u=f_u)
        res_f = dg_march(ops_f, f, times, y0, f_u=f_u)
        if adjoint_mode == "reconstruct":
            adj_low = dg_adjoint_march(ops_p, f, res_p.u, times, y0, f_u=f_u, g_u=g_u)
            v = dg_adjoint_reconstruct(ops_p, adj_low.v, times)
            err = dg_awr_from_adjoint(ops_a, f, res_p.u, times, y0, v)
        else:
            adj = dg_adjoint_march(ops_a, f, res_p.u, times, y0, f_u=f_u, g_u=g_u)
            v, err = adj.v, adj.err
        j_coarse = dg_element_functional(ops_p, res_p.u, times, g)
        j_fine = dg_element_functional(ops_f, res_f.u, times, g)
        return res_p.u, v, err, j_coarse, j_fine, _bisect(times, torch.abs(err))

    return iteration


def run_adaptive_dg(
    f: Callable,
    y0: float,
    t_span: tuple[float, float],
    *,
    f_u: Callable | None = None,
    n_order: int = 1,
    k0: int = 2,
    g: Callable | None = None,
    g_u: Callable | None = None,
    tol: float = 1e-5,
    maxit: int = 30,
    fine_offset: int = 2,
    n_gq: int | None = None,
    callback: Callable | None = None,
    padded: bool = False,
    adjoint_mode: str = "solve",
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    dtype=None,
    device="cuda",
) -> list[DGAdaptResult]:
    """Adaptive h-refinement of the DG-in-time partition driven by the
    adjoint-weighted residual, with MAIN.m's effectivity telemetry.

    ``f_u`` is ∂f/∂u (derived from an elementwise ``f`` when ``None``);
    ``g``/``g_u`` the functional integrand and its derivative (default
    J = ∫u); ``dtype`` defaults to torch's default float type. The history
    lives on the host (NumPy arrays, Python floats); ``callback`` receives
    each result. ``checkpoint_dir`` saves partition + history after every
    iteration (once at the end with ``device_loop``) and resumes from it;
    the callback is not re-invoked for restored iterations.
    ``device_loop=True`` requires ``padded=True`` (module docstring)."""
    if device_loop and not padded:
        raise ValueError("device_loop=True requires padded=True (fixed shapes are what let "
                         "the trip run without host decisions)")
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    ops_p = dg_time_operators(n_order, n_gq)
    ops_a = dg_time_operators(n_order + 1, None if n_gq is None else n_gq + 2)
    ops_f = dg_time_operators(n_order + fine_offset)

    times = np.linspace(t_span[0], t_span[1], k0 + 1)
    max_k = k0 + maxit + 1
    if padded:
        times = np.concatenate([times, np.full(max_k - k0, times[-1])])
    n_active = k0
    iteration = _make_dg_iteration(f, f_u, g, g_u, ops_p, ops_a, ops_f, adjoint_mode)
    history: list[DGAdaptResult] = []
    it0 = 0
    raw = _load(checkpoint_dir, CHECKPOINT_FILE)
    if raw is not None:
        history = [DGAdaptResult(**_from_saved(h)) for h in raw["history"]]
        times = raw["times"].numpy()
        n_active = int(raw["n_active"])
        # a resumed run may ask for more iterations: re-pad (zero-width slabs)
        if padded and len(times) < max_k + 1:
            times = np.concatenate([times, np.full(max_k + 1 - len(times), times[-1])])
        it0 = len(history)
        if abs(history[-1].est_total) < tol:
            return history

    def save(times_h, n_act):
        if checkpoint_dir is not None:
            payload = {"times": torch.from_numpy(np.asarray(times_h)), "n_active": n_act,
                       "history": [_to_saved(r._asdict()) for r in history]}
            _atomic_save(payload, Path(checkpoint_dir) / CHECKPOINT_FILE)

    def result(times_h, u, v, err, j_c, j_f, est, na):
        return DGAdaptResult(
            times=times_h[: na + 1].copy(), u=u[:na], v=v[:na], err=err[:na],
            j_coarse=float(j_c), j_fine=float(j_f),
            effectivity_gap=float(j_c) - float(j_f), est_total=float(est))

    if device_loop:
        t = torch.as_tensor(times, dtype=dtype, device=device)
        active = torch.ones((), dtype=torch.bool, device=device)
        rows = []
        for _ in range(it0, maxit + 1):
            u, v, err, j_c, j_f, t_new = iteration(t, y0)
            est = torch.sum(err)
            rows.append((u, v, err, j_c, j_f, t, est, active))
            go = active & ~(torch.abs(est) < tol)
            t = torch.where(go, t_new, t)
            active = go
        if not rows:
            return history
        bufs = [torch.stack(col).cpu().numpy() for col in zip(*rows)]  # the one fetch
        n_new = int(bufs[7].sum())
        for i in range(n_new):
            r = result(bufs[5][i], bufs[0][i], bufs[1][i], bufs[2][i], bufs[3][i], bufs[4][i],
                       bufs[6][i], n_active + i)
            history.append(r)
            if callback is not None:
                callback(r)
        if n_new:
            done = abs(history[-1].est_total) < tol
            save(t.cpu().numpy(), n_active + n_new - 1 + (0 if done else 1))
        return history

    for _ in range(it0, maxit + 1):
        u, v, err, j_c, j_f, times_new = iteration(
            torch.as_tensor(times, dtype=dtype, device=device), y0)
        r = result(times, u.cpu().numpy(), v.cpu().numpy(), err.cpu().numpy(), j_c, j_f,
                   torch.sum(err), n_active)
        history.append(r)
        if callback is not None:
            callback(r)
        done = abs(r.est_total) < tol
        if not done:
            if padded:
                times = times_new.cpu().numpy()
            else:
                ref_i = int(np.argmax(np.abs(r.err)))
                times = np.insert(times, ref_i + 1, 0.5 * (times[ref_i] + times[ref_i + 1]))
            n_active += 1
        save(times, n_active)
        if done:
            break
    return history


# ------------------------------------------------------------ ensemble loops


def _estimator(engine, f, f_u, g_u, ode, dtype, newton, ops_p, ops_a, max_k, device):
    """The per-iteration estimate ``run(times, y0s) -> (u, err)`` of an
    ensemble loop: the batched torch pipeline (``newton`` = the keyword
    arguments of its Newton), or one launch of the DG slab kernel (its plain
    version on a CPU device)."""
    if engine not in ("torch", "cuda"):
        raise ValueError(f"engine={engine!r}: 'torch' or 'cuda'")
    if engine == "cuda":
        if dtype != torch.float32:
            raise ValueError(f"engine='cuda' runs float32, not {dtype}")
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_slab import (
            make_cuda_dg_estimate_ensemble,
        )

        # the registry entry (or ODEProblem) ode, else the loop's f and f_u traced
        kernel = make_cuda_dg_estimate_ensemble(
            ode, ops_p, ops_a, max_k, newton["newton_iters"] or 8,
            **({} if ode is not None else {"f": f, "f_u": f_u}), g_u=g_u, device=device)

        def run(times, y0s):
            u, _v, err = kernel(times, y0s)
            return u, err

        return run

    def run(times, y0s):
        u = dg_march_batched(ops_p, f, times, y0s, f_u=f_u, **newton).u
        return u, dg_adjoint_march_batched(ops_a, f, u, times, y0s, f_u=f_u, g_u=g_u).err

    return run


class DGEnsembleAdaptResult(NamedTuple):
    times: np.ndarray  # shared partition at this iteration
    err_mean: np.ndarray  # (K,) ensemble-mean |contribution| per element
    j_mean: float  # ensemble-mean functional
    est_total_mean: float  # mean over members of Σ_k err_k


def run_adaptive_dg_ensemble(
    f: Callable,
    y0s,  # (B,) initial-condition ensemble
    t_span: tuple[float, float],
    *,
    f_u: Callable | None = None,
    n_order: int = 1,
    k0: int = 4,
    g: Callable | None = None,
    g_u: Callable | None = None,
    tol: float = 0.0,
    maxit: int = 10,
    n_gq: int | None = None,
    newton_iters: int | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    engine: str = "torch",
    ode=None,
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    mesh: RankGrid | None = None,
    mesh_axis: str = "data",
    dtype=None,
    device="cuda",
) -> list[DGEnsembleAdaptResult]:
    """Ensemble-signal adaptive DG-in-time loop: all B members share one
    partition, padded with zero-width slabs to ``k0 + maxit + 1`` elements;
    each iteration runs the batched fwd(n) + adjoint(n+1) + AWR pipeline and
    bisects the element with the largest ensemble-mean |contribution|,
    until |mean Σerr| < tol or maxit. ``newton_iters`` fixes the forward
    Newton count (the cuda engine's default is 8). ``engine``, ``ode``,
    ``device_loop``, ``checkpoint_dir``, ``mesh`` and ``mesh_axis`` as in
    the module docstring; ``dtype`` defaults to torch's default float
    type."""
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    ops_p = dg_time_operators(n_order, n_gq)
    ops_a = dg_time_operators(n_order + 1, None if n_gq is None else n_gq + 2)
    y0s = torch.as_tensor(np.asarray(y0s), dtype=dtype, device=device)
    b = y0s.shape[0]
    grid = _member_grid(mesh, mesh_axis, b)

    # restore before sizing the padding: a resumed run may ask for fewer or
    # more iterations than the one it resumes
    history: list[DGEnsembleAdaptResult] = []
    it0 = 0
    raw = _load(checkpoint_dir, ENSEMBLE_CHECKPOINT_FILE)
    if raw is not None:
        history = [DGEnsembleAdaptResult(**_from_saved(h)) for h in raw["history"]]
        it0 = len(history)
        if abs(history[-1].est_total_mean) < tol:
            return history
    max_k = k0 + maxit + 1
    if raw is not None:
        max_k = max(max_k, raw["times"].shape[0] - 1)
    n_pad = max_k + 1  # node slots
    estimate = _estimator(engine, f, f_u, g_u, ode, dtype,
                          dict(newton_tol=newton_tol, newton_maxit=newton_maxit,
                               newton_iters=newton_iters), ops_p, ops_a, max_k, device)
    # this rank's members through the estimate; the partition is replicated
    estimate_shard = ensemble_batched(lambda y, t: estimate(t, y), grid, mesh_axis)

    def iteration(times):
        u, err = estimate_shard(y0s, times)
        # the means over all members: this rank's sums, summed over the ranks
        sums = torch.cat([torch.sum(torch.abs(err), dim=0),  # (K,)
                          torch.sum(dg_element_functional_batched(ops_p, u, times, g))[None],
                          torch.sum(torch.sum(err, dim=1))[None]])
        means = all_reduce_sum(sums, grid, mesh_axis) / b
        err_mean = means[:max_k]
        diag = torch.cat([times, means.to(times.dtype)])
        return _bisect(times, err_mean), diag

    if raw is not None:
        t_res = raw["times"].numpy()
        times_h = np.concatenate([t_res, np.full(n_pad - len(t_res), t_res[-1])])
        n_active = int(raw["n_active"])
    else:
        row = np.linspace(t_span[0], t_span[1], k0 + 1)
        times_h = np.concatenate([row, np.full(max_k - k0, row[-1])])
        n_active = k0
    times = torch.as_tensor(times_h, dtype=dtype, device=device)

    def append(d: np.ndarray, na: int) -> None:
        history.append(DGEnsembleAdaptResult(
            times=d[: na + 1].copy(), err_mean=d[n_pad: n_pad + na].copy(),
            j_mean=float(d[n_pad + max_k]), est_total_mean=float(d[n_pad + max_k + 1])))

    def save(times_f, n_act):
        if checkpoint_dir is not None:
            _save_rank0(grid, lambda: {
                "times": times_f.cpu(), "n_active": n_act,
                "history": [_to_saved(r._asdict()) for r in history]},
                Path(checkpoint_dir) / ENSEMBLE_CHECKPOINT_FILE)

    if device_loop:
        rows, active = [], torch.ones((), dtype=torch.bool, device=device)
        for _ in range(it0, maxit + 1):
            t_new, diag = iteration(times)
            rows.append(torch.cat([diag, active.to(diag.dtype)[None]]))
            go = active & ~(torch.abs(diag[n_pad + max_k + 1]) < tol)
            times = torch.where(go, t_new, times)
            active = go
        buf = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 0))  # the one fetch
        n_new = 0
        for d in buf:
            if d[-1] == 0:
                break
            append(d[:-1], n_active + n_new)
            n_new += 1
        if n_new:
            done = abs(history[-1].est_total_mean) < tol
            save(times, n_active + n_new - 1 + (0 if done else 1))
        return history

    for _ in range(it0, maxit + 1):
        times_new, diag = iteration(times)
        append(diag.cpu().numpy(), n_active)
        done = abs(history[-1].est_total_mean) < tol
        if not done:
            times = times_new
            n_active += 1
        save(times, n_active)
        if done:
            break
    return history


class DGPerMemberAdaptResult(NamedTuple):
    times: np.ndarray  # (B, n_pad+1) padded partitions (zero-width tail)
    n_active: np.ndarray  # (B,) live slab count per member
    err: np.ndarray  # (B, n_pad) contributions (exactly 0 on padding)
    j: np.ndarray  # (B,) functional per member
    est_total: np.ndarray  # (B,) Σ_k err_k per member
    n_refining: int  # members still above tol AFTER this iteration


def run_adaptive_dg_per_member(
    f: Callable,
    y0s,  # (B,) initial-condition ensemble
    t_span: tuple[float, float],
    *,
    f_u: Callable | None = None,
    n_order: int = 1,
    k0: int = 4,
    g: Callable | None = None,
    g_u: Callable | None = None,
    tol: float = 0.0,
    maxit: int = 10,
    n_gq: int | None = None,
    newton_iters: int | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    engine: str = "torch",
    ode=None,
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    mesh: RankGrid | None = None,
    mesh_axis: str = "data",
    dtype=None,
    device="cuda",
) -> list[DGPerMemberAdaptResult]:
    """Per-member adaptive DG-in-time: every member owns a (B, k0+maxit+2)
    padded partition, bisects its own largest-|AWR| element, and freezes
    independently once |Σerr| < tol (frozen members are masked on the
    member axis, so shapes never change). Arguments as for
    :func:`run_adaptive_dg_ensemble`; the cuda engine reads per-member
    partitions, which shard with the members under ``mesh``."""
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    ops_p = dg_time_operators(n_order, n_gq)
    ops_a = dg_time_operators(n_order + 1, None if n_gq is None else n_gq + 2)
    y0s = torch.as_tensor(np.asarray(y0s), dtype=dtype, device=device)
    b = y0s.shape[0]
    grid = _member_grid(mesh, mesh_axis, b)

    def gather(x, dim=0):  # the ranks' blocks in member order
        return all_gather(x, grid, mesh_axis, dim)

    def shard(x):
        return shard_along(x, grid, mesh_axis)

    history: list[DGPerMemberAdaptResult] = []
    it0 = 0
    raw = _load(checkpoint_dir, PER_MEMBER_CHECKPOINT_FILE)
    if raw is not None:
        history = [DGPerMemberAdaptResult(**_from_saved(h)) for h in raw["history"]]
        it0 = len(history)
        if history[-1].n_refining == 0:
            return history
    max_k = k0 + maxit + 1
    if raw is not None:
        max_k = max(max_k, raw["times"].shape[1] - 1)
    n_pad = max_k + 1  # node slots per member
    if raw is not None:
        # re-pad restored rows to this run's width (zero-width slabs at
        # t_end; padding err is exactly 0)
        history = [
            r._replace(
                times=np.concatenate([r.times, np.repeat(r.times[:, -1:], n_pad - r.times.shape[1],
                                                         axis=1)], axis=1),
                err=np.concatenate([r.err, np.zeros((b, max_k - r.err.shape[1]))], axis=1))
            for r in history
        ]
    estimate = _estimator(engine, f, f_u, g_u, ode, dtype,
                          dict(newton_tol=newton_tol, newton_maxit=newton_maxit,
                               newton_iters=newton_iters), ops_p, ops_a, max_k, device)

    y_local = shard(y0s)  # this rank's members

    def iteration(times, refining):
        # ``times`` and ``refining`` are this rank's block of members: the
        # partitions shard with them, as ensemble_batched's shard_extras
        u, err = estimate(times, y_local)
        j = dg_element_functional_batched(ops_p, u, times, g)  # (B,)
        est_total = torch.sum(err, dim=1)  # (B,)
        # members at tolerance freeze: their partition stops changing
        refine_now = refining & (torch.abs(est_total) >= tol)
        times_new = torch.where(refine_now[:, None], _bisect(times, torch.abs(err)), times)
        diag = torch.cat([times, err.to(times.dtype), j[:, None].to(times.dtype),
                          est_total[:, None].to(times.dtype), refine_now[:, None].to(times.dtype)],
                         dim=1)  # (B, n_pad + max_k + 3)
        return times_new, refine_now, diag

    if raw is not None:
        t_res = raw["times"].numpy()
        t_res = np.concatenate([t_res, np.repeat(t_res[:, -1:], n_pad - t_res.shape[1], axis=1)],
                               axis=1)
        times = shard(torch.as_tensor(t_res, dtype=dtype, device=device))
        refining = shard(raw["refining"].to(device)) != 0
        n_active = raw["n_active"].numpy().copy()  # (B,) on the host: every member
    else:
        row = np.linspace(t_span[0], t_span[1], k0 + 1)
        row = np.concatenate([row, np.full(max_k - k0, row[-1])])
        b_loc = b // grid.axis_size(mesh_axis)
        times = torch.as_tensor(np.broadcast_to(row, (b_loc, n_pad)).copy(), dtype=dtype,
                                device=device)
        refining = torch.ones((b_loc,), dtype=torch.bool, device=device)
        n_active = np.full((b,), k0, np.int64)

    def append(d: np.ndarray) -> np.ndarray:
        """Append one diagnostics row; returns the members it refined."""
        refine_h = d[:, n_pad + max_k + 2] != 0
        history.append(DGPerMemberAdaptResult(
            times=d[:, :n_pad].copy(), n_active=n_active.copy(),
            err=d[:, n_pad: n_pad + max_k].copy(), j=d[:, n_pad + max_k].copy(),
            est_total=d[:, n_pad + max_k + 1].copy(), n_refining=int(refine_h.sum())))
        return refine_h

    def save(times_f, refining_f):
        if checkpoint_dir is None:
            return
        times_f, refining_f = gather(times_f), gather(refining_f.to(torch.int32))
        _save_rank0(grid, lambda: {
            "times": times_f.cpu(), "refining": refining_f.cpu(),
            "n_active": torch.from_numpy(n_active),
            "history": [_to_saved(r._asdict()) for r in history]},
            Path(checkpoint_dir) / PER_MEMBER_CHECKPOINT_FILE)

    if device_loop:
        rows = []
        for _ in range(it0, maxit + 1):
            t_new, r_new, diag = iteration(times, refining)
            rows.append(diag)
            times, refining = t_new, r_new
        # the one fetch; the history ends at the first iteration that left no
        # member refining (the rest ran on frozen partitions)
        buf = gather(torch.stack(rows), dim=1).cpu().numpy() if rows else np.zeros((0, b, 0))
        for d in buf:
            # a row that refines no member adds zeros: the host loop's update
            n_active = n_active + append(d).astype(np.int64)
            if history[-1].n_refining == 0:
                break
        if len(history) > it0:
            save(times, refining)
        return history

    for _ in range(it0, maxit + 1):
        times_new, refine_new, diag = iteration(times, refining)
        refine_h = append(gather(diag).cpu().numpy())
        if history[-1].n_refining > 0:
            times, refining = times_new, refine_new
            n_active = n_active + refine_h.astype(np.int64)
        save(times, refining)
        if history[-1].n_refining == 0:
            break
    return history
