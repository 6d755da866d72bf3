"""The adaptive forward/adjoint/estimate/refine loop for one-step marches.

Counterpart of the JAX package's ``adapt/fd_loop.py`` (the end-to-end
algorithm of ``python/Main_finite_difference.py``): march the primal on the
coarse grid, solve the discrete adjoint on the uniformly refined grid,
localise the adjoint-weighted residual per coarse step, bisect the worst
step, repeat until the total estimate drops below ``tol``.

Grids are padded to a fixed length (the final time repeated: zero-width
steps, exact identities downstream), so every iteration runs at the same
shapes. Time is axis 0 of the solve; a per-member study solves all members
at once on (max_nodes, B) grids, one grid per member.

``device_loop=True`` runs a fixed trip of ``maxit + 1`` iterations (fewer
when resumed) with the stopping tests as masks on the device: nothing is
read back between iterations, one fetch at the end says which iterations
belong to the history, and the rest are dropped. The history is
bit-identical to the host loop's (the iterations that count run the same
operations on the same inputs). It replaces the JAX package's
``lax.while_loop``; the cost is the iterations after the stop, which still
run.

Entry points run on the card unless the caller passes ``device="cpu"``;
a CUDA device that is not there raises. Checkpoints are ``torch.save``
files; a resumed run continues bit-identically.

``mesh=`` (the per-member study): a :class:`~..parallel.mesh.RankGrid`
whose ``mesh_axis`` (default ``"data"``) shards the members over ranks, as
the JAX package's ``mesh=`` shards them over devices. Each rank runs its
block of members, their grids and widths with them, through the same
estimate; the diagnostics are gathered in member order, so every rank
returns the global history, and the stop (no member refining) is global.
With ``checkpoint_dir`` rank 0 writes the gathered state and every rank
resumes from it (a directory every rank reads).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import functionals as fnl
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt.policy import (
    bisect_refine_masked,
    bisect_refine_padded,
    bisect_refine_padded_masked,
    coarsen_merge,
    coarsen_merge_padded,
    pad_times,
)
from adjoint_ode_adaptivity_tpu_torch.adjoint.discrete import adjoint_march
from adjoint_ode_adaptivity_tpu_torch.adjoint.estimate import (
    coarse_indicator,
    interp_to_fine,
    refine_all,
    residual,
)
from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import (
    RankGrid,
    all_gather,
    barrier,
    shard_along,
)

__all__ = [
    "AdaptState",
    "AdaptResult",
    "adapt_iteration",
    "backtrack_iteration",
    "run_adaptive_fd",
    "run_adaptive_fd_backtrack",
    "run_adaptive_fd_backtrack_padded",
    "FDPerMemberAdaptResult",
    "run_adaptive_fd_per_member",
    "estimate_per_member",
]

CHECKPOINT_FILE = "fd_adapt.pt"
PER_MEMBER_CHECKPOINT_FILE = "fd_adapt_per_member.pt"


class AdaptState(NamedTuple):
    """Per-iteration adaptivity state (padded, fixed shapes)."""

    times: torch.Tensor  # (max_nodes,) padded node times
    n_active: torch.Tensor  # 0-dim int32: number of real steps
    it: torch.Tensor  # 0-dim int32 iteration counter


class AdaptResult(NamedTuple):
    state: AdaptState  # post-refinement state (next iteration's grid)
    times_used: torch.Tensor  # (max_nodes,) the grid this iteration solved on
    n_steps_used: torch.Tensor  # 0-dim int32: active steps this iteration
    u: torch.Tensor  # (max_nodes,) coarse primal
    v: torch.Tensor  # (max_fine+1,) fine-grid adjoint
    err_steps: torch.Tensor  # (max_nodes-1,) per-coarse-step indicator
    err_total: torch.Tensor  # 0-dim Σ err_steps
    j_coarse: torch.Tensor  # J evaluated on the coarse march


def _k_vector(functional: fnl.Functional, u_fine, dt_fine, n_active, ref_factor):
    """∂J/∂U on the padded fine grid. ``J=u_N`` places its unit at fine node
    ``n_active·rf − 1`` (the second-to-last active node, the reference
    convention); the integral functionals are padding-safe because padded
    widths are zero."""
    if functional.name == "J=u_N":
        idx = torch.arange(u_fine.shape[0], device=u_fine.device)
        idx = idx.reshape((-1,) + (1,) * n_active.dim())
        return (idx == n_active * ref_factor - 1).to(u_fine.dtype)
    return fnl.get_k(functional, u_fine, dt_fine)


def _solve(step_fn, times, n_active, u0, functional, ref_factor, convention):
    """One fwd + adjoint + indicator solve on padded grids ``times``
    (max_nodes, ...) — trailing axes are members, each on its own grid.
    Returns (u, v, err_steps (max_nodes−1, ...), j_coarse)."""
    t0 = times[0]
    dt = torch.diff(times, dim=0)
    u = forward_march(step_fn, u0, dt, t0)
    dt_fine = refine_all(dt, ref_factor)
    u_fine = interp_to_fine(u, dt, dt_fine, t0)
    k_vec = _k_vector(functional, u_fine, dt_fine, n_active, ref_factor)
    v = adjoint_march(step_fn, u_fine, dt_fine, k_vec, t0)
    res = residual(step_fn, u_fine, dt_fine, t0)
    err_steps = coarse_indicator(res * v, ref_factor, convention)
    if functional.name == "J=u_N":
        # J ≡ u_{N−1}: the second-to-last active node, as _k_vector
        j_coarse = u.gather(0, (n_active.long() - 1).reshape((1,) + n_active.shape))[0]
    else:
        j_coarse = functional.value(u, dt)
    return u, v, err_steps, j_coarse


def adapt_iteration(
    state: AdaptState,
    u0,
    step_fn: Callable,
    functional_name: str,
    ref_factor: int,
    convention: str = "strided",
) -> AdaptResult:
    """One adaptive iteration at fixed padded shapes."""
    functional = fnl.get_functional(functional_name)
    u, v, err_steps, j_coarse = _solve(
        step_fn, state.times, state.n_active, u0, functional, ref_factor, convention
    )
    err_total = torch.sum(err_steps)
    times_new, n_active_new = bisect_refine_padded(state.times, state.n_active, err_steps)
    new_state = AdaptState(times=times_new, n_active=n_active_new, it=state.it + 1)
    return AdaptResult(
        new_state, state.times, state.n_active, u, v, err_steps, err_total, j_coarse
    )


# ---------------------------------------------------------------- checkpoints


def _atomic_save(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(checkpoint_dir: str | None, name: str):
    if checkpoint_dir is None:
        return None
    path = Path(checkpoint_dir) / name
    return torch.load(path, weights_only=True) if path.exists() else None


def _save_rank0(grid: RankGrid, payload, path: Path) -> None:
    """Rank 0 writes ``payload()``; no rank returns before the file is
    there (a rank that resumes next reads it)."""
    if grid.rank == 0:
        _atomic_save(payload(), path)
    barrier(grid)


def _member_grid(mesh, axis: str, b: int) -> RankGrid:
    """The rank grid that shards B members along ``axis``: ``mesh``, or one
    rank (no process group) when it is None. B must divide over the axis."""
    if mesh is None:
        return RankGrid((axis,), (1,), 0, None, None)
    if not isinstance(mesh, RankGrid):
        raise TypeError(f"mesh= takes a RankGrid (parallel.make_rank_grid), not {type(mesh)}")
    n = mesh.axis_size(axis)
    if b % n:
        raise ValueError(f"B={b} must divide over {n} ranks of mesh axis {axis!r}")
    return mesh


def _state_dict(s: AdaptState) -> dict:
    return {k: v.detach().cpu() for k, v in s._asdict().items()}


def _result_dict(r: AdaptResult) -> dict:
    d = {k: v.detach().cpu() for k, v in r._asdict().items() if k != "state"}
    return {**d, "state": _state_dict(r.state)}


def _to(d: dict, device) -> dict:
    return {k: v.to(device) for k, v in d.items() if k != "state"}


def _pad_to(times: torch.Tensor, max_nodes: int) -> torch.Tensor:
    """Re-pad a restored grid (last axis) to ``max_nodes`` by repeating its
    final time: zero-width steps, exact identities."""
    extra = max_nodes - times.shape[-1]
    if extra <= 0:
        return times
    return torch.cat([times, times[..., -1:].expand(*times.shape[:-1], extra)], dim=-1)


# ---------------------------------------------------------------- the loops


def run_adaptive_fd(
    step_fn: Callable,
    u0: float,
    t_span: tuple[float, float],
    n_steps0: int = 2,
    *,
    functional_name: str = "J=int(u^2)",
    ref_factor: int = 4,
    tol: float = 1e-5,
    maxit: int = 100,
    convention: str = "strided",
    max_nodes: int | None = None,
    callback: Callable | None = None,
    dtype=None,
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    device="cuda",
) -> list[AdaptResult]:
    """Run the adaptive loop until Σerr ≤ tol or maxit — the complete
    Main_finite_difference.py driver, minus plotting.

    Returns the per-iteration :class:`AdaptResult` history (tensors on
    ``device``); ``callback`` is invoked with each result. ``dtype``
    defaults to torch's default float type. ``checkpoint_dir`` saves the
    loop after every iteration (once at the end with ``device_loop``) and
    resumes from it; the callback is not re-invoked for restored
    iterations. ``device_loop`` is described in the module docstring."""
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    if max_nodes is None:
        max_nodes = n_steps0 + maxit + 2
    times0 = torch.linspace(t_span[0], t_span[1], n_steps0 + 1, dtype=dtype, device=device)
    times, n_active = pad_times(times0, max_nodes)
    state = AdaptState(times, n_active, torch.zeros((), dtype=torch.int32, device=device))

    history: list[AdaptResult] = []
    err, it = float("inf"), 0
    raw = _load(checkpoint_dir, CHECKPOINT_FILE)
    if raw is not None:
        history = [
            AdaptResult(**{**_to(h, device), "state": AdaptState(**_to(h["state"], device))})
            for h in raw["history"]
        ]
        state = AdaptState(**_to(raw["state"], device))
        # a resumed run may ask for more (re-pad) or fewer (keep) nodes
        max_nodes = max(max_nodes, state.times.shape[0])
        state = state._replace(times=_pad_to(state.times, max_nodes))
        err, it = float(history[-1].err_total), len(history)

    def save():
        if checkpoint_dir is not None:
            payload = {"state": _state_dict(state), "history": [_result_dict(r) for r in history]}
            _atomic_save(payload, Path(checkpoint_dir) / CHECKPOINT_FILE)

    if device_loop:
        err_t = torch.tensor(err, dtype=torch.float64, device=device)
        active = torch.ones((), dtype=torch.bool, device=device)
        results, flags = [], []
        for _ in range(it, maxit + 1):
            active = active & (err_t > tol)
            r = adapt_iteration(state, u0, step_fn, functional_name, ref_factor, convention)
            results.append(r)
            flags.append(active)
            state = AdaptState(
                times=torch.where(active, r.state.times, state.times),
                n_active=torch.where(active, r.state.n_active, state.n_active),
                it=torch.where(active, r.state.it, state.it),
            )
            err_t = torch.where(active, r.err_total.to(torch.float64), err_t)
        n_new = int(torch.stack(flags).sum()) if flags else 0  # the one fetch
        for r in results[:n_new]:
            history.append(r)
            if callback is not None:
                callback(r)
        if n_new:
            save()
        return history

    while it <= maxit and err > tol:
        result = adapt_iteration(state, u0, step_fn, functional_name, ref_factor, convention)
        history.append(result)
        if callback is not None:
            callback(result)
        state = result.state
        err = float(result.err_total)
        it += 1
        save()
    return history


def backtrack_iteration(
    state: AdaptState,
    blocked: torch.Tensor,
    u0,
    step_fn: Callable,
    functional_name: str,
    ref_factor: int,
    convention: str = "strided",
):
    """One backtrack-schedule iteration at fixed padded shapes: the full
    solve and indicator, then a masked bisection (blocked intervals excluded
    from the argmax). Returns (err_steps, err_total, times_new,
    n_active_new, blocked_new, interval)."""
    functional = fnl.get_functional(functional_name)
    _, _, err_steps, _ = _solve(
        step_fn, state.times, state.n_active, u0, functional, ref_factor, convention
    )
    err_total = torch.sum(err_steps)
    times_new, n_active_new, blocked_new, interval = bisect_refine_padded_masked(
        state.times, state.n_active, err_steps, blocked
    )
    return err_steps, err_total, times_new, n_active_new, blocked_new, interval


def _interval_key(tl, tr):
    return (round(float(tl), 12), round(float(tr), 12))


def run_adaptive_fd_backtrack_padded(
    step_fn: Callable,
    u0: float,
    t_span: tuple[float, float],
    n_steps0: int = 2,
    *,
    functional_name: str = "J=int(u^2)",
    ref_factor: int = 4,
    tol: float = 1e-5,
    maxit: int = 100,
    convention: str = "strided",
    coarsen_tol: float | None = None,
    max_nodes: int | None = None,
    dtype=None,
    device="cuda",
) -> list[dict]:
    """The backtrack schedule (insert / undo / block, optional coarsening)
    on padded fixed-shape grids; the host runs the accept/backtrack control
    flow. Semantics equal :func:`run_adaptive_fd_backtrack`: refine at the
    masked argmax; when the total estimate increased, undo the insert and
    block that interval for good; a coarsen merge re-solves on the merged
    grid within the same iteration before refining. Blocked intervals are
    keyed by their (t_l, t_r) endpoints rounded to 1e-12, and the
    positional mask is rebuilt from the keys before each iteration."""
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    if max_nodes is None:
        max_nodes = n_steps0 + maxit + 2
    times0 = torch.linspace(t_span[0], t_span[1], n_steps0 + 1, dtype=dtype, device=device)
    times, n_active = pad_times(times0, max_nodes)
    state = AdaptState(times, n_active, torch.zeros((), dtype=torch.int32, device=device))
    blocked_keys: set = set()

    def build_mask(st: AdaptState) -> torch.Tensor:
        t_host = st.times.cpu().numpy()
        m = np.zeros((max_nodes - 1,), bool)
        for i in range(int(st.n_active)):
            m[i] = _interval_key(t_host[i], t_host[i + 1]) in blocked_keys
        return torch.as_tensor(m, device=device)

    def solve(st, blocked):
        return backtrack_iteration(st, blocked, u0, step_fn, functional_name, ref_factor,
                                   convention)

    history: list[dict] = []
    prev_total = None
    last_insert = None  # (pre-insert state, key of the inserted interval)
    it = 0
    while it <= maxit:
        blocked = build_mask(state)
        err_steps, err_total, t_new, n_new, _b, interval = solve(state, blocked)
        total = float(err_total)
        if prev_total is not None and last_insert is not None and total > prev_total:
            state, key = last_insert  # backtrack: revert, block the interval
            blocked_keys.add(key)
            last_insert = None
            history.append({"it": it, "n_steps": int(state.n_active), "total": total,
                            "action": "backtrack"})
            it += 1
            continue
        prev_total = total
        n_act = int(state.n_active)
        history.append({
            "it": it,
            "n_steps": n_act,
            "times": state.times[: n_act + 1].cpu().numpy(),
            "err_steps": err_steps.cpu().numpy(),
            "total": total,
            "action": "accept",
        })
        if total < tol:
            break
        if coarsen_tol is not None:
            t_c, n_c, _bc, merged = coarsen_merge_padded(
                state.times, state.n_active, err_steps, blocked, coarsen_tol
            )
            if bool(merged):  # re-solve on the merged grid, same iteration
                state = AdaptState(times=t_c, n_active=n_c, it=state.it)
                blocked = build_mask(state)
                err_steps, _, t_new, n_new, _b, interval = solve(state, blocked)
        n_act = int(state.n_active)
        if bool(torch.all(blocked[:n_act])):
            break  # every active interval blocked: no legal refinement left
        if int(n_new) == n_act:  # guarded no-op insert: the padded grid is full
            history.append({"it": it, "n_steps": n_act, "total": total, "action": "capacity"})
            break
        t_host = state.times.cpu().numpy()
        iv = int(interval)
        last_insert = (state, _interval_key(t_host[iv], t_host[iv + 1]))
        state = AdaptState(times=t_new, n_active=n_new, it=state.it + 1)
        it += 1
    return history


def run_adaptive_fd_backtrack(
    step_fn: Callable,
    u0: float,
    t_span: tuple[float, float],
    n_steps0: int = 2,
    *,
    functional_name: str = "J=int(u^2)",
    ref_factor: int = 4,
    tol: float = 1e-5,
    maxit: int = 100,
    convention: str = "strided",
    coarsen_tol: float | None = None,
    dtype=None,
    device="cuda",
) -> list[dict]:
    """Adaptive loop with a backtrack schedule (and optional coarsening), on
    grids that grow by one node per insert: refine at the masked argmax; if
    the total estimate increased after a refinement, undo that insert,
    block the interval for good, and pick the next candidate. With
    ``coarsen_tol`` the cheapest adjacent step pair is merged whenever its
    combined contribution is below the tolerance. Returns per-iteration
    dicts with times / err / action records."""
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    functional = fnl.get_functional(functional_name)
    times = torch.linspace(t_span[0], t_span[1], n_steps0 + 1, dtype=dtype, device=device)

    def solve(times):
        dt = torch.diff(times)
        u = forward_march(step_fn, u0, dt, times[0])
        dt_fine = refine_all(dt, ref_factor)
        u_fine = interp_to_fine(u, dt, dt_fine, times[0])
        k_vec = fnl.get_k(functional, u_fine, dt_fine)
        v = adjoint_march(step_fn, u_fine, dt_fine, k_vec, times[0])
        res = residual(step_fn, u_fine, dt_fine, times[0])
        err_steps = coarse_indicator(res * v, ref_factor, convention)
        return err_steps, float(torch.sum(err_steps))

    blocked: set = set()
    history: list[dict] = []
    prev_total = None
    last_insert = None  # (times before, interval key)
    it = 0
    while it <= maxit:
        err_steps, total = solve(times)
        if prev_total is not None and last_insert is not None and total > prev_total:
            times, key = last_insert
            blocked.add(key)
            last_insert = None
            history.append({"it": it, "times": times.cpu().numpy(), "total": total,
                            "action": f"backtrack {key}"})
            it += 1
            continue
        prev_total = total
        history.append({"it": it, "times": times.cpu().numpy(),
                        "err_steps": err_steps.cpu().numpy(), "total": total,
                        "action": "accept"})
        if total < tol:
            break
        if coarsen_tol is not None:
            times = coarsen_merge(times, err_steps, coarsen_tol)
            if times.shape[0] - 1 != err_steps.shape[0]:
                err_steps, total = solve(times)  # grid changed: re-solve first
        t_host = times.cpu().numpy()
        mask = torch.as_tensor(
            [_interval_key(t_host[i], t_host[i + 1]) in blocked for i in range(len(t_host) - 1)],
            device=device,
        )
        if bool(torch.all(mask)):
            break  # every interval blocked: no legal refinement left
        times_before = times
        times, interval = bisect_refine_masked(times, err_steps, mask)
        last_insert = (times_before, _interval_key(t_host[interval], t_host[interval + 1]))
        it += 1
    return history


class FDPerMemberAdaptResult(NamedTuple):
    """Per-iteration snapshot of a B-member per-member FD adaptive study."""

    times: np.ndarray  # (B, max_nodes) padded per-member grids
    n_active: np.ndarray  # (B,) live step count per member
    err_steps: np.ndarray  # (B, max_nodes-1) per-coarse-step indicators
    err_total: np.ndarray  # (B,) signed Σ err_steps per member
    j_coarse: np.ndarray  # (B,) functional per member
    n_refining: int  # members still above tol AFTER this iteration


def _resumed_history(history) -> list:
    """The history of a resumed, already complete study."""
    return list(history)


def estimate_per_member(step_fn: Callable, times, n_active, u0s, functional_name="J=int(u^2)",
                        ref_factor: int = 4, convention: str = "strided"):
    """The torch engine's per-member estimate on padded grids ``times``
    (B, max_nodes): ``(err_steps (B, max_nodes−1), j_coarse (B,))``."""
    _, _, err_t, j_coarse = _solve(step_fn, times.T, n_active, u0s,
                                   fnl.get_functional(functional_name), ref_factor, convention)
    return err_t.T, j_coarse


def run_adaptive_fd_per_member(
    step_fn: Callable,
    u0s,
    t_span: tuple[float, float],
    n_steps0: int = 2,
    *,
    functional_name: str = "J=int(u^2)",
    ref_factor: int = 4,
    tol: float = 1e-5,
    maxit: int = 100,
    convention: str = "strided",
    max_nodes: int | None = None,
    dtype=None,
    engine: str = "torch",
    ode=None,
    ode_f: Callable | None = None,
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    mesh: RankGrid | None = None,
    mesh_axis: str = "data",
    device="cuda",
) -> list[FDPerMemberAdaptResult]:
    """Per-member adaptive FD study: B independent Main_finite_difference.py
    loops, one per initial condition in ``u0s`` (B,). Each member owns its
    padded grid, bisects its own worst step and freezes once its signed
    Σerr drops to ``tol``; frozen members are masked on the member axis, so
    shapes never change.

    ``engine="torch"`` solves every member with the loop's own torch path
    (``step_fn``); ``engine="cuda"`` runs each iteration's whole estimate in
    one launch of the per-member kernel
    (:func:`~adjoint_ode_adaptivity_tpu_torch.ops.cuda.fd_estimate_per_member`)
    followed by the batched padded bisection on the device. It needs the
    forward-Euler ODE as ``ode`` (a registry entry's functor; an
    ``ODEProblem`` without a ``kernel_id`` is traced) or, as the JAX
    package's Pallas engine takes it, as ``ode_f(u, t)``, an elementwise
    callable traced into a device functor with its f_u derived by forward
    mode (JAX's ``jax.jvp``), once a study; ``functional_name="J=int(u^2)"``,
    and float32 on a CUDA device (a CPU device runs the kernel's plain
    version). ``device_loop`` and
    ``checkpoint_dir`` as for :func:`run_adaptive_fd`; ``mesh`` and
    ``mesh_axis`` shard the members over ranks (module docstring), the
    per-member widths with them."""
    device = require_device(device)
    if engine not in ("torch", "cuda"):
        raise ValueError(f"engine={engine!r}: 'torch' or 'cuda'")
    dtype = dtype or torch.get_default_dtype()
    u0s = torch.as_tensor(np.asarray(u0s), dtype=dtype, device=device)
    b = u0s.shape[0]
    grid = _member_grid(mesh, mesh_axis, b)
    u0s = shard_along(u0s, grid, mesh_axis)  # this rank's members

    def gather(x, dim=0):  # the ranks' blocks in member order
        return all_gather(x, grid, mesh_axis, dim)

    def shard(x):
        return shard_along(x, grid, mesh_axis)
    if max_nodes is None:
        max_nodes = n_steps0 + maxit + 2

    history: list[FDPerMemberAdaptResult] = []
    it0 = 0
    raw = _load(checkpoint_dir, PER_MEMBER_CHECKPOINT_FILE)
    if raw is not None:
        history = [
            FDPerMemberAdaptResult(**{k: (int(v) if k == "n_refining" else v.numpy())
                                      for k, v in h.items()})
            for h in raw["history"]
        ]
        it0 = len(history)
        if history[-1].n_refining == 0:
            return _resumed_history(history)
        max_nodes = max(max_nodes, raw["times"].shape[1])
        # re-pad restored rows to this run's width (zero-width steps at the
        # final time; indicator padding is exactly 0)
        history = [
            r._replace(
                times=_pad_to(torch.from_numpy(r.times), max_nodes).numpy(),
                err_steps=np.pad(r.err_steps, ((0, 0), (0, max_nodes - 1 - r.err_steps.shape[1]))),
            )
            for r in history
        ]

    fnl.get_functional(functional_name)  # an unknown name raises before any solve
    if engine == "cuda":
        if (ode is None) == (ode_f is None):
            raise ValueError("engine='cuda' needs the forward-Euler ODE as ode= (a registry "
                             "entry or an ODEProblem) or as ode_f= (a callable), one of them")
        if functional_name != "J=int(u^2)":
            raise ValueError(f"engine='cuda' supports functional_name='J=int(u^2)', "
                             f"not {functional_name!r}")
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda.fd_ensemble import (
            make_cuda_fd_estimate_per_member,
        )

        if ode is None:  # f_u derived by forward mode, as JAX's engine takes jax.jvp
            ode = odes.ODEProblem("ode_f", f=ode_f)
        cuda_run = make_cuda_fd_estimate_per_member(
            ode, max_nodes - 1, ref_factor, convention, t0=t_span[0], device=device
        )

    def _iteration(times, n_active, refining):
        if engine == "cuda":
            err_steps, j_coarse = cuda_run(torch.diff(times, dim=1), u0s)
        else:
            err_steps, j_coarse = estimate_per_member(step_fn, times, n_active, u0s,
                                                      functional_name, ref_factor, convention)
        err_total = torch.sum(err_steps, dim=1)
        t_new, na_new = bisect_refine_padded(times, n_active, err_steps)
        refine_now = refining & (err_total > tol)  # signed test, per member
        times_next = torch.where(refine_now[:, None], t_new, times)
        n_active_next = torch.where(refine_now, na_new, n_active)
        diag = torch.cat(
            [times, err_steps.to(times.dtype), err_total[:, None].to(times.dtype),
             j_coarse[:, None].to(times.dtype), refine_now[:, None].to(times.dtype)],
            dim=1,
        )  # (B, max_nodes + max_nodes−1 + 3)
        return times_next, n_active_next, refine_now, diag

    if raw is not None:
        times = shard(_pad_to(raw["times"], max_nodes)).to(device=device, dtype=dtype)
        n_active = shard(raw["n_active"]).to(device=device, dtype=torch.int32)
        refining = shard(raw["refining"]).to(device) != 0
    else:
        row = np.linspace(t_span[0], t_span[1], n_steps0 + 1)
        row = np.concatenate([row, np.full(max_nodes - n_steps0 - 1, row[-1])])
        b_loc = u0s.shape[0]
        times = torch.as_tensor(np.broadcast_to(row, (b_loc, max_nodes)).copy(), dtype=dtype,
                                device=device)
        n_active = torch.full((b_loc,), n_steps0, dtype=torch.int32, device=device)
        refining = torch.ones((b_loc,), dtype=torch.bool, device=device)

    def _append(d_row: np.ndarray, na_row: np.ndarray) -> None:
        history.append(FDPerMemberAdaptResult(
            times=d_row[:, :max_nodes].copy(),
            n_active=na_row.astype(np.int32),
            err_steps=d_row[:, max_nodes:2 * max_nodes - 1].copy(),
            err_total=d_row[:, 2 * max_nodes - 1].copy(),
            j_coarse=d_row[:, 2 * max_nodes].copy(),
            n_refining=int((d_row[:, -1] != 0).sum()),
        ))

    def _save(times_f, n_active_f, refining_f):
        if checkpoint_dir is None:
            return
        times_f, n_active_f = gather(times_f), gather(n_active_f)
        refining_f = gather(refining_f.to(torch.int32))
        _save_rank0(grid, lambda: {
            "times": times_f.cpu(),
            "n_active": n_active_f.cpu(),
            "refining": refining_f.cpu(),
            "history": [
                {k: (v if k == "n_refining" else torch.from_numpy(v))
                 for k, v in r._asdict().items()}
                for r in history
            ],
        }, Path(checkpoint_dir) / PER_MEMBER_CHECKPOINT_FILE)

    def _row(diag, n_act):  # per member: diag and the pre-iteration n_active
        return torch.cat([diag, n_act[:, None].to(diag.dtype)], dim=1)

    if device_loop:
        rows = []
        for _ in range(it0, maxit + 1):
            t_n, na_n, r_n, diag = _iteration(times, n_active, refining)
            rows.append(_row(diag, n_active))
            times, n_active, refining = t_n, na_n, r_n
        # the one fetch; the history ends at the first iteration that left no
        # member refining (the rest ran on frozen grids)
        buf = gather(torch.stack(rows), dim=1).cpu().numpy() if rows else np.zeros((0, b, 0))
        for row in buf:
            _append(row[:, :-1], row[:, -1])
            if history[-1].n_refining == 0:
                break
        if len(history) > it0:
            _save(times, n_active, refining)
        return history

    for _ in range(it0, maxit + 1):
        times_new, n_active_new, refine_new, diag = _iteration(times, n_active, refining)
        row = gather(_row(diag, n_active)).cpu().numpy()
        _append(row[:, :-1], row[:, -1])
        if history[-1].n_refining > 0:
            times, n_active, refining = times_new, n_active_new, refine_new
        _save(times, n_active, refining)
        if history[-1].n_refining == 0:
            break
    return history
