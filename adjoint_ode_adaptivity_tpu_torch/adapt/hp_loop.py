"""Goal-oriented hp-adaptive DG-in-time loops: raise the ORDER (p) or bisect
the slab (h) at the largest |adjoint-weighted residual|.

Counterpart of the JAX package's ``adapt/hp_loop.py``. The reference's
``MAIN.m:29-166`` loop only bisects at a uniform order, but its
``dg_march(Ns, ...)`` signature carries a per-element order vector
(dg_march.m:1,29); these loops drive that capability on the mixed-order
solvers (march/dg_mixed.py, adjoint/dg_mixed.py). Per iteration: coarse
march at ``ns``, fine march at ``ns + fine_offset``, adjoint at ``ns + 1``
(solved, or reconstructed through Radau collocation), both functionals and
the refinement decision at ``ref_i = argmax |err|`` (ties: the first):

- ``mode="p"``: raise the order of the argmax among the live elements below
  ``n_max`` (a saturated element cannot improve in p);
- ``mode="h"``: bisect the argmax element (the children inherit its order);
- ``mode="hp"``: raise the order while the argmax element is below
  ``n_max``, else bisect it;
- ``mode="smooth"``: p-refine where the top orthonormal-Legendre mode of the
  element's own solution carries at most a ``smooth_theta`` fraction of its
  modal energy (fast decay), else bisect; saturation still forces h.

Partitions are padded with zero-width slabs (exact identities with exactly
zero contribution) to ``k0 + maxit + 1`` elements (``k0 + 1`` for p-mode)
and ``ns`` is data, so refinement never changes a shape.

:func:`run_adaptive_dg_hp` runs one initial condition, or a (B,) ensemble
sharing one partition and order vector refined at the ensemble-mean |err|;
:func:`run_adaptive_dg_hp_per_member` gives every member its own partition
and order vector. ``engine="torch"`` runs the eager pipeline
(``adjoint/dg_mixed.dg_estimate_mixed``); ``engine="cuda"`` (ensembles only)
runs each iteration's member pipeline in one launch of the hp kernel
(ops/cuda/dg_slab_mixed.py), in float32, on the ODE ``ode`` (a registry
entry's functor; an ``ODEProblem`` without a ``kernel_id`` is traced) or,
with ``ode=None``, the loop's own ``f`` and ``f_u`` traced into a device
functor (``f_u=None`` derived by forward mode), as the JAX package's
Pallas engine takes ``f``; ``g_u`` is ``None`` (J = ∫u), a registry
functional's g_u, or any elementwise callable, traced, evaluated at the
live nodes only. The trace and the user library's build happen once a
study; a callable outside the tracer's op set raises. On a CPU device it
runs the kernel's plain version.

``device_loop=True`` runs a fixed trip of ``maxit + 1`` iterations (fewer
when resumed) with the stopping tests as device masks and one fetch at the
end; the history is bit-identical to the host loop's (the torch engine's
tolerance Newton and order checks still read the host; the cuda engine's
iterations read nothing until the fetch). Entry points run on
the card unless the caller passes ``device="cpu"``; a CUDA device that is
not there raises. Checkpoints are ``torch.save`` files; a resumed run
continues the history.

``mesh=`` (the ensembles): a :class:`~..parallel.mesh.RankGrid` whose
``mesh_axis`` (default ``"data"``) shards the members over ranks, as the
JAX package's ``mesh=`` shards them over devices; B must divide over the
axis (the hp kernel takes any B ≥ 1 a rank). Each rank runs its block of
members through the same estimate (the cuda engine's H1, or the torch
engine). The shared-partition loop sums its means (the signed and the
absolute per-element err, both functionals, and the mean solution in
``smooth`` mode) over the ranks in one all-reduce an iteration, so every
rank takes the same decision and the same stop, and gathers the members'
``u`` and ``v`` for the history (once at the end with ``device_loop``);
the per-member loop keeps only its block's partitions and orders and
gathers its diagnostics in member order (once at the end with
``device_loop``), the stop (no member refining) global. Every rank returns
the global history; at one rank it is the unsharded loop's, bit for bit
(``mesh=None`` runs the same path on one rank). With ``checkpoint_dir``
rank 0 writes the gathered state and every rank resumes from it. Not
ported: the JAX package's jit-reuse hooks (``iteration=``, ``run_fused``,
``fused_args``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.adapt.dg_loop import _from_saved, _to_saved
from adjoint_ode_adaptivity_tpu_torch.adapt.fd_loop import _load, _member_grid, _save_rank0
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    _functional,
    _functional_tables,
    dg_adjoint_interp_mixed,
    dg_estimate_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl
from adjoint_ode_adaptivity_tpu_torch.ops.operators import vandermonde_1d
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import (
    RankGrid,
    all_gather,
    all_reduce_sum,
    shard_along,
)

__all__ = [
    "HPAdaptResult",
    "HPPerMemberAdaptResult",
    "run_adaptive_dg_hp",
    "run_adaptive_dg_hp_per_member",
]

CHECKPOINT_FILE = "hp_adapt.pt"
PER_MEMBER_CHECKPOINT_FILE = "hp_adapt_per_member.pt"
MODES = ("h", "p", "hp", "smooth")


class HPAdaptResult(NamedTuple):
    times: np.ndarray  # (K_active+1,) partition at this iteration
    ns: np.ndarray  # (K_active,) per-element orders
    u: np.ndarray  # (K_active, np_max) padded coarse primal ((B, ...) for an ensemble)
    v: np.ndarray  # (K_active, np_max) padded adjoint at order ns+1 (likewise)
    err: np.ndarray  # (K_active,) element contributions (the ensemble's signed mean)
    j_coarse: float
    j_fine: float
    effectivity_gap: float  # JuH − Juh (MAIN.m:55-64 telemetry)
    est_total: float  # Σ err


class HPPerMemberAdaptResult(NamedTuple):
    """One iteration of the per-member hp study (arrays over members)."""

    times: np.ndarray  # (B, max_k+1) per-member partitions
    ns: np.ndarray  # (B, max_k) per-member order vectors
    err: np.ndarray  # (B, max_k) per-element contributions
    j_coarse: np.ndarray  # (B,)
    j_fine: np.ndarray  # (B,)
    est_total: np.ndarray  # (B,) per-member Σ err
    n_active: np.ndarray  # (B,) live element counts
    n_refining: int  # members still refining after this iteration


def _refine_candidate(times, ns, abs_err, mode, n_max, smooth_ok=None):
    """One p/h refinement candidate per member at the |AWR| argmax on padded
    partitions ``times`` (B, K+1), orders ``ns`` (B, K) and signal
    ``abs_err`` (B, K): the single place that encodes the refinement
    semantics (module docstring). Bisection shifts the tail right, so the
    children inherit the order."""
    k = ns.shape[1]
    ref_any = torch.argmax(abs_err, dim=1)
    # p-eligibility: order-refinable LIVE elements only (zero-width padding
    # slabs are never selected)
    eligible = (ns < n_max) & (times[:, 1:] - times[:, :-1] > 0)
    ref_p = torch.argmax(torch.where(eligible, abs_err, -torch.ones_like(abs_err)), dim=1)

    def at(x, idx):
        return torch.gather(x, 1, idx[:, None])[:, 0]

    if mode == "p":
        ref_i, use_p = ref_p, torch.ones_like(eligible[:, 0])
    elif mode == "h":
        ref_i, use_p = ref_any, torch.zeros_like(eligible[:, 0])
    elif mode == "smooth":
        ref_i, use_p = ref_any, at(smooth_ok, ref_any) & at(eligible, ref_any)
    else:  # hp: p until the argmax element saturates, then bisect it
        ref_i, use_p = ref_any, at(eligible, ref_any)
    idx_e = torch.arange(k, device=ns.device)[None, :]
    if mode != "h":
        ns_p = ns + ((idx_e == ref_i[:, None]) & at(eligible, ref_i)[:, None]).to(ns.dtype)
    else:
        ns_p = ns
    if mode == "p":
        return times, ns_p
    mid = 0.5 * (at(times, ref_i) + at(times, ref_i + 1))
    idx_t = torch.arange(k + 1, device=times.device)[None, :]
    t_shift = torch.cat([times[:, :1], times[:, :-1]], dim=1)
    times_h = torch.where(idx_t <= ref_i[:, None], times,
                          torch.where(idx_t == ref_i[:, None] + 1, mid[:, None], t_shift))
    ns_h = torch.where(idx_e <= ref_i[:, None], ns, torch.cat([ns[:, :1], ns[:, :-1]], dim=1))
    return (torch.where(use_p[:, None], times, times_h),
            torch.where(use_p[:, None], ns_p, ns_h))


def _make_modal_smoothness(n_max_user, np_max, theta, device):
    """``smooth(u (B, K, np_max), ns (B, K)) -> (B, K) bool``: True where
    the top orthonormal-Legendre mode of the element's nodal solution (at
    its own order) carries at most a ``theta`` fraction of the modal l2
    energy over modes 1..n (the mean mode is left out, except at n = 1 where
    the lone slope would always read as rough) — the classic hp decay
    indicator. Padded nodal entries and inverse-Vandermonde columns are
    zero, so the padding never enters. Evaluated in float64."""
    inv_v = np.zeros((n_max_user, np_max, np_max))
    for n in range(1, n_max_user + 1):
        inv_v[n - 1, : n + 1, : n + 1] = np.linalg.inv(vandermonde_1d(n, jacobi_gl(0.0, 0.0, n)))
    inv_v = torch.tensor(inv_v, dtype=torch.float64, device=device)
    idx = torch.arange(np_max, device=device)

    def smooth(u, ns):
        c = torch.einsum("bkij,bkj->bki", inv_v[ns - 1], u.to(torch.float64))
        lo = torch.where(ns >= 2, 1, 0)[..., None]
        live = (idx >= lo) & (idx <= ns[..., None])
        e_top = torch.sum(torch.where(idx == ns[..., None], c, 0.0) ** 2, dim=-1)
        e_all = torch.sum(torch.where(live, c, 0.0) ** 2, dim=-1)
        return e_top <= (theta * theta) * (e_all + 1e-30)

    return smooth


def _check_args(mode, n0, n_max, adjoint_mode, fine_offset, engine):
    if engine not in ("torch", "cuda"):
        raise ValueError(f"engine={engine!r}: 'torch' or 'cuda'")
    if mode not in MODES:
        raise ValueError(f"mode must be 'h', 'p', 'hp' or 'smooth', got {mode!r}")
    if not 1 <= n0 <= n_max:
        raise ValueError(f"n0={n0} must satisfy 1 <= n0 <= n_max={n_max}")
    if adjoint_mode not in ("solve", "reconstruct"):
        raise ValueError(f"unknown adjoint_mode {adjoint_mode!r}")
    if fine_offset < 1:
        raise ValueError("fine_offset must be >= 1: the adjoint solves at ns+1, which must fit "
                         "the operator stack")


def _estimator(engine, f, f_u, g, g_u, ode, dtype, n_max, fine_offset, n_gq, adjoint_mode,
               newton, max_k, device):
    """``run(times (B, K+1), ns (B, K), y0 (B,)) -> (u_c, v, err, j_c,
    j_f)``: the eager member pipeline (``newton`` = the keyword arguments of
    its Newton), or one launch of the hp kernel (its plain version on a CPU
    device), then both functionals."""
    mops = dg_time_operators_mixed(n_max + fine_offset, n_gq)
    interp = dg_adjoint_interp_mixed(mops)
    radau = dg_radau_interp_mixed(mops) if adjoint_mode == "reconstruct" else None
    if engine == "cuda":
        if dtype != torch.float32:
            raise ValueError(f"engine='cuda' runs float32, not {dtype}")
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_slab_mixed import (
            make_cuda_dg_estimate_hp_per_member,
        )

        # the registry entry (or ODEProblem) ode, else the loop's f and f_u traced
        pipeline = make_cuda_dg_estimate_hp_per_member(
            ode, mops, interp, max_k, n_max_user=n_max, fine_offset=fine_offset,
            newton_iters=newton["newton_iters"] or 8, adjoint_mode=adjoint_mode, rad=radau,
            **({} if ode is not None else {"f": f, "f_u": f_u}), g_u=g_u, device=device)
    else:
        def pipeline(times, ns, y0):
            return dg_estimate_mixed(mops, interp, f, times, ns, y0, fine_offset=fine_offset,
                                     adjoint_mode=adjoint_mode, rad=radau, f_u=f_u, g_u=g_u,
                                     **newton)

    # on the device once: a table copied per iteration would wait for the
    # kernel (a synchronous host-to-device copy) before the next launch
    tables = _functional_tables(mops, torch.empty(0, dtype=dtype, device=device))

    def run(times, ns, y0):
        u_c, u_f, v, err = pipeline(times, ns, y0)
        return (u_c, v, err, _functional(tables, u_c, times, ns, g),
                _functional(tables, u_f, times, ns + fine_offset, g))

    return run, mops


def _initial(t_span, k0, n0, max_k):
    """The padded starting partition (max_k+1,) and orders (max_k,)."""
    times = np.linspace(t_span[0], t_span[1], k0 + 1)
    times = np.concatenate([times, np.full(max_k - k0, times[-1])])
    ns = np.concatenate([np.full(k0, n0), np.ones(max_k - k0)]).astype(np.int64)
    return times, ns


# ------------------------------------------------------- shared partition


def run_adaptive_dg_hp(
    f: Callable,
    y0,
    t_span: tuple[float, float],
    *,
    f_u: Callable | None = None,
    k0: int = 4,
    n0: int = 1,
    n_max: int = 4,
    mode: str = "hp",
    g: Callable | None = None,
    g_u: Callable | None = None,
    tol: float = 1e-8,
    maxit: int = 30,
    fine_offset: int = 2,
    n_gq: int | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    newton_iters: int | None = None,
    adjoint_mode: str = "solve",
    engine: str = "torch",
    ode=None,
    smooth_theta: float = 0.3,
    callback: Callable | None = None,
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    mesh: RankGrid | None = None,
    mesh_axis: str = "data",
    dtype=None,
    device="cuda",
) -> list[HPAdaptResult]:
    """hp-adaptive DG-in-time study; returns the per-iteration history.
    Stops when ``|Σ err| < tol``, after ``maxit`` refinements, or when
    nothing can refine (p-mode with every live element at ``n_max``).

    ``y0`` a scalar: one run. ``y0`` a (B,) array: the ensemble-signal
    study — the members share one partition and order vector, the
    refinement signal is the ensemble-mean |err| per element, the history
    holds per-member ``u``/``v`` (B, K, np_max), the signed mean ``err``
    and member-mean functionals, and ``est_total = Σ_k mean_b err``; the
    ``smooth`` test reads the mean solution.

    ``f_u`` is ∂f/∂u (derived from an elementwise ``f`` when ``None``),
    ``g``/``g_u`` the functional integrand and its derivative (default
    J = ∫u). ``adjoint_mode``: 'solve' marches the adjoint at ``ns + 1``
    (adj_march), 'reconstruct' solves it at ``ns`` and lifts it through
    Radau collocation (adj_rec). ``engine="cuda"`` needs an ensemble (the
    kernel's fixed Newton count, ``newton_iters`` default 8).
    ``checkpoint_dir``, ``device_loop``, ``mesh`` (an ensemble only),
    ``mesh_axis``, ``dtype`` (default torch's default float type) and
    ``device`` as in the module docstring; the callback receives each
    result on every rank (after the run with ``device_loop``) and is not
    re-invoked for restored iterations."""
    _check_args(mode, n0, n_max, adjoint_mode, fine_offset, engine)
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    y0_arr = np.asarray(y0)
    ensemble = y0_arr.ndim == 1
    if engine == "cuda" and not ensemble:
        raise ValueError("engine='cuda' requires an ensemble (B,) y0")
    if mesh is not None and not ensemble:
        raise ValueError("mesh= requires a (B,) initial-condition array")
    y0_t = torch.as_tensor(y0_arr, dtype=dtype, device=device).reshape(-1)
    b = y0_t.shape[0]
    grid = _member_grid(mesh, mesh_axis, b)
    y_local = shard_along(y0_t, grid, mesh_axis)  # this rank's members
    b_loc = y_local.shape[0]

    def gather(x, dim=0):  # the ranks' blocks in member order
        return all_gather(x, grid, mesh_axis, dim) if ensemble else x
    max_k = k0 + (maxit + 1 if mode != "p" else 1)
    # restore before sizing: a resume may come from a run with a larger maxit
    raw = _load(checkpoint_dir, CHECKPOINT_FILE)
    if raw is not None:
        max_k = max(max_k, raw["times"].shape[0] - 1)
    times, ns = _initial(t_span, k0, n0, max_k)
    estimate, mops = _estimator(engine, f, f_u, g, g_u, ode, dtype, n_max, fine_offset, n_gq,
                                adjoint_mode, dict(newton_tol=newton_tol,
                                                   newton_maxit=newton_maxit,
                                                   newton_iters=newton_iters), max_k, device)
    smooth = (_make_modal_smoothness(n_max, mops.np_max, smooth_theta, device)
              if mode == "smooth" else None)

    def iteration(times, ns):
        t_b, n_b = times.expand(b_loc, -1).contiguous(), ns.expand(b_loc, -1).contiguous()
        u_b, v_b, err_b, j_cb, j_fb = estimate(t_b, n_b, y_local)
        u_s = None
        if ensemble:
            # the means over all members: this rank's sums (the signed err
            # for the history and the estimate, |err| the signal), summed
            # over the ranks in one all-reduce
            u_r, v_r = u_b, v_b  # this rank's members
            k = err_b.shape[1]
            parts = [torch.sum(err_b, dim=0), torch.sum(torch.abs(err_b), dim=0),
                     torch.sum(j_cb)[None], torch.sum(j_fb)[None]]
            if smooth is not None:
                parts.append(torch.sum(u_r, dim=0).reshape(-1).to(err_b.dtype))
            means = all_reduce_sum(torch.cat(parts), grid, mesh_axis) / b
            err_adj, abs_err = means[:k], means[k:2 * k]
            j_c, j_f = means[2 * k], means[2 * k + 1]
            if smooth is not None:
                u_s = means[2 * k + 2:].reshape(u_r.shape[1:])
        else:
            u_r, v_r, err_adj, j_c, j_f = u_b[0], v_b[0], err_b[0], j_cb[0], j_fb[0]
            abs_err = torch.abs(err_adj)
            u_s = u_r
        smooth_ok = None
        if smooth is not None:
            smooth_ok = smooth(u_s[None], ns[None])
        t_new, n_new = _refine_candidate(times[None], ns[None], abs_err[None], mode, n_max,
                                         smooth_ok)
        return u_r, v_r, err_adj, j_c, j_f, torch.sum(err_adj), t_new[0], n_new[0]

    history: list[HPAdaptResult] = []
    n_active, it0 = k0, 0
    if raw is not None:
        history = [HPAdaptResult(**_from_saved(h)) for h in raw["history"]]
        t_res, n_res = raw["times"].numpy(), raw["ns"].numpy()
        # re-pad to this run's max_k (zero-width slabs at order 1)
        times = np.concatenate([t_res, np.full(max_k + 1 - len(t_res), t_res[-1])])
        ns = np.concatenate([n_res, np.ones(max_k - len(n_res), np.int64)])
        n_active, it0 = int(raw["n_active"]), len(history)
        # stopped at tol, or saturated (re-running would append a duplicate)
        if abs(history[-1].est_total) < tol or bool(raw["saturated"]):
            return history

    def save(times_s, ns_s, n_act, saturated):
        if checkpoint_dir is not None:
            _save_rank0(grid, lambda: {
                "times": torch.as_tensor(np.asarray(times_s)),
                "ns": torch.as_tensor(np.asarray(ns_s, np.int64)), "n_active": n_act,
                "saturated": saturated,
                "history": [_to_saved(r._asdict()) for r in history]},
                Path(checkpoint_dir) / CHECKPOINT_FILE)

    def result(times_h, ns_h, u, v, err, j_c, j_f, est, na):
        return HPAdaptResult(
            times=times_h[: na + 1].copy(), ns=ns_h[:na].astype(np.int32), u=u[..., :na, :],
            v=v[..., :na, :], err=err[:na], j_coarse=float(j_c), j_fine=float(j_f),
            effectivity_gap=float(j_c) - float(j_f), est_total=float(est))

    t = torch.as_tensor(times, dtype=dtype, device=device)
    nsv = torch.as_tensor(ns, device=device)
    if device_loop:
        rows, active = [], torch.ones((), dtype=torch.bool, device=device)
        for _ in range(it0, maxit + 1):
            u, v, err, j_c, j_f, est, t_new, ns_new = iteration(t, nsv)
            rows.append((u, v, err, j_c, j_f, t, nsv, est, active))
            go = active & ~(torch.abs(est) < tol)
            changed = torch.any(t_new != t) | torch.any(ns_new != nsv)
            t, nsv = torch.where(go, t_new, t), torch.where(go, ns_new, nsv)
            active = go & changed
        # the fetch; the members' u and v gathered once
        bufs = [(gather(torch.stack(col), dim=1) if c < 2 else torch.stack(col)).cpu().numpy()
                for c, col in enumerate(zip(*rows))] if rows else []
        n_new = int(bufs[8].sum()) if rows else 0
        for i in range(n_new):
            na = int((np.diff(bufs[5][i]) > 0).sum())
            r = result(bufs[5][i], bufs[6][i], *(bufs[c][i] for c in (0, 1, 2, 3, 4, 7)), na)
            history.append(r)
            if callback is not None:
                callback(r)
        if n_new:
            # the trip stops at tol, at maxit, or at saturation (the mask
            # went off above tol, on the last allowed iteration too); keep
            # the third so a resume does not re-run the identical iteration
            sat = not bool(active) and abs(history[-1].est_total) >= tol
            t_f = t.cpu().numpy()
            save(t_f, nsv.cpu().numpy(), int((np.diff(t_f) > 0).sum()), sat)
        return history

    saturated = False
    for it in range(it0, maxit + 1):
        u, v, err, j_c, j_f, est, t_new, ns_new = iteration(t, nsv)
        r = result(t.cpu().numpy(), nsv.cpu().numpy(), gather(u).cpu().numpy(),
                   gather(v).cpu().numpy(), err.cpu().numpy(), j_c, j_f, est, n_active)
        history.append(r)
        if callback is not None:
            callback(r)
        done = abs(r.est_total) < tol
        if not done:
            # refine unconditionally when not done: the checkpoint always
            # holds the refined state, so a resume with a larger maxit
            # continues where an uninterrupted run would
            changed_t = not torch.equal(t_new, t)
            changed = changed_t or not torch.equal(ns_new, nsv)
            n_active += int(changed_t)
            t, nsv = t_new, ns_new
            if not changed:  # p-mode with every live element saturated
                done = saturated = True
        save(t.cpu().numpy(), nsv.cpu().numpy(), n_active, saturated)
        if done or it == maxit:
            break
    return history


# ------------------------------------------------------------ per member


def run_adaptive_dg_hp_per_member(
    f: Callable,
    y0s,
    t_span: tuple[float, float],
    *,
    f_u: Callable | None = None,
    k0: int = 4,
    n0: int = 1,
    n_max: int = 4,
    mode: str = "hp",
    g: Callable | None = None,
    g_u: Callable | None = None,
    tol: float = 1e-8,
    maxit: int = 30,
    fine_offset: int = 2,
    n_gq: int | None = None,
    newton_tol: float = 1e-7,
    newton_maxit: int = 500,
    newton_iters: int | None = None,
    adjoint_mode: str = "solve",
    engine: str = "torch",
    ode=None,
    smooth_theta: float = 0.3,
    checkpoint_dir: str | None = None,
    device_loop: bool = False,
    mesh: RankGrid | None = None,
    mesh_axis: str = "data",
    dtype=None,
    device="cuda",
) -> list[HPPerMemberAdaptResult]:
    """Per-member hp-adaptive DG-in-time: every member of the (B,)
    ensemble owns its partition AND order vector, p/h-refines its own |AWR|
    argmax, and freezes at ``tol`` (or when nothing can refine) on its own —
    the reference's one-adaptive-job-per-IC farm (Submit_schedule_frontera)
    on the hp axis. Each history entry holds the partitions and orders the
    iteration ran on (before it refined) and ``n_refining`` after it.
    Arguments as for :func:`run_adaptive_dg_hp`; the cuda engine runs any
    B ≥ 1 (a rank); under ``mesh`` the partitions, orders and refining
    flags shard with the members."""
    _check_args(mode, n0, n_max, adjoint_mode, fine_offset, engine)
    device = require_device(device)
    dtype = dtype or torch.get_default_dtype()
    y0_t = torch.as_tensor(np.asarray(y0s), dtype=dtype, device=device)
    b = y0_t.shape[0]
    grid = _member_grid(mesh, mesh_axis, b)
    y_local = shard_along(y0_t, grid, mesh_axis)  # this rank's members

    def gather(x, dim=0):  # the ranks' blocks in member order
        return all_gather(x, grid, mesh_axis, dim)

    def shard(x):
        return shard_along(x, grid, mesh_axis)

    history: list[HPPerMemberAdaptResult] = []
    it0 = 0
    raw = _load(checkpoint_dir, PER_MEMBER_CHECKPOINT_FILE)
    if raw is not None:
        history = [HPPerMemberAdaptResult(**_from_saved(h)) for h in raw["history"]]
        it0 = len(history)
        if history[-1].n_refining == 0:
            return history
    max_k = k0 + (maxit + 1 if mode != "p" else 1)
    if raw is not None:
        max_k = max(max_k, raw["times"].shape[1] - 1)

        def repad(times_r, ns_r):
            """Pad restored (B, ·) partitions and orders to this run's max_k."""
            w = max_k + 1 - times_r.shape[1]
            return (np.concatenate([times_r, np.repeat(times_r[:, -1:], w, axis=1)], axis=1),
                    np.concatenate([ns_r, np.ones((b, w), ns_r.dtype)], axis=1))

        t_res, n_res = repad(raw["times"].numpy(), raw["ns"].numpy())
        refining = shard(raw["refining"].to(device)) != 0
        history = [r._replace(times=tt, ns=nn, err=np.concatenate(
            [r.err, np.zeros((b, max_k - r.err.shape[1]))], axis=1))
            for r, (tt, nn) in ((r, repad(r.times, r.ns)) for r in history)]
    else:
        row_t, row_n = _initial(t_span, k0, n0, max_k)
        t_res, n_res = np.broadcast_to(row_t, (b, max_k + 1)), np.broadcast_to(row_n, (b, max_k))
        refining = shard(torch.ones((b,), dtype=torch.bool, device=device))
    # this rank's block of the members' partitions and orders
    times = shard(torch.as_tensor(np.ascontiguousarray(t_res), dtype=dtype, device=device))
    nsb = shard(torch.as_tensor(np.ascontiguousarray(n_res), dtype=torch.int64, device=device))
    estimate, mops = _estimator(engine, f, f_u, g, g_u, ode, dtype, n_max, fine_offset, n_gq,
                                adjoint_mode, dict(newton_tol=newton_tol,
                                                   newton_maxit=newton_maxit,
                                                   newton_iters=newton_iters), max_k, device)
    smooth = (_make_modal_smoothness(n_max, mops.np_max, smooth_theta, device)
              if mode == "smooth" else None)

    def iteration(times_b, ns_b, refining):
        u_c, _v, err, j_c, j_f = estimate(times_b, ns_b, y_local)
        est = torch.sum(err, dim=1)
        smooth_ok = smooth(u_c, ns_b) if smooth is not None else None
        t_new, n_new = _refine_candidate(times_b, ns_b, torch.abs(err), mode, n_max, smooth_ok)
        changed = torch.any(t_new != times_b, dim=1) | torch.any(n_new != ns_b, dim=1)
        # a member refines while it was refining and its tolerance test
        # fails; it freezes when nothing could refine
        apply = refining & ~(torch.abs(est) < tol)
        n_active = torch.sum(times_b[:, 1:] - times_b[:, :-1] > 0, dim=1)
        return (torch.where(apply[:, None], t_new, times_b),
                torch.where(apply[:, None], n_new, ns_b), apply & changed,
                (err, j_c, j_f, est, n_active))

    k = nsb.shape[1]

    def row(times_b, ns_b, diag, ref_new):
        """This rank's members' diagnostics in one float64 (b_loc, ·) block:
        times, orders, err, j_c, j_f, est, n_active and the refining flag
        (float64 holds the float32 values and the counts exactly)."""
        err, j_c, j_f, est, n_act = diag
        return torch.cat([times_b.double(), ns_b.double(), err.double(),
                          torch.stack([j_c, j_f, est], dim=1).double(),
                          torch.stack([n_act, ref_new], dim=1).double()], dim=1)

    def record(rows_g):
        """One iteration from the gathered (B, ·) block."""
        c = np.cumsum([0, k + 1, k, k, 1, 1, 1, 1])
        cast = lambda j, dt: rows_g[:, c[j]:c[j + 1]].astype(dt)  # noqa: E731
        fdt = torch.empty((), dtype=dtype).numpy().dtype
        history.append(HPPerMemberAdaptResult(
            times=cast(0, fdt), ns=cast(1, np.int32), err=cast(2, fdt),
            j_coarse=cast(3, fdt)[:, 0], j_fine=cast(4, fdt)[:, 0], est_total=cast(5, fdt)[:, 0],
            n_active=cast(6, np.int32)[:, 0], n_refining=int(rows_g[:, c[7]].sum())))

    def save(times_s, ns_s, refining_s):
        if checkpoint_dir is None:
            return
        times_s, ns_s = gather(times_s), gather(ns_s)
        refining_s = gather(refining_s.to(torch.int32))
        _save_rank0(grid, lambda: {
            "times": times_s.cpu(), "ns": ns_s.cpu(), "refining": refining_s.cpu(),
            "history": [_to_saved(r._asdict()) for r in history]},
            Path(checkpoint_dir) / PER_MEMBER_CHECKPOINT_FILE)

    if device_loop:
        rows = []
        for _ in range(it0, maxit + 1):
            t_new, ns_new, ref_new, diag = iteration(times, nsb, refining)
            rows.append(row(times, nsb, diag, ref_new))
            # once no member refines, an iteration leaves the state as it is
            times, nsb, refining = t_new, ns_new, ref_new
        # the one fetch; the history ends at the first iteration that left no
        # member refining
        bufs = gather(torch.stack(rows), dim=1).cpu().numpy() if rows else []
        for rows_g in bufs:
            record(rows_g)
            if history[-1].n_refining == 0:
                break
        if len(history) > it0:
            save(times, nsb, refining)
        return history

    for it in range(it0, maxit + 1):
        t_new, ns_new, ref_new, diag = iteration(times, nsb, refining)
        record(gather(row(times, nsb, diag, ref_new)).cpu().numpy())
        save(t_new, ns_new, ref_new)
        if history[-1].n_refining == 0 or it == maxit:
            break
        times, nsb, refining = t_new, ns_new, ref_new
    return history
