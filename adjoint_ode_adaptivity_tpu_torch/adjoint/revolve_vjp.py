"""Bounded-memory adjoints: the revolve schedule executed behind autograd.

The planner (adjoint/checkpointing.py) emits the Griewank–Walther binomial
action list; this module consumes it. Counterpart of the JAX package's
``adjoint/revolve_vjp.py``, with ``jax.custom_vjp`` turned into
``torch.autograd.Function``:

- :func:`execute_revolve` runs a schedule: slot stores and restores keep
  tensor references, "advance" segments are forward steps, and each
  "reverse" applies one per-step VJP. At most ``snaps`` checkpoint states
  plus one live state are held: O(s) memory for an N-step march with
  O(N·t) recompute, t = min_repetitions(N, s).
- :func:`checkpointed_march` wraps ``u_{i+1} = step_fn(u_i, t_i, dt_i)``:
  its forward saves only ``(u0, dt)``, its backward runs the schedule with
  per-step ``torch.autograd.grad`` and carries the time cotangent, so the
  ``dt`` gradient includes the step times' dependence t_i = t0 + Σ_{j<i} dt_j.
- :func:`checkpointed_advec_march` is the same wrapper around the DG
  advection LSRK step (adjoint/advec.py::lsrk_step).
- :func:`revolve_advec_estimate` is the beyond-memory fwd + adjoint +
  estimate of the DG advection march: the schedule runs over UNITS of
  ``unit_steps`` steps; an advance is K1 with no trajectory
  (``make_cuda_advec_march``, replacing the TPU's ``_fwd_grid_kernel_b``),
  a reverse is the stored pipeline over one unit (K1 storing that unit's
  trajectory, then K2), with λ chained across unit boundaries.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.checkpointing import (
    min_repetitions,
    optimal_snaps,
    plan_schedule,
    simulate_schedule,
)
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device

__all__ = [
    "execute_revolve",
    "checkpointed_march",
    "checkpointed_advec_march",
    "revolve_advec_estimate",
]


def execute_revolve(
    step_at: Callable[[int, Any], Any],
    reverse_at: Callable[[int, Any, Any], Any],
    u0: Any,
    lam_init: Any,
    n_steps: int,
    snaps: int,
    schedule: list[tuple[str, int]] | None = None,
):
    """Run a revolve schedule. ``step_at(i, state) -> state_{i+1}`` advances
    one step; ``reverse_at(i, state_i, lam) -> lam`` applies the adjoint of
    step i (and may fold in source terms / accumulators — ``lam`` is any
    object carried through the reverse sweep).

    Returns ``(lam_final, stats)`` with ``stats = {"forward_steps",
    "max_slots"}`` counted during execution — the structural proof that the
    memory bound holds.
    """
    schedule = schedule if schedule is not None else plan_schedule(n_steps, snaps)
    slots: dict[int, tuple[int, Any]] = {}
    pos, state, lam = 0, u0, lam_init
    next_rev = n_steps
    fwd_count, max_slots = 0, 0
    for act, arg in schedule:
        if act == "advance":
            for _ in range(arg):
                state = step_at(pos, state)
                pos += 1
                fwd_count += 1
        elif act == "takeshot":
            slots[arg] = (pos, state)
            if len(slots) > snaps:
                raise AssertionError("revolve slot budget exceeded")
            max_slots = max(max_slots, len(slots))
        elif act == "restore":
            pos, state = slots[arg]
        elif act == "reverse":
            if pos != next_rev - 1:  # pragma: no cover — planner invariant
                raise AssertionError(f"reverse at {pos}, expected {next_rev - 1}")
            lam = reverse_at(pos, state, lam)
            next_rev -= 1
        else:  # pragma: no cover
            raise ValueError(act)
    if next_rev != 0:  # pragma: no cover — planner invariant
        raise AssertionError(f"{next_rev} steps never reversed")
    return lam, {"forward_steps": fwd_count, "max_slots": max_slots}


def _vjp(fn, inputs, cotangents):
    """Cotangents of ``inputs`` (detached leaves) for ``fn(*inputs)``'s
    outputs weighted by ``cotangents``; an input the outputs do not depend
    on gets zeros, as ``jax.vjp`` gives."""
    leaves = tuple(x.detach().requires_grad_(True) for x in inputs)
    with torch.enable_grad():
        outs = fn(*leaves)
        grads = torch.autograd.grad(outs, leaves, cotangents, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads))


def checkpointed_march(
    step_fn: Callable,
    n_steps: int,
    snaps: int | None = None,
    t0: float = 0.0,
):
    """A march ``(u0, dt) -> u_final`` over ``n_steps`` (possibly nonuniform)
    steps whose reverse-mode gradient runs the revolve schedule with
    ``snaps`` checkpoint slots instead of storing the trajectory.

    Gradients w.r.t. both ``u0`` and ``dt`` are exact, including the
    dependence of the step times ``t_i = t0 + Σ_{j<i} dt_j`` on earlier
    steps (the reverse sweep carries the time cotangent alongside the state
    cotangent). ``step_fn(u, t, dt_i)`` gets ``t`` and ``dt_i`` as 0-d
    tensors of ``u0``'s dtype.
    """
    if snaps is None:
        snaps = optimal_snaps(n_steps)
    schedule = plan_schedule(n_steps, snaps)

    def _start(u0):
        return u0, torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)

    def _step(ut, dt_i):
        u, t = ut
        return step_fn(u, t, dt_i), t + dt_i

    class _March(torch.autograd.Function):
        @staticmethod
        def forward(ctx, u0, dt):
            ut = _start(u0)
            for i in range(n_steps):
                ut = _step(ut, dt[i])
            ctx.save_for_backward(u0, dt)
            return ut[0]

        @staticmethod
        def backward(ctx, g):
            u0, dt = ctx.saved_tensors

            def step_at(i, ut):
                return _step(ut, dt[i])

            def reverse_at(i, ut, lam):
                (lam_u, lam_t), dt_bar = lam
                u_bar, t_bar, dt_i_bar = _vjp(
                    lambda u, t, d: _step((u, t), d), (ut[0], ut[1], dt[i]), (lam_u, lam_t))
                dt_bar[i] += dt_i_bar
                return (u_bar, t_bar), dt_bar

            lam0 = ((g, torch.zeros((), dtype=g.dtype, device=g.device)), torch.zeros_like(dt))
            with torch.no_grad():
                ((u_bar, _), dt_bar), _ = execute_revolve(
                    step_at, reverse_at, _start(u0), lam0, n_steps, snaps, schedule)
            return u_bar, dt_bar

    def march(u0, dt):
        return _March.apply(u0, dt)

    march.revolve_stats = {
        "snaps": snaps,
        "repetitions": min_repetitions(n_steps, snaps),
        "schedule_len": len(schedule),
    }
    return march


def checkpointed_advec_march(
    ops,
    dt: float,
    n_steps: int,
    snaps: int | None = None,
    t0: float = 0.0,
):
    """Revolve-checkpointed DG advection march ``u0 -> u_final`` (uniform
    ``dt``): the gradient of ``J(march(u0))`` runs the binomial reverse
    sweep of the LSRK step's VJP with ``snaps`` stored states."""
    # imported here, as in revolve_advec_estimate: the package ``adjoint``
    # imports this module, and adjoint.advec and ops.cuda.dg_rhs import the
    # package ``march``, which imports ``adjoint`` again
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import lsrk_step

    if snaps is None:
        snaps = optimal_snaps(n_steps)
    schedule = plan_schedule(n_steps, snaps)

    def step_at(i, u):
        return lsrk_step(ops, u, t0 + i * dt, dt)

    class _March(torch.autograd.Function):
        @staticmethod
        def forward(ctx, u0):
            u = u0
            for i in range(n_steps):
                u = step_at(i, u)
            ctx.save_for_backward(u0)
            return u

        @staticmethod
        def backward(ctx, g):
            (u0,) = ctx.saved_tensors

            def reverse_at(i, u, lam):
                return _vjp(lambda v: step_at(i, v), (u,), (lam,))[0]

            with torch.no_grad():
                lam, _ = execute_revolve(step_at, reverse_at, u0, g, n_steps, snaps, schedule)
            return lam

    def march(u0):
        return _March.apply(u0)

    march.revolve_stats = {
        "snaps": snaps,
        "repetitions": min_repetitions(n_steps, snaps),
        "schedule_len": len(schedule),
    }
    return march


def revolve_advec_estimate(
    disc,
    a: float,
    dt: float,
    n_steps: int,
    unit_steps: int,
    snaps: int | None = None,
    segment: int = 8,
    device="cuda",
):
    """Beyond-memory fwd+adjoint+estimate for the DG advection march: the
    revolve schedule over UNITS of ``unit_steps`` steps, each unit driven by
    the CUDA kernels K1 and K2 (their plain versions on the CPU).

    The stored-trajectory pipeline (``make_cuda_fwd_adj_estimate_single``)
    keeps every coarse state in device memory — Np·K·4·n_steps bytes, which
    at K = 10⁵, N = 2 passes the H100's 80 GB near 66,000 steps. This
    composition keeps only ``snaps`` checkpointed STATES plus ONE unit's
    trajectory: advances are K1 with no trajectory from ``t0 + i·unit_dt``,
    each reverse runs the stored pipeline on one unit from its start time
    and chains λ through the unit boundary. λ composition is exact (the
    same transposes in the same order); η is the same per-step sum
    accumulated unit-wise (association differs at unit boundaries only).

    ``segment`` is the TPU kernels' step chunk and means nothing on the
    card; it is kept, and validated the same way, for parity.

    Returns ``run(u0, t0, lam_end) -> (u_final, lam0, eta)`` on (Np, K)
    states, eta (K,), the contract of the stored pipeline, with
    ``run.revolve_stats`` carrying the planner's structural counts:
    ``forward_units`` (units advanced, recomputation included) and
    ``max_slots`` (≤ snaps, the memory bound).
    """
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import (
        make_cuda_advec_march,
        make_cuda_fwd_adj_estimate_single,
    )

    if n_steps % unit_steps:
        raise ValueError(f"n_steps={n_steps} not a multiple of {unit_steps}")
    if unit_steps % segment:
        raise ValueError(f"unit_steps={unit_steps} not a multiple of {segment}")
    device = require_device(device)
    n_units = n_steps // unit_steps
    if snaps is None:
        snaps = optimal_snaps(n_units)
    schedule = plan_schedule(n_units, snaps)
    plan_stats = simulate_schedule(n_units, snaps, schedule)
    march = make_cuda_advec_march(disc, a, dt, unit_steps, device)
    pipe = make_cuda_fwd_adj_estimate_single(disc, a, dt, unit_steps, device,
                                             store_trajectory=True)
    unit_dt = unit_steps * dt

    def run(u0, t0, lam_end):
        t0 = float(t0)
        u_final = []

        def step_at(i, u):
            return march(u, t0 + i * unit_dt)

        def reverse_at(i, u_i, lam):
            lam_u, eta_acc = lam
            uf, lam0, eta = pipe(u_i, t0 + i * unit_dt, lam_u)
            if i == n_units - 1:  # this unit's final state IS u(T)
                u_final.append(uf)
            return lam0, eta_acc + eta

        lam_init = (lam_end, torch.zeros((disc.k,), dtype=lam_end.dtype, device=lam_end.device))
        (lam0, eta), _ = execute_revolve(step_at, reverse_at, u0, lam_init, n_units, snaps,
                                         schedule)
        return u_final[0], lam0, eta

    run.revolve_stats = {
        "snaps": snaps,
        "n_units": n_units,
        "unit_steps": unit_steps,
        "forward_units": plan_stats["forward_steps"],
        "max_slots": plan_stats["max_slots"],
        "repetitions": min_repetitions(n_units, snaps),
    }
    return run
