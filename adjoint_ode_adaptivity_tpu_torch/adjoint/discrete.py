"""Discrete adjoint of one-step time marches: an O(N) reverse loop of VJPs.

Counterpart of the JAX package's ``adjoint/discrete.py``. The recurrence

    v_N = K_N,      v_n = K_n + (∂G_{n+1}/∂u_n)ᵀ · v_{n+1}

(``G_{n+1}`` the step map producing u_{n+1}) is what the reference's dense
solve of ``(JFᵀ − I) v = −K`` computes (python/Main_finite_difference.py:
54-76); :func:`adjoint_dense_oracle` keeps that solve as a test oracle.
Time is axis 0; trailing axes of ``dt`` and ``k_vec`` (independent
members) ride along elementwise.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import grad, vjp

from adjoint_ode_adaptivity_tpu_torch.march.fd import _index, times_from_dt

__all__ = [
    "adjoint_march",
    "adjoint_march_per_step",
    "adjoint_march_linearized",
    "adjoint_dense_oracle",
]


def _reverse(u_traj, k_vec, vjp_n: Callable) -> torch.Tensor:
    v = k_vec[-1] * torch.ones_like(u_traj[-1])
    vs = [v]
    for n in range(u_traj.shape[0] - 2, -1, -1):
        v = k_vec[n] + vjp_n(n, v)
        vs.append(v)
    return torch.stack(vs[::-1])


def adjoint_march(
    step_fn: Callable, u_traj: torch.Tensor, dt: torch.Tensor, k_vec: torch.Tensor, t0=0.0
) -> torch.Tensor:
    """Adjoint trajectory v on the grid of ``u_traj`` (N+1 nodes), with
    ``k_vec`` = ∂J/∂U — the reference's ``adjSolve`` solution."""
    t = times_from_dt(dt, t0)

    def vjp_n(n, v_next):
        _, pull = vjp(lambda u: step_fn(u, t[n], dt[n]), u_traj[n])
        return pull(v_next)[0]

    return _reverse(u_traj, k_vec, vjp_n)


def adjoint_march_per_step(
    step_fn: Callable,
    u_traj: torch.Tensor,
    dt: torch.Tensor,
    k_vec: torch.Tensor,
    params_stacked: Any,
    t0=0.0,
) -> torch.Tensor:
    """Per-step-parameter variant: step n uses ``params_stacked[n]``
    (python/Main_variable_params.py:74-101)."""
    t = times_from_dt(dt, t0)

    def vjp_n(n, v_next):
        p_n = _index(params_stacked, n)
        _, pull = vjp(lambda u: step_fn(u, t[n], dt[n], p_n), u_traj[n])
        return pull(v_next)[0]

    return _reverse(u_traj, k_vec, vjp_n)


def adjoint_march_linearized(
    f_u: Callable, u_traj: torch.Tensor, dt: torch.Tensor, k_vec: torch.Tensor, t0=0.0
) -> torch.Tensor:
    """Forward-Euler adjoint with a closed-form Jacobian: d_n = 1 +
    f_u(u_n, t_n)·dt_n, then v_n = k_n + d_n·v_{n+1}. Equals
    :func:`adjoint_march` with ``euler_step(f)`` to rounding."""
    t = times_from_dt(dt, t0)
    d = 1.0 + f_u(u_traj[:-1], t[:-1]) * dt
    return _reverse(u_traj, k_vec, lambda n, v_next: d[n] * v_next)


def adjoint_dense_oracle(
    step_fn: Callable, u_traj: torch.Tensor, dt: torch.Tensor, k_vec: torch.Tensor, t0=0.0
) -> torch.Tensor:
    """Dense-solve oracle: assemble the sub-diagonal JF (∂G_n/∂u_{n−1}) and
    solve ``(JFᵀ − I) v = −K`` as python/Main_finite_difference.py:69-73.
    O(N³); scalar state only."""
    t = times_from_dt(dt, t0)
    n_nodes = u_traj.shape[0]
    dstep = torch.stack([
        grad(lambda u: step_fn(u, t[n], dt[n]))(u_traj[n]) for n in range(n_nodes - 1)
    ])
    jf = torch.zeros((n_nodes, n_nodes), dtype=u_traj.dtype, device=u_traj.device)
    idx = torch.arange(n_nodes - 1, device=u_traj.device)
    jf[idx + 1, idx] = dstep
    a = jf.T - torch.eye(n_nodes, dtype=u_traj.dtype, device=u_traj.device)
    return torch.linalg.solve(a, -k_vec)
