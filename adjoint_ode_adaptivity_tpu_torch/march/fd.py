"""Forward time marching with one-step update rules, as a Python loop over
steps.

Counterpart of the JAX package's ``march/fd.py`` (reference
``forwardSolve``, python/Main_finite_difference.py:34-51). A *step
function* has the signature ``step_fn(u, t, dt) -> u_next``; the builders
turn an ODE right-hand side into one.

The time axis is axis 0 of ``dt``; trailing axes of ``dt`` (e.g. the
members of a per-member study, each on its own grid) broadcast against the
state. The JAX package's ``remat`` option (rematerialisation in reverse-mode
AD) has no counterpart: the port's adjoint is an explicit reverse loop over
the stored trajectory (adjoint/discrete.py), not autograd through the march.

Padding contract: a step with ``dt == 0`` is an exact identity for every
rule here, so grids padded to a fixed length by repeating the final time
march correctly with no masking.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = [
    "euler_step",
    "heun_step",
    "rk4_step",
    "forward_march",
    "forward_march_per_step",
    "times_from_dt",
]


def euler_step(f: Callable) -> Callable:
    """Forward-Euler step u_{n+1} = u_n + f(u_n, t_n)·dt_n
    (``fwdUpdate``, python/factory.py:107-108)."""

    def step(u, t, dt):
        return u + f(u, t) * dt

    return step


def heun_step(f: Callable) -> Callable:
    """Heun (explicit trapezoid) step, 2nd order."""

    def step(u, t, dt):
        k1 = f(u, t)
        k2 = f(u + dt * k1, t + dt)
        return u + dt / 2.0 * (k1 + k2)

    return step


def rk4_step(f: Callable) -> Callable:
    """Classical RK4 step, 4th order."""

    def step(u, t, dt):
        k1 = f(u, t)
        k2 = f(u + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = f(u + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = f(u + dt * k3, t + dt)
        return u + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    return step


def times_from_dt(dt: torch.Tensor, t0=0.0) -> torch.Tensor:
    """Node times from step sizes: t = [t0, t0 + cumsum(dt)] along axis 0."""
    t0 = torch.as_tensor(t0, dtype=dt.dtype, device=dt.device)
    first = t0.expand(dt.shape[1:]).unsqueeze(0)
    return torch.cat([first, t0 + torch.cumsum(dt, dim=0)])


def forward_march(step_fn: Callable, u0: Any, dt: torch.Tensor, t0=0.0) -> torch.Tensor:
    """March u_{n+1} = step_fn(u_n, t_n, dt_n) over all steps. Returns the
    trajectory stacked on a new leading axis, ``(len(dt)+1, *shape(u))``."""
    u = torch.as_tensor(u0, dtype=dt.dtype, device=dt.device)
    t = times_from_dt(dt, t0)
    us = [u]
    for n in range(dt.shape[0]):
        u = step_fn(u, t[n], dt[n])
        us.append(u)
    return torch.stack(us)


def forward_march_per_step(
    step_fn: Callable, u0: Any, dt: torch.Tensor, params_stacked: Any, t0=0.0
) -> torch.Tensor:
    """March with per-step parameters: ``step_fn(u, t, dt, params_n)``,
    where ``params_stacked`` is a tensor (or a dict of tensors) with leading
    axis ``len(dt)`` (python/Main_variable_params.py:46-65)."""
    u = torch.as_tensor(u0, dtype=dt.dtype, device=dt.device)
    t = times_from_dt(dt, t0)
    us = [u]
    for n in range(dt.shape[0]):
        u = step_fn(u, t[n], dt[n], _index(params_stacked, n))
        us.append(u)
    return torch.stack(us)


def _index(params: Any, n: int):
    if isinstance(params, dict):
        return {k: _index(v, n) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_index(v, n) for v in params)
    return params[n]
