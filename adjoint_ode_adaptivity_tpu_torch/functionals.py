"""Output functionals J(u) on a discrete time grid, and their state gradients.

Counterpart of the JAX package's ``functionals.py``. The time axis is axis
0; trailing axes (e.g. the members of a per-member study) are independent,
so ``value`` sums over time only. ``K = ∂J/∂U`` is written out by hand
(:func:`get_k`), as the reference does (python/factory.py:126-150); the
tests hold it equal to ``jax.grad`` of the JAX package's functionals.

Discrete conventions (the reference's, for effectivity parity):
- ``J=int(u)``   : J = Σ_{n<N} u_n·dt_n          (left rectangle rule)
- ``J=int(u^2)`` : J = Σ_{n<N} u_n²·dt_n
- ``J=u_N``      : K = e_{N−1} — the reference places the unit at the
                   second-to-last node (python/factory.py:135-138), so J ≡ u_{N−1}.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["Functional", "get_functional", "get_k", "FUNCTIONAL_REGISTRY", "terminal_abs_error",
           "kernel_goal"]


class Functional(NamedTuple):
    name: str
    value: Callable  # value(u, dt) -> J (summed over the time axis 0)
    g_u: Callable | None  # integrand derivative g_u(u, t) for the continuous adjoint
    terminal: float  # continuous-adjoint terminal condition a(T)
    linear: bool
    # the DG-in-time kernels' registry functor of g_u (csrc/odes.cuh
    # AOA_GOAL_SWITCH): 0 g_u ≡ 1, 1 g_u = 2u; None for any other (the
    # kernels trace its g_u, ops/cuda/functor.py)
    kernel_id: int | None = None


def _j_int_u(u, dt):
    return torch.sum(u[:-1] * dt, dim=0)


def _j_int_u2(u, dt):
    return torch.sum(u[:-1] ** 2 * dt, dim=0)


def _j_u_n(u, dt):
    return u[-2]


FUNCTIONAL_REGISTRY: dict[str, Functional] = {
    "J=int(u)": Functional("J=int(u)", _j_int_u, lambda u, t: torch.ones_like(u), 0.0, True, 0),
    "J=int(u^2)": Functional("J=int(u^2)", _j_int_u2, lambda u, t: 2.0 * u, 0.0, False, 1),
    # g_u ≡ 0: the goal is a terminal condition, not an elementwise source
    "J=u_N": Functional("J=u_N", _j_u_n, lambda u, t: torch.zeros_like(u), 1.0, True),
}


def get_functional(name: str) -> Functional:
    return FUNCTIONAL_REGISTRY[name]


def kernel_goal(g_u) -> Functional:
    """The goal of a DG-in-time kernel for the adjoint source ``g_u``: J = ∫u
    for ``None``; the registry functional with a ``kernel_id`` whose ``g_u``
    (or which) this is; any other elementwise callable ``g_u(u, t)`` as a
    functional with no ``kernel_id``, which the kernels trace into a device
    functor (ops/cuda/functor.py)."""
    if g_u is None:
        return FUNCTIONAL_REGISTRY["J=int(u)"]
    for fn in FUNCTIONAL_REGISTRY.values():
        if fn.kernel_id is not None and (g_u is fn or g_u is fn.g_u):
            return fn
    if isinstance(g_u, Functional):
        if g_u.g_u is None or g_u.terminal != 0.0:
            raise ValueError(f"the functional {g_u.name!r} is no integral J = ∫g dt: the "
                             "kernels take an adjoint source g_u and no terminal condition")
        return g_u._replace(kernel_id=None)
    if not callable(g_u):
        raise ValueError(f"g_u={g_u!r} is neither a callable nor a functional")
    return Functional(f"J with g_u={getattr(g_u, '__qualname__', repr(g_u))}", None, g_u, 0.0,
                      False)


def get_k(functional: Functional, u: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """K = ∂J/∂U on the grid of ``u`` ((N+1, ...), time axis 0)."""
    k = torch.zeros_like(u)
    if functional.name == "J=int(u)":
        k[:-1] = dt
    elif functional.name == "J=int(u^2)":
        k[:-1] = 2.0 * u[:-1] * dt
    elif functional.name == "J=u_N":
        k[-2] = 1.0
    else:
        raise KeyError(functional.name)
    return k


def terminal_abs_error(u: torch.Tensor, true) -> torch.Tensor:
    """|u_N − u_true|: the goal functional of the NN-adaptivity drivers
    (``outFnl``, python/Main_new_loss.py:70-73)."""
    return torch.abs(torch.squeeze(u[-1]) - torch.squeeze(torch.as_tensor(true)))
