"""Declarative problem configuration: the reference's ``Problem`` NamedTuple
and ``FunFactory`` string-keyed dispatch (python/factory.py:18-74), as a
thin facade over the ODE and functional registries.

Counterpart of the JAX package's ``config.py``. ``get_problem_functions``
returns the closure bundle the reference's
``FunFactory.getFunctions``/``getAdaptFunctions`` produced (forward update,
full residual map, Jacobian diagonal, K vector, exact solutions, forward and
adjoint solvers, error estimate, adapt step), each built on the port's
layers. Every function moves its array arguments onto the facade's device
and keeps their dtype.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch import functionals as fnl
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt.policy import bisect_refine
from adjoint_ode_adaptivity_tpu_torch.adjoint import (
    adjoint_march,
    coarse_indicator,
    interp_to_fine,
    refine_all,
    residual,
)
from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step, forward_march, times_from_dt
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device

__all__ = ["Problem", "Funs", "get_problem_functions"]


class Problem(NamedTuple):
    """Problem spec (python/factory.py:18-27). ``is_net``/``linear_*`` flags
    are subsumed by the registries."""

    case: str
    ode: str
    out_functional: str
    ref_factor: int = 4
    t_span: tuple[float, float] = (0.0, 2.0)
    u0: float = 1.0


class Funs(NamedTuple):
    """The function bundle (python/factory.py:29-36 + AdaptFuns :38-46)."""

    fwd_update: Callable  # step_fn(u, t, dt)
    get_f: Callable  # full residual map F(U) (getF)
    get_jf_diag: Callable  # sub-diagonal of the discrete Jacobian (getJF)
    get_k: Callable  # K = dJ/dU (getK)
    exact_fwd: Callable | None
    exact_adj: Callable | None  # exact_adj(t_eval) along the exact primal
    forward_solve: Callable  # forward_solve(dt) -> trajectory
    adjoint_solve: Callable  # adjoint_solve(dt, u) -> v on the fine grid
    error_estimate: Callable  # error_estimate(dt, u, v) -> per-step indicator
    adapt: Callable  # adapt(times, err_steps) -> refined times


def get_problem_functions(problem: Problem, device="cuda") -> Funs:
    """The :class:`Funs` of ``problem`` on ``device`` (the card by default;
    ``device="cpu"`` to run on the CPU)."""
    device = require_device(device)
    ode = odes.get_ode(problem.ode)
    functional = fnl.get_functional(problem.out_functional)
    step = euler_step(ode.f)
    rf = problem.ref_factor
    t0, t1 = problem.t_span

    def on(x):
        return torch.as_tensor(x, device=device)

    def get_f(u, dt):
        u, dt = on(u), on(dt)
        t = times_from_dt(dt, t0)
        return torch.cat([u[:1], step(u[:-1], t[:-1], dt)])

    def get_jf_diag(u, dt):
        u, dt = on(u), on(dt)
        t = times_from_dt(dt, t0)
        d_step = torch.func.vmap(torch.func.grad(lambda x, tt, dd: step(x, tt, dd)))
        return d_step(u[:-1], t[:-1], dt)

    def get_k(u, dt):
        return fnl.get_k(functional, on(u), on(dt))

    def forward_solve(dt, u0=None):
        return forward_march(step, problem.u0 if u0 is None else u0, on(dt), t0)

    def adjoint_solve(dt, u):
        dt, u = on(dt), on(u)
        dt_fine = refine_all(dt, rf)
        u_fine = interp_to_fine(u, dt, dt_fine, t0)
        return adjoint_march(step, u_fine, dt_fine, get_k(u_fine, dt_fine), t0)

    def error_estimate(dt, u, v):
        dt, u, v = on(dt), on(u), on(v)
        dt_fine = refine_all(dt, rf)
        u_fine = interp_to_fine(u, dt, dt_fine, t0)
        res = residual(step, u_fine, dt_fine, t0)
        return coarse_indicator(res * v, rf, "strided")

    def adapt(times, err_steps):
        return bisect_refine(on(times), on(err_steps))

    exact_adj = None
    if ode.exact_fwd is not None and functional.g_u is not None:
        def exact_adj(t_eval):
            return odes.exact_adjoint_rk4(ode, functional.g_u, on(t_eval), problem.u0, t1,
                                          functional.terminal)

    return Funs(
        fwd_update=step,
        get_f=get_f,
        get_jf_diag=get_jf_diag,
        get_k=get_k,
        exact_fwd=ode.exact_fwd,
        exact_adj=exact_adj,
        forward_solve=forward_solve,
        adjoint_solve=adjoint_solve,
        error_estimate=error_estimate,
        adapt=adapt,
    )
