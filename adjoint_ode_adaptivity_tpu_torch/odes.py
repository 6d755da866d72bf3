"""ODE problem registry: right-hand sides, closed-form Jacobians, exact primal
solutions, and the exact continuous adjoint for verification.

Counterpart of the JAX package's ``odes.py``. Every scalar entry carries a
closed-form ``f_u`` (the JAX package differentiates the ones it leaves out
by AD) and a ``kernel_id`` naming its device functor in ``csrc/odes.cuh``,
the header shared by the FD kernels (``csrc/fd_ensemble.cu``) and the DG
slab kernels (``csrc/dg_slab.cu``, ``csrc/dg_slab_mixed.cu``). An
``ODEProblem`` without a ``kernel_id`` runs on the kernels too: their entry
points trace its elementwise ``f`` (and ``f_u``, derived by forward mode
where it is ``None``) into a device functor (ops/cuda/functor.py), and
raise for a callable outside the tracer's op set.

``gaussian_mixture`` draws its constants from ``jax.random.PRNGKey(1/2/3)``
in the JAX package. The port holds those draws (taken with 64-bit floats,
``t_m`` reusing the ``u_m`` key as the reference does) as float64 literals;
:func:`gaussian_mixture_ode` builds the same ODE from any constants.

Exact adjoints: for ``u' = f(u, t)`` and ``J = ∫ g dt + h(u(T))`` the
continuous adjoint solves ``a' = −f_u(u(t), t)·a − g_u(u(t), t)`` backward
from ``a(T) = h_u(u(T))``; :func:`exact_adjoint_rk4` integrates it with
dense fixed-step RK4 along the exact primal.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = [
    "ODEProblem",
    "get_ode",
    "register_ode",
    "ODE_REGISTRY",
    "exact_adjoint_rk4",
    "gaussian_mixture_ode",
    "GAUSSIAN_MIXTURE_CONSTANTS",
    "KERNEL_IDS",
]

# device functors of csrc/odes.cuh (its AOA_ODE_SCALAR_SWITCH; 6 is the vector functor)
KERNEL_IDS = {
    "du/dt=u": 0,
    "du/dt=sin(u)": 1,
    "du/dt=cos(2*pi*u)": 2,
    "du/dt=10cos(u)": 3,
    "du/dt=t*sin(u)": 4,
    "gaussian_mixture": 5,
    "harmonic_oscillator": 6,
}


class ODEProblem(NamedTuple):
    """A scalar (or small-vector) ODE ``u' = f(u, t)`` with its oracles.

    ``kernel_params`` are the constants the device functor takes by value
    (the gaussian mixture's (u_m, u_s, t_m, t_s, c), each a tuple)."""

    name: str
    f: Callable  # f(u, t) -> du/dt
    exact_fwd: Callable | None = None  # exact_fwd(t, u0) -> u(t)
    f_u: Callable | None = None  # df/du, closed form
    linear: bool = False
    kernel_id: int | None = None  # None: the kernels trace f and f_u
    kernel_params: tuple = ()


ODE_REGISTRY: dict[str, ODEProblem] = {}


def register_ode(problem: ODEProblem) -> ODEProblem:
    ODE_REGISTRY[problem.name] = problem
    return problem


def get_ode(name: str) -> ODEProblem:
    return ODE_REGISTRY[name]


def _t_like(t, u: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=u.dtype, device=u.device)


def _oracle(x) -> torch.Tensor:
    """A tensor as given, a Python or NumPy number as a float64 tensor (the
    exact solutions are oracles: float32 inputs would cost them digits)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def _entry(name, f, f_u, exact_fwd=None, linear=False) -> ODEProblem:
    return register_ode(ODEProblem(name=name, f=f, exact_fwd=exact_fwd, f_u=f_u,
                                   linear=linear, kernel_id=KERNEL_IDS[name]))


# --- the reference's cases -------------------------------------------------

_entry(
    "du/dt=u",
    lambda u, t: u,
    lambda u, t: torch.ones_like(u),
    exact_fwd=lambda t, u0: _oracle(u0) * torch.exp(_oracle(t)),
    linear=True,
)

# u' = sin(u): exact solution 2·atan2(sin(u0/2) e^t, cos(u0/2))
# (python/Main_finite_difference.py:142-143)
_entry(
    "du/dt=sin(u)",
    lambda u, t: torch.sin(u),
    lambda u, t: torch.cos(u),
    exact_fwd=lambda t, u0: 2.0 * torch.atan2(
        torch.sin(_oracle(u0) / 2) * torch.exp(_oracle(t)), torch.cos(_oracle(u0) / 2)
    ),
)

# training-truth ODEs used by the NN drivers; f_u in closed form
_TWO_PI = 2 * math.pi
_entry(
    "du/dt=cos(2*pi*u)",
    lambda u, t: torch.cos(_TWO_PI * u),
    lambda u, t: -torch.sin(_TWO_PI * u) * _TWO_PI,
)
_entry("du/dt=10cos(u)", lambda u, t: 10.0 * torch.cos(u), lambda u, t: -10.0 * torch.sin(u))
_entry(
    "du/dt=t*sin(u)",
    lambda u, t: _t_like(t, u) * torch.sin(u),
    lambda u, t: _t_like(t, u) * torch.cos(u),
)


# The JAX package's draws (jax.random.normal under 64-bit floats):
# u_m = N(key 1, 5); u_s = |N(key 2, 5)/3 + 1|; t_m = |N(key 1, 3)/6 + 0.5|;
# t_s = |N(key 2, 3)/3 + 1|; c = N(key 3, 8)
GAUSSIAN_MIXTURE_CONSTANTS = {
    "u_m": (-1.184284421837855, -0.11617040844628398, 0.17269028009903425,
            0.9573071790540392, -0.8329541450744178),
    "u_s": (0.9361281448600851, 0.6522137473730625, 1.1428383198876462,
            0.9483049126118845, 0.7667398019394333),
    "t_m": (0.30261926302702413, 0.48063826525895265, 0.528781713349839),
    "t_s": (0.9361281448600851, 0.6522137473730625, 1.1428383198876462),
    "c": (1.1048739767803086, -0.11756943795234803, -0.7110143201629989,
          -0.8265806018037718, -0.475055842352611, 0.18600443975337544,
          1.0889371633802944, 0.2960732848789476),
}


def gaussian_mixture_ode(u_m=None, u_s=None, t_m=None, t_s=None, c=None) -> ODEProblem:
    """The 'complex' test ODE: a Gaussian mixture in u (len(u_m) modes) and
    t (len(t_m) modes), mirroring ``python/Main_no_matrix_detect_complex.py:37-52``.
    Constants default to :data:`GAUSSIAN_MIXTURE_CONSTANTS`; ``c`` holds the
    u-mode weights, then the t-mode weights."""
    d = GAUSSIAN_MIXTURE_CONSTANTS
    consts = [
        tuple(float(x) for x in (d[k] if v is None else v))
        for k, v in (("u_m", u_m), ("u_s", u_s), ("t_m", t_m), ("t_s", t_s), ("c", c))
    ]
    um, us, tm, ts, cc = consts
    n_u = len(um)
    if len(us) != n_u or len(ts) != len(tm) or len(cc) != n_u + len(tm):
        raise ValueError("gaussian mixture: inconsistent constant lengths")

    def gaussian(x, m, s):
        return torch.exp(-((x - m) ** 2) / (2 * s**2)) / torch.sqrt(2 * math.pi * s**2)

    def vec(v, like):
        return torch.tensor(v, dtype=like.dtype, device=like.device)

    def f(u, t):
        tt = _t_like(t, u)
        in_u = torch.sum(vec(cc[:n_u], u) * gaussian(u[..., None], vec(um, u), vec(us, u)), dim=-1)
        in_t = torch.sum(vec(cc[n_u:], u) * gaussian(tt[..., None], vec(tm, u), vec(ts, u)), dim=-1)
        return in_u + in_t

    def f_u(u, t):
        m, s = vec(um, u), vec(us, u)
        x = u[..., None]
        return torch.sum(vec(cc[:n_u], u) * gaussian(x, m, s) * (-(x - m) / s**2), dim=-1)

    return ODEProblem(
        name="gaussian_mixture", f=f, f_u=f_u, kernel_id=KERNEL_IDS["gaussian_mixture"],
        kernel_params=tuple(consts),
    )


register_ode(gaussian_mixture_ode())


# vector-state system: harmonic oscillator u'' = −ω²u as a 2-vector ODE
_OMEGA = 2.0


def _harmonic_f(u, t):
    return torch.stack([u[..., 1], -(_OMEGA**2) * u[..., 0]], dim=-1)


def _harmonic_exact(t, u0):
    t, u0 = _oracle(t), _oracle(u0)
    return torch.stack(
        [
            u0[..., 0] * torch.cos(2.0 * t) + u0[..., 1] / 2.0 * torch.sin(2.0 * t),
            -2.0 * u0[..., 0] * torch.sin(2.0 * t) + u0[..., 1] * torch.cos(2.0 * t),
        ],
        dim=-1,
    )


register_ode(
    ODEProblem(
        name="harmonic_oscillator",
        f=_harmonic_f,
        exact_fwd=_harmonic_exact,
        # Jacobian ∂f_m/∂u_i (constant): [[0, 1], [−ω², 0]]
        f_u=lambda u, t: torch.tensor([[0.0, 1.0], [-(_OMEGA**2), 0.0]],
                                      dtype=u.dtype, device=u.device),
        linear=True,
        kernel_id=KERNEL_IDS["harmonic_oscillator"],
    )
)


# --- exact continuous adjoint by dense backward RK4 ------------------------


def exact_adjoint_rk4(
    ode: ODEProblem,
    g_u: Callable,
    t_eval: torch.Tensor,
    u0,
    t_end: float,
    terminal: float = 0.0,
    n_sub: int = 512,
) -> torch.Tensor:
    """Continuous adjoint a(t) of J = ∫ g(u) dt [+ terminal·u(T)] along the
    exact primal, evaluated at ``t_eval``: ``n_sub`` RK4 steps backward from
    ``t_end`` to min(t_eval) on a uniform grid, then linear interpolation.
    Requires ``ode.exact_fwd`` and ``ode.f_u`` (scalar state)."""
    from adjoint_ode_adaptivity_tpu_torch.adjoint.estimate import interp

    if ode.exact_fwd is None:
        raise ValueError(f"ODE {ode.name} has no exact solution")
    t_eval = torch.as_tensor(t_eval)
    dtype = t_eval.dtype if t_eval.is_floating_point() else torch.get_default_dtype()

    def rhs(a, t):
        u = ode.exact_fwd(t, u0)
        return -ode.f_u(u, t) * a - g_u(u, t)

    ts = torch.linspace(t_end, float(torch.min(t_eval)), n_sub + 1, dtype=dtype,
                        device=t_eval.device)
    h = ts[1] - ts[0]  # negative
    a = torch.as_tensor(terminal, dtype=dtype, device=t_eval.device)
    grid = [a]
    for t in ts[:-1]:
        k1 = rhs(a, t)
        k2 = rhs(a + 0.5 * h * k1, t + 0.5 * h)
        k3 = rhs(a + 0.5 * h * k2, t + 0.5 * h)
        k4 = rhs(a + h * k3, t + h)
        a = a + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        grid.append(a)
    # ts is decreasing; flip for the interpolation
    return interp(t_eval.to(dtype), ts.flip(0), torch.stack(grid).flip(0))
