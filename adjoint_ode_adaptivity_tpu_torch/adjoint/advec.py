"""Adjoint of the DG advection march + goal-oriented error estimate (eager).

The advection march (march/advec.py) is *affine* in the state (the inflow BC
contributes a constant): its linearisation is the homogeneous operator L, and
the discrete adjoint of ``u_{n+1} = L u_n + b_n`` is the reverse march
``λ_n = Lᵀ λ_{n+1}``. torch has no ``jax.linear_transpose``, so the transpose
of one homogeneous LSRK step is written out here (after the JAX package's
``ops/pallas/dg_rhs.py::_lsrk_step_t_b``): the five stages run reversed, and
the transposed RHS (:func:`advec_rhs_t`) turns each ±1 circular element
shift of a face trace into the ∓1 shift. The tests hold it to
⟨Lv, w⟩ = ⟨v, Lᵀw⟩ and to ``torch.func.vjp``.

Memory: two-level (segmented) checkpointing — the forward pass keeps one
state per segment, the adjoint pass recomputes each segment before its
reverse sweep.

Error estimate: per-element adjoint-weighted residual of the time
discretisation, with the residual measured by step doubling,
``r_n = u_{n+1} − Φ_{dt/2}(Φ_{dt/2}(u_n))`` and
``η_k = Σ_n Σ_nodes λ_{n+1} ⊙ r_n`` restricted to element k.

λ is propagated by the transpose of the **fine** propagator B = Φ_{dt/2}²,
not the coarse step: with ``λ_n = Bᵀ λ_{n+1}`` the identity
``J(u_N) − J(û_N) = Σ_n λ_{n+1}ᵀ r_n`` is exact for this affine march
(effectivity to roundoff). The coarse transpose (``fine_adjoint=False``) is
a first-order estimate only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch.march.advec import (
    AdvecOperators,
    lsrk_stages,
)
from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D
from adjoint_ode_adaptivity_tpu_torch.ops.operators import mass_matrix

__all__ = [
    "lsrk_step",
    "lsrk_step_homogeneous",
    "advec_rhs_t",
    "lsrk_step_homogeneous_t",
    "advec_adjoint_march",
    "terminal_integral_cotangent",
    "AdvecAdjointResult",
    "advec_fwd_adj_estimate",
]


def lsrk_step(ops: AdvecOperators, u: torch.Tensor, t: float, dt: float) -> torch.Tensor:
    """One full 5-stage LSRK4 step of the advection semidiscretization."""
    return lsrk_stages(ops, u, t, dt, inflow=True)


def lsrk_step_homogeneous(ops: AdvecOperators, u: torch.Tensor, dt: float) -> torch.Tensor:
    """The homogeneous (linear) part L of one LSRK step: the BC forcing
    ``uin`` is frozen at zero, so L is the state-linear map whose transpose
    is the adjoint step."""
    return lsrk_stages(ops, u, 0.0, dt, inflow=False)


def advec_rhs_t(ops: AdvecOperators, w: torch.Tensor) -> torch.Tensor:
    """Transpose of the homogeneous RHS ``advec_rhs(ops, ·, t, inflow=False)``.

    Forward faces: du_left[k] = f0[k]·(u[0,k] − u[-1,k−1]) (k ≥ 1; no
    neighbour at k = 0) and du_right[k] = f1[k]·(u[-1,k] − u[0,k+1])
    (k ≤ K−2; zero at k = K−1). Their cotangents g0, g1 scatter back onto
    the own face node and, shifted the other way, onto the neighbour's.
    """
    vol = ops.dr.T @ (-ops.a * ops.rx * w)
    g = ops.fscale * (ops.lift.T @ w) * ops.flux_fac  # (2, K)
    g0 = g[0]
    g1 = torch.cat([g[1, :-1], torch.zeros_like(g[1, :1])])  # outflow face: 0
    d_left = g0 - torch.cat([torch.zeros_like(g1[:1]), g1[:-1]])
    d_right = g1 - torch.cat([g0[1:], torch.zeros_like(g0[:1])])
    out = vol.clone()
    out[0] += d_left
    out[-1] += d_right
    return out


def lsrk_step_homogeneous_t(ops: AdvecOperators, lam: torch.Tensor, dt: float) -> torch.Tensor:
    """Lᵀ λ for one homogeneous LSRK step: the stages in reverse order.

    Forward stage s: r ← A_s·r + dt·R u; u ← u + B_s·r. Its transpose, with
    cotangents (λu, λr): w = B_s·λu + λr; λu ← λu + dt·Rᵀw; λr ← A_s·w.
    λr is zero at the step boundary (A_0 = 0)."""
    lu = lam
    lr = torch.zeros_like(lam)
    for s in (4, 3, 2, 1, 0):
        w = float(RK4B[s]) * lu + lr
        lr = float(RK4A[s]) * w
        lu = lu + dt * advec_rhs_t(ops, w)
    return lu


def terminal_integral_cotangent(
    disc: Discretization1D, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """∂J/∂u_nodal for J = ∫_Ω u(x, T) dx: per-element J·(M_ref @ 1), on
    ``device`` (the card unless the caller asks for the CPU)."""
    m1 = mass_matrix(disc.v).sum(axis=1)
    return torch.as_tensor(disc.jac * m1[:, None], dtype=dtype, device=require_device(device))


def advec_adjoint_march(
    ops: AdvecOperators, lam_end: torch.Tensor, dt: float, n_steps: int
) -> torch.Tensor:
    """Pure adjoint sweep λ_0 = (Lᵀ)ⁿ λ_N (no residual weighting)."""
    lam = lam_end
    for _ in range(n_steps):
        lam = lsrk_step_homogeneous_t(ops, lam, dt)
    return lam


class AdvecAdjointResult(NamedTuple):
    u_final: torch.Tensor  # forward terminal state (Np, K)
    lam0: torch.Tensor  # adjoint at t=0 (Np, K)
    eta: torch.Tensor  # per-element error contributions (K,)
    j_value: torch.Tensor  # J(u(T)) = ∫ u dx


def advec_fwd_adj_estimate(
    ops: AdvecOperators,
    disc: Discretization1D,
    u0: torch.Tensor,
    dt: float,
    n_steps: int,
    segment: int = 256,
    t0: float = 0.0,
    lam_end: torch.Tensor | None = None,
    fine_adjoint: bool = True,
) -> AdvecAdjointResult:
    """Forward march + adjoint sweep + adjoint-weighted step-doubling error
    estimate, with two-level checkpointing.

    ``n_steps`` must be a multiple of ``segment``. ``lam_end`` is ∂J/∂u(T);
    it defaults to the full-domain terminal integral J = ∫ u(x,T) dx.

    ``fine_adjoint=True`` (default) propagates λ with the transpose of the
    half-step-squared propagator, making ``Σ η == J(u_dt) − J(u_dt/2)``
    exact to roundoff. ``False`` uses the coarse transpose.
    """
    if n_steps % segment != 0:
        raise ValueError(f"n_steps={n_steps} not a multiple of segment={segment}")
    n_seg = n_steps // segment
    dt = float(dt)

    # ---- forward: keep one state per segment
    seg_starts = []
    u = u0
    for si in range(n_seg):
        seg_starts.append(u)
        for i in range(segment):
            u = lsrk_step(ops, u, t0 + (si * segment + i) * dt, dt)
    u_final = u

    lam = (
        terminal_integral_cotangent(disc, u0.dtype, u0.device)
        if lam_end is None
        else lam_end
    )
    j_value = torch.sum(lam * u_final)

    if fine_adjoint:

        def step_t(v):
            v = lsrk_step_homogeneous_t(ops, v, dt / 2)
            return lsrk_step_homogeneous_t(ops, v, dt / 2)

    else:

        def step_t(v):
            return lsrk_step_homogeneous_t(ops, v, dt)

    eta = torch.zeros(u0.shape[1], dtype=u0.dtype, device=u0.device)
    for si in reversed(range(n_seg)):
        # recompute the segment's entry states; u_{n+1} rides the reverse loop
        us = []
        u = seg_starts[si]
        for i in range(segment):
            us.append(u)
            u = lsrk_step(ops, u, t0 + (si * segment + i) * dt, dt)
        u_np1 = u
        for i in reversed(range(segment)):
            u_n = us[i]
            t_n = t0 + (si * segment + i) * dt
            # step-doubling residual r = u_{n+1} − Φ_{dt/2}²(u_n)
            half = lsrk_step(ops, u_n, t_n, dt / 2)
            half2 = lsrk_step(ops, half, t_n + dt / 2, dt / 2)
            eta = eta + torch.sum(lam * (u_np1 - half2), dim=0)
            lam = step_t(lam)
            u_np1 = u_n
    return AdvecAdjointResult(u_final, lam, eta, j_value)
