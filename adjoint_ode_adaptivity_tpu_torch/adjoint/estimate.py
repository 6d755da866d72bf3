"""Grid refinement, trajectory interpolation, and the adjoint-weighted
residual error estimate.

Counterpart of the JAX package's ``adjoint/estimate.py``:
- :func:`refine_all` splits every coarse step into ``ref_factor`` equal
  fine steps (``refineAll``, python/Main_finite_difference.py:16-21);
- :func:`interp_to_fine` linearly interpolates the coarse primal onto the
  fine grid with :func:`interp`, which computes exactly what
  ``jnp.interp`` computes — including on padded grids, whose repeated final
  time makes zero-width coarse intervals (no slope is formed there);
- :func:`residual` is the fine one-step residual, :func:`error_estimate`
  weights it by the adjoint (``errEst``, Main_finite_difference.py:79-94);
- :func:`coarse_indicator` collapses fine contributions per coarse step in
  the reference's two conventions: ``"strided"`` (|err|[2:] in windows of
  rf−1 at stride rf, Main_finite_difference.py:270-277) and ``"block"``
  (signed block sums, then abs; ``errorIndicator``, Main_new_loss.py:123-135).

Time is axis 0. A 1-D ``dt`` is one grid shared by every trailing column of
the state; a 2-D ``dt`` of shape (N, B) gives each column its own grid (the
members of a per-member study).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from adjoint_ode_adaptivity_tpu_torch.march.fd import _index, times_from_dt

__all__ = [
    "interp",
    "refine_all",
    "interp_to_fine",
    "residual",
    "error_estimate",
    "coarse_indicator",
]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` along axis 0, operation for operation:
    i = clip(searchsorted(xp, x, right), 1, M−1); where |dx| ≤ spacing(eps)
    the value is fp[i−1], else fp[i−1] + (x − xp[i−1])/dx · (fp[i] − fp[i−1]);
    clamped to fp[0] / fp[−1] outside [xp[0], xp[−1]].

    1-D ``xp`` (M,): ``x`` (P,), ``fp`` (M, ...) — trailing axes of ``fp``
    are interpolated on the shared grid. 2-D ``xp`` (M, B): ``x`` (P, B)
    and ``fp`` (M, B), one grid per column."""
    m = xp.shape[0]
    if xp.dim() == 1:
        i = torch.searchsorted(xp, x, right=True).clamp(1, m - 1)
        shape = (-1,) + (1,) * (fp.dim() - 1)
        x_, xp_hi, xp_lo = x.reshape(shape), xp[i].reshape(shape), xp[i - 1].reshape(shape)
        fp_hi, fp_lo = fp[i], fp[i - 1]
        x_lo_edge, x_hi_edge = x.reshape(shape) < xp[0], x.reshape(shape) > xp[-1]
        f_first, f_last = fp[0], fp[-1]
    else:
        i = torch.searchsorted(xp.T.contiguous(), x.T.contiguous(), right=True).T
        i = i.clamp(1, m - 1)
        x_, xp_hi, xp_lo = x, xp.gather(0, i), xp.gather(0, i - 1)
        fp_hi, fp_lo = fp.gather(0, i), fp.gather(0, i - 1)
        x_lo_edge, x_hi_edge = x < xp[:1], x > xp[-1:]
        f_first, f_last = fp[:1], fp[-1:]
    df = fp_hi - fp_lo
    dx = xp_hi - xp_lo
    delta = x_ - xp_lo
    # np.spacing(eps) of a binary float is eps² (eps is a power of two)
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, fp_lo, fp_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x_lo_edge, f_first, f)
    return torch.where(x_hi_edge, f_last, f)


def refine_all(dt: torch.Tensor, ref_factor: int) -> torch.Tensor:
    """Uniformly split each step (axis 0) into ``ref_factor`` fine steps."""
    return torch.repeat_interleave(dt / ref_factor, ref_factor, dim=0)


def interp_to_fine(u: torch.Tensor, dt: torch.Tensor, dt_fine: torch.Tensor, t0=0.0) -> torch.Tensor:
    """Linear interpolation of nodal values from the coarse to the fine grid.
    ``u`` is (N+1,) or (N+1, d) on a 1-D grid, or (N+1, B) on per-column
    grids ``dt`` (N, B)."""
    return interp(times_from_dt(dt_fine, t0), times_from_dt(dt, t0), u)


def residual(
    step_fn: Callable,
    u_fine: torch.Tensor,
    dt_fine: torch.Tensor,
    t0=0.0,
    params_stacked: Any = None,
) -> torch.Tensor:
    """One-step residual res[n] = u[n] − G(u[n−1]) on the fine grid
    (res[0] = 0). With ``params_stacked``, step n applies its parameters."""
    t_fine = times_from_dt(dt_fine, t0)
    if params_stacked is None:
        res = u_fine[1:] - step_fn(u_fine[:-1], _col(t_fine[:-1], u_fine), _col(dt_fine, u_fine))
    else:
        res = torch.stack([
            u_fine[n + 1] - step_fn(u_fine[n], t_fine[n], dt_fine[n], _index(params_stacked, n))
            for n in range(dt_fine.shape[0])
        ])
    return torch.cat([torch.zeros_like(u_fine[:1]), res])


def _col(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-node vector against trailing state axes: (N,) against
    (N, d) becomes (N, 1)."""
    return x.reshape(x.shape + (1,) * (u.dim() - x.dim()))


def error_estimate(res: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Adjoint-weighted residual per fine node: err = res ⊙ v."""
    return res * v


def coarse_indicator(err_fine: torch.Tensor, ref_factor: int, convention: str = "strided") -> torch.Tensor:
    """Collapse fine-node contributions (length n_coarse·rf + 1 on axis 0,
    entry 0 unused) to one value per coarse step."""
    rf = ref_factor
    n_coarse = (err_fine.shape[0] - 1) // rf
    rest = err_fine.shape[1:]
    if convention == "strided":
        # |err|[2:] → windows of rf−1 at stride rf: step i sums
        # |err_fine|[i·rf+2 .. i·rf+rf]
        x = torch.abs(err_fine)
        x = torch.cat([x[2:], torch.zeros_like(x[:1])])
        rows = x[: n_coarse * rf].reshape(n_coarse, rf, *rest)
        return torch.sum(rows[:, : rf - 1], dim=1)
    if convention == "block":
        # signed sums err_fine[i·rf+1 .. (i+1)·rf], then abs
        rows = err_fine[1:].reshape(n_coarse, rf, *rest)
        return torch.abs(torch.sum(rows, dim=1))
    raise ValueError(f"unknown convention {convention!r}")
