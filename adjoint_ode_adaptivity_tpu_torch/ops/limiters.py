"""Slope limiters for nodal DG (minmod, TVB minmod, Pi^1 and Pi^N limiters).

Reference parity: ``utils/minmod.m``, ``utils/minmodB.m``,
``utils/SlopeLimitLin.m``, ``utils/SlopeLimit1.m``, ``utils/SlopeLimitN.m``.
Counterpart of the JAX package's ``ops/limiters.py``; the tests hold the two
to 1e-14 in float64.

Vectorised over elements: the limited reconstruction is computed for every
element and blended with a per-element mask (no troubled-cell index lists).
The operators ``v``, ``inv_v``, ``dr`` and the nodes ``x`` come in as tensors
on the state's device and dtype. The neighbour cell averages copy the
endpoints at the global ends (``utils/SlopeLimitN.m``), whatever the flux's
boundary condition.
"""
from __future__ import annotations

import torch

__all__ = ["minmod", "minmod_tvb", "slope_limit_lin", "slope_limit_1", "slope_limit_n"]

EPS0 = 1.0e-8  # the troubled-cell threshold of utils/SlopeLimitN.m


def minmod(v: torch.Tensor) -> torch.Tensor:
    """Minmod along dim 0: sign-unanimous minimum magnitude, else 0.

    ``v`` is (m, K); returns (K,).
    """
    s = torch.sum(torch.sign(v), dim=0) / v.shape[0]
    unanimous = torch.abs(s) == 1.0
    return torch.where(unanimous, s * torch.min(torch.abs(v), dim=0).values, torch.zeros_like(s))


def minmod_tvb(v: torch.Tensor, m_const: float, h: torch.Tensor) -> torch.Tensor:
    """TVB-modified minmod: pass the first argument through when it is small
    relative to M·h² (Shu's TVB trick), else fall back to minmod."""
    mfunc = v[0]
    small = torch.abs(mfunc) <= m_const * h**2
    return torch.where(small, mfunc, minmod(v))


def _cell_averages(u: torch.Tensor, v: torch.Tensor, inv_v: torch.Tensor) -> torch.Tensor:
    """Cell averages via the mean mode: keep only modal coefficient 0."""
    uh0 = (inv_v @ u)[0:1, :]
    return (v[:, 0:1] @ uh0)[0]


def slope_limit_lin(ul, xl, vm1, v0, vp1, dr) -> torch.Tensor:
    """Limit a piecewise-linear field to the minmod of its slope and the
    neighbour cell-average differences (``utils/SlopeLimitLin.m``)."""
    h = xl[-1, :] - xl[0, :]
    x0 = xl[0, :] + h / 2
    ux = (2.0 / h) * (dr @ ul)[0, :]
    slope = minmod(torch.stack([ux, (vp1 - v0) / h, (v0 - vm1) / h]))
    return v0[None, :] + (xl - x0[None, :]) * slope[None, :]


def _neighbor_averages(vk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Left/right neighbour cell averages with copied-endpoint boundaries."""
    vkm1 = torch.cat([vk[:1], vk[:-1]])
    vkp1 = torch.cat([vk[1:], vk[-1:]])
    return vkm1, vkp1


def _linear_part(u, v, inv_v):
    """u projected onto the linear modes (modes 2.. zeroed)."""
    uh = inv_v @ u
    if uh.shape[0] > 2:
        uh = torch.cat([uh[:2], torch.zeros_like(uh[2:])])
    return v @ uh


def slope_limit_1(u, x, v, inv_v, dr) -> torch.Tensor:
    """Pi^1 limiter: project every element to linear, then slope-limit."""
    vk = _cell_averages(u, v, inv_v)
    vkm1, vkp1 = _neighbor_averages(vk)
    return slope_limit_lin(_linear_part(u, v, inv_v), x, vkm1, vk, vkp1, dr)


def slope_limit_n(u, x, v, inv_v, dr) -> torch.Tensor:
    """Pi^N limiter: detect troubled cells via minmod reconstruction of the
    endpoint values, and replace only those cells with the limited linear
    solution (``utils/SlopeLimitN.m``)."""
    vk = _cell_averages(u, v, inv_v)
    vkm1, vkp1 = _neighbor_averages(vk)
    ue1, ue2 = u[0, :], u[-1, :]
    ve1 = vk - minmod(torch.stack([vk - ue1, vk - vkm1, vkp1 - vk]))
    ve2 = vk + minmod(torch.stack([ue2 - vk, vk - vkm1, vkp1 - vk]))
    troubled = (torch.abs(ve1 - ue1) > EPS0) | (torch.abs(ve2 - ue2) > EPS0)
    limited = slope_limit_lin(_linear_part(u, v, inv_v), x, vkm1, vk, vkp1, dr)
    return torch.where(troubled[None, :], limited, u)
