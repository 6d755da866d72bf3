"""Adaptivity policies: argmax bisection of the time grid and coarsening.

Counterpart of the JAX package's ``adapt/policy.py`` (bisection insert:
python/Main_finite_difference.py:336-343). The padded forms keep a fixed
grid length: active nodes ``0..n_active``, padding repeating the final time
so that its steps have zero width (exact identities downstream). They work
on the last axis and accept leading member axes, so one call refines every
member of a per-member study. ``torch.argmax`` returns the first maximum,
as ``jnp.argmax`` does. The NN strand's triggers are here too: the
plateau test on a loss window and the width-vs-depth test.
"""
from __future__ import annotations

import torch

__all__ = [
    "pad_times",
    "bisect_refine",
    "bisect_refine_padded",
    "bisect_refine_masked",
    "bisect_refine_padded_masked",
    "coarsen_merge",
    "coarsen_merge_padded",
    "plateau_detect",
    "should_refine_depth",
]


def pad_times(times: torch.Tensor, max_nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a node-time vector to ``max_nodes`` by repeating the final time.
    Returns (times_padded, n_active) with ``n_active`` the real step count."""
    n_nodes = times.shape[0]
    if n_nodes > max_nodes:
        raise ValueError(f"times has {n_nodes} nodes > max_nodes={max_nodes}")
    pad = times[-1:].expand(max_nodes - n_nodes)
    n_active = torch.tensor(n_nodes - 1, dtype=torch.int32, device=times.device)
    return torch.cat([times, pad]), n_active


def _insert(times, ref_idx):
    """``times`` with the midpoint of (times[ref_idx−1], times[ref_idx])
    inserted at ``ref_idx`` (last axis, fixed length: the last entry drops)."""
    mid = (times.gather(-1, ref_idx - 1) + times.gather(-1, ref_idx)) / 2.0
    idx = torch.arange(times.shape[-1], device=times.device)
    shifted = torch.cat([times[..., :1], times[..., :-1]], dim=-1)  # times[max(idx−1, 0)]
    return torch.where(idx < ref_idx, times, torch.where(idx == ref_idx, mid, shifted))


def bisect_refine(times: torch.Tensor, err_steps: torch.Tensor) -> torch.Tensor:
    """Dynamic-shape bisection: insert the midpoint of step argmax(err)
    (Main_finite_difference.py:336-341); the grid grows by one node."""
    ref_idx = int(torch.argmax(err_steps)) + 1
    mid = (times[ref_idx - 1] + times[ref_idx]) / 2.0
    return torch.cat([times[:ref_idx], mid[None], times[ref_idx:]])


def bisect_refine_padded(times: torch.Tensor, n_active: torch.Tensor, err_steps: torch.Tensor):
    """Fixed-length bisection on a padded grid: ``times`` (..., max_nodes),
    ``n_active`` (...), ``err_steps`` (..., max_nodes−1) with zeros on the
    padding. A full grid (n_active + 2 > max_nodes) is a guarded no-op.
    Returns (times_new, n_active_new)."""
    max_nodes = times.shape[-1]
    ref_idx = torch.argmax(err_steps, dim=-1, keepdim=True) + 1
    new = _insert(times, ref_idx)
    do = n_active + 2 <= max_nodes
    return torch.where(do[..., None], new, times), n_active + do.to(n_active.dtype)


def bisect_refine_masked(times: torch.Tensor, err_steps: torch.Tensor, blocked_mask: torch.Tensor):
    """Bisection with intervals masked out (backtrack schedules). Returns
    (new_times, interval) with ``interval`` the index that was bisected."""
    masked = torch.where(blocked_mask, torch.full_like(err_steps, -torch.inf), err_steps)
    interval = int(torch.argmax(masked))
    ref_idx = interval + 1
    mid = (times[ref_idx - 1] + times[ref_idx]) / 2.0
    return torch.cat([times[:ref_idx], mid[None], times[ref_idx:]]), interval


def bisect_refine_padded_masked(times, n_active, err_steps, blocked):
    """Fixed-length masked bisection (1-D grid): argmax over active,
    unblocked intervals; the blocked mask shifts with the insert (both
    children start unblocked). A full grid is a guarded no-op.
    Returns (times_new, n_active_new, blocked_new, interval)."""
    max_nodes = times.shape[0]
    step_idx = torch.arange(max_nodes - 1, device=times.device)
    valid = (step_idx < n_active) & ~blocked
    masked = torch.where(valid, err_steps, torch.full_like(err_steps, -torch.inf))
    interval = torch.argmax(masked)
    times_new = _insert(times, (interval + 1).reshape(1))
    shifted_b = torch.cat([blocked[:1], blocked[:-1]])
    blocked_new = torch.where(step_idx <= interval, blocked, shifted_b)
    blocked_new = torch.where(step_idx == interval + 1, torch.zeros_like(blocked), blocked_new)
    do = n_active + 2 <= max_nodes
    return (
        torch.where(do, times_new, times),
        n_active + do.to(n_active.dtype),
        torch.where(do, blocked_new, blocked),
        interval,
    )


def coarsen_merge_padded(times, n_active, err_steps, blocked, coarsen_tol: float):
    """Fixed-length coarsening: merge the adjacent active step pair with the
    smallest combined contribution when it is below ``coarsen_tol`` (the
    rest shifts left by one; padding still repeats the final time).
    Returns (times_new, n_active_new, blocked_new, merged)."""
    max_nodes = times.shape[0]
    step_idx = torch.arange(max_nodes - 1, device=times.device)
    pair_valid = step_idx + 1 < n_active
    nxt = err_steps[torch.clamp(step_idx + 1, max=max_nodes - 2)]
    inf = torch.full_like(err_steps, torch.inf)
    pair_sums = torch.where(pair_valid, err_steps + torch.where(pair_valid, nxt, inf), inf)
    k = torch.argmin(pair_sums)
    do = (pair_sums[k] < coarsen_tol) & (n_active >= 2)
    idx = torch.arange(max_nodes, device=times.device)
    shifted_t = torch.cat([times[1:], times[-1:]])  # times[min(idx+1, max)]
    times_new = torch.where(do, torch.where(idx <= k, times, shifted_t), times)
    shifted_b = torch.cat([blocked[1:], blocked[-1:]])
    blocked_new = torch.where(step_idx < k, blocked, shifted_b)
    blocked_new = torch.where(step_idx == k, torch.zeros_like(blocked), blocked_new)
    blocked_new = torch.where(do, blocked_new, blocked)
    return times_new, n_active - do.to(n_active.dtype), blocked_new, do


def coarsen_merge(times: torch.Tensor, err_steps: torch.Tensor, coarsen_tol: float) -> torch.Tensor:
    """Remove the interior node between the two adjacent steps with the
    smallest combined contribution when that sum is below ``coarsen_tol``
    (the reference never coarsens). Returns the possibly shortened grid."""
    if err_steps.shape[0] < 2:
        return times
    pair_sums = err_steps[:-1] + err_steps[1:]
    k = int(torch.argmin(pair_sums))
    if float(pair_sums[k]) >= coarsen_tol:
        return times
    return torch.cat([times[: k + 1], times[k + 2 :]])


def plateau_detect(loss_hist: torch.Tensor, min_loss, ref_tol: float = 5e-5):
    """Quadratic-fit plateau test on the log-loss window: refine when |c2|
    and |c1| of the degree-2 least-squares fit of log(loss) against the epoch
    index are below ``ref_tol`` and the window's mean is a new floor
    (Main_no_matrix_detect_complex.py:274-282). The fit is ``jnp.polyfit``'s:
    the Vandermonde columns scaled to unit norm, an SVD least-squares solve
    with rcond = n·eps, the scale divided back out. Returns (refine,
    new_min_loss)."""
    n = loss_hist.shape[0]
    x = torch.arange(n, dtype=loss_hist.dtype, device=loss_hist.device)
    lhs = torch.stack([x**2, x, torch.ones_like(x)], dim=1)
    scale = torch.sqrt(torch.sum(lhs * lhs, dim=0))
    rcond = n * torch.finfo(loss_hist.dtype).eps
    coeffs = _lstsq_svd(lhs / scale, torch.log(loss_hist), rcond) / scale
    flat = (torch.abs(coeffs[0]) < ref_tol) & (torch.abs(coeffs[1]) < ref_tol)
    mean_loss = torch.mean(loss_hist)
    min_loss = torch.as_tensor(min_loss, dtype=loss_hist.dtype, device=loss_hist.device)
    refine = flat & (min_loss > mean_loss)
    return refine, torch.where(refine, mean_loss, min_loss)


def _lstsq_svd(a: torch.Tensor, b: torch.Tensor, rcond: float) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, singular values below
    rcond·s_max dropped (``jnp.linalg.lstsq``)."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return vh.T @ (s_inv * (u.T @ b))


def should_refine_depth(loss_hist: torch.Tensor, rel_tol: float = 0.1) -> torch.Tensor:
    """Depth (vs width) trigger: the relative loss improvement over the
    window is below ``rel_tol`` (Main_width_ref.py:487-500)."""
    return (loss_hist[0] - loss_hist[-1]) / loss_hist[0] < rel_tol
