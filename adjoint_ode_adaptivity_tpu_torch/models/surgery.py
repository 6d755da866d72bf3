"""Network surgery: depth insertion (time refinement ≡ a new layer) and width
growth (a neuron inserted at a poorly fit bias knot).

Counterpart of the JAX package's ``models/surgery.py``:

- depth (``adapt``, Main_variable_params.py:165-189): a new step's
  parameters at the refined index, a copy of the left neighbour
  (Main_width_ref.py:201) or 1e-8·normal noise; the caller builds a fresh
  optimizer state;
- width (``adaptWidth``, Main_width_ref.py:225-312): bin the samples by the
  nearest sorted bias, take each bin's mean loss, insert a neuron (bias ← the
  bin's mean u, weights ← 1e-5) where it exceeds the tolerance.

Stacked parameters carry the step axis first. The padded forms keep every
shape: a fixed depth (zero-dt padding steps) or a fixed neuron capacity with
an active count, the sorted active knots first. ``segment_sum`` becomes
``index_add``; ``argmax``/``argmin`` return the first extremum, as in JAX.
"""
from __future__ import annotations

from typing import Any

import torch

from adjoint_ode_adaptivity_tpu_torch.tree import tree_leaves, tree_map

__all__ = [
    "insert_step_params",
    "insert_step_params_padded",
    "bin_losses",
    "insert_neuron",
    "grow_width",
    "sort_neurons_padded",
    "layer_knot_losses",
    "bin_losses_padded",
    "insert_neuron_padded",
    "grow_width_padded",
    "grow_width_all_steps",
    "zero_step_moments",
]

_BIG = 1e30  # sentinel distance for inactive neuron slots


def insert_step_params(params_stacked: Any, idx: int, *, mode: str = "copy_left",
                       noise=None, noise_scale: float = 1e-8) -> Any:
    """Insert a new step's parameters at ``idx`` in every stacked leaf (depth
    + 1). ``mode`` 'copy_left' duplicates step idx−1; 'noise' takes
    ``noise_scale · noise(shape, dtype, device)``, ``noise`` returning unit
    normal draws (a ``torch.Generator``-backed callable, or the JAX draws in
    a parity test)."""
    def insert(leaf):
        if mode == "copy_left":
            new = leaf[max(idx - 1, 0)]
        elif mode == "noise":
            if noise is None:
                raise ValueError("mode='noise' needs noise(shape, dtype, device)")
            new = noise_scale * noise(leaf.shape[1:], leaf.dtype, leaf.device)
        else:
            raise ValueError(mode)
        return torch.cat([leaf[:idx], new[None], leaf[idx:]])

    return tree_map(insert, params_stacked)


def _bcast(flag: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return flag.reshape(flag.shape + (1,) * (leaf.dim() - flag.dim()))


def insert_step_params_padded(params_stacked: Any, n_active, idx, *, depth: int | None = None,
                              fill: str = "copy_left") -> Any:
    """Static-shape depth insertion: steps ≥ idx shift right by one (the last
    falls off) and slot idx is step idx−1 (``copy_left``) or zeros
    (``zero``: fresh moments). Leaves whose leading dim is not ``depth``
    (e.g. an optimizer's step count) pass through."""
    if depth is None:
        depth = max((l.shape[0] for l in tree_leaves(params_stacked) if l.dim() >= 1), default=0)

    def insert(leaf):
        if leaf.dim() < 1 or leaf.shape[0] != depth:
            return leaf
        pos = torch.arange(depth, device=leaf.device)
        shifted = leaf[torch.clamp(pos - 1, min=0)]
        out = torch.where(_bcast(pos < idx, leaf), leaf, shifted)
        if fill == "zero":
            out = torch.where(_bcast(pos == idx, leaf), torch.zeros_like(out), out)
        return out

    return tree_map(insert, params_stacked)


def _segment_sum(values: torch.Tensor, k: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=values.dtype, device=values.device).index_add_(0, k, values)


def _bins(u_samples, losses, bias, d):
    """Bin index k = i + (sign(u − b_i) > 0 ? 0 : −1) + 1, i the nearest knot
    under the distance table ``d`` (B, F); counts, mean u, mean loss."""
    i = torch.argmin(d, dim=1)
    sgn = torch.sign(u_samples - bias[i])
    k = i + torch.where(sgn > 0, 0, -1) + 1
    n_bins = bias.shape[0] + 1
    counts = _segment_sum(torch.ones_like(u_samples), k, n_bins)
    u_sum = _segment_sum(u_samples, k, n_bins)
    l_sum = _segment_sum(losses, k, n_bins)
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))
    return counts, u_sum / safe, l_sum / safe


def bin_losses(u_samples: torch.Tensor, losses: torch.Tensor, bias: torch.Tensor):
    """Counts, mean u and mean loss over len(bias)+1 bins of the nearest
    (sorted) knot (``fillBins`` + ``layerLoss``, Main_width_ref.py:148-159,
    214-222)."""
    return _bins(u_samples, losses, bias, torch.square(u_samples[:, None] - bias[None, :]))


def insert_neuron(bias, weights_in, weights_out, k, new_bias, new_weight: float = 1e-5):
    """Insert one neuron at bin ``k`` (shapes grow by one): bias[k] ←
    ``new_bias``, its W1 row and W2 column ← ``new_weight``
    (Main_width_ref.py:256-266)."""
    f = bias.shape[0]
    k = int(min(max(int(k), 0), f))
    new = torch.as_tensor(new_bias, device=bias.device).reshape(1)
    bias_new = torch.cat([bias[:k], new, bias[k:]])  # promotes, as jnp.concatenate does
    w_in_new = torch.cat([weights_in[:k], torch.full((1,) + weights_in.shape[1:], new_weight,
                                                     dtype=weights_in.dtype), weights_in[k:]])
    if weights_out is None:
        return bias_new, w_in_new, None
    w_out_new = torch.cat([weights_out[:, :k], torch.full(weights_out.shape[:1] + (1,), new_weight,
                                                          dtype=weights_out.dtype),
                           weights_out[:, k:]], dim=1)
    return bias_new, w_in_new, w_out_new


def grow_width(params: dict, u_samples, losses, *, tol: float = 5e-5, new_weight: float = 1e-5):
    """One ResBlockSimple layer's width step (d = 1): sort by bias, bin, and
    insert at the worst bin when its mean loss exceeds ``tol``. Returns
    (new_params, inserted)."""
    bias = params["bias"][:, 0]
    order = torch.argsort(bias, stable=True)
    bias, w1, w2 = bias[order], params["weights1"][order], params["weights2"][:, order]
    _, u_bins, l_bins = bin_losses(u_samples, losses, bias)
    k = int(torch.argmax(l_bins))
    if float(l_bins[k]) <= tol:
        return {"bias": bias[:, None], "weights1": w1, "weights2": w2}, False
    b_new, w1_new, w2_new = insert_neuron(bias, w1, w2, k, u_bins[k], new_weight)
    return {"bias": b_new[:, None], "weights1": w1_new, "weights2": w2_new}, True


def sort_neurons_padded(params_l: dict, n_active) -> dict:
    """One padded layer re-sorted: active slots first, ascending bias."""
    f = params_l["bias"].shape[0]
    active = torch.arange(f, device=params_l["bias"].device) < n_active
    key = torch.where(active, params_l["bias"][:, 0], torch.full_like(params_l["bias"][:, 0], _BIG))
    order = torch.argsort(key, stable=True)
    return {"bias": params_l["bias"][order], "weights1": params_l["weights1"][order],
            "weights2": params_l["weights2"][:, order]}


def _masked_distance(u_samples, bias, n_active):
    active = torch.arange(bias.shape[0], device=bias.device) < n_active
    d = torch.square(u_samples[:, None] - bias[None, :])
    return torch.where(active[None, :], d, torch.full_like(d, _BIG))


def layer_knot_losses(u_samples, bias, n_active):
    """Per sample, the squared distance to the nearest active knot
    (``layerLoss``, Main_width_ref.py:146-150)."""
    return torch.min(_masked_distance(u_samples, bias, n_active), dim=1).values


def bin_losses_padded(u_samples, losses, bias, n_active):
    """Static-shape ``fillBins`` over F+1 bin slots; bins past n_active + 1
    are dead (loss −BIG)."""
    counts, u_mean, l_mean = _bins(u_samples, losses, bias, _masked_distance(u_samples, bias, n_active))
    valid = torch.arange(bias.shape[0] + 1, device=bias.device) <= n_active
    return counts, u_mean, torch.where(valid, l_mean, torch.full_like(l_mean, -_BIG))


def insert_neuron_padded(params_l: dict, n_active, k, new_bias, new_weight: float = 1e-5,
                         do_insert=True):
    """Static-shape neuron insertion at sorted slot ``k``: slots ≥ k shift
    right (the last padding slot falls off), slot k ← (new_bias, new_weight,
    new_weight), ``n_active`` bumps. ``do_insert=False`` (or a full
    capacity) is an exact identity."""
    f = params_l["bias"].shape[0]
    n_active = torch.as_tensor(n_active)
    do = torch.as_tensor(do_insert, device=n_active.device) & (n_active < f)
    pos = torch.arange(f, device=params_l["bias"].device)

    def shift_rows(leaf, new_row):
        new_row = torch.as_tensor(new_row, device=leaf.device).to(leaf.dtype)
        shifted = leaf[torch.clamp(pos - 1, min=0)]
        out = torch.where((pos < k)[:, None], leaf, shifted)
        out = torch.where((pos == k)[:, None], new_row, out)
        return torch.where(do, out, leaf)

    d = params_l["bias"].shape[1]
    bias = shift_rows(params_l["bias"], torch.as_tensor(new_bias).expand(d))
    w1 = shift_rows(params_l["weights1"], torch.full((d,), new_weight))
    w2t = shift_rows(params_l["weights2"].T, torch.full((d,), new_weight))
    return {"bias": bias, "weights1": w1, "weights2": w2t.T.contiguous()}, n_active + do.to(n_active.dtype)


def grow_width_padded(params_l: dict, n_active, u_samples, losses, *, tol: float = 5e-5,
                      new_weight: float = 1e-5):
    """One padded layer's adaptWidth: sort, bin, insert at the worst bin iff
    its mean loss exceeds ``tol`` and capacity remains. No growth leaves the
    parameters bit-identical (not even re-sorted). Returns (params_l,
    n_active, inserted)."""
    n_active = torch.as_tensor(n_active)
    srt = sort_neurons_padded(params_l, n_active)
    _, u_bins, l_bins = bin_losses_padded(u_samples, losses, srt["bias"][:, 0], n_active)
    k = torch.argmax(l_bins)
    new, n_new = insert_neuron_padded(srt, n_active, k, u_bins[k], new_weight,
                                      do_insert=l_bins[k] > tol)
    inserted = n_new > n_active
    return tree_map(lambda a, b: torch.where(inserted, a, b), new, params_l), n_new, inserted


def grow_width_all_steps(params_stacked: dict, n_active, u_states, trues, *, tol: float = 5e-5,
                         new_weight: float = 1e-5):
    """adaptWidth over every step in place (Main_width_ref.py:225-312):
    hidden layers bin the knot losses of the state entering them, the last
    layer the terminal prediction error. ``u_states`` (B, L+1), ``trues``
    (B,). Returns (params, n_active (L,), inserted (L,))."""
    l_steps = params_stacked["bias"].shape[0]
    pred_losses = torch.square(u_states[:, -1] - trues)
    outs = []
    for l in range(l_steps):
        p_l = {k: v[l] for k, v in params_stacked.items()}
        u_l = u_states[:, l]
        losses = pred_losses if l == l_steps - 1 else layer_knot_losses(
            u_l, p_l["bias"][:, 0], n_active[l])
        outs.append(grow_width_padded(p_l, n_active[l], u_l, losses, tol=tol,
                                      new_weight=new_weight))
    params = {k: torch.stack([o[0][k] for o in outs]) for k in params_stacked}
    return (params, torch.stack([o[1] for o in outs]).to(n_active.dtype),
            torch.stack([o[2] for o in outs]))


def zero_step_moments(opt_state: Any, inserted: torch.Tensor) -> Any:
    """Fresh moments for the steps that grew: their slices of every stacked
    moment leaf are zeroed; leaves without the step axis (the shared step
    count) pass through (Main_width_ref.py:302-303 re-inits per layer)."""
    l_steps = inserted.shape[0]

    def z(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and leaf.shape[0] == l_steps:
            return torch.where(_bcast(inserted, leaf), torch.zeros_like(leaf), leaf)
        return leaf

    return tree_map(z, opt_state)
