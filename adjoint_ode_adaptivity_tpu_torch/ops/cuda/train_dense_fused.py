"""The fused training epoch of the shared-parameter Dense chain on
hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/train_dense_fused.py``. One
kernel entry, **T2** :func:`dense_epoch_grad` (csrc/train_dense_fused.cu),
replaces ``_epoch_kernel`` (train_dense_fused.py:136): for B members, the
S-step Euler march of ``ResNetBlock(sizes)`` with ONE parameter set,

  z_1 = u·w_1 + b_1,  a_l = relu(a_{l−1} W_l + b_l),  f = a_L·w_out + b_out,
  u_{n+1} = u_n + dt_n·f,

the terminal MSE, and the backward sweep that recomputes the chain from the
stored scalar trajectory at each step:

  df = dt·g, ∂W_out += a_Lᵀdf, ∂b_out += Σdf, da_L = df ⊗ w_out,
  dz_l = da_l·1[z_l>0], ∂W_l += a_{l−1}ᵀdz_l, ∂b_l += Σdz_l,
  da_{l−1} = dz_l W_lᵀ, g_n = g + Σ_i dz1_i·w1_i.

Zero-dt steps are exact identities with gradients that are exactly 0. The
hidden products are the kernel's own FP32 FMAs (IEEE float32, no TF32, no
library call), or with ``mxu_dtype=torch.bfloat16`` (the TPU kernel's opt-in
mode, train_dense_fused.py:124-134) bf16 tensor-core products (mma.sync
m16n8k16, operands rounded to bf16 to nearest even, f32 accumulators) with
everything else in f32 as in JAX; hidden widths then pad to multiples of 16.
:func:`dense_epoch_grad_plain` takes the same ``mxu_dtype``: it rounds the
hidden products' operands to bf16 and accumulates in its own dtype.

On the card one thread-block cluster of C CTAs takes each tile of BM
members: CTA r holds the column slice J_r of every hidden matrix in its
shared memory for the whole epoch, forms its slice of each layer's
activations, gathers the rest from the other CTAs' shared memory, and sums
the cluster's partial products in rank order (csrc/train_dense_fused.cu).
:func:`dense_plan` picks (BM, C); :func:`dense_epoch_grad_split_plain`
emulates that split in plain PyTorch.

Parameters are the flax pytree ``{'Dense_i': {'kernel', 'bias'}}``. The
kernel takes them flattened into one float32 vector (:func:`pack_dense`,
hidden widths padded to multiples of 4 with zeros, which relu keeps inert in
both passes). A CUDA float32 tensor launches the kernel or raises; a CPU
tensor takes the plain version, :func:`dense_epoch_grad_plain`, the same
sweep in eager torch in the inputs' dtype. Nothing falls back from the
kernel. The wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.train_fused import EPS32, WARP, _check

__all__ = [
    "pad4",
    "dense_layout",
    "pack_dense",
    "unpack_dense",
    "dense_block_members",
    "DensePlan",
    "dense_smem_bytes",
    "dense_plan",
    "dense_epoch_grad",
    "dense_epoch_grad_plain",
    "dense_epoch_grad_split_plain",
    "dense_kernel_tolerance",
    "reset_launch_counts",
    "make_cuda_dense_epoch_grad",
]

MAX_LAYERS = 8  # hidden layers the kernel takes (csrc kMaxLayers)
SMEM_BYTES = 227 * 1024  # shared memory a CTA may hold (csrc kMaxSmem)
TILE_MEMBERS = (64, 32, 16)  # BM, the members of a tile, largest first
CLUSTER_SIZES = (1, 2, 4, 8)  # C, the CTAs of a tile's cluster, fewest first
H100_SMS = 132
CALIBRATION = 16  # dense_kernel_tolerance's factor on the float32 sweep's deviations


def pad4(n: int) -> int:
    return -(-n // 4) * 4


def _bf16(mxu_dtype) -> bool:
    if mxu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mxu_dtype={mxu_dtype}: torch.float32 or torch.bfloat16")
    return mxu_dtype == torch.bfloat16


def _pad(n: int, mxu_dtype=torch.float32) -> int:
    """A hidden width padded for the kernel: to 4 (f32), to the MMA's depth
    16 (bf16)."""
    a = 16 if _bf16(mxu_dtype) else 4
    return -(-n // a) * a


def dense_layout(sizes: Sequence[int], mxu_dtype=torch.float32) -> list:
    """Offsets into the flat parameter (and gradient) vector, hidden widths
    padded to P_l = pad4(H_l) (pad16 in bf16): [w1 (P1), b1 (P1)], then per hidden matrix
    l = 1..L−1 [W_l (P_{l−1}·P_l, row-major), b_l (P_l)], then [w_out
    (P_L), b_out (1)]. Returns a list of (name, offset, shape) with the
    padded shapes; the total is the last offset plus its size."""
    p = [_pad(s, mxu_dtype) for s in sizes]
    out, off = [], 0
    shapes = [("Dense_0/kernel", (p[0],)), ("Dense_0/bias", (p[0],))]
    for l in range(1, len(sizes)):
        shapes += [(f"Dense_{l}/kernel", (p[l - 1], p[l])), (f"Dense_{l}/bias", (p[l],))]
    shapes += [(f"Dense_{len(sizes)}/kernel", (p[-1],)), (f"Dense_{len(sizes)}/bias", (1,))]
    for name, shape in shapes:
        out.append((name, off, shape))
        off += math.prod(shape)
    return out


def _total(layout) -> int:
    name, off, shape = layout[-1]
    return off + math.prod(shape)


def _flatten(tree: dict, sizes: tuple, device=None, dtype=torch.float32,
             mxu_dtype=torch.float32) -> torch.Tensor:
    """A Dense-chain pytree (parameters or gradients) as the flat vector of
    :func:`dense_layout`, padding exactly zero."""
    n = len(sizes)
    layout = dense_layout(sizes, mxu_dtype)
    flat = torch.zeros(_total(layout), dtype=dtype, device=device)
    for name, off, shape in layout:
        layer, leaf = name.split("/")
        x = tree[layer][leaf].to(device=device, dtype=dtype)
        if leaf == "kernel" and int(layer.split("_")[1]) in (0, n):
            x = x.reshape(-1)
        view = flat[off: off + math.prod(shape)].view(shape)
        view[tuple(slice(0, s) for s in x.shape)] = x
    return flat


def pack_dense(params: dict, sizes: Sequence[int], device=None,
               mxu_dtype=torch.float32) -> torch.Tensor:
    """theta: the flat float32 parameter vector of :func:`dense_layout`
    (for ``mxu_dtype``'s padding; the values stay float32)."""
    return _flatten(params, tuple(sizes), device, mxu_dtype=mxu_dtype)


def unpack_dense(flat: torch.Tensor, sizes: Sequence[int], mxu_dtype=torch.float32) -> dict:
    """The flat gradient vector as the flax pytree (padding dropped)."""
    sizes = tuple(sizes)
    n = len(sizes)
    out: dict = {}
    for name, off, shape in dense_layout(sizes, mxu_dtype):
        layer, leaf = name.split("/")
        i = int(layer.split("_")[1])
        x = flat[off: off + math.prod(shape)].view(shape)
        if leaf == "kernel":
            if i == 0:
                x = x[: sizes[0]][None, :]
            elif i == n:
                x = x[: sizes[-1]][:, None]
            else:
                x = x[: sizes[i - 1], : sizes[i]]
        else:
            x = x[: (sizes[i] if i < n else 1)]
        out.setdefault(layer, {})[leaf] = x
    return out


def _slice_width(p: int, c: int, mxu_dtype=torch.float32) -> int:
    """Columns a rank owns of a layer of padded width p split over c CTAs."""
    return _pad(-(-p // c), mxu_dtype)


def dense_smem_bytes(sizes: Sequence[int], bm: int, c: int, mxu_dtype=torch.float32) -> int:
    """Shared memory one CTA of the kernel needs (csrc make_layout): w_1,
    b_1; each hidden matrix's column slice (f32: row stride ≡ 4 mod 8
    floats; bf16: the slice transposed, P_{l−1} + 8 halves a row) and bias
    slice; w_out's slice; the activations of every layer but the last whole,
    the last's slice; one BM × max P partial product; six BM-vectors. Every
    region starts on 16 bytes."""
    p = [_pad(x, mxu_dtype) for x in sizes]
    jw = [p[0]] + [_slice_width(x, c, mxu_dtype) for x in p[1:]]
    if _bf16(mxu_dtype):
        w_floats = [jw[l] * (p[l - 1] + 8) // 2 for l in range(1, len(p))]
    else:
        w_floats = [p[l - 1] * (jw[l] + 4 if jw[l] % 8 == 0 else jw[l]) for l in range(1, len(p))]
    floats = 2 * p[0]
    floats += sum(pad4(w) + jw[l] for l, w in enumerate(w_floats, start=1))
    floats += jw[-1]
    floats += sum(bm * x for x in p[:-1]) + bm * jw[-1]
    floats += bm * max(p[:-1], default=0) + 6 * bm
    return 4 * floats


def _feasible(sizes: tuple, mxu_dtype=torch.float32):
    """(BM, C) pairs the kernel takes for ``sizes`` in preference order
    (largest tile, then fewest CTAs): the CTA fits its shared memory and
    every rank owns columns of every split layer (one CTA for a single
    hidden layer, which is not split)."""
    p = [_pad(x, mxu_dtype) for x in sizes]
    for bm in TILE_MEMBERS:
        for c in CLUSTER_SIZES:
            if len(p) == 1 and c > 1:
                continue
            if any((c - 1) * _slice_width(x, c, mxu_dtype) >= x for x in p[1:]):
                continue
            if dense_smem_bytes(sizes, bm, c, mxu_dtype) <= SMEM_BYTES:
                yield bm, c


def dense_block_members(sizes: Sequence[int], mxu_dtype=torch.float32) -> int:
    """The largest member tile some cluster size fits; raises where none
    does (a chain too wide for the card)."""
    fits = [bm for bm, _ in _feasible(tuple(int(x) for x in sizes), mxu_dtype)]
    if not fits:
        raise ValueError(f"hidden widths {tuple(sizes)} need more shared memory than a CTA has")
    return fits[0]


class DensePlan(NamedTuple):
    """T2's launch: tiles of ``block_members`` members, each a cluster of
    ``cluster`` CTAs; ``smem_bytes`` of shared memory a CTA."""

    block_members: int
    cluster: int
    n_tiles: int
    smem_bytes: int
    bf16: bool = False  # the hidden products on the bf16 tensor cores


@functools.lru_cache(maxsize=256)
def dense_plan(sizes: tuple, b: int, sms: int = H100_SMS,
               mxu_dtype=torch.float32) -> DensePlan:
    """T2's plan for B members on a card of ``sms`` SMs: the first (BM, C)
    of :func:`_feasible` (largest tile, then fewest CTAs) whose ⌈B/BM⌉·C
    CTAs fill the card, that is reach the most CTAs of eight-CTA clusters it
    can hold at one a SM (8·⌊sms/8⌋, 128 on 132 SMs); where none does, the
    one with the most CTAs (a tie to the fewest padded members, then the
    larger tile). At (100, 500): B =
    512 takes (32, 8), 128 CTAs; B = 8192 takes (64, 2), 256 CTAs (C = 1
    cannot hold W_1 in shared memory). The bf16 mode (``mxu_dtype``) holds
    half the weights a CTA and searches its own feasible set: at (100, 500)
    (padded (112, 512)) it takes the same two plans, and (32, 1) fits too.
    Cached: no search runs inside a timed call."""
    sizes = tuple(int(x) for x in sizes)
    fits = list(_feasible(sizes, mxu_dtype))
    if not fits:
        raise ValueError(f"hidden widths {sizes} need more shared memory than a CTA has")
    ctas = lambda f: -(-b // f[0]) * f[1]  # noqa: E731
    fill = 8 * (sms // 8)
    bm, c = next((f for f in fits if ctas(f) >= fill), None) or max(
        fits, key=lambda f: (ctas(f), -(-(-b // f[0]) * f[0])))
    return DensePlan(bm, c, -(-b // bm), dense_smem_bytes(sizes, bm, c, mxu_dtype),
                     _bf16(mxu_dtype))


# ------------------------------------------------------------ plain version


def _layers(params: dict, n: int, dtype):
    return [(params[f"Dense_{i}"]["kernel"].to(dtype), params[f"Dense_{i}"]["bias"].to(dtype))
            for i in range(n + 1)]


def _tree(leaves) -> dict:
    return {f"Dense_{i}": {"kernel": k, "bias": bb} for i, (k, bb) in enumerate(leaves)}


def _keep(x):
    return x


def _bf16_round(x):
    """x rounded to bf16 (round to nearest even), in x's dtype: the operand
    of a hidden product in the bf16 mode (JAX's ``astype(bfloat16)``)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _operand(mxu_dtype):
    return _bf16_round if _bf16(mxu_dtype) else _keep


class _SameOperands:
    """bf16 rounding for two evaluations in lockstep: called by the leading
    (float64) one, it rounds and keeps the operand; ``follow``, called by the
    float32 one at the same place, returns that same operand in float32. So
    the two differ by their sums' rounding alone; the flips are charged
    apart (:func:`_bf16_flips`)."""

    def __init__(self):
        self.kept = []

    def __call__(self, x):
        r = _bf16_round(x)
        self.kept.append(r)
        return r

    def follow(self, x):
        return self.kept.pop(0).to(x.dtype)


def _follow(lead):
    return lead.follow if isinstance(lead, _SameOperands) else lead


def _bf16_flips(x, x32):
    """One bf16 ulp of every entry of ``x`` (a hidden product's operand, in
    float64) that may round the other way in another evaluation: within
    CALIBRATION times its row's largest deviation ``x32 − x`` of a rounding
    boundary; 0 elsewhere."""
    _, ex = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), ex - 8)  # bf16's spacing at |x|
    edge = ulp / 2 - (x - _bf16_round(x)).abs()
    window = CALIBRATION * (x32.to(x.dtype) - x).abs().amax(-1, keepdim=True)
    return torch.where((edge <= window) & (x != 0), ulp, torch.zeros_like(x))


def _chain(lay, u, rnd=_keep):
    """Pre-activations and activations of every hidden layer at the states
    ``u`` (B,), and f (B,); ``rnd`` rounds the hidden products' operands."""
    z = u[:, None] * lay[0][0][0][None, :] + lay[0][1]
    zs, acts = [z], [torch.relu(z)]
    for k, bb in lay[1:-1]:
        z = rnd(acts[-1]) @ rnd(k) + bb
        zs.append(z)
        acts.append(torch.relu(z))
    return zs, acts, acts[-1] @ lay[-1][0][:, 0] + lay[-1][1][0]


def _march(lay, dt, u0s, rnd=_keep):
    traj = [u0s]
    for s in range(dt.shape[0]):
        traj.append(traj[-1] + dt[s] * _chain(lay, traj[-1], rnd)[2])
    return traj


def _backward_step(lay, dt_s, g, u, acts, masks, grads, rnd=_keep):
    """One step of the reverse sweep at the states ``u`` with the relu masks
    ``masks`` (one per hidden layer): adds the step's contributions to
    ``grads`` and returns (the cotangent one step back, the cotangents of
    every hidden layer's activations); ``rnd`` rounds the hidden products'
    operands (∂W_l and dz_l·W_lᵀ; the first layer and the output stay as
    they are)."""
    n = len(acts)
    df = dt_s * g
    grads[n][0] += (acts[-1] * df[:, None]).sum(0)[:, None]
    grads[n][1] += df.sum(0, keepdim=True)
    da = df[:, None] * lay[n][0][:, 0][None, :]
    das = [None] * n
    for i in range(n - 1, -1, -1):
        das[i] = da
        dz = da * masks[i]
        if i > 0:
            grads[i][0] += rnd(acts[i - 1]).T @ rnd(dz)
            da = rnd(dz) @ rnd(lay[i][0]).T
        else:
            grads[i][0] += u[:, None].T @ dz
        grads[i][1] += dz.sum(0)
    return g + dz @ lay[0][0][0], das


def dense_epoch_grad_plain(params: dict, sizes: Sequence[int], dt, u0s, trues,
                           mxu_dtype=torch.float32):
    """T2's plain version: (loss, grads pytree) of the terminal-MSE epoch
    (mean over members) in the dtype of ``u0s``: the forward march, then
    the backward sweep recomputing the chain from the stored states. With
    ``mxu_dtype=torch.bfloat16`` every hidden product's operands are rounded
    to bf16 first (the products and sums stay in the dtype of ``u0s``)."""
    dtype = u0s.dtype
    rnd = _operand(mxu_dtype)
    lay = _layers(params, len(sizes), dtype)
    dt = dt.to(dtype)
    traj = _march(lay, dt, u0s, rnd)
    inv_b = 1.0 / u0s.shape[0]
    e = traj[-1] - trues.to(dtype)
    g = 2.0 * e * inv_b
    grads = [[torch.zeros_like(k), torch.zeros_like(bb)] for k, bb in lay]
    for s in range(dt.shape[0] - 1, -1, -1):
        zs, acts, _ = _chain(lay, traj[s], rnd)
        g, _ = _backward_step(lay, dt[s], g, traj[s], acts, [(z > 0).to(dtype) for z in zs],
                              grads, rnd)
    return (e * e * inv_b).sum(), _tree(grads)


def _splits(p: int, c: int):
    """Rank r's columns of a layer of padded width p over c CTAs."""
    w = _slice_width(p, c)
    return [slice(min(r * w, p), min((r + 1) * w, p)) for r in range(c)]


def _rank_sum(parts):
    """The cluster's partials summed in rank order."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def dense_epoch_grad_split_plain(params: dict, sizes: Sequence[int], dt, u0s, trues,
                                 block_members: int, cluster: int):
    """T2's reduction structure in plain PyTorch, in the dtype of ``u0s``:
    each tile of ``block_members`` members on its own, every hidden layer
    but the first split into ``cluster`` column slices (padded widths, as
    the kernel), f as the slices' partial dots and da_{l−1} as their partial
    products summed in rank order, each tile's gradients summed over its
    members and steps, then the tiles summed in order. Returns (loss,
    grads) as :func:`dense_epoch_grad_plain`."""
    sizes = tuple(sizes)
    n, dtype, dev = len(sizes), u0s.dtype, u0s.device
    theta = _flatten(params, sizes, dev, dtype)
    lay = [(theta[ok: ok + math.prod(sk)].view(sk), theta[ob: ob + math.prod(sb)])
           for (_, ok, sk), (_, ob, sb) in zip(*[iter(dense_layout(sizes))] * 2)]
    lay[0] = (lay[0][0].view(1, -1), lay[0][1])
    lay[n] = (lay[n][0].view(-1, 1), lay[n][1])
    cols = [None] + [_splits(k.shape[1], cluster) for k, _ in lay[1:-1]]
    last = cols[-1] if n > 1 else [slice(0, lay[0][0].shape[1])]
    dt = dt.to(dtype)
    b = u0s.shape[0]
    inv_b = 1.0 / b

    def chain(u):
        acts = [torch.relu(u[:, None] * lay[0][0][0] + lay[0][1])]
        for i in range(1, n):
            k, bb = lay[i]
            acts.append(torch.cat([torch.relu(acts[-1] @ k[:, j] + bb[j]) for j in cols[i]], 1))
        f = _rank_sum([acts[-1][:, j] @ lay[n][0][j, 0] for j in last])
        return acts, f

    loss = torch.zeros((), dtype=dtype, device=dev)
    total = [[torch.zeros_like(k), torch.zeros_like(bb)] for k, bb in lay]
    for m0 in range(0, b, block_members):
        u = u0s[m0:m0 + block_members].to(dtype)
        traj = [u]
        for s in range(dt.shape[0]):
            traj.append(traj[-1] + dt[s] * (chain(traj[-1])[1] + lay[n][1][0]))
        e = traj[-1] - trues[m0:m0 + block_members].to(dtype)
        loss = loss + (e * e * inv_b).sum()
        g = 2.0 * e * inv_b
        grads = [[torch.zeros_like(k), torch.zeros_like(bb)] for k, bb in lay]
        for s in range(dt.shape[0] - 1, -1, -1):
            acts, _ = chain(traj[s])
            df = dt[s] * g
            grads[n][0] += (acts[-1] * df[:, None]).sum(0)[:, None]
            grads[n][1] += df.sum(0, keepdim=True)
            dz = (acts[-1] > 0).to(dtype) * (df[:, None] * lay[n][0][:, 0])
            for i in range(n - 1, 0, -1):
                grads[i][0] += acts[i - 1].T @ dz
                grads[i][1] += dz.sum(0)
                da = _rank_sum([dz[:, j] @ lay[i][0][:, j].T for j in cols[i]])
                dz = (acts[i - 1] > 0).to(dtype) * da
            grads[0][0] += (traj[s][:, None] * dz).sum(0)[None, :]
            grads[0][1] += dz.sum(0)
            g = g + dz @ lay[0][0][0]
        for acc, gl in zip(total, grads):
            acc[0] += gl[0]
            acc[1] += gl[1]
    flat = _flatten(_tree(total), sizes, dtype=dtype)
    return loss, unpack_dense(flat, sizes)


def _jacobian(lay, masks):
    """∂f/∂u (B,) of the chain with the relu masks ``masks``."""
    da = lay[-1][0][:, 0][None, :]
    for i in range(len(masks) - 1, 0, -1):
        da = (da * masks[i]) @ lay[i][0].T
    return (da * masks[0]) @ lay[0][0][0]


def dense_kernel_tolerance(params: dict, sizes: Sequence[int], dt, u0s, trues,
                           block_members: int | None = None, cluster: int | None = None,
                           mxu_dtype=torch.float32):
    """Per-entry bounds within which a float32 evaluation of T2 lies from the
    float64 plain version, calibrated by a float32 evaluation of the same
    sweep in eager torch (IEEE float32 products, another summation order):

    - the float64 and float32 sweeps run in lockstep, the float32 one with
      the float64 relu masks (and in the bf16 mode the float64 sweep's bf16
      operands), so that its deviation is its sums' rounding alone; ρ is
      its largest deviation over all gradient entries, each relative to
      the entry's scale Σ|c|, the summed magnitudes of its (step, member)
      contributions c;
    - a relu whose float64 argument lies within CALIBRATION times the
      float32 sweep's largest deviation of that member's arguments in that
      layer at that step may switch in another evaluation: its whole
      contribution is charged, and the charge φ is carried by magnitudes to
      the lower layers and, through the cotangent, to the earlier steps by
      the signed step derivative |1 + dt·J| (J = ∂f/∂u), as a perturbation
      is;
    - each entry's bound is (CALIBRATION·ρ + k_red·ε)·Σ|c| + 2φ, with k_red
      the lengths of the kernel's sums that the float32 sweep does not
      share: an entry is summed over the ``block_members`` members of a
      tile, then over the S steps, then over the tiles (BM + S + n_tiles,
      each sum of m terms within (m − 1)·ε of its magnitudes), and the
      cluster adds one C-term sum in rank order ahead of it (f's partial
      dots and each da_{l−1}'s partial products over C column slices, whose
      relative error, within (C − 1)·ε, every contribution below them
      carries): k_red = BM + C + S + n_tiles + 2 (the 2 a margin for the
      final rounding). ``block_members`` and ``cluster`` default to
      :func:`dense_plan`'s for B members on an H100.

    The loss: CALIBRATION times the float32 sweep's largest terminal-state
    deviation δ, through Σ(2|e|δ + δ²)/B, plus its reduction. An entry no
    contribution reaches (a dead neuron, a zero-dt step) has bound 0: the
    kernel must give exactly 0 there. Returns ``loss`` (float), ``grads``
    and ``scale`` (pytrees of bounds and of Σ|c|) and ``rho``.

    The bf16 mode (``mxu_dtype=torch.bfloat16``): the bounds are about the
    float64 plain version of that mode (operands rounded to bf16 from
    float64 values). Another evaluation rounds its operands from its own
    float32 values, and two effects can move an operand by one bf16 ulp
    (2⁻⁸ to 2⁻⁷ relative) between the two: an operand near a rounding
    boundary, and the float32 sums' order before the rounding. Such flips
    are rare and each moves one product term by up to 2⁻⁷ of it, so a
    calibration cannot see the ones of another run: the float32 sweep takes
    the float64 sweep's bf16 operands (:class:`_SameOperands`; its
    deviation is its sums' rounding alone, as in float32), and every flip
    is charged where it may happen: an operand whose float64 value lies within
    CALIBRATION times its row's float32 deviation of a bf16 rounding
    boundary is charged one bf16 ulp (:func:`_bf16_flips`) through the
    magnitudes of its partners: a flagged a_{l−1} or dz_l in ∂W_l, a
    flagged dz_l on da_{l−1} (carried down and through the cotangent as a
    relu switch's charge is), and a flagged a_{l−1} on z_l (which widens the
    relu window and is charged on ∂W_{l+1}, or ∂w_out). Everything else is
    as above. Its teeth: the float32 mode's result lies outside the bf16
    bounds (tests/test_torch_train_dense_bf16.py)."""
    f64, f32 = torch.float64, torch.float32
    sizes = tuple(sizes)
    n, b = len(sizes), u0s.shape[0]
    bf = _bf16(mxu_dtype)
    plan = dense_plan(sizes, b, mxu_dtype=mxu_dtype)
    bm = block_members or plan.block_members
    c = cluster or plan.cluster
    inv_b = 1.0 / b
    lay, lay32 = _layers(params, n, f64), _layers(params, n, f32)
    dt64, dt32 = dt.to(f64), dt.to(f32)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # IEEE float32, no TF32
    try:
        traj, traj32 = [u0s.to(f64)], [u0s.to(f32)]
        for s in range(dt.shape[0]):
            lead = _SameOperands() if bf else _keep
            traj.append(traj[-1] + dt64[s] * _chain(lay, traj[-1], lead)[2])
            traj32.append(traj32[-1] + dt32[s] * _chain(lay32, traj32[-1], _follow(lead))[2])
        e = traj[-1] - trues.to(f64)
        g, g32 = 2.0 * e * inv_b, 2.0 * (traj32[-1] - trues.to(f32)) * inv_b
        zeros = lambda ls: [[torch.zeros_like(k), torch.zeros_like(bb)] for k, bb in ls]  # noqa: E731
        grads, grads32, scale, phi = zeros(lay), zeros(lay32), zeros(lay), zeros(lay)
        phi_g = torch.zeros_like(g)
        for s in range(dt.shape[0] - 1, -1, -1):
            lead = _SameOperands() if bf else _keep
            zs, acts, _ = _chain(lay, traj[s], lead)
            zs32, acts32, _ = _chain(lay32, traj32[s], _follow(lead))
            masks = [(z > 0).to(f64) for z in zs]
            # bf16: the flips of a_{l−1} in z_l = a_{l−1}W_l, charged on z_l
            fa = [torch.zeros_like(a) for a in acts]
            cz = [torch.zeros_like(z) for z in zs]
            if bf:
                for i in range(1, n):
                    fa[i - 1] = _bf16_flips(acts[i - 1], acts32[i - 1])
                    cz[i] = fa[i - 1] @ lay[i][0].abs()
            flags = [(z.abs() <= CALIBRATION * (z32.to(f64) - z).abs().amax(1, keepdim=True)
                      + cz[i]).to(f64) for i, (z, z32) in enumerate(zip(zs, zs32))]
            g_next, das = _backward_step(lay, dt64[s], g, traj[s], acts, masks, grads, lead)
            g32, das32 = _backward_step(lay32, dt32[s], g32, traj32[s], acts32,
                                        [m.to(f32) for m in masks], grads32, _follow(lead))
            dfm, phi_df = (dt64[s] * g).abs(), dt64[s].abs() * phi_g
            am = acts[-1].abs()
            ca = [c * torch.clamp(m + fl, max=1.0) for c, m, fl in zip(cz, masks, flags)]
            scale[n][0] += (am.T @ dfm)[:, None]
            scale[n][1] += dfm.sum(0, keepdim=True)
            phi[n][0] += ((am.T @ phi_df) + ca[-1].T @ dfm)[:, None]
            phi[n][1] += phi_df.sum(0, keepdim=True)
            ko = lay[n][0][:, 0].abs()[None, :]
            pa = phi_df[:, None] * ko  # carried charge on da (entries)
            pb = torch.zeros_like(pa)  # this step's switches alone (the cotangent)
            for i in range(n - 1, -1, -1):
                live = torch.clamp(masks[i] + flags[i], max=1.0)
                switch = (das[i].abs() + pa) * flags[i]
                pa, pb = pa * live + switch, pb * live + switch
                a_prev = (acts[i - 1] if i > 0 else traj[s][:, None]).abs()
                dzm = das[i].abs() * masks[i]
                scale[i][0] += a_prev.T @ dzm
                scale[i][1] += dzm.sum(0)
                phi[i][0] += a_prev.T @ pa
                phi[i][1] += pa.sum(0)
                k = lay[i][0].abs()
                cd = 0.0
                if bf and i > 0:  # the flips of dz_i and a_{i−1} in ∂W_i, of dz_i on da_{i−1}
                    fd = _bf16_flips(das[i] * masks[i], das32[i].to(f64) * masks[i])
                    phi[i][0] += fa[i - 1].T @ dzm + a_prev.T @ fd + ca[i - 1].T @ dzm
                    cd = fd @ k.T
                pa, pb = (pa @ k.T + cd, pb @ k.T + cd) if i > 0 else (pa, pb @ k[0])
            phi_g = (1.0 + dt64[s] * _jacobian(lay, masks)).abs() * phi_g + pb
            g = g_next
        rho = 0.0
        for gl, gl32, ml in zip(grads, grads32, scale):
            for x, y, m in zip(gl, gl32, ml):
                if bool((m > 0).any()):
                    rho = max(rho, float(((y.to(f64) - x).abs()[m > 0] / m[m > 0]).max()))
        delta = CALIBRATION * float((traj32[-1].to(f64) - traj[-1]).abs().max())
    finally:
        torch.set_float32_matmul_precision(precision)
    n_tiles = -(-b // bm)
    k_red = (bm + c + dt.shape[0] + n_tiles + 2) * EPS32
    k_loss = (math.ceil(b / WARP) + 7) * EPS32
    bound = [[(CALIBRATION * rho + k_red) * m + 2 * c for m, c in zip(ml, cl)]
             for ml, cl in zip(scale, phi)]
    loss_bound = float(inv_b * (2 * e.abs() * delta + delta * delta).sum()
                       + k_loss * inv_b * (e * e).sum())
    return {"loss": loss_bound, "grads": _tree(bound), "scale": _tree(scale), "rho": rho}


# ------------------------------------------------------------------ wrapper


def dense_epoch_grad(theta, sizes: Sequence[int], dt, u0s, trues, mxu_dtype=torch.float32):
    """T2: (loss, flat gradient vector) for the packed parameters
    (:func:`pack_dense` with the same ``mxu_dtype``), ``dt`` (S,), ``u0s``
    and ``trues`` (B,); the loss is the mean over members. One call of the C
    entry on :func:`dense_plan`'s plan for the card's SM count: the
    cluster-launched march-and-sweep kernel (its hidden products in f32, or
    on the bf16 tensor cores), then a fixed-order reduction of the tiles'
    partial gradients (2 CUDA launches)."""
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} hidden layers, got {len(sizes)}")
    if u0s.dim() != 1:
        raise ValueError(f"u0s must be (B,), got {tuple(u0s.shape)}")
    b, s_steps, dev = u0s.shape[0], dt.shape[0], u0s.device
    _check("theta", theta, (_total(dense_layout(sizes, mxu_dtype)),), torch.float32, dev)
    _check("dt", dt, (s_steps,), torch.float32, dev)
    _check("u0s", u0s, (b,), torch.float32, dev)
    _check("trues", trues, (b,), torch.float32, dev)
    if dev.type != "cuda":
        return _plain_flat(theta, sizes, dt, u0s, trues, mxu_dtype)
    plan = dense_plan(sizes, b, _sm_count(dev), mxu_dtype)
    out = _t2_launch(theta, sizes, dt, u0s, trues, plan)
    dense_epoch_grad.launches += 1
    return out


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _t2_launch(theta, sizes: tuple, dt, u0s, trues, plan: DensePlan):
    """One call of the C entry with ``plan``: (loss, flat gradients). The
    wrapper counts its launches; this does not."""
    b, s_steps, dev = u0s.shape[0], dt.shape[0], u0s.device
    lib = load_library()
    mxu_dtype = torch.bfloat16 if plan.bf16 else torch.float32
    widths = np.array([_pad(s, mxu_dtype) for s in sizes], dtype=np.int32)
    traj = torch.empty((plan.cluster, s_steps + 1, b), dtype=torch.float32, device=dev)
    loss_m = torch.empty((b,), dtype=torch.float32, device=dev)
    part = torch.zeros((plan.n_tiles, pad4(theta.numel())), dtype=torch.float32, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    grads = torch.empty_like(theta)
    code = lib.lib.dense_epoch_grad(
        len(sizes), widths.ctypes.data, plan.block_members, plan.cluster, int(plan.bf16),
        s_steps, b,
        theta.data_ptr(), dt.data_ptr(), u0s.data_ptr(), trues.data_ptr(), 1.0 / b,
        traj.data_ptr(), loss_m.data_ptr(), part.data_ptr(), loss.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    lib.check(code, "dense_epoch_grad", lib.lib.train_dense_error_string)
    return loss[0], grads


dense_epoch_grad.launches = 0


def _plain_flat(theta, sizes, dt, u0s, trues, mxu_dtype=torch.float32):
    loss, grads = dense_epoch_grad_plain(unpack_dense(theta, sizes, mxu_dtype), sizes, dt, u0s,
                                         trues, mxu_dtype)
    return loss, _flatten(grads, sizes, theta.device, loss.dtype, mxu_dtype)


def reset_launch_counts() -> None:
    dense_epoch_grad.launches = 0


# -------------------------------------------------------------- entry point


def make_cuda_dense_epoch_grad(n_steps: int, sizes: Sequence[int], device="cuda",
                               mxu_dtype=torch.float32):
    """``run(params, dt, u0s, trues) -> (loss, grads)``: value and gradient of
    the terminal-MSE epoch loss of a shared-parameter ``ResNetBlock(sizes)``
    over B members in one call of T2, with
    ``make_pallas_dense_epoch_grad``'s contract (train_dense_fused.py:
    236-286): float32, dt (S,), any B ≥ 1; ``mxu_dtype=torch.bfloat16`` the
    opt-in mode of bf16 hidden products with f32 accumulation."""
    sizes = tuple(int(s) for s in sizes)
    device = require_device(device)
    dense_block_members(sizes, mxu_dtype)

    def run(params, dt, u0s, trues):
        f32 = lambda x: torch.as_tensor(x).to(device=device, dtype=torch.float32).contiguous()  # noqa: E731
        if dt.shape[0] != n_steps:
            raise ValueError(f"dt has {dt.shape[0]} steps, expected {n_steps}")
        loss, flat = dense_epoch_grad(pack_dense(params, sizes, device, mxu_dtype), sizes,
                                      f32(dt), f32(u0s), f32(trues), mxu_dtype)
        return loss, unpack_dense(flat, sizes, mxu_dtype)

    return run
