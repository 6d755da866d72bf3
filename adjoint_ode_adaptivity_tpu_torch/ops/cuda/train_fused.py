"""The fused training epoch of a per-step ResBlockSimple net on hand-written
CUDA.

Counterpart of the JAX package's ``ops/pallas/train_fused.py``. One kernel
entry, **T1** :func:`resblock_epoch_grad` (csrc/train_fused.cu), replaces
``_epoch_kernel`` (train_fused.py:107): for B members, the S-step Euler march
u_{n+1} = u_n + dt_n·Σ_i w2_i·relu(w1_i·(u_n − b_i)) (scalar state), the loss
(terminal MSE, or the trapezoid trajectory loss plus a ramped terminal term),
and the hand-derived reverse sweep giving the whole parameter gradient:

  ∂w2_i += Σ_m g·dt·a_i,   ∂w1_i += Σ_m g·dt·w2_i·1[s_i>0]·(u_n − b_i),
  ∂b_i  −= Σ_m g·dt·w2_i·1[s_i>0]·w1_i,
  g_n    = g·(1 + dt·Σ_i w2_i·w1_i·1[s_i>0])   (g = ∂L/∂u_{n+1}).

relu'(0) = 0: the mask is strict ``s > 0``, as in jax. ``masked``: a per-step
active count gates each neuron (ResBlockSimpleMasked): inactive slots add
nothing and get gradients that are exactly 0. ``mixed``: full (S+1, B)
targets, node weights c_n = (dt_{n−1} + dt_n)/2 with the edges halved, the
ramp weight on the terminal node, each node's cotangent 2·c_n·e_n injected
before the next backward step. Optional 0/1 member ``weights``: the loss and
gradients are divided by Σw after the kernel. A zero-dt step is an exact
identity with gradients that are exactly 0.

The parameters travel packed as one (3, S, F) float32 tensor (bias, weights1,
weights2), the flax pytree's (S, F, 1)/(S, 1, F) leaves flattened. A CUDA
float32 tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`resblock_epoch_grad_plain`, the same sweep in eager torch in
the inputs' dtype. Nothing falls back from the kernel. The wrapper counts its
launches in ``.launches``. Adam stays outside (train/loop.py), as in JAX.

On the card T1 is two launches: one CTA of 8 warps per tile of BM members,
the lanes of a warp splitting the neuron loop, each tile's gradient
contributions summed over its members in member order into a partial; then
a fixed-order reduction of the tiles' partials. :func:`resblock_plan` picks
BM; :func:`resblock_epoch_grad_split_plain` runs that summation order in
plain float32, and :func:`reduce_terms_of` gives the order's length to
:func:`resblock_kernel_tolerance`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device

__all__ = [
    "pack_params",
    "unpack_grads",
    "resblock_epoch_grad",
    "resblock_epoch_grad_plain",
    "resblock_epoch_grad_split_plain",
    "resblock_kernel_tolerance",
    "ResblockPlan",
    "resblock_plan",
    "reduce_terms_of",
    "reset_launch_counts",
    "make_cuda_resblock_epoch_grad",
]

EPS32 = 2.0**-23
WARP = 32
H100_SMS = 132
TILE_MEMBERS = (64, 32, 16, 8)  # 8 warps of 8, 4, 2 or 1 members
GROUP = 16  # the reduction's group of consecutive tiles (csrc/train_fused.cu kGroup)


class ResblockPlan(NamedTuple):
    """T1's launch shape: tiles of ``block_members`` members (the last
    ragged), one CTA of 8 warps each."""

    block_members: int
    n_tiles: int


@functools.lru_cache(maxsize=64)
def resblock_plan(b: int, sms: int = H100_SMS) -> ResblockPlan:
    """T1's tile for B members on a card of ``sms`` SMs: the largest of
    64, 32, 16, 8 members whose tiles give at least 3/4 of a CTA an SM (at
    B = 8192: 64, 128 tiles), else 8. It depends on B alone, so zero-dt
    padded steps leave the live steps' bits as they were."""
    bm = next((m for m in TILE_MEMBERS if 4 * -(-b // m) >= 3 * sms), TILE_MEMBERS[-1])
    return ResblockPlan(bm, -(-b // bm))


def reduce_terms_of(plan: ResblockPlan) -> int:
    """The length of T1's member reduction: a tile's members in order, then
    groups of GROUP tiles in order, then the groups in order."""
    return plan.block_members + min(plan.n_tiles, GROUP) + -(-plan.n_tiles // GROUP)


def pack_params(params: dict, n_steps: int, features: int) -> torch.Tensor:
    """Stacked ResBlockSimple parameters ({'bias': (S, F, 1), 'weights1':
    (S, F, 1), 'weights2': (S, 1, F)}) as one (3, S, F) float32 tensor."""
    return torch.stack([params[k].reshape(n_steps, features).to(torch.float32)
                        for k in ("bias", "weights1", "weights2")]).contiguous()


def unpack_grads(packed: torch.Tensor, n_steps: int, features: int) -> dict:
    """(3, S, F) gradients as the flax parameter pytree."""
    return {"bias": packed[0][:, :, None], "weights1": packed[1][:, :, None],
            "weights2": packed[2][:, None, :]}


# ------------------------------------------------------------ plain version


def _sweep(packed, dt, u0s, targets, weights, n_active, ramp_weight, inv_b, mixed, track):
    """The epoch's forward march and reverse sweep over (F, B) sheets, in
    the dtype of ``u0s``. With ``track``, also a first-order bound on how far
    a float32 evaluation of the same sweep can lie from the exact one: each
    product and sum rounds once per operand; a sum of k terms is charged
    (k+1)·ε of the sum of their magnitudes; a relu whose argument lies
    within its own error of 0 may switch, and is charged the full switch.
    The state's and the cotangent's errors carry from step to step through
    the signed step derivative |1 + dt·J_n| (J_n = Σ_i w2_i w1_i 1[s_i>0]),
    which is what a perturbation does; magnitudes (|w2|·|w1| summed) would
    grow the bound geometrically with S.
    Returns (loss, grads (3, S, F)) or, with ``track``, (loss, grads,
    bound_loss, bound_grads (3, S, F), magnitudes (3, S, F)) with per-member
    sums still to be reduced; see :func:`resblock_kernel_tolerance`."""
    dtype = u0s.dtype
    bias, w1, w2 = (x.to(dtype) for x in packed)
    s_steps, f = bias.shape
    dt = dt.to(dtype)
    nm = torch.ones((s_steps, f), dtype=dtype, device=u0s.device)
    if n_active is not None:
        idx = torch.arange(f, device=u0s.device)
        nm = (idx[None, :] < n_active.to(u0s.device)[:, None]).to(dtype)
    w2m = w2 * nm
    w = torch.ones_like(u0s) if weights is None else weights.to(dtype)
    eps = EPS32

    def layer(n, u, eu):
        d = u[None, :] - bias[n][:, None]  # (F, B)
        s = w1[n][:, None] * d
        if not track:
            return d, s, None, None
        ed = eu[None, :] + eps * d.abs()
        es = w1[n].abs()[:, None] * ed + eps * s.abs()
        return d, s, ed, es

    traj, errs = [u0s], [torch.zeros_like(u0s)]
    u, eu = u0s, errs[0]
    for n in range(s_steps):
        d, s, ed, es = layer(n, u, eu)
        a = torch.relu(s)
        p = w2m[n][:, None] * a
        inc = dt[n] * p.sum(0)
        u_next = u + inc
        if track:
            jac = ((w2m[n] * w1[n])[:, None] * (s > 0)).sum(0)
            amb = s.abs() <= es
            es_loc = w1[n].abs()[:, None] * eps * d.abs() + eps * s.abs()
            ea_loc = torch.where(amb, es, es_loc * (s > 0))
            eacc = (w2m[n].abs()[:, None] * ea_loc).sum(0) + eps * (f + 1) * p.abs().sum(0)
            eu = ((1.0 + dt[n] * jac).abs() * eu + dt[n].abs() * eacc
                  + eps * (inc.abs() + u_next.abs()))
            errs.append(eu)
        u = u_next
        traj.append(u)

    tgt_last = targets[-1] if mixed else targets
    e = (traj[-1] - tgt_last.to(dtype)) * w
    ee = (errs[-1] + eps * e.abs()) * w.abs()
    c_term = dt[-1] * 0.5 + ramp_weight if mixed else 1.0
    loss_m = c_term * e * e * inv_b
    g = 2.0 * c_term * e * inv_b
    eloss = 2.0 * abs(c_term * inv_b) * e.abs() * ee + 5 * eps * loss_m.abs()
    eg = 2.0 * abs(c_term * inv_b) * ee + 5 * eps * g.abs()

    grads = torch.zeros((3, s_steps, f), dtype=dtype, device=u0s.device)
    if track:
        egrads, mags = torch.zeros_like(grads), torch.zeros_like(grads)
    for n in range(s_steps - 1, -1, -1):
        u_n = traj[n]
        d, s, ed, es = layer(n, u_n, errs[n] if track else None)
        mask = (s > 0).to(dtype)
        a = s * mask
        gdt = g * dt[n]
        ds = gdt[None, :] * (w2m[n][:, None] * mask)  # (F, B)
        grads[2, n] = (gdt[None, :] * a).sum(1) * nm[n]
        grads[1, n] = (ds * d).sum(1)
        grads[0, n] = -w1[n] * ds.sum(1)
        du = (ds * w1[n][:, None]).sum(0)
        g_next = g + du
        if track:
            amb = (s.abs() <= es).to(dtype)
            live = torch.clamp(mask + amb, max=1.0)
            ea = es * (s > -es)
            egdt = eg * dt[n].abs() + eps * gdt.abs()
            ds_max = gdt.abs()[None, :] * w2m[n].abs()[:, None] * live
            eds = (egdt[None, :] * w2m[n].abs()[:, None] + eps * ds_max) * live + ds_max * amb
            cw2 = (gdt.abs()[None, :] * a.abs()) * nm[n][:, None]
            egrads[2, n] = ((egdt[None, :] * a.abs() + gdt.abs()[None, :] * ea) * nm[n][:, None]
                            + 2 * eps * cw2).sum(1)
            mags[2, n] = cw2.sum(1)
            cw1 = ds_max * d.abs()
            egrads[1, n] = (eds * d.abs() + ds_max * ed + 2 * eps * cw1).sum(1)
            mags[1, n] = cw1.sum(1)
            cb = ds_max * w1[n].abs()[:, None]
            egrads[0, n] = (eds * w1[n].abs()[:, None] + 2 * eps * cb).sum(1)
            mags[0, n] = cb.sum(1)
            eds_loc = eps * (gdt.abs()[None, :] * w2m[n].abs()[:, None] + ds_max) * live + ds_max * amb
            edu = (eds_loc * w1[n].abs()[:, None]).sum(0) + eps * (f + 1) * cb.sum(0)
            jac = ((w2m[n] * w1[n])[:, None] * mask).sum(0)
            eg = (1.0 + dt[n] * jac).abs() * eg + edu + eps * g_next.abs()
        g = g_next
        if mixed:
            c_n = 0.5 * ((dt[n - 1] if n > 0 else 0.0) + dt[n])
            e_n = (traj[n] - targets[n].to(dtype)) * w
            loss_m = loss_m + c_n * e_n * e_n * inv_b
            inject = 2.0 * c_n * e_n * inv_b
            g = g + inject
            if track:
                ee_n = (errs[n] + eps * e_n.abs()) * w.abs()
                eloss = eloss + 2.0 * abs(c_n * inv_b) * e_n.abs() * ee_n + 6 * eps * loss_m.abs()
                eg = eg + 2.0 * abs(c_n * inv_b) * ee_n + 6 * eps * (inject.abs() + g.abs())
    loss = loss_m.sum()
    if not track:
        return loss, grads
    return loss, grads, eloss, egrads, mags, loss_m


def resblock_epoch_grad_plain(packed, dt, u0s, targets, weights=None, n_active=None,
                              ramp_weight=None, *, inv_b: float, mixed: bool = False):
    """T1's plain version: (loss, grads (3, S, F)) of the epoch, in the dtype
    of ``u0s`` (float32 or float64). The loss and gradients carry the factor
    ``inv_b`` (1/B, or 1 when the caller divides by Σw afterwards)."""
    return _sweep(packed, dt, u0s, targets, weights, n_active, ramp_weight, inv_b, mixed, False)


def resblock_kernel_tolerance(packed, dt, u0s, targets, weights=None, n_active=None,
                              ramp_weight=None, *, inv_b: float, mixed: bool = False,
                              reduce_terms: int | None = None):
    """Per-entry bounds within which a float32 evaluation of T1 lies from the
    exact result, computed in float64 by the same sweep (:func:`_sweep`):

    - each gradient entry (n, i) is a sum over members of contributions
      c_m; its bound is 2·(Σ_m E_m + k_red·ε·Σ_m |c_m|), with E_m the
      first-order error of c_m carried through the forward march and the
      reverse sweep (every rounding of the state, the activations, the
      neuron sums over F and the cotangent, and a full switch of any relu
      whose argument lies within its own error of 0), and k_red·ε the
      reduction over members: ``reduce_terms`` (default: the kernel's,
      :func:`reduce_terms_of` its plan for B on the inputs' card, or on a
      132-SM card for CPU inputs) plus 2;
    - the loss likewise over its per-member terms.

    The factor 2 covers the second-order terms. Inactive neurons and zero-dt
    steps have bound 0: both sides give exactly 0 there. Returns a dict with
    ``loss`` (float), ``grads`` (3, S, F) bounds and ``scale`` (3, S, F), the
    summed magnitudes Σ_m |c_m| of each entry's contributions."""
    f64 = torch.float64
    b = u0s.shape[0]
    if reduce_terms is None:
        sms = _sm_count(u0s.device) if u0s.device.type == "cuda" else H100_SMS
        reduce_terms = reduce_terms_of(resblock_plan(b, sms))
    k = (reduce_terms + 2) * EPS32
    _, _, eloss, egrads, mags, loss_m = _sweep(
        packed.to(f64), dt.to(f64), u0s.to(f64), targets.to(f64),
        None if weights is None else weights.to(f64),
        n_active, ramp_weight, inv_b, mixed, True)
    return {"loss": float(2 * (eloss.sum() + k * loss_m.abs().sum())),
            "grads": 2 * (egrads + k * mags), "scale": mags}


def _fma(a, b, c):
    """float32 a·b + c rounded once (the product is exact in float64; the
    sum rounds there, then to float32: a double rounding that an FMA does
    not make, far below any bound here)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _lane_sum(v):
    """Σ over the lane axis 0 of (32, ...) by the kernel's xor butterfly."""
    lanes = torch.arange(WARP, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ off]
    return v[0]


def _tiles_sum(x):
    """Σ over axis 0 (tiles) in the reduction's order: groups of GROUP
    consecutive tiles in order, then the groups in order."""
    total = torch.zeros_like(x[0])
    for t0 in range(0, x.shape[0], GROUP):
        s = torch.zeros_like(x[0])
        for t in range(t0, min(t0 + GROUP, x.shape[0])):
            s = s + x[t]
        total = total + s
    return total


def resblock_epoch_grad_split_plain(packed, dt, u0s, targets, weights=None, n_active=None,
                                    ramp_weight=None, *, inv_b: float, mixed: bool = False,
                                    plan: ResblockPlan | None = None):
    """T1's summation order in plain float32: (loss, grads (3, S, F)). A
    member's neuron sums split over 32 lanes (lane l takes i ≡ l mod 32, in
    order) joined by the xor butterfly; each tile of ``plan`` (default
    :func:`resblock_plan`) sums its members' gradient contributions in
    member order; the tiles' partials are reduced in groups of GROUP. Each
    product, sum and FMA rounds to float32 as on the card (an FMA through
    :func:`_fma`), so this shows that the order stays within
    :func:`resblock_kernel_tolerance` at :func:`reduce_terms_of` the plan."""
    f32 = torch.float32
    bias, w1, w2 = (x.to(f32) for x in packed)
    s_steps, f = bias.shape
    b = u0s.shape[0]
    plan = plan or resblock_plan(b)
    bm, n_tiles = plan.block_members, plan.n_tiles
    dev = u0s.device
    dt = dt.to(f32)
    na = (torch.full((s_steps,), f, device=dev) if n_active is None
          else n_active.to(dev).clamp(0, f))
    rounds = -(-f // WARP)  # neurons a lane takes
    idx = torch.arange(WARP * rounds, device=dev).view(rounds, WARP)  # [j, l] = i
    pad = lambda x: torch.cat([x, x.new_zeros(WARP * rounds - f)])  # noqa: E731
    w = torch.ones(b, dtype=f32, device=dev) if weights is None else weights.to(f32)

    u, traj = u0s.to(f32), [u0s.to(f32)]
    for n in range(s_steps):
        bn, an, cn = pad(bias[n]), pad(w1[n]), pad(w2[n])
        acc = torch.zeros((WARP, b), dtype=f32, device=dev)
        for j in range(rounds):
            i = idx[j]
            term = torch.clamp_min(an[i][:, None] * (u[None, :] - bn[i][:, None]), 0.0)
            acc = torch.where((i < na[n])[:, None], _fma(cn[i][:, None], term, acc), acc)
        u = _fma(dt[n], _lane_sum(acc), u)
        traj.append(u)

    tgt = targets.to(f32)
    c_term = dt[s_steps - 1] * 0.5 + float(ramp_weight) if mixed else torch.tensor(1.0)
    e = (u - (tgt[s_steps] if mixed else tgt)) * w
    loss_m = c_term * e * e * inv_b
    g = 2.0 * c_term * e * inv_b
    gcot = [None] * s_steps
    for n in range(s_steps - 1, -1, -1):
        gcot[n] = g
        bn, an, cn = pad(bias[n]), pad(w1[n]), pad(w2[n])
        gdt = g * dt[n]
        du = torch.zeros((WARP, b), dtype=f32, device=dev)
        for j in range(rounds):
            i = idx[j]
            live = (i < na[n])[:, None] & (an[i][:, None] * (traj[n][None, :] - bn[i][:, None]) > 0)
            du = torch.where(live, _fma(gdt[None, :] * cn[i][:, None], an[i][:, None], du), du)
        g = g + _lane_sum(du)
        if mixed:
            c_n = 0.5 * ((dt[n - 1] if n > 0 else 0.0) + dt[n])
            e_n = (traj[n] - tgt[n]) * w
            loss_m = loss_m + c_n * e_n * e_n * inv_b
            g = g + 2.0 * c_n * e_n * inv_b

    # the tiles' partials: members in order, (tiles, S, F) at a time
    member = torch.arange(n_tiles, device=dev)[:, None] * bm  # (tiles, 1)
    ut = torch.stack(traj[:s_steps]).T  # (B, S)
    gt = torch.stack(gcot).T
    active = (torch.arange(f, device=dev)[None, :] < na[:, None])  # (S, F)
    parts = torch.zeros((3, n_tiles, s_steps, f), dtype=f32, device=dev)
    loss_t = torch.zeros(n_tiles, dtype=f32, device=dev)
    for m in range(bm):
        gm = (member + m).clamp(max=b - 1)
        valid = (member + m < b)[:, :, None]  # (tiles, 1, 1)
        gdt = gt[gm] * dt  # (tiles, 1, S)
        d = ut[gm].transpose(1, 2) - bias[None]  # (tiles, S, F)
        sv = w1[None] * d
        gdt = gdt.transpose(1, 2)  # (tiles, S, 1)
        live = valid & active[None] & (sv > 0)
        ds = gdt * w2[None]
        parts[2] = torch.where(live, _fma(gdt, sv, parts[2]), parts[2])
        parts[1] = torch.where(live, _fma(ds, d, parts[1]), parts[1])
        parts[0] = torch.where(live, parts[0] + ds, parts[0])
        loss_t = torch.where(valid[:, 0, 0], loss_t + loss_m[gm[:, 0]], loss_t)
    sums = _tiles_sum(parts.transpose(0, 1))  # (3, S, F)
    grads = torch.stack([torch.where(active, -w1 * sums[0], torch.zeros_like(w1)),
                         sums[1], sums[2]])
    return _tiles_sum(loss_t), grads


# ------------------------------------------------------------------ wrapper


def _check(name, x, shape, dtype, device):
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if device.type == "cuda" and (x.dtype != dtype or not x.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous {dtype}, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (not contiguous)'}")


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resblock_epoch_grad(packed, dt, u0s, targets, weights=None, n_active=None, ramp_weight=None,
                        *, inv_b: float, mixed: bool = False):
    """T1: (loss, grads (3, S, F)) for ``packed`` (3, S, F), ``dt`` (S,),
    ``u0s`` (B,), ``targets`` (B,) or, ``mixed``, (S+1, B), optional 0/1
    ``weights`` (B,) and int ``n_active`` (S,); the loss and gradients
    carry ``inv_b``. On the card one call of the C entry on
    :func:`resblock_plan`'s tiles: the tile kernel, then the reduction."""
    if u0s.dim() != 1 or packed.dim() != 3 or packed.shape[0] != 3:
        raise ValueError(f"u0s must be (B,) and packed (3, S, F); got {tuple(u0s.shape)}, "
                         f"{tuple(packed.shape)}")
    (b,), (_, s_steps, f) = u0s.shape, packed.shape
    dev = u0s.device
    if mixed and ramp_weight is None:
        raise ValueError("mixed=True requires ramp_weight (scalar)")
    _check("packed", packed, (3, s_steps, f), torch.float32, dev)
    _check("dt", dt, (s_steps,), torch.float32, dev)
    _check("u0s", u0s, (b,), torch.float32, dev)
    _check("targets", targets, (s_steps + 1, b) if mixed else (b,), torch.float32, dev)
    if weights is not None:
        _check("weights", weights, (b,), torch.float32, dev)
    if n_active is not None:
        if n_active.dtype.is_floating_point:
            raise TypeError(f"n_active must hold integer counts, got {n_active.dtype}")
        _check("n_active", n_active, (s_steps,), n_active.dtype, dev)
    if dev.type != "cuda":
        return resblock_epoch_grad_plain(packed, dt, u0s, targets, weights, n_active,
                                         ramp_weight, inv_b=inv_b, mixed=mixed)
    plan = resblock_plan(b, _sm_count(dev))
    out = _t1_launch(packed, dt, u0s, targets, weights, n_active, ramp_weight, inv_b, mixed, plan)
    resblock_epoch_grad.launches += 1
    return out


resblock_epoch_grad.launches = 0


def _t1_launch(packed, dt, u0s, targets, weights, n_active, ramp_weight, inv_b: float,
               mixed: bool, plan: ResblockPlan):
    """One call of T1's C entry on ``plan`` (checked CUDA inputs): (loss,
    grads), views of one buffer that also holds the tiles' partials (one
    allocation a call). The wrapper counts its calls; this does not."""
    lib = load_library()
    (_, s_steps, f), b, dev = packed.shape, u0s.shape[0], u0s.device
    na = None if n_active is None else n_active.to(torch.int32).contiguous()
    # the current stream's handle without a Stream object (~0.3 µs, not ~5)
    stream = torch._C._cuda_getCurrentRawStream(dev.index if dev.index is not None
                                                 else torch.cuda.current_device())
    n_grads = 3 * s_steps * f
    # [loss, grads (3·S·F), partials (tiles·3·S·F), partial losses (tiles)]
    out = torch.empty(((1 + plan.n_tiles) * (1 + n_grads),), dtype=torch.float32, device=dev)
    at = out.data_ptr()
    part = at + 4 * (1 + n_grads)
    code = lib.lib.resblock_epoch_grad(
        s_steps, f, b, int(mixed), plan.block_members, packed.data_ptr(), dt.data_ptr(),
        u0s.data_ptr(), targets.data_ptr(), None if weights is None else weights.data_ptr(),
        None if na is None else na.data_ptr(), float(ramp_weight or 0.0), float(inv_b),
        part, part + 4 * plan.n_tiles * n_grads, at, at + 4, stream)
    lib.check(code, "resblock_epoch_grad", lib.lib.train_fused_error_string)
    return out[0], out[1:1 + n_grads].view(3, s_steps, f)


def reset_launch_counts() -> None:
    resblock_epoch_grad.launches = 0


# -------------------------------------------------------------- entry point


def make_cuda_resblock_epoch_grad(n_steps: int, features: int, *, masked: bool = False,
                                  mixed: bool = False, device="cuda"):
    """``run(params, dt, u0s, trues, weights=None, n_active=None,
    ramp_weight=None) -> (loss, grads)``: value and gradient of the epoch
    loss of a per-step ResBlockSimple net (stacked flax-named parameters)
    in one call of T1, with ``make_pallas_resblock_epoch_grad``'s contract
    (train_fused.py:248-300): inputs in float32, ``trues`` (B,) or, with
    ``mixed``, the (S+1, B) trajectory and a ``ramp_weight``; ``weights``
    makes the loss Σw·e²/Σw; ``masked`` takes ``features`` as the capacity
    and needs ``n_active`` (S,). Any B ≥ 1 (the TPU's multiple of 128 does
    not apply)."""
    device = require_device(device)

    def run(params, dt, u0s, trues, weights=None, n_active=None, ramp_weight=None):
        if masked and n_active is None:
            raise ValueError("masked=True requires n_active (S,)")
        if mixed and ramp_weight is None:
            raise ValueError("mixed=True requires ramp_weight (scalar)")
        if mixed and tuple(trues.shape) != (n_steps + 1, u0s.shape[0]):
            raise ValueError(f"mixed=True targets must be the full (S+1, B) trajectory, got "
                             f"{tuple(trues.shape)}")
        f32 = lambda x: torch.as_tensor(x).to(device=device, dtype=torch.float32).contiguous()  # noqa: E731
        packed = pack_params(params, n_steps, features).to(device)
        u0 = f32(u0s)
        w = None if weights is None else f32(weights)
        inv_b = 1.0 if w is not None else 1.0 / u0.shape[0]
        na = None if not masked else torch.as_tensor(n_active).to(device=device,
                                                                   dtype=torch.int32)
        loss, g = resblock_epoch_grad(packed, f32(dt), u0, f32(trues), w, na,
                                      None if ramp_weight is None else float(ramp_weight),
                                      inv_b=inv_b, mixed=mixed)
        if w is not None:
            live = torch.sum(w)
            loss, g = loss / live, g / live
        return loss, unpack_grads(g, n_steps, features)

    return run
