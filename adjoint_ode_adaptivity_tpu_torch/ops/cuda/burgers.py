"""The limited Burgers march on hand-written CUDA (B1, csrc/burgers.cu).

Counterpart of the JAX package's ``ops/pallas/burgers.py``:
:func:`make_cuda_burgers_march` on (Np, B, K) batches replaces
``make_pallas_burgers_march`` and :func:`make_cuda_burgers_march_single` on
(Np, K) states replaces ``make_pallas_burgers_march_single_blocked``; one
kernel serves both (the TPU's blocked-sublane layout has no counterpart).

The wrapper :func:`burgers_march` launches B1 for a CUDA float32 or float64
tensor and raises on anything the kernel does not take; a CPU tensor takes
the kernel's plain PyTorch version :func:`burgers_march_plain`, which does
the same arithmetic with the same folded tables. Nothing falls back from
the kernel to the plain version. The wrapper counts its calls that launch in
``burgers_march.launches`` and keeps the last call's CUDA launches in
``burgers_march.cuda_launches``.

On the card B1 runs s_f steps a launch, one CTA per (tile, member) on a
window of L local elements and W ghosts a side taken around the periodic
ring; where one tile holds the mesh the whole march is one launch with no
ghosts. :func:`burgers_plan` picks the schedule under a cost model fitted
on the card, and :func:`burgers_march_fused_plain` runs the same schedule
in plain PyTorch (the same tiles, windows, remainders and per-element
geometry), bit-equal to the untiled plain version: the ghost rule (W ≥
10·s_f limited, 5·s_f unlimited) is tested there. The kernel takes Np
2-16 (N = 1-15), one thread an element at every order; above Np = 8 the
plans price a step by the high-order fit (:data:`HIGH_NP_COST`) and take
512-thread CTAs.

The plain version equals ``march/burgers.py::burgers_march`` per batch
member up to the order of operations (the step size is folded into the
tables here, and the cell average and the limited slope are single
coefficient rows, as in the Pallas kernel's ``_host_tables``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.march.lsrk import RK4A, RK4B
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import Discretization1D

__all__ = [
    "BurgersTables",
    "BurgersPlan",
    "burgers_tables",
    "burgers_plan",
    "burgers_fused_plan",
    "burgers_march",
    "burgers_march_plain",
    "burgers_march_fused_plain",
    "reset_launch_counts",
    "make_cuda_burgers_march",
    "make_cuda_burgers_march_single",
]

# Np 2-16: csrc/burgers.cu's folded tables (kMaxNp = 16) and the instances
# it builds; float64 at 512 threads already spills 52-372 bytes at Np 11-16
MIN_NP, MAX_NP = 2, 16
LIMITER_IDS = {"n": 0, "1": 1, "none": 2}
EPS0 = 1.0e-8  # the troubled-cell threshold of utils/SlopeLimitN.m


class BurgersTables(NamedTuple):
    """Everything B1 needs for one mesh, step size and limiter, on one
    device: the folded coefficient rows (float64 tensors for the plain
    version), the per-element geometry rows, and the packed host copies
    that the kernel takes by value."""

    np_: int
    k: int
    dt: float
    limiter: str
    drc: torch.Tensor  # (Np, Np) −dt·Dr
    ll: torch.Tensor  # (Np,) dt·LIFT[:, 0]
    lr: torch.Tensor  # (Np,) dt·LIFT[:, 1]
    cavg: torch.Tensor  # (Np,) V[0,0]·invV[0, :]
    drux: torch.Tensor  # (Np,) (Dr·Π¹)[0, :]
    geom: torch.Tensor  # (4 + Np, K) [rx, fscale_l, fscale_r, 1/h, ξ_0..ξ_{Np−1}]
    packed: np.ndarray  # float64 [drc, ll, lr, cavg, drux, RK4A, RK4B]


def burgers_tables(disc: Discretization1D, dt: float, limiter: str = "n",
                   device="cuda") -> BurgersTables:
    """Fold B1's tables for ``disc`` at step ``dt`` on ``device`` (the
    counterpart of the Pallas kernel's ``_host_tables``, always with the
    per-element geometry)."""
    if limiter not in LIMITER_IDS:
        raise ValueError(f"limiter {limiter!r}: expected one of {tuple(LIMITER_IDS)}")
    if not MIN_NP <= disc.np_ <= MAX_NP:
        raise ValueError(f"Np={disc.np_}: the kernel takes {MIN_NP} <= Np <= {MAX_NP} "
                         f"(MAX_NP = {MAX_NP}: an element's nodes in one thread's registers)")
    device = require_device(device)
    v, inv_v, dr = (np.asarray(m, dtype=np.float64) for m in (disc.v, disc.inv_v, disc.dr))
    n_lin = min(2, disc.np_)
    p_lin = v[:, :n_lin] @ inv_v[:n_lin, :]
    drc = -dt * dr
    ll = dt * np.asarray(disc.lift[:, 0], dtype=np.float64)
    lr = dt * np.asarray(disc.lift[:, 1], dtype=np.float64)
    cavg = v[0, 0] * inv_v[0, :]
    drux = dr[0, :] @ p_lin
    x = np.asarray(disc.x, dtype=np.float64)
    h = x[-1, :] - x[0, :]
    geom = np.concatenate([
        np.asarray(disc.rx[0, :])[None], np.asarray(disc.fscale[0, :])[None],
        np.asarray(disc.fscale[1, :])[None], (1.0 / h)[None], x - (x[0, :] + h / 2)[None, :],
    ])
    packed = np.concatenate([drc.ravel(), ll, lr, cavg, drux, RK4A, RK4B])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    return BurgersTables(disc.np_, disc.k, float(dt), limiter, t(drc), t(ll), t(lr), t(cavg),
                         t(drux), t(geom), np.ascontiguousarray(packed))


# ------------------------------------------------------------ plain version


def _minmod3(a, b, c):
    s = (torch.sign(a) + torch.sign(b) + torch.sign(c)) / 3.0
    mag = torch.minimum(torch.abs(a), torch.minimum(torch.abs(b), torch.abs(c)))
    return torch.where(torch.abs(s) == 1.0, s * mag, torch.zeros_like(s))


def plain_operands(tab: BurgersTables, dtype):
    names = ("drc", "ll", "lr", "cavg", "drux", "geom")
    return dict(zip(names, (getattr(tab, n).to(dtype) for n in names)))


def _rhs_dt_plain(u, p, ring=True):
    """dt·rhs on (Np, B, K): LLF flux, volume and lift. ``ring``: the
    traces wrap around (periodic); else each end element takes its own face
    value for its missing outer neighbour's (a fused window's ends)."""
    rx, fsl, fsr = p["geom"][0], p["geom"][1], p["geom"][2]
    f = 0.5 * u * u
    u_l, u_r = u[0], u[-1]  # (B, K)
    if ring:
        u_l_ext = torch.roll(u_r, 1, dims=-1)
        u_r_ext = torch.roll(u_l, -1, dims=-1)
    else:
        u_l_ext = torch.cat([u_l[:, :1], u_r[:, :-1]], dim=-1)
        u_r_ext = torch.cat([u_l[:, 1:], u_r[:, -1:]], dim=-1)
    c_l = torch.maximum(torch.abs(u_l), torch.abs(u_l_ext))
    c_r = torch.maximum(torch.abs(u_r), torch.abs(u_r_ext))
    fstar_l = 0.5 * (0.5 * u_l * u_l + 0.5 * u_l_ext * u_l_ext) + 0.5 * c_l * (u_l_ext - u_l)
    fstar_r = 0.5 * (0.5 * u_r * u_r + 0.5 * u_r_ext * u_r_ext) - 0.5 * c_r * (u_r_ext - u_r)
    df_l = (-(0.5 * u_l * u_l) + fstar_l) * fsl
    df_r = (0.5 * u_r * u_r - fstar_r) * fsr
    vol = (p["drc"] @ f.reshape(u.shape[0], -1)).reshape(f.shape) * rx
    return vol + p["ll"][:, None, None] * df_l + p["lr"][:, None, None] * df_r


def limited_and_margin(u, p, first=None, last=None):
    """The Π¹-limited candidate of every element of (Np, B, K) ``u`` and
    ΠN's troubled-cell margin (B, K), max(|ve1 − u_0|, |ve2 − u_{Np−1}|):
    a cell is troubled where it exceeds ε₀. Copied-endpoint neighbour
    averages at the ends, and (a fused window) where the (K,) masks
    ``first``/``last`` mark the global ends; ``p`` from
    :func:`plain_operands`."""
    ih, xi = p["geom"][3], p["geom"][4:, None, :]
    vk = torch.tensordot(p["cavg"], u, dims=1)  # (B, K)
    vkm1 = torch.cat([vk[:, :1], vk[:, :-1]], dim=1)
    vkp1 = torch.cat([vk[:, 1:], vk[:, -1:]], dim=1)
    if first is not None:
        vkm1 = torch.where(first, vk, vkm1)
        vkp1 = torch.where(last, vk, vkp1)
    dm, dp = vk - vkm1, vkp1 - vk
    ux = 2.0 * torch.tensordot(p["drux"], u, dims=1) * ih
    limited = vk + xi * _minmod3(ux, dp * ih, dm * ih)
    ve1 = vk - _minmod3(vk - u[0], dm, dp)
    ve2 = vk + _minmod3(u[-1] - vk, dm, dp)
    return limited, torch.maximum(torch.abs(ve1 - u[0]), torch.abs(ve2 - u[-1]))


def _steps_plain(u, n_steps, limiter, p, observe=None, ring=True, first=None, last=None):
    """``n_steps`` LSRK4(5) steps of (Np, B, K) ``u`` with the limiter
    after every stage (see :func:`_rhs_dt_plain`, :func:`limited_and_margin`
    for ``ring``, ``first`` and ``last``)."""

    def limit(v):
        if limiter == "none":
            return v
        limited, margin = limited_and_margin(v, p, first, last)
        if observe is not None:
            observe(v, limited, margin)
        return limited if limiter == "1" else torch.where(margin > EPS0, limited, v)

    resu = None
    for _ in range(n_steps):
        for s in range(5):
            r = _rhs_dt_plain(u, p, ring)
            resu = r if s == 0 else float(RK4A[s]) * resu + r
            u = limit(u + float(RK4B[s]) * resu)
    return u


def burgers_march_plain(u0: torch.Tensor, n_steps: int, tab: BurgersTables,
                        observe=None) -> torch.Tensor:
    """B1's plain version on (Np, B, K): ``n_steps`` LSRK4(5) steps with the
    LLF flux (periodic) and the limiter after every stage. ``observe(v,
    limited, margin)``, when given, sees every limited stage's updated
    state, its Π¹ candidate and ΠN's margin (for checks of the kernel)."""
    return _steps_plain(u0, n_steps, tab.limiter, plain_operands(tab, u0.dtype), observe)


# ------------------------------------------------------------ launch plans


class BurgersPlan(NamedTuple):
    """B1's launch schedule: ``segment`` (s_f) steps a launch; CTA tiles of
    ``tile`` (L) local elements, the last ragged, each with a window of
    ``ghost`` (W) elements a side around the periodic ring; CTAs built for
    ``threads``, one thread a window element. ``ghost == 0`` with one tile
    of the whole mesh: the window is the ring itself."""

    segment: int
    ghost: int
    tile: int
    n_tiles: int
    threads: int


CTA_THREADS = (512, 1024)  # float32; float64 is built for 512 only
CANDIDATE_STEPS = (2, 4, 8, 16)

# The plans' cost model: a launch lasts as long as its busiest SM takes to
# issue s_f steps of its warps (BURGERS_STEP_WARP_US a step for each warp
# the SM holds, at least MIN_WARPS' worth: below that the stage's dependent
# chain and its two barriers set the pace), plus LAUNCH_US a launch.
# Fitted to chip_smoke.py phase 33 on an NVIDIA H100 (700 W): the 16 tiled
# plans at bench.py's row (Np = 3, B = 8 and 1) imply 0.151-0.189 µs, the
# median 0.168. The ring at burgers_dg's shape (two warps, Np = 5) runs its
# stage's dependent chain faster than the 16-warp floor says: the model
# reads it ~44 % high, and it is the only plan there.
BURGERS_STEP_WARP_US = 0.17
LAUNCH_US = 3.74
MIN_WARPS = 16
H100_SMS = 132
# Above Np = 8: (c0, c2, launch) -> c0 + c2·Np² µs a step for each warp the
# busiest SM holds, plus launch µs a launch, least squares over
# tools/torch_high_order_plans.py's sweep (float32 ΠN, K = 10⁴, B = 8, 256
# steps, Np 9, 12 and 16, every candidate plan, 512-thread CTAs) on an
# NVIDIA H100 80GB HBM3 at 700 W; its plans there were the fastest measured.
HIGH_NP_COST = (0.23514, 0.001397, 7.09)


def ghost_rule(limiter: str) -> int:
    """W per fused step: a limited stage couples ±2 elements (the
    neighbours' traces, then their updated averages), 5 stages a step; an
    unlimited stage ±1."""
    return 5 if limiter == "none" else 10


def is_ring(k: int, plan: BurgersPlan) -> bool:
    return plan.ghost == 0 and plan.tile >= k


def window_of(k: int, plan: BurgersPlan) -> int:
    """A CTA's window: the ring, or L + 2W."""
    return k if is_ring(k, plan) else min(plan.tile, k) + 2 * plan.ghost


def _threads_for(f64: bool, np_: int):
    """The CTA sizes the plans take: float32 512 or 1024 threads through
    Np = 8 (ptxas -v: 38-64 registers, no spills), 512 above (1024 spills
    20-196 bytes from Np = 11; 512 measured fastest at Np 9, 12 and 16);
    float64 is built for 512 only (54-128 registers)."""
    return CTA_THREADS[:1] if f64 or np_ > 8 else CTA_THREADS


def burgers_fused_plan(k: int, steps: int, threads: int = 512, limiter: str = "n") -> BurgersPlan:
    """B1's widest plan of ``steps`` steps a launch on CTAs of ``threads``:
    W = :func:`ghost_rule`·steps, L = threads − 2W."""
    if steps < 1:
        raise ValueError(f"steps={steps}: B1 fuses at least one step a launch")
    if threads not in CTA_THREADS:
        raise ValueError(f"threads={threads}: B1 is built for {CTA_THREADS}")
    ghost = ghost_rule(limiter) * steps
    tile = threads - 2 * ghost
    if tile < 1:
        raise ValueError(f"{steps} steps need {2 * ghost} ghost elements, past a "
                         f"{threads}-thread window")
    return BurgersPlan(steps, ghost, tile, -(-k // tile), threads)


def _cost(k: int, b: int, np_: int, n_steps: int, plan: BurgersPlan, sms: int) -> float:
    """Modelled µs of ``plan``: n_steps times the busiest SM's warps (CTAs
    dealt round-robin; at least MIN_WARPS) at BURGERS_STEP_WARP_US a step
    (above Np = 8 :data:`HIGH_NP_COST`'s), plus the launches."""
    step_us, launch_us = BURGERS_STEP_WARP_US, LAUNCH_US
    if np_ > 8:
        step_us, launch_us = HIGH_NP_COST[0] + HIGH_NP_COST[1] * np_ * np_, HIGH_NP_COST[2]
    warps = -(-plan.n_tiles * b // sms) * -(-window_of(k, plan) // 32)
    return n_steps * max(warps, MIN_WARPS) * step_us + -(-n_steps // plan.segment) * launch_us


def _plans(k: int, b: int, np_: int, n_steps: int, limiter: str, f64: bool, sms: int):
    """The candidates: one tile of the whole ring where a CTA holds it (one
    launch), then for s_f ∈ {2, 4, 8, 16} (at most n_steps) and each CTA
    size every tiling from the fewest tiles a CTA holds to one more CTA an
    SM (each tile count's L = ⌈K/tiles⌉)."""
    threads_opts = _threads_for(f64, np_)
    for threads in threads_opts:
        if k <= threads:
            yield BurgersPlan(n_steps, 0, k, 1, threads)
            break
    for steps in sorted({min(s, n_steps) for s in CANDIDATE_STEPS}):
        for threads in threads_opts:
            try:
                widest = burgers_fused_plan(k, steps, threads, limiter)
            except ValueError:
                continue
            n_min = -(-k // widest.tile)
            for n_t in range(n_min, n_min + -(-sms // b) + 1):
                tile = -(-k // n_t)
                yield widest._replace(tile=tile, n_tiles=-(-k // tile))


@functools.lru_cache(maxsize=256)
def burgers_plan(k: int, b: int, np_: int, n_steps: int, limiter: str = "n",
                 f64: bool = False, sms: int = H100_SMS) -> BurgersPlan:
    """B1's plan for K elements, B members, Np nodes and n_steps ≥ 1 steps
    with ``limiter`` in float32 (or ``f64``) on a card of ``sms`` SMs (the
    model is fitted at Np = 3 and 5 and taken through Np = 8; above, the
    high-order fit): of :func:`_plans`, whichever minimises
    :func:`_cost`; a tie goes to the first found (the ring, then the fewest
    steps, 512 threads, the fewest tiles)."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps}: a plan needs at least one step")
    best = None
    for plan in _plans(k, b, np_, n_steps, limiter, f64, sms):
        cost = _cost(k, b, np_, n_steps, plan, sms)
        if best is None or cost < best[0]:
            best = (cost, plan)
    return best[1]


def burgers_march_fused_plain(u0: torch.Tensor, n_steps: int, tab: BurgersTables,
                              plan: BurgersPlan) -> torch.Tensor:
    """B1's launch schedule in plain PyTorch: s_f steps a launch (the last
    takes the remainder), every tile on its own window around the periodic
    ring, the window's end slots taking their own face values and averages
    for their missing neighbours', the limiter's copied endpoints at the
    global ends (any ghost width, so a narrow one can be shown to reach the
    local elements)."""
    p = plain_operands(tab, u0.dtype)
    k = tab.k
    ring = is_ring(k, plan)
    u = u0
    for lo_n in range(0, n_steps, plan.segment):
        steps = min(plan.segment, n_steps - lo_n)
        nxt = torch.empty_like(u)
        for t in range(plan.n_tiles):
            lo = t * plan.tile
            hi = min(lo + plan.tile, k)
            w0, w1 = (0, k) if ring else (lo - plan.ghost, hi + plan.ghost)
            idx = torch.arange(w0, w1, device=u.device) % k
            pw = dict(p, geom=p["geom"][:, idx])
            uw = _steps_plain(u[:, :, idx], steps, tab.limiter, pw, ring=ring,
                              first=idx == 0, last=idx == k - 1)
            loc = slice(lo - w0, hi - w0)
            nxt[:, :, lo:hi] = uw[:, :, loc]
        u = nxt
    return u


# ------------------------------------------------------------------ wrapper


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def burgers_march(u0: torch.Tensor, n_steps: int, tab: BurgersTables) -> torch.Tensor:
    """B1: march (Np, B, K) ``u0`` n_steps limited LSRK4(5) steps. A CUDA
    float32/float64 tensor launches the kernel on :func:`burgers_plan`'s
    schedule for the card's SM count (⌈n_steps/s_f⌉ CUDA launches; one
    where a CTA holds the mesh); a CPU tensor takes the plain version."""
    if n_steps < 0:
        raise ValueError(f"n_steps={n_steps} must be >= 0")
    if u0.dim() != 3 or u0.shape[0] != tab.np_ or u0.shape[2] != tab.k:
        raise ValueError(f"u0: shape {tuple(u0.shape)}, expected ({tab.np_}, B, {tab.k})")
    if u0.device != tab.geom.device:
        raise ValueError(f"u0 on {u0.device}, kernel operands on {tab.geom.device}")
    if u0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"u0: dtype {u0.dtype}; B1 takes float32/float64")
    if u0.device.type == "cpu":
        return burgers_march_plain(u0, n_steps, tab)
    if u0.device.type != "cuda":
        raise ValueError(f"u0: device {u0.device} is neither cuda nor cpu")
    if not u0.is_contiguous():
        raise ValueError("u0 must be contiguous")
    if n_steps == 0:
        return u0.clone()
    plan = burgers_plan(tab.k, u0.shape[1], tab.np_, n_steps, tab.limiter,
                        u0.dtype == torch.float64, _sm_count(u0.device))
    u, burgers_march.cuda_launches = _b1_launch(u0, n_steps, tab, plan)
    burgers_march.launches += 1
    return u


burgers_march.launches = 0
burgers_march.cuda_launches = 0


def _b1_launch(u0: torch.Tensor, n_steps: int, tab: BurgersTables, plan: BurgersPlan):
    """One B1 march of CUDA ``u0`` on ``plan``: ``(u, CUDA launches)``. The
    wrapper counts its calls; this does not."""
    lib = load_library()
    f64 = u0.dtype == torch.float64
    packed = tab.packed if f64 else tab.packed.astype(np.float32)
    geom = tab.geom.to(u0.dtype).contiguous()
    u_out = torch.empty_like(u0)
    ubuf = (torch.empty((2, *u0.shape), dtype=u0.dtype, device=u0.device)
            if n_steps > plan.segment else None)
    launches = ctypes.c_int(0)
    entry = lib.lib.burgers_march_f64 if f64 else lib.lib.burgers_march_f32
    code = entry(
        tab.np_, u0.shape[1], tab.k, n_steps, LIMITER_IDS[tab.limiter], plan.segment,
        plan.tile, plan.ghost, plan.threads, packed.ctypes.data_as(ctypes.c_void_p),
        geom.data_ptr(), u0.data_ptr(), u_out.data_ptr(),
        None if ubuf is None else ubuf.data_ptr(), ctypes.addressof(launches),
        torch.cuda.current_stream(u0.device).cuda_stream,
    )
    lib.check(code, "burgers_march", lib.lib.burgers_error_string)
    return u_out, launches.value


def reset_launch_counts() -> None:
    burgers_march.launches = 0


# -------------------------------------------------------------- entry points


def make_cuda_burgers_march(disc: Discretization1D, dt: float, n_steps: int, batch: int = 8,
                            limiter: str = "n", device="cuda"):
    """Returns ``run(u0) -> u_final`` for batched states (Np, B, K):
    ``n_steps`` limited LSRK4(5) Burgers steps in one B1 launch."""
    tab = burgers_tables(disc, dt, limiter, device)

    def run(u0):
        if u0.dim() != 3 or u0.shape[1] != batch:
            raise ValueError(f"u0: shape {tuple(u0.shape)}, expected ({disc.np_}, {batch}, {disc.k})")
        return burgers_march(u0, n_steps, tab)

    return run


def make_cuda_burgers_march_single(disc: Discretization1D, dt: float, n_steps: int,
                                   limiter: str = "n", device="cuda"):
    """Limited Burgers march of one (Np, K) state: B1 at B = 1. Same
    contract as ``march/burgers.py::burgers_march``."""
    tab = burgers_tables(disc, dt, limiter, device)

    def run(u0):
        if u0.dim() != 2:
            raise ValueError(f"u0: shape {tuple(u0.shape)}, expected ({disc.np_}, {disc.k})")
        return burgers_march(u0[:, None, :].contiguous(), n_steps, tab)[:, 0, :]

    return run
