"""The per-member mixed-order (hp) DG-in-time estimate on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/dg_slab_mixed.py``. One
kernel, **H1** :func:`dg_estimate_hp_per_member` (csrc/dg_slab_mixed.cu),
replaces ``_mixed_kernel`` (dg_slab_mixed.py:99): per member, with its own
partition and order vector, the coarse Newton march at orders ``ns``, the
fine march at ``ns + fine_offset``, the adjoint at ``ns + 1`` (solved, or
solved at ``ns`` and lifted by Radau reconstruction) and the per-element
adjoint-weighted residual, a group of G lanes of one warp per member. It is
the engine of the hp loops (adapt/hp_loop.py) with ``engine="cuda"``.

What bounds it, and what the design does about it: FP32 arithmetic on one
serial chain per member (elements × Newton steps), so the kernel is
latency-bound. The G lanes of a member split every quadrature loop (lane ℓ
the points q ≡ ℓ mod G) and join their partial sums by a fixed-order xor
butterfly of warp shuffles, so the chain's quadrature part shortens G-fold
and the card holds G× more warps; each lane then assembles and solves the
member's small system itself. The systems are padded to the stack's node
count ``np_max`` (a template parameter: registers, unrolled loops); the
folded tables (:func:`kernel_tables`) live in shared memory, copied once per
CTA, and a member's lanes read the same address. :func:`hp_plan` picks G
and the CTA size; :func:`dg_estimate_hp_lanes_plain` emulates the lanes'
sum order in plain PyTorch.

A CUDA float32 tensor launches the kernel or raises; a CPU tensor takes its
plain version, :func:`dg_estimate_hp_per_member_plain` —
``adjoint/dg_mixed.dg_estimate_mixed(..., newton_iters=n)``, the same
function in eager torch. Nothing falls back from the kernel. The wrapper
counts its launches in ``.launches``.

The goal J = ∫g(u, t) dt enters as the adjoint's source g_u, as in the DG
slab kernel: J = ∫u on the folded row sums, any other g_u by a functor —
the registry's (J = ∫u²) or a caller's callable traced into one
(ops/cuda/functor.py) — evaluated at the system's live nodes and 0 at the
padding (the TPU kernel's live mask), which keeps a g_u singular at 0
(g_u = 1/u) finite. The ODE's f and f_u are a registry entry's functor or
traced callables (f_u derived by forward mode when not given); anything
traced runs on a user library of csrc/dg_slab_mixed.cu alone.

The TPU tiling (the (8, B/8) member tiles, ``pick_lane_block``,
``ensure_scoped_vmem``, B a multiple of 8) is not ported: any B ≥ 1. The
kernel does not check the orders (that would cost a host read per launch):
the hp loops keep them in ``1..n_max_user`` by construction; the plain
version checks.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    MixedAdjointInterp,
    MixedRadauInterp,
    _geometry,
    _inflows,
    dg_estimate_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import (
    MixedDGTimeOperators,
    _a_adj,
    _a_fwd,
    _one_hot,
    _tab,
    gauss_solve,
)
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_slab import _check, _lane_sum, _seq_dot
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.fd_ensemble import _consts
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import KernelFunctors, scalar_functors

__all__ = [
    "HpPlan",
    "HpLaunch",
    "hp_plan",
    "kernel_tables",
    "dg_estimate_hp_per_member",
    "dg_estimate_hp_per_member_plain",
    "dg_estimate_hp_lanes_plain",
    "hp_kernel_tolerance",
    "reset_launch_counts",
    "make_cuda_dg_estimate_hp_per_member",
]

MAX_NP = 8  # the stack's padded node count the kernel takes (3..8)
MAX_TABLES = 12 * 1024  # floats of shared memory the kernel holds (csrc kMaxHpTables)
LANES = (4, 8, 16)  # the lanes a member hp_plan picks from (the kernel takes 1..32)
CTA_THREADS = (64, 128, 256)  # CTA sizes timed on the card (the kernel takes 32..256)
# hp_plan's rule: the most lanes (at most the quadrature points) that keep
# B·G/32 at or below HP_MAX_WARPS warps on the card
HP_MAX_WARPS = 1024


class HpLaunch(NamedTuple):
    """H1's launch plan: ``lanes`` (G) lanes of one warp per member, CTAs of
    ``threads``, each holding threads/G members."""

    lanes: int
    threads: int


@functools.lru_cache(maxsize=64)
def hp_plan(b: int, np_max: int, nq: int) -> HpLaunch:
    """H1's launch plan for B members of a stack padded to np_max nodes on
    an Nq-point Gauss rule: G = the most of LANES (4, 8, 16) with G ≤ Nq and
    B·G/32 ≤ HP_MAX_WARPS warps (else 4), on 64-thread CTAs.

    From times on an NVIDIA H100 80GB HBM3 at 700 W (the development runs of
    chip_smoke.py phase 34; 64-thread CTAs, np_max 6 with Nq = 22
    unless said; ms, solve mode): B = 512, G = 4/8/16/32: 0.611 / 0.549 /
    0.531 / 0.548; B = 4096: 0.641 / 0.640 / 0.811 / 1.496; np_max 8 (Nq =
    28), B = 1024: 0.821 / 0.795 / 0.738 / 0.876. A member's chain waits on
    its own dependencies (1-8 warps an SM), so more lanes shorten it until
    the butterfly's extra round and idle lanes (G = 32 > Nq/2) cost more
    than they save, or until the grid outgrows the card (B = 4096 at G =
    16: 2048 warps). 64- and 128-thread CTAs measured the same, 256 slower
    (fewer CTAs for the same warps). np_max 6 and 8 picked the same G."""
    lanes = [g for g in LANES if g <= nq and b * g <= 32 * HP_MAX_WARPS]
    return HpLaunch(max(lanes, default=LANES[0]), 64)


class HpPlan(NamedTuple):
    """Everything the kernel needs, on one device: the operator stacks, the
    folded tables (:func:`kernel_tables` rounded to float32, on the device),
    the ODE's by-value constants, and ``functors``: what the kernel runs
    (its library and ids) and the plain version's callables (``functors.ode``
    and ``functors.g_u``, None: J = ∫u)."""

    mops: MixedDGTimeOperators
    interp: MixedAdjointInterp
    rad: MixedRadauInterp | None  # adjoint_mode "reconstruct" only
    n_elements: int
    fine_offset: int
    newton_iters: int
    adjoint_mode: str
    tables: torch.Tensor  # float32, on ``device``
    consts: np.ndarray
    n_modes: tuple
    device: torch.device
    functors: KernelFunctors


def kernel_tables(mops: MixedDGTimeOperators, interp: MixedAdjointInterp,
                  rad: MixedRadauInterp | None = None, goal: bool = False) -> np.ndarray:
    """The kernel's tables in float64 (csrc/dg_slab_mixed.cu ``HpLayout``):
    w_q (Q), (1 + r_q)/2 (Q); per stack order s: A_fwd = Sᵀ − e_{s+1}e_{s+1}ᵀ
    + pad_eye, A_adj = −Sᵀ − e_0e_0ᵀ + pad_eye, Sᵀ (np_max² each), the mass
    row sums (np_max; M·g_u with g_u ≡ 1) and Φ (Q×np_max); per primal order
    p: to_nodes, the Radau eval_rad and to_hi (np_max² each; zero without
    ``rad``) and to_quad (Q×np_max); with ``goal`` (a g_u other than ≡ 1)
    then per stack order s: the padded mass matrix (np_max²) and (1 + r_i)/2
    (np_max, the padding's r = 1)."""
    np_m, n_stack = mops.np_max, mops.n_max
    s_t, a_adj = mops.stiff_pad.transpose(0, 2, 1), _a_adj(mops)
    eval_rad = np.zeros((n_stack - 1, np_m, np_m)) if rad is None else rad.eval_rad
    to_hi = np.zeros((n_stack - 1, np_m, np_m)) if rad is None else rad.to_hi
    parts = [mops.wq, (1.0 + mops.rq) / 2.0]
    a_fwd = _a_fwd(mops)
    for s in range(n_stack):
        parts += [a_fwd[s], a_adj[s], s_t[s], mops.mass_pad[s].sum(axis=1), mops.phi_pad[s]]
    for p in range(n_stack - 1):
        parts += [interp.to_nodes[p], eval_rad[p], to_hi[p], interp.to_quad[p]]
    if goal:
        for s in range(n_stack):
            parts += [mops.mass_pad[s], (1.0 + mops.r_pad[s]) / 2.0]
    return np.concatenate([np.asarray(x, dtype=np.float64).ravel() for x in parts])


# ------------------------------------------------------------ plain version


def dg_estimate_hp_per_member_plain(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor,
                                    plan: HpPlan):
    """H1's plain version: ``dg_estimate_mixed`` with the plan's ODE,
    ``newton_iters`` Newton steps and the plan's goal (g_u, 0 at the
    padding), in the inputs' dtype. Returns ``(u_c, u_f, v (B, K, np_max),
    err (B, K))``."""
    ode = plan.functors.ode
    return dg_estimate_mixed(plan.mops, plan.interp, ode.f, times, ns, y0s,
                             fine_offset=plan.fine_offset, adjoint_mode=plan.adjoint_mode,
                             rad=plan.rad, f_u=ode.f_u, g_u=plan.functors.g_u,
                             newton_iters=plan.newton_iters)


# ------------------------------------------------- the lanes' sum order


def _quad_parts(interp, ue, phi_r, phi_m, tl, h, consts, ode, lanes: int):
    """One quadrature loop of H1 for (B,) members: u_q = interp·ue, then
    res_i = Σ_q phi_r[q, i]·w_q f_q and the symmetric mat_ij = Σ_q (w_q
    f_u,q·phi_m[q, i])·phi_m[q, j], each in the lanes' order."""
    wq, cq = consts
    uq = _seq_dot(interp, ue[:, None, :])
    t_q = tl[:, None] + cq * h[:, None]
    wf, wfu = wq * ode.f(uq, t_q), wq * ode.f_u(uq, t_q)
    res = _lane_sum(phi_r * wf[..., None], lanes)
    d = wfu[..., None] * phi_m
    mat = _lane_sum(d[..., :, None] * phi_m[..., None, :], lanes)
    upper = torch.ones(mat.shape[-2:], dtype=torch.bool, device=mat.device).triu()
    return res, torch.where(upper, mat, mat.transpose(-1, -2))


def dg_estimate_hp_lanes_plain(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor,
                               plan: HpPlan, lanes: int):
    """H1's algorithm in plain PyTorch with its sum order at ``lanes`` (G)
    lanes a member: the kernel's float32 tables, every quadrature loop summed
    by :func:`_lane_sum`, the residual vᵀres split by rows likewise, the
    assembly and the interpolations as the kernel's unrolled chains, each
    member's elements and Newton steps in the kernel's order. Products are
    rounded apart (the kernel contracts them into FMAs) and the systems are
    solved by ``gauss_solve`` (the kernel: Cramer or pivoted elimination),
    so this holds the sum order, not the kernel's bits. Returns ``(u_c, u_f,
    v, err)`` as the plain version does."""
    mops, interp, ode = plan.mops, plan.interp, plan.functors.ode
    like = times
    f32 = lambda x: _tab(x, like)  # noqa: E731
    a_fwd, a_adj, phi = f32(_a_fwd(mops)), f32(_a_adj(mops)), f32(mops.phi_pad)
    s_t, msum = f32(mops.stiff_pad.transpose(0, 2, 1)), f32(mops.mass_pad.sum(axis=2))
    mass, c_nodes = f32(mops.mass_pad), f32((1.0 + mops.r_pad) / 2.0)
    to_nodes, to_quad = f32(interp.to_nodes), f32(interp.to_quad)
    consts = (f32(mops.wq), f32((1.0 + mops.rq) / 2.0))
    ns = ns.to(torch.int64)
    b, k_el = ns.shape
    rows = torch.arange(mops.np_max, device=times.device)
    take = lambda x, idx: torch.gather(x, 1, idx[:, None])[:, 0]  # noqa: E731

    def march(offset):
        out, u_prev = [], y0s
        for k in range(k_el):
            tl, h = times[:, k], times[:, k + 1] - times[:, k]
            top = ns[:, k] + offset
            a_t, ph = a_fwd[top - 1], phi[top - 1]
            u = torch.where(rows <= top[:, None], u_prev[:, None], torch.zeros_like(ph[:, 0]))
            for _ in range(plan.newton_iters):
                res, jac = _quad_parts(ph, u, ph, ph, tl, h, consts, ode, lanes)
                r = _seq_dot(a_t, u[:, None, :]) + (h / 2)[:, None] * res
                r[:, 0] = r[:, 0] + u_prev
                u = u - gauss_solve(a_t + (h / 2)[:, None, None] * jac, r)
            out.append(u)
            u_prev = take(u, top)
        return torch.stack(out, dim=1)

    u_c, u_f = march(0), march(plan.fine_offset)
    rec = plan.adjoint_mode == "reconstruct"
    if rec:
        eval_rad, to_hi = f32(plan.rad.eval_rad), f32(plan.rad.to_hi)
    v, err = torch.empty_like(u_c), torch.empty_like(u_c[..., 0])
    v_in = torch.zeros_like(y0s)
    for k in range(k_el - 1, -1, -1):
        tl, h = times[:, k], times[:, k + 1] - times[:, k]
        hh, n = (h / 2)[:, None], ns[:, k]
        ue = u_c[:, k]
        up = y0s if k == 0 else take(u_c[:, k - 1], ns[:, k - 1])
        s_sys = n - 1 if rec else n
        uh = _seq_dot(to_nodes[n - 1], ue[:, None, :])
        ra, mat = _quad_parts(to_quad[n - 1], ue, phi[n], phi[s_sys], tl, h, consts, ode, lanes)
        if plan.functors.g_u is None:
            rhs = -hh * msum[s_sys]
        else:  # g_u at the system's live nodes, 0 at the padding
            x = ue if rec else uh
            gu = torch.where(rows <= (s_sys + 1)[:, None],
                             plan.functors.g_u(x, tl[:, None] + c_nodes[s_sys] * h[:, None]),
                             torch.zeros_like(x))
            rhs = -hh * _seq_dot(mass[s_sys], gu[:, None, :])
        rhs = torch.where(rows == (s_sys + 1)[:, None], rhs - v_in[:, None], rhs)
        w = gauss_solve(a_adj[s_sys] + hh[..., None] * mat, rhs)
        if rec:
            vals = _seq_dot(eval_rad[n - 1], w[:, None, :])
            vals = torch.where(rows == (n + 1)[:, None], vals + v_in[:, None], vals)
            v[:, k] = _seq_dot(to_hi[n - 1], vals[:, None, :])
        else:
            v[:, k] = w
        res = _seq_dot(s_t[n], uh[:, None, :]) + hh * ra
        res[:, 0] = res[:, 0] + up
        res = torch.where(rows == (n + 1)[:, None], res - take(uh, n + 1)[:, None], res)
        err[:, k] = _lane_sum(v[:, k] * res, lanes)
        v_in = w[:, 0]
    return u_c, u_f, v, err


# ------------------------------------------------------------- tolerance


def _march_bound(u, top, y0, geom, mops, ode, eps):
    """Per-element bound (B, K) on the float32 roundoff of a march's nodal
    values: each element's Newton system J (at ``u``) turns its residual's
    rounding, 8·ε times the summed magnitudes of its terms (|A||u|, the
    quadrature's h/2·Σ|φ|w(|f| + |f_u|·|φ||u|) and the inflow), into
    |J⁻¹|·(that), and carries the inflow's error in through J⁻¹'s column 0."""
    wq, h, t_q = geom
    like = u
    a = _tab(_a_fwd(mops), like)[top - 1]
    phi = _tab(mops.phi_pad, like)[top - 1]
    u_q = torch.einsum("bkqi,bki->bkq", phi, u)
    uq_abs = torch.einsum("bkqi,bki->bkq", phi.abs(), u.abs())
    f_q, fu_q = ode.f(u_q, t_q), ode.f_u(u_q, t_q)
    hh = h / 2.0
    jinv = torch.linalg.inv(a + hh[..., None, None] * torch.einsum(
        "bkqi,bkq,bkqj->bkij", phi, wq * fu_q, phi))
    mag = (torch.einsum("bkij,bkj->bki", a.abs(), u.abs())
           + hh[..., None] * torch.einsum("bkqi,bkq->bki", phi.abs(),
                                          wq * (f_q.abs() + fu_q.abs() * uq_abs)))
    mag[..., 0] = mag[..., 0] + _inflows(u, top, y0).abs()
    local = 8 * eps * torch.einsum("bkij,bkj->bki", jinv.abs(), mag).amax(dim=-1)
    carry = jinv[..., :, 0].abs().amax(dim=-1)
    bound, out = torch.zeros_like(local[:, 0]), []
    for k in range(local.shape[1]):
        bound = local[:, k] + carry[:, k] * bound
        out.append(bound)
    return torch.stack(out, dim=1)


def _adjoint_bound(u_c, ub_c, ns, geom, plan, eps, tl):
    """Per-element bound (B, K) on the float32 roundoff of the adjoint's
    nodal values. The element's system J_a (at the coarse u) turns 8·ε times
    the summed magnitudes of its terms (|J_a||w|, the source's h/2·|M·1|, or
    h/2·Σ_j|M_ij|·|g_u(x_j)| at the live nodes x for another goal, and the
    inflow) and the coarse states' own error (through f_u at the quadrature
    points: |f_u(u_q ± δ_q) − f_u(u_q)| with δ_q from ub_c; for a goal also
    through g_u at the nodes, h/2·Σ_j|M_ij|·|g_u(x_j ± δ_j) − g_u(x_j)| with
    δ_j from ub_c and x's own rounding) into |J_a⁻¹|·(that), and
    carries the inflow's error in through J_a⁻¹'s inflow column; the
    reconstruct mode lifts the low solution's bound through |to_hi|·|eval_rad|
    and adds the lift's own rounding. w is the float64 solve at u_c."""
    mops, ode = plan.mops, plan.functors.ode
    wq, h, t_q = geom
    like = u_c
    rec = plan.adjoint_mode == "reconstruct"
    s_sys = ns - 1 if rec else ns
    e_in = s_sys + 1
    to_q = _tab(plan.interp.to_quad, like)[ns - 1]
    phi_s = _tab(mops.phi_pad, like)[s_sys]
    u_q = torch.einsum("bkqj,bkj->bkq", to_q, u_c)
    fu_q = ode.f_u(u_q, t_q)
    delta = to_q.abs().sum(dim=-1) * ub_c[..., None]
    dfu = torch.maximum((ode.f_u(u_q + delta, t_q) - fu_q).abs(),
                        (ode.f_u(u_q - delta, t_q) - fu_q).abs())
    hh = (h / 2.0)[..., None]
    a_adj = _tab(_a_adj(mops), like)[s_sys]
    jinv = torch.linalg.inv(a_adj + hh[..., None] * torch.einsum(
        "bkqi,bkq,bkqj->bkij", phi_s, wq * fu_q, phi_s))
    j_abs = a_adj.abs() + hh[..., None] * torch.einsum(
        "bkqi,bkq,bkqj->bkij", phi_s.abs(), wq * fu_q.abs(), phi_s.abs())
    if plan.functors.g_u is None:  # M·1, the folded row sums
        src = _tab(mops.mass_pad.sum(axis=2), like)[s_sys]
        src_abs, dsrc = src.abs(), torch.zeros_like(src)
    else:  # M·g_u at the live nodes (the coarse u at order n in reconstruct)
        rows = torch.arange(mops.np_max, device=like.device)
        live = rows <= e_in[..., None]
        mass = _tab(mops.mass_pad, like)[s_sys]
        t_n = tl[..., None] + _tab((1.0 + mops.r_pad) / 2.0, like)[s_sys] * h[..., None]
        if rec:
            x, d = u_c, ub_c[..., None].expand_as(u_c)
        else:
            to_n = _tab(plan.interp.to_nodes, like)[ns - 1]
            x = torch.einsum("bkij,bkj->bki", to_n, u_c)
            d = (to_n.abs().sum(dim=-1) * ub_c[..., None]
                 + 8 * eps * torch.einsum("bkij,bkj->bki", to_n.abs(), u_c.abs()))
        g_n = torch.where(live, plan.functors.g_u(x, t_n), torch.zeros_like(x))
        dg = torch.where(live, torch.maximum((plan.functors.g_u(x + d, t_n) - g_n).abs(),
                                             (plan.functors.g_u(x - d, t_n) - g_n).abs()),
                         torch.zeros_like(x))
        src = torch.einsum("bkij,bkj->bki", mass, g_n)
        src_abs = torch.einsum("bkij,bkj->bki", mass.abs(), g_n.abs())
        dsrc = torch.einsum("bkij,bkj->bki", mass.abs(), dg)
    e_hot = _one_hot(e_in, mops.np_max, like.dtype)
    carry = torch.gather(jinv.abs(), 3, e_in[..., None, None].expand(*jinv.shape[:3], 1))
    carry = carry[..., 0].amax(dim=-1)
    if rec:
        th = _tab(plan.rad.to_hi, like)[ns - 1].abs()
        lift = torch.einsum("bkij,bkjl->bkil", th, _tab(plan.rad.eval_rad, like)[ns - 1].abs())
        edge = torch.gather(th, 3, (ns + 1)[..., None, None].expand(*th.shape[:3], 1))[..., 0]
    b, k_el = ns.shape
    v_in, wb_next = torch.zeros_like(u_c[:, 0, 0]), torch.zeros_like(u_c[:, 0, 0])
    vb = torch.empty_like(ub_c)
    for k in range(k_el - 1, -1, -1):
        w = torch.einsum("bij,bj->bi", jinv[:, k],
                         -hh[:, k] * src[:, k] - e_hot[:, k] * v_in[:, None])
        w_q = torch.einsum("bqi,bi->bq", phi_s[:, k], w).abs()
        mag = (torch.einsum("bij,bj->bi", j_abs[:, k], w.abs()) + hh[:, k] * src_abs[:, k]
               + e_hot[:, k] * v_in.abs()[:, None])
        du = hh[:, k] * (torch.einsum("bqi,bq->bi", phi_s[:, k].abs(), wq * dfu[:, k] * w_q)
                         + dsrc[:, k])
        wb = (torch.einsum("bij,bj->bi", jinv[:, k].abs(), 8 * eps * mag + du).amax(dim=-1)
              + carry[:, k] * wb_next)
        if rec:
            vals = (torch.einsum("bij,bj->bi", lift[:, k], w.abs())
                    + edge[:, k] * v_in.abs()[:, None])
            vb[:, k] = ((lift[:, k].sum(dim=-1) * wb[:, None] + edge[:, k] * wb_next[:, None])
                        + 8 * eps * vals).amax(dim=-1)
        else:
            vb[:, k] = wb
        wb_next, v_in = wb, w[:, 0]
    return vb


def hp_kernel_tolerance(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor, plain,
                        plan: HpPlan) -> dict:
    """The bounds within which H1 agrees with its plain version's result
    ``plain`` = (u_c, u_f, v, err) on the same float32 inputs; the two
    round in another order (FMA contraction, the quadrature sums, the
    solves). Every bound is per member and element, computed in float64 at
    the plain result:

    - ``u_c``, ``u_f`` (B, K, 1) each march's nodal values: element k's
      Newton system J_k turns the rounding of its residual, 8·ε times the
      summed magnitudes of its terms, into |J_k⁻¹|·(that), and the inflow
      carries element k−1's bound in through J_k⁻¹'s column 0
      (:func:`_march_bound`): ub_k = 8ε·max_i(|J_k⁻¹|·mag_k)_i +
      max_i|J_k⁻¹|_{i0}·ub_{k−1}.
    - ``v`` (B, K, 1) the adjoint's nodal values, the same from the adjoint
      system J_a (at the coarse u), its inflow at the right end carried in
      backward from element k+1, plus the coarse states' own error through
      f_u (:func:`_adjoint_bound`).
    - ``err`` (B, K), per element 8·ε·scale_k, with scale_k =
      Σ_i |v_i|·(Σ_j |Sᵀ_ij|·(|T||u|)_j + h/2·Σ_q |φ_qi|·w_q·(|f_q| +
      |f_u,q|·(|T_q||u|)_q) + [i = 0]·|u_prev| + [i = n+1]·(|T||u|)_{n+1}),
      the sum of the magnitudes of the products that err_k = vᵀres adds
      (T, T_q the order-n interpolations to the order-(n+1) nodes and to
      the quadrature points; Sᵀ and φ at order n+1). err_k is local: a
      state shift carried in through the inflow moves the coarse solution
      along its own order-n equations and cancels in the order-(n+1)
      residual, so κ does not enter.

    The float32 plain version stays within a quarter of each bound of
    float64 (tests/test_torch_dg_slab_mixed.py), so two float32 evaluations
    in any order stay inside it. A trailing zero-width element has v = 0 and
    bounds v = err = 0 there: both sides return exactly 0."""
    mops, interp, ode = plan.mops, plan.interp, plan.functors.ode
    eps = float(np.finfo(np.float32).eps)
    times = times.to(torch.float64)
    ns = ns.to(torch.int64)
    y0 = y0s.to(times.dtype)
    u, u_f, v = (x.to(times.dtype) for x in plain[:3])
    tl, h, t_q = _geometry(times, _tab(mops.rq, times))
    geom = (_tab(mops.wq, times), h, t_q)
    ub_c = _march_bound(u, ns, y0, geom, mops, ode, eps)
    ub_f = _march_bound(u_f, ns + plan.fine_offset, y0, geom, mops, ode, eps)
    vb = _adjoint_bound(u, ub_c, ns, geom, plan, eps, tl)

    s_t = _tab(mops.stiff_pad, times).transpose(-1, -2)[ns]  # order n+1
    to_n = _tab(interp.to_nodes, times)[ns - 1]
    to_q = _tab(interp.to_quad, times)[ns - 1]
    phi = _tab(mops.phi_pad, times)[ns]
    u_h = torch.einsum("bkij,bkj->bki", to_n.abs(), u.abs())
    u_q = torch.einsum("bkqj,bkj->bkq", to_q, u)
    u_q_abs = torch.einsum("bkqj,bkj->bkq", to_q.abs(), u.abs())
    wf = geom[0] * (ode.f(u_q, t_q).abs() + ode.f_u(u_q, t_q).abs() * u_q_abs)
    terms = (torch.einsum("bkij,bkj->bki", s_t.abs(), u_h)
             + h[..., None] / 2.0 * torch.einsum("bkqi,bkq->bki", phi.abs(), wf)
             + _one_hot(ns + 1, mops.np_max, times.dtype) * u_h)
    terms[..., 0] = terms[..., 0] + _inflows(u, ns, y0).abs()
    scale = torch.sum(v.abs() * terms, dim=-1)
    return {"u_c": ub_c[..., None], "u_f": ub_f[..., None], "v": vb[..., None],
            "err": 8 * eps * scale}


# ------------------------------------------------------------------ wrapper


def dg_estimate_hp_per_member(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor,
                              plan: HpPlan):
    """H1: ``(u_c, u_f, v (B, K, np_max), err (B, K))`` for ``y0s`` (B,) on
    per-member partitions ``times`` (B, K+1) with per-member primal orders
    ``ns`` (B, K) in ``1..n_max_user``. A trailing run of zero-width
    (padding) slabs contributes exactly 0. On the card it runs one launch
    on :func:`hp_plan`'s lanes and CTA size."""
    if y0s.dim() != 1:
        raise ValueError(f"y0s must be (B,), got {tuple(y0s.shape)}")
    b, k = y0s.shape[0], plan.n_elements
    on_cuda = _check("y0s", y0s, (b,), plan)
    _check("times", times, (b, k + 1), plan)
    if times.dtype != y0s.dtype:
        raise ValueError(f"times ({times.dtype}) must match y0s ({y0s.dtype})")
    if tuple(ns.shape) != (b, k) or ns.device != y0s.device:
        raise ValueError(f"ns {tuple(ns.shape)} on {ns.device}: expected (B={b}, K={k}) on "
                         f"{y0s.device}")
    if ns.dtype.is_floating_point or ns.dtype == torch.bool:
        raise TypeError(f"ns must hold integer orders, got {ns.dtype}")
    if not on_cuda:
        return dg_estimate_hp_per_member_plain(times, ns, y0s, plan)
    launch = hp_plan(b, plan.mops.np_max, plan.mops.rq.shape[0])
    dg_estimate_hp_per_member.launches += 1
    return _h1_launch(times, ns, y0s, plan, launch)


def _h1_launch(times, ns, y0s, plan: HpPlan, launch: HpLaunch):
    """One H1 launch on ``launch``'s lanes and CTA size (checked inputs on
    the card): ``(u_c, u_f, v, err)``. The wrapper counts its launches; this
    does not."""
    b, k = y0s.shape[0], plan.n_elements
    np_m = plan.mops.np_max
    lib = plan.functors.library()
    times_k = times.T.contiguous()  # (K+1, B)
    ns_k = ns.T.to(torch.int32).contiguous()  # (K, B)
    u_c = torch.empty((k, np_m, b), dtype=torch.float32, device=y0s.device)
    u_f = torch.empty_like(u_c)
    v = torch.empty_like(u_c)
    err = torch.empty((k, b), dtype=torch.float32, device=y0s.device)
    code = lib.lib.dg_estimate_hp_per_member(
        plan.functors.ode_id, plan.functors.gu_id, *plan.n_modes, plan.consts.ctypes.data,
        plan.tables.data_ptr(),
        plan.tables.numel(), np_m, plan.mops.rq.shape[0], plan.mops.n_max, plan.fine_offset,
        int(plan.adjoint_mode == "reconstruct"), launch.lanes, launch.threads, b, k,
        plan.newton_iters, times_k.data_ptr(), ns_k.data_ptr(), y0s.data_ptr(), u_c.data_ptr(),
        u_f.data_ptr(), v.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(y0s.device).cuda_stream,
    )
    lib.check(code, "dg_estimate_hp_per_member", lib.lib.dg_slab_mixed_error_string)
    return u_c.permute(2, 0, 1), u_f.permute(2, 0, 1), v.permute(2, 0, 1), err.T


dg_estimate_hp_per_member.launches = 0


def reset_launch_counts() -> None:
    dg_estimate_hp_per_member.launches = 0


# -------------------------------------------------------------- entry point


def make_cuda_dg_estimate_hp_per_member(ode=None, mops: MixedDGTimeOperators | None = None,
                                        interp: MixedAdjointInterp | None = None,
                                        n_elements: int = 16, *, n_max_user: int,
                                        fine_offset: int = 2, newton_iters: int = 8,
                                        adjoint_mode: str = "solve",
                                        rad: MixedRadauInterp | None = None, f=None, f_u=None,
                                        g_u=None, device="cuda"):
    """``run(times, ns, y0s) -> (u_c, u_f, v, err)``: the per-member hp
    estimate in one launch of H1, with the ``dg_estimate_mixed`` contract.
    ``mops`` must be the ``dg_time_operators_mixed(n_max_user +
    fine_offset)`` stack and ``interp`` its ``dg_adjoint_interp_mixed``;
    ``adjoint_mode="reconstruct"`` needs ``rad`` (its
    ``dg_radau_interp_mixed``). The ODE is ``ode`` (a registry entry, its
    name, or an ``ODEProblem``, traced where it has no ``kernel_id``) or,
    as JAX's ``make_pallas_dg_estimate_hp_per_member(mops, interp, f,
    f_u=None, …)`` takes it, an elementwise callable ``f`` (or ``ode``) with
    ``f_u`` (derived by forward mode when ``None``); ``g_u`` is ``None``
    (J = ∫u), a registry functional's g_u (or the functional), or any
    elementwise callable ``g_u(u, t)``, traced. ``run.plan`` holds the plan
    (for the plain version)."""
    if mops is None or interp is None:
        raise ValueError("mops and interp are required")
    functors = scalar_functors(ode, f, f_u, g_u, source="dg_slab_mixed.cu")
    if fine_offset < 1:
        raise ValueError(f"fine_offset={fine_offset} must be >= 1 (the adjoint runs at ns + 1 "
                         "and needs its tables in the operator stack)")
    if mops.n_max != n_max_user + fine_offset:
        raise ValueError(f"mops stack n_max={mops.n_max} must equal n_max_user + fine_offset = "
                         f"{n_max_user + fine_offset}")
    if mops.np_max > MAX_NP:
        raise ValueError(f"in-kernel solves support np_max <= {MAX_NP}")
    if adjoint_mode not in ("solve", "reconstruct"):
        raise ValueError(f"unknown adjoint_mode {adjoint_mode!r}")
    if adjoint_mode == "reconstruct" and rad is None:
        raise ValueError("adjoint_mode='reconstruct' requires rad "
                         "(adjoint.dg_mixed.dg_radau_interp_mixed(mops))")
    if n_elements < 1 or newton_iters < 0:
        raise ValueError(f"n_elements={n_elements} must be >= 1 and newton_iters="
                         f"{newton_iters} >= 0")
    rad = rad if adjoint_mode == "reconstruct" else None
    tables = kernel_tables(mops, interp, rad, goal=functors.g_u is not None)
    if tables.size > MAX_TABLES:
        raise ValueError(f"folded tables of {tables.size} floats exceed the kernel's "
                         f"{MAX_TABLES} (n_gq too large)")
    device = require_device(device)
    if functors.header is not None and device.type == "cuda":
        functors.library()  # build the user library now, not inside the first call
    consts, n_modes = _consts(functors.ode)
    plan = HpPlan(mops, interp, rad, int(n_elements), int(fine_offset), int(newton_iters),
                  adjoint_mode, torch.tensor(tables, dtype=torch.float32, device=device), consts,
                  n_modes, torch.empty(0, device=device).device, functors)

    def run(times, ns, y0s):
        return dg_estimate_hp_per_member(times, ns, y0s, plan)

    run.plan = plan
    return run
