"""The ensemble DG-in-time estimate on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/dg_slab.py``. One kernel,
**D1** :func:`dg_estimate_ensemble` (csrc/dg_slab.cu), replaces ``_kernel``
(dg_slab.py:92): per member, the fixed-count Newton forward march at order
n over K slabs, the adjoint at order n+1 swept backward, and the per-element
adjoint-weighted residual err_k, a group of G lanes of one warp per member
with the Np×Np and Na×Na systems in registers (Cramer for N ≤ 4, pivoted
elimination for 5..8). It is the engine of ``run_adaptive_dg_ensemble`` and
``run_adaptive_dg_per_member`` with ``engine="cuda"``.

What bounds it, and what the design does about it: the work is FP32
arithmetic (newton_iters × Nq quadrature points with a sincos pair and the
Jacobian's Np² multiply-adds per member-element), but each member's
elements and Newton steps form one serial chain, so the kernel is
latency-bound per member. The G lanes of a member split every quadrature
loop (lane ℓ the points q ≡ ℓ mod G) and join their partial sums by a
fixed-order xor butterfly of warp shuffles, so the chain's quadrature part
shortens G-fold and the card holds G× more warps (at B = 1024 one thread a
member filled 8 CTAs of 128 threads on 132 SMs); every lane then assembles
and solves the member's small system itself. :func:`d1_plan` picks G and
the CTA size; :func:`dg_estimate_ensemble_lanes_plain` emulates the lanes'
sum order in plain PyTorch.

A CUDA float32 tensor launches the kernel or raises; a CPU tensor takes the
kernel's plain version, :func:`dg_estimate_ensemble_plain` — which is
``march/dg_batched.dg_estimate_batched(..., newton_iters=n)``, the same
function in eager torch (float32 or float64). Nothing falls back from the
kernel to the plain version. The wrapper counts its launches in
``.launches``. :func:`dg_kernel_tolerance` gives the per-member,
per-element bounds within which the kernel agrees with its plain version.

The goal J = ∫g(u, t) dt enters as the adjoint's source g_u at the adjoint
nodes: J = ∫u (g_u ≡ 1) is read as the folded mass row sums; any other g_u
is evaluated by a functor against the adjoint-order mass matrix — the
registry's (J = ∫u², g_u = 2u; functionals.py ``kernel_id``) or a caller's
elementwise callable traced into one (ops/cuda/functor.py). The ODE's f
and f_u are likewise a registry entry's functor or traced callables (f_u
derived by forward mode when not given, as JAX's ``jax.jvp``); anything
traced runs on a user library of csrc/dg_slab.cu alone.

The TPU tiling (the (8, B/8) member tiles, ``pick_lane_block``,
``ensure_scoped_vmem``, B a multiple of 8) is not ported: any B ≥ 1.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_time import _interp_ops
from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import dg_estimate_batched, solve_small
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import DGTimeOperators
from adjoint_ode_adaptivity_tpu_torch.ops import fast_trig
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.fd_ensemble import SIN_ID, _consts
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import KernelFunctors, scalar_functors
from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl
from adjoint_ode_adaptivity_tpu_torch.ops.operators import interp_matrix_1d

__all__ = [
    "DgSlabPlan",
    "D1Launch",
    "d1_plan",
    "kernel_tables",
    "dg_estimate_ensemble",
    "dg_estimate_ensemble_plain",
    "dg_estimate_ensemble_lanes_plain",
    "dg_kernel_tolerance",
    "reset_launch_counts",
    "make_cuda_dg_estimate_ensemble",
]

MAX_NP = 8  # the adjoint's node count (the primal's is one less)
MAX_TABLES = 8192  # floats of shared memory the kernel holds (csrc kMaxTables)
LANES = (1, 2, 4, 8, 16)  # the lanes a member d1_plan picks from (the kernel takes 1..32)
CTA_THREADS = (64, 128, 256)  # CTA sizes timed on the card (the kernel takes 32..256)
# d1_plan's rule: the most lanes (at most the quadrature points) that keep
# B·G/32 at or below D1_MAX_WARPS warps on the card
D1_MAX_WARPS = 1024
D1_THREADS = 128


class D1Launch(NamedTuple):
    """D1's launch plan: ``lanes`` (G) lanes of one warp per member, CTAs of
    ``threads``, each holding threads/G members."""

    lanes: int
    threads: int


@functools.lru_cache(maxsize=64)
def d1_plan(b: int, np_: int, nq: int) -> D1Launch:
    """D1's launch plan for B members at Np primal nodes with Nq quadrature
    points (the larger of the forward's and the sweep's): G = the most of
    :data:`LANES` with G ≤ Nq and B·G/32 ≤ :data:`D1_MAX_WARPS` warps (else
    1), on CTAs of :data:`D1_THREADS`.

    From times on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
    35; order 1, Nq 10 and 13; ms on 128-thread CTAs, G = 1/2/4/8/16/32): B =
    1024, K = 15, 8 Newton steps: 0.233 / 0.177 / 0.168 / 0.145 / 0.139 /
    0.141; B = 16,384, K = 16, 5 steps: 0.188 / 0.154 / 0.153 / 0.238 /
    0.337 / 0.535; B = 102,400: 0.378 / 0.419 / 0.605 / 0.857 / 1.373 /
    2.866. A member's chain waits on its own dependencies at a few warps an
    SM, so more lanes shorten it until the grid outgrows the card (B·G/32
    past ~1024 warps); G = 16 beat G = 8 at B = 1024 by 4-6 % in two runs of
    three; 64- and 128-thread CTAs measured within 12 % of each other,
    neither ahead everywhere."""
    lanes = [g for g in LANES if g <= nq and b * g <= 32 * D1_MAX_WARPS]
    return D1Launch(max(lanes, default=1), D1_THREADS)


class DgSlabPlan(NamedTuple):
    """Everything the kernel needs, on one device: the operators, the folded
    tables (:func:`kernel_tables` rounded to float32; on the device, each
    CTA copies them to shared memory), the ODE's by-value constants, and
    ``functors``: what the kernel runs (its library and ids) and the plain
    version's callables (``functors.ode`` and ``functors.g_u``, None:
    J = ∫u)."""

    ops_p: DGTimeOperators
    ops_a: DGTimeOperators
    n_elements: int
    newton_iters: int
    trig: str  # "libm" or "fast"
    tables32: np.ndarray  # float32, contiguous
    tables: torch.Tensor  # the same on ``device``
    consts: np.ndarray
    n_modes: tuple
    device: torch.device
    functors: KernelFunctors


def kernel_tables(ops_p: DGTimeOperators, ops_a: DGTimeOperators,
                  goal: bool = False) -> np.ndarray:
    """The kernel's tables folded in float64 (csrc/dg_slab.cu ``Layout``):

    forward (order n, Np nodes): A = Sᵀ with A[−1,−1] −= 1 (Np²), then per
    quadrature point q: φ_q (Np), (1+r_q)/2, w_q·φ_q (Np), w_q·φ_q φ_qᵀ (Np²);
    adjoint (Na = Np+1): −Sᵀ − e_L e_Lᵀ (Na²), Sᵀ (Na²), the mass row sums
    (Na; M·g_u with g_u ≡ 1), the primal→adjoint-node interpolation (Na×Np),
    then per adjoint quadrature point: the primal→quadrature row (Np),
    (1+r_q)/2, w_q·φ_q (Na), w_q·φ_q φ_qᵀ (Na²); with ``goal`` (a g_u other
    than ≡ 1) then the mass matrix M (Na²) and the node positions (1+r_i)/2
    (Na)."""
    np_p = ops_p.np_
    a_p = ops_p.stiff.T.copy()
    a_p[-1, -1] -= 1.0
    parts = [a_p.ravel()]
    for q in range(ops_p.phi.shape[0]):
        phi, w = ops_p.phi[q], ops_p.wq[q]
        parts += [phi, [(1.0 + ops_p.rq[q]) / 2.0], phi * w, np.outer(phi * w, phi).ravel()]
    base_a = -ops_a.stiff.T.copy()
    base_a[0, 0] -= 1.0
    r_p = jacobi_gl(0.0, 0.0, np_p - 1)
    to_nodes = interp_matrix_1d(np_p - 1, r_p, np.asarray(ops_a.r))
    to_quad = interp_matrix_1d(np_p - 1, r_p, np.asarray(ops_a.rq))
    parts += [base_a.ravel(), ops_a.stiff.T.ravel(), ops_a.mass.sum(axis=1), to_nodes.ravel()]
    for q in range(ops_a.phi.shape[0]):
        phi, w = ops_a.phi[q], ops_a.wq[q]
        parts += [to_quad[q], [(1.0 + ops_a.rq[q]) / 2.0], phi * w, np.outer(phi * w, phi).ravel()]
    if goal:
        parts += [ops_a.mass.ravel(), (1.0 + np.asarray(ops_a.r)) / 2.0]
    return np.concatenate([np.asarray(p, dtype=np.float64).ravel() for p in parts])


# ------------------------------------------------------------ plain version


def _fns(plan: DgSlabPlan):
    if plan.trig == "fast":
        return (lambda u, t: fast_trig.fast_sin(u)), (lambda u, t: fast_trig.fast_cos(u))
    return plan.functors.ode.f, plan.functors.ode.f_u


def dg_estimate_ensemble_plain(times: torch.Tensor, y0s: torch.Tensor, plan: DgSlabPlan):
    """D1's plain version: ``dg_estimate_batched`` with the plan's ODE (or
    the fast-trig polynomials), ``newton_iters`` Newton steps and the plan's
    goal (g_u), in the inputs' dtype. Returns ``(u (B,K,Np), v (B,K,Np+1),
    err (B,K))``."""
    f, f_u = _fns(plan)
    return dg_estimate_batched(plan.ops_p, plan.ops_a, f, times, y0s, f_u=f_u,
                               g_u=plan.functors.g_u, newton_iters=plan.newton_iters)


# ------------------------------------------------- the lanes' sum order


def _lane_sum(terms, lanes: int):
    """Σ over axis 1 in the lanes' order: lane ℓ of the group sums the
    entries ≡ ℓ (mod G) in ascending order, then rounds m = 1, 2, …, G/2
    add each lane's partner ℓ xor m; lane 0's value (every lane's)."""
    parts = []
    for lane in range(lanes):
        acc = torch.zeros_like(terms[:, 0])
        for q in range(lane, terms.shape[1], lanes):
            acc = acc + terms[:, q]
        parts.append(acc)
    m = 1
    while m < lanes:
        parts = [parts[i] + parts[i ^ m] for i in range(lanes)]
        m <<= 1
    return parts[0]


def _seq_dot(a, x):
    """Σ_j a[..., j]·x[..., j] in the order j = 0, 1, … (an unrolled chain)."""
    acc = a[..., 0] * x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + a[..., j] * x[..., j]
    return acc


class _Tables(NamedTuple):
    """The kernel's float32 tables (:func:`kernel_tables`), unpacked."""

    a_p: torch.Tensor  # (Np, Np)
    phi: torch.Tensor  # (Qp, Np)
    c_p: torch.Tensor  # (Qp,) (1 + r_q)/2
    wphi: torch.Tensor  # (Qp, Np)
    wphiphi: torch.Tensor  # (Qp, Np, Np)
    base_a: torch.Tensor  # (Na, Na)
    st_a: torch.Tensor  # (Na, Na)
    msum: torch.Tensor  # (Na,)
    to_nodes: torch.Tensor  # (Na, Np)
    to_quad: torch.Tensor  # (Qa, Np)
    c_a: torch.Tensor  # (Qa,)
    wphi_a: torch.Tensor  # (Qa, Na)
    wphiphi_a: torch.Tensor  # (Qa, Na, Na)
    mass_a: torch.Tensor | None  # (Na, Na), a goal other than J = ∫u only
    c_nodes: torch.Tensor | None  # (Na,) (1 + r_i)/2


def _unpack(plan: DgSlabPlan, like: torch.Tensor) -> _Tables:
    tab = torch.as_tensor(plan.tables32, device=like.device).to(like.dtype)
    npp, qp, qa = plan.ops_p.np_, plan.ops_p.phi.shape[0], plan.ops_a.phi.shape[0]
    na = npp + 1
    at = 0

    def take(*shape):
        nonlocal at
        n = int(np.prod(shape))
        out = tab[at:at + n].reshape(shape)
        at += n
        return out

    a_p = take(npp, npp)
    rows = take(qp, 2 * npp + 1 + npp * npp)
    base_a, st_a, msum, to_nodes = take(na, na), take(na, na), take(na), take(na, npp)
    rows_a = take(qa, npp + 1 + na + na * na)
    goal = (take(na, na), take(na)) if plan.functors.g_u is not None else (None, None)
    return _Tables(a_p, rows[:, :npp], rows[:, npp], rows[:, npp + 1:2 * npp + 1],
                   rows[:, 2 * npp + 1:].reshape(qp, npp, npp), base_a, st_a, msum, to_nodes,
                   rows_a[:, :npp], rows_a[:, npp], rows_a[:, npp + 1:npp + 1 + na],
                   rows_a[:, npp + 1 + na:].reshape(qa, na, na), *goal)


def _member_times(times, b: int):
    return times if times.dim() == 2 else times[None, :].expand(b, times.shape[0])


def dg_estimate_ensemble_lanes_plain(times: torch.Tensor, y0s: torch.Tensor, plan: DgSlabPlan,
                                     lanes: int):
    """D1's algorithm in plain PyTorch with its sum order at ``lanes`` (G)
    lanes a member: the kernel's float32 tables, every quadrature loop
    summed by :func:`_lane_sum`, the assembly, the interpolations and vᵀres
    as the kernel's unrolled chains (the goal's M·g_u too), each member's
    elements and Newton steps in the kernel's order, the systems solved by
    ``solve_small`` (the
    kernel's Cramer and pivoted elimination). Products are rounded apart
    (the kernel contracts them into FMAs), so this holds the sum order, not
    the kernel's bits. Returns ``(u (B,K,Np), v (B,K,Np+1), err (B,K))`` as
    the plain version does."""
    f, f_u = _fns(plan)
    tb = _unpack(plan, times)
    b, k_el = y0s.shape[0], plan.n_elements
    tm = _member_times(times, b)
    npp = plan.ops_p.np_
    us, u_prev = [], y0s
    for k in range(k_el):
        tl, h = tm[:, k], tm[:, k + 1] - tm[:, k]
        hh = h / 2
        t_q = tl[:, None] + tb.c_p * h[:, None]
        u = u_prev[:, None].expand(b, npp).clone()
        for _ in range(plan.newton_iters):
            uq = _seq_dot(tb.phi, u[:, None, :])  # (B, Qp)
            fq, fuq = f(uq, t_q), f_u(uq, t_q)
            res = _lane_sum(tb.wphi * fq[..., None], lanes)  # (B, Np)
            jac = _lane_sum(tb.wphiphi * fuq[..., None, None], lanes)  # (B, Np, Np)
            r = _seq_dot(tb.a_p, u[:, None, :]) + hh[:, None] * res
            r[:, 0] = r[:, 0] + u_prev
            jac = tb.a_p + hh[:, None, None] * jac
            u = u - solve_small(jac.permute(1, 2, 0), r.T).T
        us.append(u)
        u_prev = u[:, -1]
    u_all = torch.stack(us, dim=1)
    v_all, err = [None] * k_el, [None] * k_el
    v_in = torch.zeros_like(y0s)
    for k in range(k_el - 1, -1, -1):
        tl, h = tm[:, k], tm[:, k + 1] - tm[:, k]
        hh = h / 2
        ue = u_all[:, k]
        up = y0s if k == 0 else u_all[:, k - 1, -1]
        uh = _seq_dot(tb.to_nodes, ue[:, None, :])  # (B, Na)
        uq = _seq_dot(tb.to_quad, ue[:, None, :])  # (B, Qa)
        t_q = tl[:, None] + tb.c_a * h[:, None]
        fq, fuq = f(uq, t_q), f_u(uq, t_q)
        r = _lane_sum(tb.wphi_a * fq[..., None], lanes)
        a = tb.base_a + hh[:, None, None] * _lane_sum(tb.wphiphi_a * fuq[..., None, None], lanes)
        if tb.mass_a is None:
            rhs = -hh[:, None] * tb.msum
        else:
            gu = plan.functors.g_u(uh, tl[:, None] + tb.c_nodes * h[:, None])
            rhs = -hh[:, None] * _seq_dot(tb.mass_a, gu[:, None, :])
        rhs[:, -1] = rhs[:, -1] - v_in
        v = solve_small(a.permute(1, 2, 0), rhs.T).T
        acc = _seq_dot(tb.st_a, uh[:, None, :]) + hh[:, None] * r
        acc[:, -1] = acc[:, -1] - uh[:, -1]
        acc[:, 0] = acc[:, 0] + up
        v_all[k], err[k] = v, _seq_dot(v, acc)
        v_in = v[:, 0]
    return u_all, torch.stack(v_all, dim=1), torch.stack(err, dim=1)


# ------------------------------------------------------------- tolerance


def dg_kernel_tolerance(times: torch.Tensor, y0s: torch.Tensor, plain, plan: DgSlabPlan) -> dict:
    """The bounds within which D1 agrees with its plain version's result
    ``plain`` = (u, v, err) on the same float32 inputs; the two round in
    another order (FMA contraction, the lanes' quadrature sums, the
    solves). Every bound is per member and element, computed in float64 at
    the plain result, as ``dg_slab_mixed.hp_kernel_tolerance`` builds H1's:

    - ``u`` (B, K, 1) the march's nodal values: element k's Newton system
      J_k = A + h/2·Φᵀ diag(w f_u) Φ turns the rounding of its residual, 8·ε
      times the summed magnitudes of its terms (|A||u|, h/2·|Φ|ᵀw(|f| +
      |f_u|·|Φ||u|) and the inflow |u_prev|), into |J_k⁻¹|·(that), and the
      inflow carries element k−1's bound in through J_k⁻¹'s column 0:
      ub_k = 8ε·max_i(|J_k⁻¹|·mag_k)_i + max_i|J_k⁻¹|_{i0}·ub_{k−1}.
    - ``v`` (B, K, 1) the adjoint's nodal values, the same from the adjoint
      system J_a (at the plain u), its inflow at the right end carried in
      backward from element k+1 through J_a⁻¹'s last column, plus the
      states' own error through f_u: |f_u(u_q ± δ_q) − f_u(u_q)| with
      δ_q = Σ_j|T_qj|·ub_k. The source's terms are h/2·|M·1| for J = ∫u
      and h/2·Σ_j|M_ij|·|g_u(u_h,j, t_j)| for another goal, which also
      carries the nodes' error through g_u: h/2·Σ_j|M_ij|·|g_u(u_h,j ± δ_j)
      − g_u(u_h,j)| with δ_j = Σ_l|T_jl|·ub_k + 8ε·(|T||u|)_j.
    - ``err`` (B, K), per element 8·ε·scale_k, with scale_k =
      Σ_i |v_i|·(Σ_j |Sᵀ_ij|·(|T||u|)_j + h/2·Σ_q |φ_qi|·w_q·(|f_q| +
      |f_u,q|·(|T_q||u|)_q) + [i = 0]·|u_prev| + [i = Na−1]·(|T||u|)_{Na−1}),
      the summed magnitudes of the products that err_k = vᵀres adds (T, T_q
      the order-n interpolations to the order-(n+1) nodes and quadrature
      points). err_k is local: a state shift carried in through the inflow
      moves the solution along its own order-n equations and cancels in the
      order-(n+1) residual, so no condition number enters.

    The float32 plain version stays within a tenth of each bound of float64
    (tests/test_torch_dg_slab_lanes.py), so two float32 evaluations in any
    order stay inside it. A zero-width slab has h = 0, and a trailing run of
    them has v = 0 and err bounds 0: both sides return exactly 0 there."""
    eps = float(np.finfo(np.float32).eps)
    f, f_u = _fns(plan)
    ops_p, ops_a = plan.ops_p, plan.ops_a
    t64 = _member_times(times.to(torch.float64), y0s.shape[0])
    y0 = y0s.to(torch.float64)
    u, v = (x.to(torch.float64) for x in plain[:2])
    dev = t64.device

    def tab(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)

    tl, h = t64[:, :-1], t64[:, 1:] - t64[:, :-1]  # (B, K)
    hh = h / 2.0
    u_prev = torch.cat([y0[:, None], u[:, :-1, -1]], dim=1)  # (B, K)

    # the forward march (order n)
    a_np = ops_p.stiff.T.copy()
    a_np[-1, -1] -= 1.0
    a_p, phi, wq = tab(a_np), tab(ops_p.phi), tab(ops_p.wq)
    t_q = tl[..., None] + tab((1.0 + ops_p.rq) / 2.0) * h[..., None]
    u_q = torch.einsum("qi,bki->bkq", phi, u)
    uq_abs = torch.einsum("qi,bki->bkq", phi.abs(), u.abs())
    f_q, fu_q = f(u_q, t_q), f_u(u_q, t_q)
    jinv = torch.linalg.inv(a_p + hh[..., None, None] * torch.einsum(
        "qi,bkq,qj->bkij", phi, wq * fu_q, phi))
    mag = (torch.einsum("ij,bkj->bki", a_p.abs(), u.abs())
           + hh[..., None] * torch.einsum("qi,bkq->bki", phi.abs(),
                                          wq * (f_q.abs() + fu_q.abs() * uq_abs)))
    mag[..., 0] = mag[..., 0] + u_prev.abs()
    local = 8 * eps * torch.einsum("bkij,bkj->bki", jinv.abs(), mag).amax(dim=-1)
    carry = jinv[..., :, 0].abs().amax(dim=-1)
    ub, ubs = torch.zeros_like(local[:, 0]), []
    for k in range(local.shape[1]):
        ub = local[:, k] + carry[:, k] * ub
        ubs.append(ub)
    ub = torch.stack(ubs, dim=1)  # (B, K)

    # the adjoint sweep (order n+1) and the residual's scale
    to_nodes, to_quad = (tab(x) for x in _interp_ops(ops_p.n, ops_a))
    base = -ops_a.stiff.T.copy()
    base[0, 0] -= 1.0
    base, phi_a, wq_a, st_a = tab(base), tab(ops_a.phi), tab(ops_a.wq), tab(ops_a.stiff.T)
    msum = tab(ops_a.mass.sum(axis=1))
    t_qa = tl[..., None] + tab((1.0 + ops_a.rq) / 2.0) * h[..., None]
    u_qa = torch.einsum("qj,bkj->bkq", to_quad, u)
    u_qa_abs = torch.einsum("qj,bkj->bkq", to_quad.abs(), u.abs())
    fa_q, fua_q = f(u_qa, t_qa), f_u(u_qa, t_qa)
    delta = to_quad.abs().sum(dim=-1) * ub[..., None]
    dfu = torch.maximum((f_u(u_qa + delta, t_qa) - fua_q).abs(),
                        (f_u(u_qa - delta, t_qa) - fua_q).abs())
    jinv_a = torch.linalg.inv(base + hh[..., None, None] * torch.einsum(
        "qi,bkq,qj->bkij", phi_a, wq_a * fua_q, phi_a))
    j_abs = base.abs() + hh[..., None, None] * torch.einsum(
        "qi,bkq,qj->bkij", phi_a.abs(), wq_a * fua_q.abs(), phi_a.abs())
    carry_a = jinv_a[..., :, -1].abs().amax(dim=-1)
    v_in = torch.cat([v[:, 1:, 0], torch.zeros_like(v[:, :1, 0])], dim=1)  # (B, K)
    w_q = torch.einsum("qi,bki->bkq", phi_a, v).abs()
    du = hh[..., None] * torch.einsum("qi,bkq->bki", phi_a.abs(), wq_a * dfu * w_q)
    if plan.functors.g_u is None:  # M·1, the folded row sums
        src = hh[..., None] * msum.abs()
    else:  # M·g_u(u_h, t_n), and the nodes' own error through g_u
        mass = tab(ops_a.mass)
        u_n = torch.einsum("ij,bkj->bki", to_nodes, u)
        t_n = tl[..., None] + tab((1.0 + np.asarray(ops_a.r)) / 2.0) * h[..., None]
        g_n = plan.functors.g_u(u_n, t_n)
        src = hh[..., None] * torch.einsum("ij,bkj->bki", mass.abs(), g_n.abs())
        d_n = (to_nodes.abs().sum(dim=-1) * ub[..., None]
               + 8 * eps * torch.einsum("ij,bkj->bki", to_nodes.abs(), u.abs()))
        dg = torch.maximum((plan.functors.g_u(u_n + d_n, t_n) - g_n).abs(),
                           (plan.functors.g_u(u_n - d_n, t_n) - g_n).abs())
        du = du + hh[..., None] * torch.einsum("ij,bkj->bki", mass.abs(), dg)
    mag_a = torch.einsum("bkij,bkj->bki", j_abs, v.abs()) + src
    mag_a[..., -1] = mag_a[..., -1] + v_in.abs()
    local_a = torch.einsum("bkij,bkj->bki", jinv_a.abs(), 8 * eps * mag_a + du).amax(dim=-1)
    vb, vbs = torch.zeros_like(local_a[:, 0]), [None] * local_a.shape[1]
    for k in range(local_a.shape[1] - 1, -1, -1):
        vb = local_a[:, k] + carry_a[:, k] * vb
        vbs[k] = vb
    vb = torch.stack(vbs, dim=1)

    u_h = torch.einsum("ij,bkj->bki", to_nodes.abs(), u.abs())
    wf = wq_a * (fa_q.abs() + fua_q.abs() * u_qa_abs)
    terms = (torch.einsum("ij,bkj->bki", st_a.abs(), u_h)
             + hh[..., None] * torch.einsum("qi,bkq->bki", phi_a.abs(), wf))
    terms[..., -1] = terms[..., -1] + u_h[..., -1]
    terms[..., 0] = terms[..., 0] + u_prev.abs()
    scale = torch.sum(v.abs() * terms, dim=-1)
    return {"u": ub[..., None], "v": vb[..., None], "err": 8 * eps * scale}


# ------------------------------------------------------------------ wrapper


def _check(name: str, x: torch.Tensor, shape, plan: DgSlabPlan) -> bool:
    """Validate an operand; True on a CUDA device (kernel path), False on
    the CPU (plain path). Raises on anything else."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != plan.device:
        raise ValueError(f"{name} on {x.device}, the plan on {plan.device}")
    if x.device.type == "cpu":
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {x.dtype}; the plain path takes float32/64")
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: device {x.device} is neither cuda nor cpu")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return True


def dg_estimate_ensemble(times: torch.Tensor, y0s: torch.Tensor, plan: DgSlabPlan):
    """D1: ``(u (B,K,Np), v (B,K,Np+1), err (B,K))`` for ``y0s`` (B,) on
    the shared partition ``times`` (K+1,) or per-member partitions (B, K+1).
    Zero-width (padding) slabs are identities; a trailing run of them
    contributes exactly 0. On the card it runs one launch on
    :func:`d1_plan`'s lanes and CTA size."""
    if y0s.dim() != 1:
        raise ValueError(f"y0s must be (B,), got {tuple(y0s.shape)}")
    b, k = y0s.shape[0], plan.n_elements
    on_cuda = _check("y0s", y0s, (b,), plan)
    if tuple(times.shape) not in ((k + 1,), (b, k + 1)):
        raise ValueError(f"times {tuple(times.shape)}: expected (K+1={k + 1},) or per-member "
                         f"(B={b}, K+1={k + 1})")
    if times.device != y0s.device or times.dtype != y0s.dtype:
        raise ValueError(f"times ({times.dtype} on {times.device}) must match y0s "
                         f"({y0s.dtype} on {y0s.device})")
    if not on_cuda:
        return dg_estimate_ensemble_plain(times, y0s, plan)
    nq = max(plan.ops_p.phi.shape[0], plan.ops_a.phi.shape[0])
    launch = d1_plan(b, plan.ops_p.np_, nq)
    dg_estimate_ensemble.launches += 1
    return _d1_launch(times, y0s, plan, launch)


def _d1_launch(times, y0s, plan: DgSlabPlan, launch: D1Launch):
    """One D1 launch on ``launch``'s lanes and CTA size (checked inputs on
    the card): ``(u, v, err)``. The wrapper counts its launches; this does
    not."""
    b, k = y0s.shape[0], plan.n_elements
    per_member = times.dim() == 2
    times = times.contiguous()  # (B, K+1) or (K+1,)
    np_p, np_a = plan.ops_p.np_, plan.ops_a.np_
    lib = plan.functors.library()
    u = torch.empty((k, np_p, b), dtype=torch.float32, device=y0s.device)
    v = torch.empty((k, np_a, b), dtype=torch.float32, device=y0s.device)
    err = torch.empty((k, b), dtype=torch.float32, device=y0s.device)
    # a user library's ODE functor carries its trig policy itself
    fast = plan.trig == "fast" and plan.functors.header is None
    code = lib.lib.dg_estimate_ensemble(
        plan.functors.ode_id, int(fast), plan.functors.gu_id, *plan.n_modes,
        plan.consts.ctypes.data,
        plan.tables.data_ptr(), plan.tables.numel(), np_p, plan.ops_p.phi.shape[0],
        plan.ops_a.phi.shape[0], b, k, plan.newton_iters, int(per_member), launch.lanes,
        launch.threads, times.data_ptr(), y0s.data_ptr(), u.data_ptr(), v.data_ptr(),
        err.data_ptr(), torch.cuda.current_stream(y0s.device).cuda_stream,
    )
    lib.check(code, "dg_estimate_ensemble", lib.lib.dg_slab_error_string)
    return u.permute(2, 0, 1), v.permute(2, 0, 1), err.T


dg_estimate_ensemble.launches = 0


def reset_launch_counts() -> None:
    dg_estimate_ensemble.launches = 0


# -------------------------------------------------------------- entry point


def make_cuda_dg_estimate_ensemble(ode=None, ops_p: DGTimeOperators | None = None,
                                   ops_a: DGTimeOperators | None = None, n_elements: int = 16,
                                   newton_iters: int = 5, *, f=None, f_u=None, g_u=None,
                                   trig: str = "libm", device="cuda"):
    """``run(times, y0s) -> (u, v, err)``: the whole ensemble DG-in-time
    estimate (Newton forward march at ``ops_p``'s order, adjoint at
    ``ops_a``'s = one above, per-element AWR for the goal J = ∫g dt) in one
    launch of D1, with the ``dg_estimate_batched`` contract. The ODE is
    ``ode`` (a registry entry, its name, or an ``ODEProblem``, traced where
    it has no ``kernel_id``) or, as JAX's ``make_pallas_dg_estimate_ensemble(
    ops_p, ops_a, f, f_u=None, …)`` takes it, an elementwise callable ``f``
    (or ``ode``) with ``f_u`` (derived by forward mode when ``None``);
    ``g_u`` is ``None`` (J = ∫u), a registry functional's g_u (or the
    functional), or any elementwise callable ``g_u(u, t)``, traced
    (functionals.kernel_goal). A traced callable runs on a user library
    built once for it (on the card, when this is called). ``trig="fast"``
    (sin(u) only, |u| ≤ 4) evaluates sin/cos by the shared-x² polynomials.
    ``run.plan`` holds the plan (for the plain version)."""
    if ops_p is None or ops_a is None:
        raise ValueError("ops_p and ops_a are required")
    functors = scalar_functors(ode, f, f_u, g_u, source="dg_slab.cu", trig=trig)
    if ops_a.np_ != ops_p.np_ + 1:
        raise ValueError("ops_a must be one order above ops_p")
    if ops_a.np_ > MAX_NP:
        raise ValueError(f"in-kernel solves support Np <= {MAX_NP} (Cramer <= 4, pivoted GE 5-8)")
    if trig not in ("libm", "fast"):
        raise ValueError(f"trig={trig!r}: 'libm' or 'fast'")
    if trig == "fast" and functors.ode.kernel_id != SIN_ID:
        raise ValueError("trig='fast' is implemented for du/dt=sin(u) only")
    if n_elements < 1 or newton_iters < 0:
        raise ValueError(f"n_elements={n_elements} must be >= 1 and newton_iters="
                         f"{newton_iters} >= 0")
    tables = kernel_tables(ops_p, ops_a, goal=functors.g_u is not None)
    if tables.size > MAX_TABLES:
        raise ValueError(f"folded tables of {tables.size} floats exceed the kernel's "
                         f"{MAX_TABLES} (n_gq too large)")
    consts, n_modes = _consts(functors.ode)
    device = require_device(device)
    if functors.header is not None and device.type == "cuda":
        functors.library()  # build the user library now, not inside the first call
    tables32 = np.ascontiguousarray(tables, dtype=np.float32)
    plan = DgSlabPlan(ops_p, ops_a, int(n_elements), int(newton_iters), trig, tables32,
                      torch.tensor(tables32, device=device), consts, n_modes,
                      torch.empty(0, device=device).device, functors)

    def run(times, y0s):
        return dg_estimate_ensemble(times, y0s, plan)

    run.plan = plan
    return run
