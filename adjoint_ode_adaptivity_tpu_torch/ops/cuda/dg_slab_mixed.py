"""The per-member mixed-order (hp) DG-in-time estimate on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/dg_slab_mixed.py``. One
kernel, **H1** :func:`dg_estimate_hp_per_member` (csrc/dg_slab_mixed.cu),
replaces ``_mixed_kernel`` (dg_slab_mixed.py:99): per member, with its own
partition and order vector, the coarse Newton march at orders ``ns``, the
fine march at ``ns + fine_offset``, the adjoint at ``ns + 1`` (solved, or
solved at ``ns`` and lifted by Radau reconstruction) and the per-element
adjoint-weighted residual, one thread per member. It is the engine of the hp
loops (adapt/hp_loop.py) with ``engine="cuda"``.

What bounds it, and what the design does about it: FP32 arithmetic on one
serial chain per member (elements × Newton steps), so the kernel is
latency-bound per thread. The systems are padded to the stack's node count
``np_max`` (a template parameter: registers, unrolled loops); each thread
reads its own order's tables, which a warp reads at divergent addresses,
so the folded tables (:func:`kernel_tables`) live in shared memory, copied
once per block, rather than in constant memory.

A CUDA float32 tensor launches the kernel or raises; a CPU tensor takes its
plain version, :func:`dg_estimate_hp_per_member_plain` —
``adjoint/dg_mixed.dg_estimate_mixed(..., newton_iters=n)``, the same
function in eager torch. Nothing falls back from the kernel. The wrapper
counts its launches in ``.launches``.

The TPU tiling (the (8, B/8) member tiles, ``pick_lane_block``,
``ensure_scoped_vmem``, B a multiple of 8) is not ported: any B ≥ 1. Only
J = ∫u dt (g_u ≡ 1) is supported, as in the DG slab kernel. The kernel does
not check the orders (that would cost a host read per launch): the hp loops
keep them in ``1..n_max_user`` by construction; the plain version checks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import odes
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
)
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_slab import _check
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.fd_ensemble import VECTOR_KERNEL_IDS, _consts

__all__ = [
    "HpPlan",
    "kernel_tables",
    "dg_estimate_hp_per_member",
    "dg_estimate_hp_per_member_plain",
    "hp_kernel_tolerance",
    "reset_launch_counts",
    "make_cuda_dg_estimate_hp_per_member",
]

MAX_NP = 8  # the stack's padded node count the kernel takes (3..8)
MAX_TABLES = 12 * 1024  # floats of shared memory the kernel holds (csrc kMaxHpTables)


class HpPlan(NamedTuple):
    """Everything the kernel needs, on one device: the operator stacks, the
    folded tables (:func:`kernel_tables` rounded to float32, on the device)
    and the ODE's by-value constants."""

    ode: odes.ODEProblem
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


def kernel_tables(mops: MixedDGTimeOperators, interp: MixedAdjointInterp,
                  rad: MixedRadauInterp | None = None) -> np.ndarray:
    """The kernel's tables in float64 (csrc/dg_slab_mixed.cu ``HpLayout``):
    w_q (Q), (1 + r_q)/2 (Q); per stack order s: A_fwd = Sᵀ − e_{s+1}e_{s+1}ᵀ
    + pad_eye, A_adj = −Sᵀ − e_0e_0ᵀ + pad_eye, Sᵀ (np_max² each), the mass
    row sums (np_max; M·g_u with g_u ≡ 1) and Φ (Q×np_max); per primal order
    p: to_nodes, the Radau eval_rad and to_hi (np_max² each; zero without
    ``rad``) and to_quad (Q×np_max)."""
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
    return np.concatenate([np.asarray(x, dtype=np.float64).ravel() for x in parts])


# ------------------------------------------------------------ plain version


def dg_estimate_hp_per_member_plain(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor,
                                    plan: HpPlan):
    """H1's plain version: ``dg_estimate_mixed`` with the plan's ODE,
    ``newton_iters`` Newton steps and g_u ≡ 1, in the inputs' dtype.
    Returns ``(u_c, u_f, v (B, K, np_max), err (B, K))``."""
    return dg_estimate_mixed(plan.mops, plan.interp, plan.ode.f, times, ns, y0s,
                             fine_offset=plan.fine_offset, adjoint_mode=plan.adjoint_mode,
                             rad=plan.rad, f_u=plan.ode.f_u, newton_iters=plan.newton_iters)


def hp_kernel_tolerance(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor, plain,
                        plan: HpPlan) -> dict:
    """The bounds within which H1 agrees with its plain version's result
    ``plain`` = (u_c, u_f, v, err) on the same float32 inputs; the two
    round in another order (FMA contraction, the quadrature sums, the
    solves).

    - ``u`` (both marches) 8·K·κ_p·ε·max|u| and ``v`` 8·K·κ_a·ε·max|v|: each
      element's Newton or adjoint solve amplifies the roundoff of its
      assembly by its system's condition number κ (the largest over the
      stack's orders of the zero-width systems A_fwd and A_adj: 1.4 at
      order 1, 7.1 at order 5), and the inflow carries it through the K
      elements.
    - ``err`` (B, K), per element 8·ε·scale_k, with scale_k =
      Σ_i |v_i|·(Σ_j |Sᵀ_ij|·(|T||u|)_j + h/2·Σ_q |φ_qi|·w_q·(|f_q| +
      |f_u,q|·(|T_q||u|)_q) + [i = 0]·|u_prev| + [i = n+1]·(|T||u|)_{n+1}),
      the sum of the magnitudes of the products that err_k = vᵀres adds
      (T, T_q the order-n interpolations to the order-(n+1) nodes and to
      the quadrature points; Sᵀ and φ at order n+1). err_k is local: a
      state shift carried in through the inflow moves the coarse solution
      along its own order-n equations and cancels in the order-(n+1)
      residual, so κ does not enter. The float32 plain version stays within
      ε·scale_k of float64 (at most 0.66·ε·scale_k at bench.py's hp shape
      for sin u, t·sin u and the Gaussian mixture; the CPU test
      tests/test_torch_dg_slab_mixed.py holds it to ε·scale_k), so two
      float32 evaluations differ by at most a quarter of the bound. A
      trailing zero-width element has v = 0, so its bound is 0: both sides
      return exactly 0 there."""
    mops, interp, ode = plan.mops, plan.interp, plan.ode
    eps = float(np.finfo(np.float32).eps)
    kp = max(float(np.linalg.cond(a)) for a in _a_fwd(mops))
    ka = max(float(np.linalg.cond(a)) for a in _a_adj(mops))
    k = plan.n_elements
    umax = max(float(x.abs().max()) for x in plain[:2])
    vmax = float(plain[2].abs().max())

    times = times.to(torch.float64)
    ns = ns.to(torch.int64)
    u, v = plain[0].to(times.dtype), plain[2].to(times.dtype)
    s_t = _tab(mops.stiff_pad, times).transpose(-1, -2)[ns]  # order n+1
    to_n = _tab(interp.to_nodes, times)[ns - 1]
    to_q = _tab(interp.to_quad, times)[ns - 1]
    phi = _tab(mops.phi_pad, times)[ns]
    _, h, t_q = _geometry(times, _tab(mops.rq, times))
    u_h = torch.einsum("bkij,bkj->bki", to_n.abs(), u.abs())
    u_q = torch.einsum("bkqj,bkj->bkq", to_q, u)
    u_q_abs = torch.einsum("bkqj,bkj->bkq", to_q.abs(), u.abs())
    wf = _tab(mops.wq, times) * (ode.f(u_q, t_q).abs() + ode.f_u(u_q, t_q).abs() * u_q_abs)
    terms = (torch.einsum("bkij,bkj->bki", s_t.abs(), u_h)
             + h[..., None] / 2.0 * torch.einsum("bkqi,bkq->bki", phi.abs(), wf)
             + _one_hot(ns + 1, mops.np_max, times.dtype) * u_h)
    terms[..., 0] = terms[..., 0] + _inflows(u, ns, y0s.to(times.dtype)).abs()
    scale = torch.sum(v.abs() * terms, dim=-1)
    return {"u": 8 * k * kp * eps * umax, "v": 8 * k * ka * eps * vmax, "err": 8 * eps * scale}


# ------------------------------------------------------------------ wrapper


def dg_estimate_hp_per_member(times: torch.Tensor, ns: torch.Tensor, y0s: torch.Tensor,
                              plan: HpPlan):
    """H1: ``(u_c, u_f, v (B, K, np_max), err (B, K))`` for ``y0s`` (B,) on
    per-member partitions ``times`` (B, K+1) with per-member primal orders
    ``ns`` (B, K) in ``1..n_max_user``. A trailing run of zero-width
    (padding) slabs contributes exactly 0."""
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
    np_m = plan.mops.np_max
    lib = load_library()
    times_k = times.T.contiguous()  # (K+1, B)
    ns_k = ns.T.to(torch.int32).contiguous()  # (K, B)
    u_c = torch.empty((k, np_m, b), dtype=torch.float32, device=y0s.device)
    u_f = torch.empty_like(u_c)
    v = torch.empty_like(u_c)
    err = torch.empty((k, b), dtype=torch.float32, device=y0s.device)
    code = lib.lib.dg_estimate_hp_per_member(
        plan.ode.kernel_id, *plan.n_modes, plan.consts.ctypes.data, plan.tables.data_ptr(),
        plan.tables.numel(), np_m, plan.mops.rq.shape[0], plan.mops.n_max, plan.fine_offset,
        int(plan.adjoint_mode == "reconstruct"), b, k, plan.newton_iters, times_k.data_ptr(),
        ns_k.data_ptr(), y0s.data_ptr(), u_c.data_ptr(), u_f.data_ptr(), v.data_ptr(),
        err.data_ptr(), torch.cuda.current_stream(y0s.device).cuda_stream,
    )
    dg_estimate_hp_per_member.launches += 1
    lib.check(code, "dg_estimate_hp_per_member", lib.lib.dg_slab_mixed_error_string)
    return u_c.permute(2, 0, 1), u_f.permute(2, 0, 1), v.permute(2, 0, 1), err.T


dg_estimate_hp_per_member.launches = 0


def reset_launch_counts() -> None:
    dg_estimate_hp_per_member.launches = 0


# -------------------------------------------------------------- entry point


def make_cuda_dg_estimate_hp_per_member(ode, mops: MixedDGTimeOperators,
                                        interp: MixedAdjointInterp, n_elements: int, *,
                                        n_max_user: int, fine_offset: int = 2,
                                        newton_iters: int = 8, adjoint_mode: str = "solve",
                                        rad: MixedRadauInterp | None = None, g_u=None,
                                        device="cuda"):
    """``run(times, ns, y0s) -> (u_c, u_f, v, err)``: the per-member hp
    estimate in one launch of H1, with the ``dg_estimate_mixed`` contract.
    ``mops`` must be the ``dg_time_operators_mixed(n_max_user +
    fine_offset)`` stack and ``interp`` its ``dg_adjoint_interp_mixed``;
    ``adjoint_mode="reconstruct"`` needs ``rad`` (its
    ``dg_radau_interp_mixed``). ``ode`` is a registry entry (or its name)
    with a scalar ``kernel_id``; ``g_u`` must stay ``None`` (g_u ≡ 1).
    ``run.plan`` holds the plan (for the plain version)."""
    ode = odes.get_ode(ode) if isinstance(ode, str) else ode
    if ode.kernel_id is None:
        raise ValueError(f"ODE {ode.name!r} has no kernel_id: the hp kernel cannot run it")
    if ode.kernel_id in VECTOR_KERNEL_IDS:
        raise ValueError(f"ODE {ode.name!r}: the hp kernel takes a scalar ODE")
    if g_u is not None:
        raise ValueError("the hp kernel supports J = ∫u dt only (g_u ≡ 1): pass g_u=None")
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
    tables = kernel_tables(mops, interp, rad)
    if tables.size > MAX_TABLES:
        raise ValueError(f"folded tables of {tables.size} floats exceed the kernel's "
                         f"{MAX_TABLES} (n_gq too large)")
    device = require_device(device)
    consts, n_modes = _consts(ode)
    plan = HpPlan(ode, mops, interp, rad, int(n_elements), int(fine_offset), int(newton_iters),
                  adjoint_mode, torch.tensor(tables, dtype=torch.float32, device=device), consts,
                  n_modes, torch.empty(0, device=device).device)

    def run(times, ns, y0s):
        return dg_estimate_hp_per_member(times, ns, y0s, plan)

    run.plan = plan
    return run
