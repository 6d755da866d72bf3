"""The ensemble DG-in-time estimate on hand-written CUDA.

Counterpart of the JAX package's ``ops/pallas/dg_slab.py``. One kernel,
**D1** :func:`dg_estimate_ensemble` (csrc/dg_slab.cu), replaces ``_kernel``
(dg_slab.py:92): per member, the fixed-count Newton forward march at order
n over K slabs, the adjoint at order n+1 swept backward, and the per-element
adjoint-weighted residual err_k, one thread per member with the Np×Np and
Na×Na systems in registers (Cramer for N ≤ 4, pivoted elimination for 5..8).
It is the engine of ``run_adaptive_dg_ensemble`` and
``run_adaptive_dg_per_member`` with ``engine="cuda"``.

What bounds it, and what the design does about it: the work is FP32
arithmetic (newton_iters × Nq quadrature points with a sincos pair and the
Jacobian's Np² multiply-adds per member-element), but each member's
elements and Newton steps form one serial chain, so the kernel is
latency-bound per thread; keeping every small array in registers and the
folded tables in constant memory (one broadcast per entry) keeps that chain
short. At B = 1024 the grid is 8 blocks of 128 threads on 132 SMs.

A CUDA float32 tensor launches the kernel or raises; a CPU tensor takes the
kernel's plain version, :func:`dg_estimate_ensemble_plain` — which is
``march/dg_batched.dg_estimate_batched(..., newton_iters=n)``, the same
function in eager torch (float32 or float64). Nothing falls back from the
kernel to the plain version. The wrapper counts its launches in
``.launches``.

The TPU tiling (the (8, B/8) member tiles, ``pick_lane_block``,
``ensure_scoped_vmem``, B a multiple of 8) is not ported: any B ≥ 1. Only
J = ∫u dt (g_u ≡ 1) is supported — the functional the loops and dg_adaptive
use; another ``g_u`` raises (a functional id is later work, ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import dg_estimate_batched
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import DGTimeOperators
from adjoint_ode_adaptivity_tpu_torch.ops import fast_trig
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, require_device
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.fd_ensemble import SIN_ID, VECTOR_KERNEL_IDS, _consts
from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl
from adjoint_ode_adaptivity_tpu_torch.ops.operators import interp_matrix_1d

__all__ = [
    "DgSlabPlan",
    "kernel_tables",
    "dg_estimate_ensemble",
    "dg_estimate_ensemble_plain",
    "reset_launch_counts",
    "make_cuda_dg_estimate_ensemble",
]

MAX_NP = 8  # the adjoint's node count (the primal's is one less)
MAX_TABLES = 8192  # floats of constant memory the kernel holds (csrc kMaxTables)


class DgSlabPlan(NamedTuple):
    """Everything the kernel needs, on one device: the operators, the folded
    tables (:func:`kernel_tables` rounded to float32, copied to constant
    memory at each launch) and the ODE's by-value constants."""

    ode: odes.ODEProblem
    ops_p: DGTimeOperators
    ops_a: DGTimeOperators
    n_elements: int
    newton_iters: int
    trig: str  # "libm" or "fast"
    tables32: np.ndarray  # float32, contiguous
    consts: np.ndarray
    n_modes: tuple
    device: torch.device


def kernel_tables(ops_p: DGTimeOperators, ops_a: DGTimeOperators) -> np.ndarray:
    """The kernel's tables folded in float64 (csrc/dg_slab.cu ``Layout``):

    forward (order n, Np nodes): A = Sᵀ with A[−1,−1] −= 1 (Np²), then per
    quadrature point q: φ_q (Np), (1+r_q)/2, w_q·φ_q (Np), w_q·φ_q φ_qᵀ (Np²);
    adjoint (Na = Np+1): −Sᵀ − e_L e_Lᵀ (Na²), Sᵀ (Na²), the mass row sums
    (Na; M·g_u with g_u ≡ 1), the primal→adjoint-node interpolation (Na×Np),
    then per adjoint quadrature point: the primal→quadrature row (Np),
    (1+r_q)/2, w_q·φ_q (Na), w_q·φ_q φ_qᵀ (Na²)."""
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
    return np.concatenate([np.asarray(p, dtype=np.float64).ravel() for p in parts])


# ------------------------------------------------------------ plain version


def _fns(plan: DgSlabPlan):
    if plan.trig == "fast":
        return (lambda u, t: fast_trig.fast_sin(u)), (lambda u, t: fast_trig.fast_cos(u))
    return plan.ode.f, plan.ode.f_u


def dg_estimate_ensemble_plain(times: torch.Tensor, y0s: torch.Tensor, plan: DgSlabPlan):
    """D1's plain version: ``dg_estimate_batched`` with the plan's ODE (or
    the fast-trig polynomials), ``newton_iters`` Newton steps and g_u ≡ 1, in
    the inputs' dtype. Returns ``(u (B,K,Np), v (B,K,Np+1), err (B,K))``."""
    f, f_u = _fns(plan)
    return dg_estimate_batched(plan.ops_p, plan.ops_a, f, times, y0s, f_u=f_u,
                               newton_iters=plan.newton_iters)


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
    contributes exactly 0."""
    if y0s.dim() != 1:
        raise ValueError(f"y0s must be (B,), got {tuple(y0s.shape)}")
    b, k = y0s.shape[0], plan.n_elements
    on_cuda = _check("y0s", y0s, (b,), plan)
    per_member = times.dim() == 2
    if tuple(times.shape) not in ((k + 1,), (b, k + 1)):
        raise ValueError(f"times {tuple(times.shape)}: expected (K+1={k + 1},) or per-member "
                         f"(B={b}, K+1={k + 1})")
    if times.device != y0s.device or times.dtype != y0s.dtype:
        raise ValueError(f"times ({times.dtype} on {times.device}) must match y0s "
                         f"({y0s.dtype} on {y0s.device})")
    if not on_cuda:
        return dg_estimate_ensemble_plain(times, y0s, plan)
    times_k = times.T.contiguous() if per_member else times.contiguous()  # (K+1, B) or (K+1,)
    np_p, np_a = plan.ops_p.np_, plan.ops_a.np_
    lib = load_library()
    u = torch.empty((k, np_p, b), dtype=torch.float32, device=y0s.device)
    v = torch.empty((k, np_a, b), dtype=torch.float32, device=y0s.device)
    err = torch.empty((k, b), dtype=torch.float32, device=y0s.device)
    code = lib.lib.dg_estimate_ensemble(
        plan.ode.kernel_id, int(plan.trig == "fast"), *plan.n_modes, plan.consts.ctypes.data,
        plan.tables32.ctypes.data, plan.tables32.size, np_p, plan.ops_p.phi.shape[0],
        plan.ops_a.phi.shape[0], b, k, plan.newton_iters, int(per_member), times_k.data_ptr(),
        y0s.data_ptr(), u.data_ptr(), v.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(y0s.device).cuda_stream,
    )
    dg_estimate_ensemble.launches += 1
    lib.check(code, "dg_estimate_ensemble", lib.lib.dg_slab_error_string)
    return u.permute(2, 0, 1), v.permute(2, 0, 1), err.T


dg_estimate_ensemble.launches = 0


def reset_launch_counts() -> None:
    dg_estimate_ensemble.launches = 0


# -------------------------------------------------------------- entry point


def make_cuda_dg_estimate_ensemble(ode, ops_p: DGTimeOperators, ops_a: DGTimeOperators,
                                   n_elements: int, newton_iters: int = 5, *, g_u=None,
                                   trig: str = "libm", device="cuda"):
    """``run(times, y0s) -> (u, v, err)``: the whole ensemble DG-in-time
    estimate (Newton forward march at ``ops_p``'s order, adjoint at
    ``ops_a``'s = one above, per-element AWR for J = ∫u dt) in one launch of
    D1, with the ``dg_estimate_batched`` contract. ``ode`` is a registry
    entry (or its name) with a scalar ``kernel_id``; ``g_u`` must stay
    ``None`` (g_u ≡ 1); ``trig="fast"`` (sin(u) only, |u| ≤ 4) evaluates
    sin/cos by the shared-x² polynomials. ``run.plan`` holds the plan (for
    the plain version)."""
    ode = odes.get_ode(ode) if isinstance(ode, str) else ode
    if ode.kernel_id is None:
        raise ValueError(f"ODE {ode.name!r} has no kernel_id: the DG kernel cannot run it")
    if ode.kernel_id in VECTOR_KERNEL_IDS:
        raise ValueError(f"ODE {ode.name!r}: the DG kernel takes a scalar ODE")
    if g_u is not None:
        raise ValueError("the DG kernel supports J = ∫u dt only (g_u ≡ 1): pass g_u=None")
    if ops_a.np_ != ops_p.np_ + 1:
        raise ValueError("ops_a must be one order above ops_p")
    if ops_a.np_ > MAX_NP:
        raise ValueError(f"in-kernel solves support Np <= {MAX_NP} (Cramer <= 4, pivoted GE 5-8)")
    if trig not in ("libm", "fast"):
        raise ValueError(f"trig={trig!r}: 'libm' or 'fast'")
    if trig == "fast" and ode.kernel_id != SIN_ID:
        raise ValueError("trig='fast' is implemented for du/dt=sin(u) only")
    if n_elements < 1 or newton_iters < 0:
        raise ValueError(f"n_elements={n_elements} must be >= 1 and newton_iters="
                         f"{newton_iters} >= 0")
    tables = kernel_tables(ops_p, ops_a)
    if tables.size > MAX_TABLES:
        raise ValueError(f"folded tables of {tables.size} floats exceed the kernel's "
                         f"{MAX_TABLES} (n_gq too large)")
    consts, n_modes = _consts(ode)
    plan = DgSlabPlan(ode, ops_p, ops_a, int(n_elements), int(newton_iters), trig,
                      np.ascontiguousarray(tables, dtype=np.float32), consts, n_modes,
                      torch.empty(0, device=require_device(device)).device)

    def run(times, y0s):
        return dg_estimate_ensemble(times, y0s, plan)

    run.plan = plan
    return run
