"""Bounded-domain polynomial sin/cos with a shared x².

Counterpart of the JAX package's ``ops/pallas/fast_trig.py``: the same
Chebyshev-interpolation (near-minimax) fits, computed at import in float64
NumPy. Accuracy on |x| ≤ DOMAIN: max abs error ≤ ~2e-7 (sin) and ~2e-8
(cos) in float64, ~1e-6 in float32 Horner roundoff near |x| = DOMAIN.
Outside ±DOMAIN the polynomials diverge: the caller owns the domain proof
(u' = sin u keeps u0 ∈ [−3, 3] inside (−π, π)).

The CUDA kernels (csrc/fd_ensemble.cu and csrc/dg_slab.cu through the
FastTrig policy of csrc/odes.cuh, ``trig="fast"``) take
:data:`SIN_C` and :data:`COS_C`, rounded to float32, by value and evaluate
the same Horner chains; the functions here are their plain versions and
take torch tensors (or NumPy arrays).
"""
from __future__ import annotations

import numpy as np

__all__ = ["DOMAIN", "SIN_C", "COS_C", "fast_sin", "fast_cos", "fast_sincos"]

DOMAIN = 4.0  # |x| bound the fits target (≥ π + slack for the bench ODEs)


def _cheb_fit_even(fn, deg_half: int):
    """Coefficients c_k of Σ c_k z^k, z = x², fitting the even function fn
    on |x| ≤ DOMAIN by Chebyshev interpolation in z ∈ [0, DOMAIN²]."""
    n = deg_half + 1
    k = np.arange(n)
    z = (np.cos((2 * k + 1) * np.pi / (2 * n)) + 1) / 2 * DOMAIN**2
    x = np.sqrt(z)
    v = np.vander(z, n, increasing=True)
    return np.linalg.solve(v, fn(x))


# sin(x) = x · S(x²), S the even fit of sin(x)/x (degree 6 in z → x¹³)
SIN_C = tuple(
    float(c) for c in _cheb_fit_even(
        lambda x: np.where(x == 0, 1.0, np.sin(x) / np.where(x == 0, 1, x)), 6
    )
)
# cos(x) = C(x²), degree 7 in z
COS_C = tuple(float(c) for c in _cheb_fit_even(np.cos, 7))


def _horner(z, coeffs):
    acc = coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * z + c
    return acc


def fast_sin(x):
    """sin(x) for |x| ≤ DOMAIN."""
    return x * _horner(x * x, SIN_C)


def fast_cos(x):
    """cos(x) for |x| ≤ DOMAIN."""
    return _horner(x * x, COS_C)


def fast_sincos(x):
    """(sin x, cos x) sharing one x²."""
    z = x * x
    return x * _horner(z, SIN_C), _horner(z, COS_C)
