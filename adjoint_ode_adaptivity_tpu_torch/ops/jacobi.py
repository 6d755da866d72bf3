"""Jacobi polynomials and Gauss-type quadrature (float64 host setup).

These are the L0 spectral primitives of the nodal-DG toolkit (reference:
``utils/JacobiP.m``, ``utils/GradJacobiP.m``, ``utils/JacobiGQ.m``,
``utils/JacobiGL.m``, Radau abscissas in ``utils/Globals1D.m:36-42``).

Design note: operator construction happens once, on the host, in float64 —
conditioning of these recurrences matters far more than their speed, and the
results are copied to the device once per mesh. The hot path never
re-evaluates polynomials; it consumes the precomputed matrices from
:mod:`adjoint_ode_adaptivity_tpu_torch.ops.operators`. Everything here is
pure NumPy, deterministic, and bit-identical to the JAX package's
``ops/jacobi.py``.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "jacobi_p",
    "grad_jacobi_p",
    "jacobi_gq",
    "jacobi_gl",
    "radau_points",
]


def jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Orthonormal Jacobi polynomial P_n^{(alpha,beta)} evaluated at ``x``.

    Normalised so that ∫_{-1}^1 P_m P_n (1-x)^a (1+x)^b dx = δ_mn, built by
    the standard symmetric three-term recurrence.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    gamma0 = (
        2.0 ** (alpha + beta + 1)
        / (alpha + beta + 1)
        * math.gamma(alpha + 1)
        * math.gamma(beta + 1)
        / math.gamma(alpha + beta + 1)
    )
    p_prev = np.full_like(x, 1.0 / math.sqrt(gamma0))
    if n == 0:
        return p_prev
    gamma1 = (alpha + 1) * (beta + 1) / (alpha + beta + 3) * gamma0
    p_curr = ((alpha + beta + 2) * x / 2 + (alpha - beta) / 2) / math.sqrt(gamma1)
    if n == 1:
        return p_curr
    a_old = (
        2.0
        / (2 + alpha + beta)
        * math.sqrt((alpha + 1) * (beta + 1) / (alpha + beta + 3))
    )
    for i in range(1, n):
        h1 = 2 * i + alpha + beta
        a_new = (
            2.0
            / (h1 + 2)
            * math.sqrt(
                (i + 1)
                * (i + 1 + alpha + beta)
                * (i + 1 + alpha)
                * (i + 1 + beta)
                / (h1 + 1)
                / (h1 + 3)
            )
        )
        b_new = -(alpha**2 - beta**2) / h1 / (h1 + 2)
        p_next = (-a_old * p_prev + (x - b_new) * p_curr) / a_new
        p_prev, p_curr = p_curr, p_next
        a_old = a_new
    return p_curr


def grad_jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """d/dx of the orthonormal Jacobi polynomial of order ``n``.

    Uses dP_n^{(a,b)} = sqrt(n (n+a+b+1)) · P_{n-1}^{(a+1,b+1)}.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    if n == 0:
        return np.zeros_like(x)
    return math.sqrt(n * (n + alpha + beta + 1)) * jacobi_p(x, alpha + 1, beta + 1, n - 1)


def jacobi_gq(alpha: float, beta: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss quadrature nodes/weights for the Jacobi weight (Golub-Welsch).

    Returns the ``n+1`` points and weights that integrate polynomials up to
    degree ``2n+1`` exactly against (1-x)^alpha (1+x)^beta on [-1, 1].
    """
    if n == 0:
        return (
            np.array([-(alpha - beta) / (alpha + beta + 2)]),
            np.array([2.0]),
        )
    h1 = 2 * np.arange(n + 1, dtype=np.float64) + alpha + beta
    h1_safe = np.where(h1 == 0.0, 1.0, h1)  # h1[0]=0 when alpha+beta=0; fixed below
    diag = -0.5 * (alpha**2 - beta**2) / (h1 + 2) / h1_safe
    if alpha + beta < 10 * np.finfo(np.float64).eps:
        diag[0] = 0.0
    k = np.arange(1, n + 1, dtype=np.float64)
    off = (
        2.0
        / (h1[:n] + 2)
        * np.sqrt(
            k * (k + alpha + beta) * (k + alpha) * (k + beta) / (h1[:n] + 1) / (h1[:n] + 3)
        )
    )
    jm = np.diag(diag) + np.diag(off, 1)
    jm = jm + jm.T
    eigval, eigvec = np.linalg.eigh(jm)
    x = eigval
    w = (
        eigvec[0, :] ** 2
        * 2.0 ** (alpha + beta + 1)
        / (alpha + beta + 1)
        * math.gamma(alpha + 1)
        * math.gamma(beta + 1)
        / math.gamma(alpha + beta + 1)
    )
    return x, w


def jacobi_gl(alpha: float, beta: float, n: int) -> np.ndarray:
    """Gauss-Lobatto points: {-1} ∪ interior GQ(alpha+1, beta+1, n-2) ∪ {1}."""
    if n == 0:
        return np.array([0.0])
    if n == 1:
        return np.array([-1.0, 1.0])
    interior, _ = jacobi_gq(alpha + 1, beta + 1, n - 2)
    return np.concatenate(([-1.0], interior, [1.0]))


def radau_points(n: int) -> np.ndarray:
    """Left-Radau collocation points on [-1, 1]: {-1} ∪ roots of P_{n-1}^{(0,1)}.

    Matches the hard-coded abscissa table in the reference
    (``utils/Globals1D.m:36-42``) but computed to machine precision for any
    order, for adjoint reconstruction (``matlab/adj_rec.m:34-47``).
    """
    if n < 1:
        raise ValueError("radau_points requires n >= 1")
    if n == 1:
        return np.array([-1.0])
    interior, _ = jacobi_gq(0.0, 1.0, n - 2)
    return np.concatenate(([-1.0], interior))
