"""Reference-element operators: Vandermonde, differentiation, lift, mass,
quadrature-interpolation matrices (float64 host setup).

Reference parity: ``utils/Vandermonde1D.m``, ``utils/GradVandermonde1D.m``,
``utils/Dmatrix1D.m``, ``utils/Lift1D.m``, and the nodal→quadrature basis
matrix ``Phi`` assembled in ``matlab/fem_setup.m:27-39``.

All matrices are small (Np ≤ ~16) and built once in float64; the jitted
compute paths consume them as constants.
"""
from __future__ import annotations

import numpy as np

from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import (
    grad_jacobi_p,
    jacobi_gl,
    jacobi_gq,
    jacobi_p,
)

__all__ = [
    "vandermonde_1d",
    "grad_vandermonde_1d",
    "dmatrix_1d",
    "lift_1d",
    "mass_matrix",
    "stiffness_matrix",
    "interp_matrix_1d",
    "element_operators",
]


def vandermonde_1d(n: int, r: np.ndarray) -> np.ndarray:
    """V[i, j] = P_j(r_i) for the orthonormal Legendre basis, j = 0..n."""
    r = np.asarray(r, dtype=np.float64).ravel()
    return np.stack([jacobi_p(r, 0.0, 0.0, j) for j in range(n + 1)], axis=1)


def grad_vandermonde_1d(n: int, r: np.ndarray) -> np.ndarray:
    """Vr[i, j] = P'_j(r_i), j = 0..n."""
    r = np.asarray(r, dtype=np.float64).ravel()
    return np.stack([grad_jacobi_p(r, 0.0, 0.0, j) for j in range(n + 1)], axis=1)


def dmatrix_1d(n: int, r: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Nodal differentiation matrix Dr = Vr V^{-1} on the reference element."""
    vr = grad_vandermonde_1d(n, r)
    return np.linalg.solve(v.T, vr.T).T


def lift_1d(np_: int, v: np.ndarray) -> np.ndarray:
    """Surface lift LIFT = V (Vᵀ E) where E picks the two endpoint nodes."""
    emat = np.zeros((np_, 2))
    emat[0, 0] = 1.0
    emat[-1, 1] = 1.0
    return v @ (v.T @ emat)


def mass_matrix(v: np.ndarray) -> np.ndarray:
    """Reference-element mass matrix M = (V Vᵀ)^{-1} (unit Jacobian)."""
    return np.linalg.inv(v @ v.T)


def stiffness_matrix(v: np.ndarray, dr: np.ndarray) -> np.ndarray:
    """S = M Dr = (V Vᵀ)^{-1} Dr, i.e. S_ij = ∫ ℓ_i ℓ'_j."""
    return mass_matrix(v) @ dr


def interp_matrix_1d(n: int, r_from: np.ndarray, r_to: np.ndarray) -> np.ndarray:
    """Interpolation matrix from nodal values at ``r_from`` (order n) to
    arbitrary points ``r_to``: rows are the Lagrange basis evaluated at r_to.

    Replaces the reference's repeated ``polyfit``/``polyval`` round-trips
    (e.g. ``matlab/dg_march.m:47-49``) with a single well-conditioned matrix
    built from the orthonormal basis: I = V_to · V_from^{-1}.
    """
    v_from = vandermonde_1d(n, r_from)
    v_to = vandermonde_1d(n, r_to)
    return np.linalg.solve(v_from.T, v_to.T).T


def element_operators(n: int, n_gq: int | None = None) -> dict[str, np.ndarray]:
    """Bundle of reference-element operators for a single order-``n`` element.

    Equivalent of ``matlab/fem_setup.m``: GL nodes ``r``, Vandermonde ``v``,
    ``dr``, lift, mass ``m``, stiffness ``s``, Gauss quadrature ``(rq, wq)``
    of order ``n_gq`` and the nodal→quadrature interpolation matrix ``phi``.
    """
    if n_gq is None:
        n_gq = 2 * max(n, 1)
    r = jacobi_gl(0.0, 0.0, n)
    v = vandermonde_1d(n, r)
    dr = dmatrix_1d(n, r, v)
    rq, wq = jacobi_gq(0.0, 0.0, n_gq)
    return {
        "r": r,
        "v": v,
        "inv_v": np.linalg.inv(v),
        "dr": dr,
        "lift": lift_1d(n + 1, v),
        "mass": mass_matrix(v),
        "stiffness": stiffness_matrix(v, dr),
        "rq": rq,
        "wq": wq,
        "phi": interp_matrix_1d(n, r, rq),
    }
