"""Spectral-element primitives (L0 layer): Jacobi polynomials, quadrature,
Vandermonde/differentiation/lift operators and the 1D mesh, all host NumPy
float64. The hand-written CUDA kernels live in :mod:`.cuda` and are not
imported here (importing them builds nothing, but they pull in torch)."""

from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import (
    grad_jacobi_p,
    jacobi_gl,
    jacobi_gq,
    jacobi_p,
    radau_points,
)
from adjoint_ode_adaptivity_tpu_torch.ops.mesh import (
    Discretization1D,
    build_maps_1d,
    connect_1d,
    mesh_gen_1d,
    startup_1d,
)
from adjoint_ode_adaptivity_tpu_torch.ops.operators import (
    dmatrix_1d,
    element_operators,
    grad_vandermonde_1d,
    interp_matrix_1d,
    lift_1d,
    mass_matrix,
    stiffness_matrix,
    vandermonde_1d,
)

__all__ = [
    "jacobi_p",
    "grad_jacobi_p",
    "jacobi_gq",
    "jacobi_gl",
    "radau_points",
    "vandermonde_1d",
    "grad_vandermonde_1d",
    "dmatrix_1d",
    "lift_1d",
    "mass_matrix",
    "stiffness_matrix",
    "interp_matrix_1d",
    "element_operators",
    "mesh_gen_1d",
    "connect_1d",
    "build_maps_1d",
    "Discretization1D",
    "startup_1d",
]
