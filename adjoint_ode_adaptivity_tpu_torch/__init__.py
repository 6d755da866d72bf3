"""PyTorch + CUDA port of ``adjoint_ode_adaptivity_tpu``.

The first slice is the DG-advection main path: the LSRK4(5) forward march of
1D nodal-DG upwind advection, its discrete adjoint by the transpose of the
fine (half-step-squared) propagator, the per-element adjoint-weighted
step-doubling estimate η_k, and the goal-oriented h-adaptive loop on top.

Layout mirrors the JAX package so each module's counterpart is easy to find:

- ``ops``        host NumPy float64 builders (Jacobi, operators, mesh)
- ``march``      LSRK coefficients and the eager advection march
- ``adjoint``    eager transpose step, adjoint march and fused estimate
- ``ops.cuda``   the hand-written CUDA kernels, their plain-PyTorch
  versions and the entry points that mirror ``ops/pallas/dg_rhs.py``
- ``adapt``      the h-adaptive loop (``engine="torch"`` or ``"cuda"``)
- ``drivers``    the ``advec_dg`` command line
- ``interop``    carries a JAX-package discretization/operator bundle across

This package imports torch and NumPy, never jax.
"""

__version__ = "0.1.0"
