"""PyTorch + CUDA port of ``adjoint_ode_adaptivity_tpu``.

The first slice is the DG-advection main path: the LSRK4(5) forward march of
1D nodal-DG upwind advection, its discrete adjoint by the transpose of the
fine (half-step-squared) propagator, the per-element adjoint-weighted
step-doubling estimate η_k, and the goal-oriented h-adaptive loop on top.
The second is the FD strand: the ODE registry, the functionals, one-step
marches, their discrete adjoints and the adjoint-weighted residual, the
adaptive time-grid loops (single run, backtrack, per-member ensemble), the
``fd_adaptive`` driver, and the ensemble refinement signal.

Layout mirrors the JAX package so each module's counterpart is easy to find:

- ``odes``, ``functionals``  the ODE registry and the output functionals
- ``ops``        host NumPy float64 builders (Jacobi, operators, mesh) and
  the fast-trig polynomials
- ``march``      one-step FD marches, LSRK coefficients, the advection march
- ``adjoint``    discrete adjoints, the FD estimate, the advection transpose
  step and fused estimate
- ``ops.cuda``   the hand-written CUDA kernels, their plain-PyTorch
  versions and the entry points that mirror ``ops/pallas/dg_rhs.py`` and
  ``ops/pallas/fd_ensemble.py``
- ``adapt``      the FD time-grid loops and the DG h-adaptive loop
  (``engine="torch"`` or ``"cuda"``), and the refinement policies
- ``drivers``    the ``fd_adaptive`` and ``advec_dg`` command lines
- ``interop``    carries JAX-package state across (discretization, operator
  bundle, gaussian-mixture constants)

This package imports torch and NumPy, never jax.
"""

__version__ = "0.1.0"
