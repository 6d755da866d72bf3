"""PyTorch + CUDA port of ``adjoint_ode_adaptivity_tpu``.

The first slice is the DG-advection main path: the LSRK4(5) forward march of
1D nodal-DG upwind advection, its discrete adjoint by the transpose of the
fine (half-step-squared) propagator, the per-element adjoint-weighted
step-doubling estimate η_k, and the goal-oriented h-adaptive loop on top.
The second is the FD strand: the ODE registry, the functionals, one-step
marches, their discrete adjoints and the adjoint-weighted residual, the
adaptive time-grid loops (single run, backtrack, per-member ensemble), the
``fd_adaptive`` driver, and the ensemble refinement signal. The third is
the DG-in-time strand (the reference's MATLAB MAIN.m): the Newton slab
march, the discrete adjoint at order n+1, the per-element adjoint-weighted
residual, Radau reconstruction, the batched ensemble pipeline, the
single-run, ensemble-signal and per-member adaptive loops, and the
``dg_adaptive`` driver. The fourth is its hp strand: the mixed
per-element-order march and adjoint, the p/h/hp/smooth refinement loops
(single run, ensemble signal, per member) and ``dg_adaptive --hp``. The
fifth is the NN strand: ResNets as time integrators trained through the
solver (per-step or shared residual blocks, Adam as optax computes it), the
adjoint-weighted refinement signal deciding where a layer (time step) or a
neuron goes, and the ``train_resnet_ode`` driver with its five methods.
The last slice adds the implicit-function-theorem DG marches that a neural
right-hand side trains through (single, ensemble and mixed-order), the
``config`` facade, and the host tools (``ops.io``, ``drivers.sweep``,
``utils.plotting`` behind the drivers' ``--plot``/``--animate``,
``utils.profiling``).

Layout mirrors the JAX package so each module's counterpart is easy to find:

- ``odes``, ``functionals``  the ODE registry and the output functionals
- ``config``     the ``Problem``/``get_problem_functions`` facade over them
- ``ops``        host NumPy float64 set-up (Jacobi, operators, mesh), the
  fast-trig polynomials, and ``ops.io`` (the discretization's ``.npz``)
- ``march``      one-step FD marches, LSRK coefficients, the advection march,
  the DG-in-time slab marches (single, batched and mixed-order) and their
  IFT counterparts as ``torch.autograd.Function``s
- ``adjoint``    discrete adjoints, the FD estimate, the advection transpose
  step and fused estimate, the DG-in-time adjoint and AWR (uniform and
  mixed-order)
- ``ops.cuda``   the hand-written CUDA kernels, their plain-PyTorch
  versions and the entry points that mirror ``ops/pallas/dg_rhs.py``,
  ``ops/pallas/fd_ensemble.py``, ``ops/pallas/dg_slab.py``,
  ``ops/pallas/dg_slab_mixed.py``, ``ops/pallas/train_fused.py`` and
  ``ops/pallas/train_dense_fused.py``
- ``adapt``      the FD time-grid loops, the DG h-adaptive loop and the
  DG-in-time loops and their hp loops (``engine="torch"`` or ``"cuda"``),
  and the refinement policies
- ``models``     residual blocks as update rules (flax parameter names) and
  depth/width surgery
- ``train``      losses, RK4 truth, train steps (torch and cuda engines),
  Adam, the padded adaptive trainer, the refinement signal, metrics,
  checkpoints
- ``drivers``    the ``fd_adaptive``, ``advec_dg``, ``dg_adaptive``,
  ``burgers_dg`` and ``train_resnet_ode`` command lines, and the ``sweep``
  launcher of seeds
- ``parallel``   rank grids over ``torch.distributed``, the sharded
  advection pipelines, member-sharded studies, ``pipeline_march``
- ``utils``      ``profiling`` (torch.profiler traces, timing) and
  ``plotting`` (matplotlib, imported only when a frame is drawn)
- ``interop``    carries JAX-package state across (discretization, operator
  bundle, mixed-order operator stack, gaussian-mixture constants, flax
  parameters, optax Adam moments)

This package imports torch and NumPy, never jax.
"""

__version__ = "0.1.0"
