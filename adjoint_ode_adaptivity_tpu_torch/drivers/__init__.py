"""Command-line drivers: ``python -m adjoint_ode_adaptivity_tpu_torch.drivers.<name>``."""
