"""The port's ``train_resnet_ode --method recurrent`` (the shared Dense chain,
shuffled minibatches) against the JAX driver from its own draws (initial
parameters, ICs and every epoch's permutation). Tolerances as in
tests/test_torch_train_driver.py: the JAX run is float64 data with float32
parameters, and so is the port's; per-epoch losses, errors and signals to
1e-6 relative.
"""
import torch
from test_torch_train_driver import assert_same_run, run_both

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers


def test_recurrent_run_matches_the_jax_driver(tmp_path, monkeypatch):
    argv = ["--method", "recurrent", "--hidden", "8,16", "--n-train", "64", "--n-steps", "2",
            "--epochs", "3", "--maxit", "2"]
    jax_run, port_run = run_both(argv, tmp_path, monkeypatch)
    assert_same_run(jax_run, port_run)
    assert len(jax_run[0]) == 9  # 3 epochs × 3 outer iterations, 4 minibatches each
