"""The port's h-adaptive loop and driver on the CPU: histories equal to the
JAX package's XLA engine in float64, checkpoint/resume, and no CPU
fallback for the CUDA paths on a machine without a GPU."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adapt.advec_loop import run_adaptive_advec as jax_run
from adjoint_ode_adaptivity_tpu_torch.adapt.advec_loop import run_adaptive_advec
from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

REPO = Path(__file__).resolve().parents[1]
# test_advec.py::test_adaptive_element_loop_reduces_estimate's config
REF_KW = dict(n_order=2, k0=8, final_time=0.1, maxit=3, tol=1e-10)
KW = {**REF_KW, "device": "cpu"}  # the port's loop defaults to the card


def _sin(x):
    return np.sin(x)


@pytest.fixture(scope="module")
def jax_history():
    return jax_run(_sin, **REF_KW)


def test_torch_engine_matches_xla_engine_f64(jax_history):
    hist = run_adaptive_advec(_sin, dtype=torch.float64, **KW)
    assert len(hist) == len(jax_history) >= 2
    for ours, ref in zip(hist, jax_history):
        np.testing.assert_array_equal(ours.vx, ref.vx)  # same bisections
        assert (ours.n_steps, ours.dt) == (ref.n_steps, ref.dt)
        # 1e-10 relative, plus the float64 roundoff floor of a sum of K
        # mixed-sign element terms λ·(u_{n+1} − half2): each carries
        # ~n_steps·Np·eps·max|λ| ≈ 8·3·1.1e-16·0.5 absolute, whatever the
        # size of the sum, so K = 8..11 elements give ≤ ~1e-14
        assert abs(ours.est_total - ref.est_total) <= 1e-10 * abs(ref.est_total) + 1e-14
        assert abs(ours.j_value - ref.j_value) <= 1e-12 * abs(ref.j_value)
        np.testing.assert_allclose(ours.eta, ref.eta, rtol=1e-9, atol=1e-15)
    assert abs(hist[-1].est_total) < abs(hist[0].est_total) / 10


def test_checkpoint_resume_reproduces_history(tmp_path):
    full = run_adaptive_advec(_sin, dtype=torch.float64, **KW)
    ckpt = str(tmp_path / "ckpt")
    first = run_adaptive_advec(_sin, dtype=torch.float64, checkpoint_dir=ckpt, **{**KW, "maxit": 1})
    assert len(first) == 2
    resumed = run_adaptive_advec(_sin, dtype=torch.float64, checkpoint_dir=ckpt, **KW)
    assert len(resumed) == len(full)
    for a, b in zip(resumed, full):
        np.testing.assert_array_equal(a.vx, b.vx)
        np.testing.assert_array_equal(a.eta, b.eta)
        assert (a.j_value, a.est_total, a.n_steps, a.dt) == (b.j_value, b.est_total, b.n_steps, b.dt)


def test_bad_engine_and_cuda_engine_on_cpu_raise():
    with pytest.raises(ValueError):
        run_adaptive_advec(_sin, engine="pallas")
    with pytest.raises(ValueError):
        run_adaptive_advec(_sin, engine="cuda", device="cpu")


def test_loop_defaults_to_the_card():
    """Without device= the loop runs on the card, and raises where there
    is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_adaptive_advec(_sin, **REF_KW)


def test_driver_cpu_adapt_and_estimate(capsys):
    hist = advec_dg.main(
        ["--device", "cpu", "--adapt", "--k", "8", "--final-time", "0.1", "--maxit", "1", "--x64"]
    )
    assert len(hist) == 2 and "finished after 2 iterations" in capsys.readouterr().out
    err = advec_dg.main(["--device", "cpu", "--k", "8", "--final-time", "0.1", "--estimate"])
    assert err < 5e-2
    assert "Σeta" in capsys.readouterr().out


@pytest.mark.parametrize(
    "argv,exc",
    [
        (["--kernel", "cuda", "--device", "cpu"], SystemExit),
        (["--kernel", "cuda", "--x64"], SystemExit),
    ],
)
def test_driver_rejects_cuda_kernel_without_cuda_device(argv, exc):
    with pytest.raises(exc):
        advec_dg.main(argv + ["--k", "8", "--final-time", "0.01"])


@pytest.mark.parametrize(
    "argv",
    [
        ["--kernel", "cuda", "--adapt"],
        ["--kernel", "torch"],
        ["--device", "cuda:0", "--estimate"],
    ],
)
def test_driver_raises_without_gpu(argv):
    """The default --device cuda raises on a GPU-less machine; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        advec_dg.main(argv + ["--k", "8", "--final-time", "0.01"])


def test_driver_module_entry_point_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    proc = subprocess.run(
        [sys.executable, "-m", "adjoint_ode_adaptivity_tpu_torch.drivers.advec_dg",
         "--adapt", "--kernel", "cuda", "--k", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "finished after" not in proc.stdout
