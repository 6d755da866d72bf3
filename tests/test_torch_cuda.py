"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``; each test skips (from the fixture) where no GPU
is present. Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: both sides run float32 with the same folded tables but a
different order of operations (FMA contraction, the volume sum, the batch
reduction), so u and λ agree to a few ulp per step relative to their
largest entry, and η — a sum of differences λ·(u_{n+1} − half2) of O(1)
states — to a few ulp of max|λ|·max|u| per step.
"""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

pytestmark = pytest.mark.cuda
A = 2 * np.pi
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_order,k,b,graded", [(2, 24, 8, True), (7, 24, 8, False), (3, 50, 1, True)])
def test_kernels_match_plain_versions(device, n_order, k, b, graded):
    vx = 2 * np.pi * np.linspace(0, 1, k + 1) ** (1.6 if graded else 1.0)
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    xmin = float(np.min(np.abs(disc.x[0] - disc.x[1])))
    dt, n_steps = 0.5 * (0.75 / A) * xmin, 16
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    phases = np.linspace(0, 2 * np.pi, b, endpoint=False)
    u0 = torch.tensor(np.stack([np.sin(disc.x + p) for p in phases], 1),
                      dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    lam = lam[:, None, :].expand(disc.np_, b, k).contiguous()
    before = (dg_rhs.fwd_march.launches, dg_rhs.adj_est_stored.launches)
    traj, uf = dg_rhs.fwd_march(u0, 0.1, n_steps, ops, store_trajectory=True)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.1, ops)
    torch.cuda.synchronize()
    assert (dg_rhs.fwd_march.launches, dg_rhs.adj_est_stored.launches) == (
        before[0] + 1, before[1] + 1)
    traj_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.1, n_steps, ops, True)
    lam0_p, eta_p = dg_rhs.adj_est_stored_plain(traj_p, uf_p, lam, 0.1, ops)
    tol_u = 8 * n_steps * EPS32 * float(uf_p.abs().max())
    tol_l = 8 * n_steps * EPS32 * float(lam0_p.abs().max())
    tol_e = 8 * n_steps * disc.np_ * EPS32 * float(lam.abs().max()) * float(uf_p.abs().max())
    assert float((traj - traj_p).abs().max()) <= tol_u
    assert float((uf - uf_p).abs().max()) <= tol_u
    assert float((lam0 - lam0_p).abs().max()) <= tol_l
    assert float((eta - eta_p).abs().max()) <= tol_e


def test_kernel_rejects_float64_and_plain_is_not_taken(device):
    disc = startup_1d(2, 0.0, 2 * np.pi, 16)
    ops = dg_rhs.kernel_ops(disc, A, 1e-3, device)
    with pytest.raises(TypeError):
        dg_rhs.fwd_march(torch.zeros((3, 1, 16), dtype=torch.float64, device=device), 0.0, 4, ops)
    with pytest.raises(ValueError):  # not contiguous
        dg_rhs.fwd_march(torch.zeros((3, 16, 2), device=device).transpose(1, 2), 0.0, 4, ops)
