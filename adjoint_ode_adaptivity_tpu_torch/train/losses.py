"""Loss functions for training through the differentiable solver.

Counterpart of the JAX package's ``train/losses.py``: the terminal MSE
(``lossFn``, Main_new_loss.py:139-142), the trapezoid trajectory loss
(``newLossFn``, :145-150), the mixed ramp weight 10**((it+1)//10 − 4)
(:163-165) and the full-trajectory MSE (Main_FD_with_net.py:96-99). Time is
axis 0; a trailing member axis is kept, so a batch of members gives a
batch of losses.
"""
from __future__ import annotations

import torch

__all__ = ["terminal_mse", "trajectory_trapezoid", "mixed_ramp_weight", "trajectory_mse"]


def terminal_mse(u_traj: torch.Tensor, true_terminal) -> torch.Tensor:
    """(u_N − true)², squeezed as in JAX."""
    return torch.squeeze(torch.square(torch.squeeze(u_traj[-1]) - torch.squeeze(
        torch.as_tensor(true_terminal))))


def trajectory_trapezoid(u_traj: torch.Tensor, true_traj: torch.Tensor, dt: torch.Tensor):
    """Σ_n dt_n·(e²_n + e²_{n+1})/2 along axis 0 (members ride along)."""
    e2 = torch.square(torch.squeeze(u_traj) - torch.squeeze(true_traj))
    node = (e2[:-1] + e2[1:]) / 2.0
    return torch.squeeze(torch.tensordot(dt.to(node.dtype), node, dims=([0], [0])))


def mixed_ramp_weight(it) -> float:
    """Terminal-loss weight 10**((it+1)//10 − 4), up every 10 outer iterations."""
    return 10.0 ** ((int(it) + 1) // 10 - 4)


def trajectory_mse(u_traj: torch.Tensor, true_traj: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(u_traj - true_traj))
