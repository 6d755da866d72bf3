"""Training data: reference trajectories and batching.

Counterpart of the JAX package's ``train/data.py``. The reference calls host
``scipy.integrate.odeint`` per IC (Main_FD_with_net.py:151); here the truth
is a dense fixed-step RK4 march of the whole IC batch at once, sampled at
``save_times`` by linear interpolation (``adjoint.estimate.interp``, which
computes what ``jnp.interp`` computes). ``make_batches`` shuffles with an
explicit permutation or ``torch.Generator`` (``getTrainBatches``,
Main_FD_with_net.py:120-132).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.estimate import interp

__all__ = ["rk4_truth", "make_batches", "train_test_split"]


def rk4_truth(f: Callable, u0: torch.Tensor, t_span: tuple[float, float], n_sub: int = 512,
              save_times: torch.Tensor | None = None) -> torch.Tensor:
    """Dense RK4 of ``u' = f(u, t)`` over ``t_span`` for every entry of
    ``u0`` (any shape). Returns the terminal values (shape of u0), or the
    trajectories sampled at ``save_times`` (shape of u0 + (P,))."""
    t0, t1 = t_span
    u0 = torch.as_tensor(u0)
    ts = torch.tensor(np.linspace(t0, t1, n_sub + 1), dtype=u0.dtype, device=u0.device)
    h = (t1 - t0) / n_sub
    u = u0.reshape(-1)
    hist = [u]
    for n in range(n_sub):
        t = ts[n]
        k1 = f(u, t)
        k2 = f(u + 0.5 * h * k1, t + 0.5 * h)
        k3 = f(u + 0.5 * h * k2, t + 0.5 * h)
        k4 = f(u + h * k3, t + h)
        u = u + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        hist.append(u)
    if save_times is None:
        return u.reshape(u0.shape)
    traj = torch.stack(hist)  # (n_sub+1, M)
    x = torch.as_tensor(save_times, dtype=u0.dtype, device=u0.device)
    return interp(x, ts, traj).T.reshape(u0.shape + (x.shape[0],))


def make_batches(u0_train: torch.Tensor, true_train, batch_size: int, *, perm=None,
                 generator: torch.Generator | None = None):
    """Shuffle (by ``perm``, or a permutation drawn from ``generator``) and
    cut ``n // batch_size`` batches (the ragged tail drops). Returns
    (u0_batches, true_batches) with a leading batch axis."""
    n = u0_train.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=generator)
    perm = torch.as_tensor(perm, device=u0_train.device)
    n_batches = n // batch_size
    cut = lambda x: x[perm][: n_batches * batch_size].reshape(  # noqa: E731
        (n_batches, batch_size) + tuple(x.shape[1:]))
    return cut(u0_train), cut(true_train)


def train_test_split(u0: torch.Tensor, true, n_test: int):
    """The first ``n_test`` entries are held out (Main_FD_with_net.py:155-156)."""
    return (u0[n_test:], true[n_test:]), (u0[:n_test], true[:n_test])
