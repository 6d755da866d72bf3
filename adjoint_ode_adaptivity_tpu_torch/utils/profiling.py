"""Profiling helpers: torch.profiler traces and wall-clock timing.

Counterpart of the JAX package's ``utils/profiling.py`` (``jax.profiler``
becomes ``torch.profiler``). The reference has no profiling at all. These
let any caller write a Chrome trace of a block and report steady-state
times.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable

import torch

from adjoint_ode_adaptivity_tpu_torch.tree import tree_leaves

__all__ = ["trace", "time_fn"]


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Profile the enclosed block (CPU activity, and the card's where there
    is one) and write a Chrome trace into ``trace_dir`` (no-op when None)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _block(out) -> None:
    """Wait for the card where any tensor of ``out`` lies on it."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_leaves(out)):
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> dict:
    """Warm up, then time ``fn(*args)`` (synchronising with the card where
    its output lies there).

    Returns {'best_s', 'mean_s', 'times'}.
    """
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times), "times": times}
