"""Checkpoints of training and adaptivity state as ``torch.save`` files.

Counterpart of the JAX package's ``train/checkpoint.py`` (orbax there): one
file per step, ``<dir>/ckpt_<step>.pt``, the three newest kept; a restore
against a template checks every leaf's shape and dtype.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_checkpoint_raw", "latest_step"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(directory) -> list[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(m.group(1)) for p in d.iterdir() if (m := _NAME.match(p.name)))


def save_checkpoint(directory, step: int, state: Any, max_to_keep: int = 3) -> None:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"ckpt_{int(step)}.pt"
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, state),
               tmp)
    os.replace(tmp, path)
    for old in _steps(d)[:-max_to_keep]:
        (d / f"ckpt_{old}.pt").unlink()


def latest_step(directory) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint_raw(directory, step: int | None = None) -> Any:
    """The saved tree as it was written (no template)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return torch.load(Path(directory) / f"ckpt_{int(step)}.pt", weights_only=True)


def restore_checkpoint(directory, template: Any, step: int | None = None) -> Any:
    """The saved tree, each tensor leaf checked against ``template``'s shape
    and dtype and moved to its device."""
    raw = restore_checkpoint_raw(directory, step)

    def check(t, x):
        if isinstance(t, torch.Tensor):
            x = torch.as_tensor(x)
            if x.shape != t.shape or x.dtype != t.dtype:
                raise ValueError(f"checkpoint leaf {tuple(x.shape)} {x.dtype} does not match "
                                 f"the template's {tuple(t.shape)} {t.dtype}")
            return x.to(t.device)
        return x

    return tree_map(check, template, raw)
