"""Metrics and experiment logging.

Counterpart of the JAX package's ``train/metrics.py``: per-epoch {Epoch,
Loss, Error, Refinements} records (Main_new_loss.py:237-248) kept in memory,
printed, and optionally mirrored to a JSONL file and to wandb (imported only
when a project is given).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

__all__ = ["MetricsLogger", "StepTimer"]


class MetricsLogger:
    """Collects scalar records; optionally mirrors them to wandb and/or JSONL."""

    def __init__(self, run_name: str, *, wandb_project: str | None = None,
                 wandb_config: dict | None = None, jsonl_path: str | Path | None = None,
                 verbose: bool = True):
        self.run_name = run_name
        self.history: list[dict[str, Any]] = []
        self.verbose = verbose
        self._jsonl = Path(jsonl_path) if jsonl_path else None
        self._wandb = None
        if wandb_project is not None:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, name=run_name)
                for k, v in (wandb_config or {}).items():
                    setattr(wandb.config, k, v)
            except ImportError:
                self._wandb = None  # record locally

    def log(self, record: dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        self.history.append(record)
        if self._wandb is not None:
            self._wandb.log(record)
        if self._jsonl is not None:
            with self._jsonl.open("a") as f:
                f.write(json.dumps(record) + "\n")
        if self.verbose:
            print(" ".join(f"{k}: {v:.3e}" if isinstance(v, float) else f"{k}: {v}"
                           for k, v in record.items()))

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class StepTimer:
    """Wall-clock step timer (host clock; synchronise the device first for a
    device time)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps: list[float] = []

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.laps.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.laps) / max(len(self.laps), 1)
