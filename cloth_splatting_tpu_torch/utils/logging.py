"""Observability; counterpart of ``cloth_splatting_tpu/utils/logging.py``: a
JSONL metrics stream any dashboard can tail, optional TensorBoard and
``wandb`` adapters (each a no-op when its package is missing), a pausable
wall-clock timer, timestamped stdout and global seeding."""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
from typing import Any


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, step: int, **metrics: Any) -> None:
        if self._f is None:
            return
        rec = {"step": step, "ts": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class TensorBoardAdapter:
    """TensorBoard scalars and images; no-ops when ``log_dir`` is empty or
    ``torch.utils.tensorboard`` cannot load."""

    def __init__(self, log_dir: str | None):
        self._writer = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir)
            except Exception:
                self._writer = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def image(self, tag: str, img_chw, step: int) -> None:
        if self._writer is not None:
            self._writer.add_image(tag, img_chw, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class WandbAdapter:
    """``wandb`` logging; no-ops when disabled or when ``wandb`` cannot
    start (not installed, no login)."""

    def __init__(self, project: str | None = None, name: str | None = None,
                 config: Any = None, enabled: bool = False):
        self._run = None
        if enabled:
            try:
                import wandb

                self._run = wandb.init(project=project, name=name, config=config)
            except Exception:
                self._run = None

    def log(self, metrics: dict, step: int | None = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()


class Timer:
    """Pausable wall-clock timer."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self):
        if self._start is None:
            self._start = time.time()
        return self

    def pause(self):
        if self._start is not None:
            self._elapsed += time.time() - self._start
            self._start = None
        return self

    def get_elapsed_time(self) -> float:
        if self._start is not None:
            return self._elapsed + time.time() - self._start
        return self._elapsed


def timestamp_stdout(silent: bool = False) -> None:
    """Wrap stdout so that each line ends with a timestamp; ``silent``
    swallows everything written to it."""
    old = sys.stdout

    class Wrapper:
        def write(self, x):
            if silent:
                return
            if x.endswith("\n"):
                stamp = datetime.datetime.now().strftime("%d/%m %H:%M:%S")
                old.write(x.replace("\n", f" [{stamp}]\n"))
            else:
                old.write(x)

        def flush(self):
            old.flush()

    sys.stdout = Wrapper()


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (torch's CUDA
    generators too, when there is a card)."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
