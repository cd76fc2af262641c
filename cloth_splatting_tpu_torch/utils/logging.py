"""Metrics logging; counterpart of ``MetricsLogger`` in
``cloth_splatting_tpu/utils/logging.py``: a JSONL stream that any dashboard
can tail."""

from __future__ import annotations

import json
import os
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
