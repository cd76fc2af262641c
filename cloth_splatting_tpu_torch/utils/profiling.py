"""Profiling and debugging aids; counterpart of
``cloth_splatting_tpu/utils/profiling.py`` in PyTorch's idiom:
``torch.profiler`` traces around arbitrary spans, named spans
(``record_function``) that show in them, anomaly detection with a NaN check
of every operation, and a per-step wall timer with an exponential average."""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, when there is a
    card, CUDA activity into ``log_dir`` (a Chrome trace that TensorBoard's
    profiler plugin or Perfetto opens)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def step_annotation(name: str):
    """A named span that shows in profiler traces."""
    return torch.profiler.record_function(name)


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` on the first operation whose output holds
    a NaN, as ``jax_debug_nans`` does (each check reads the value back, so
    everything slows down)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_nan_check: _NanCheck | None = None


def enable_debug_checks(nans: bool = True) -> None:
    """The counterpart of the JAX package's debug checks, on until
    ``disable_debug_checks``: autograd's anomaly detection (a backward
    error names the forward operation that made its input) and, with
    ``nans``, a NaN check of every operation's output, forward and backward
    (JAX's ``jax_debug_nans``; its tracer-leak check has no counterpart)."""
    global _nan_check
    torch.autograd.set_detect_anomaly(True, check_nan=nans)
    if nans and _nan_check is None:
        _nan_check = _NanCheck()
        _nan_check.__enter__()


def disable_debug_checks() -> None:
    global _nan_check
    torch.autograd.set_detect_anomaly(False)
    if _nan_check is not None:
        _nan_check.__exit__(None, None, None)
        _nan_check = None


class StepTimer:
    """Wall-clock per-step timing with an exponential average."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_ms: float | None = None
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self) -> float:
        dt = (time.time() - self._t0) * 1000.0
        self.avg_ms = dt if self.avg_ms is None else \
            self.ema * self.avg_ms + (1 - self.ema) * dt
        return dt
