"""Spans at the port's layer boundaries, and the debug checks; counterpart of
``cloth_splatting_tpu/utils/profiling.py`` in PyTorch's idiom.

``span(name, unit=None)`` marks a stage of a hot path (``with span("backward"):``).
It has three states:

- off (the default: spans not enabled and no ``torch.profiler`` recording):
  ``span`` returns one shared no-op context; nothing reads the clock and
  nothing is stored;
- enabled (``enable_spans(True)``): each span stores ``(name, parent, unit,
  start_ns, end_ns)`` from ``time.perf_counter_ns`` in memory, and
  ``take_spans()`` drains the store. The stack of open spans is per thread;
  ``parent`` is the enclosing span's index in the drained list; a root span
  takes ``unit`` (an iteration number; a running count when it is None) and
  its children inherit it, so every span of one unit of work carries the
  same identifier;
- under a recording ``torch.profiler.profile``: each span also opens
  ``torch.profiler.record_function(name)``, so it shows as a host event
  around the operations it ran, in the profiler's own timeline.

No span is opened inside an autograd ``Function.backward``: those run on
autograd's own thread, and a ``backward`` span around
``torch.autograd.grad`` covers them. Drain the store between units, when no
span is open: a span left open across ``take_spans`` keeps its parent in the
earlier list.

``enable_debug_checks`` / ``disable_debug_checks`` are anomaly detection
with a NaN check of every operation (``train --detect_anomaly``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class SpanRecord(NamedTuple):
    name: str
    parent: int | None   # the enclosing span's index in the same list
    unit: int
    start_ns: int        # time.perf_counter_ns
    end_ns: int | None   # None while the span is open


_OFF = contextlib.nullcontext()
_profiler_recording = torch._C._autograd._profiler_enabled
_enabled = False
_store: list = []            # [name, parent record, unit, start_ns, end_ns]
_roots = itertools.count()   # the unit of a root span given none
_local = threading.local()


def _open_stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "unit", "_rec", "_rf")

    def __init__(self, name: str, unit: int | None):
        self.name, self.unit = name, unit
        self._rec = self._rf = None

    def __enter__(self):
        if _profiler_recording():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if _enabled:
            stack = _open_stack()
            parent = stack[-1] if stack else None
            if parent is not None:
                unit = parent[2]
            else:
                unit = next(_roots) if self.unit is None else self.unit
            self._rec = [self.name, parent, unit, 0, None]
            _store.append(self._rec)
            stack.append(self._rec)
            self._rec[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec[4] = time.perf_counter_ns()
            _open_stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, unit: int | None = None):
    """A context marking one stage; the shared no-op when spans are off."""
    if not _enabled and not _profiler_recording():
        return _OFF
    return _Span(name, unit)


def enable_spans(on: bool = True) -> None:
    """Store every span from now on (``on``), or stop storing; what is stored
    stays until ``take_spans``."""
    global _enabled
    _enabled = bool(on)


def take_spans() -> list[SpanRecord]:
    """Every span stored since the last call, in the order they opened,
    and empty the store."""
    global _store
    recs, _store = _store, []
    index = {id(r): i for i, r in enumerate(recs)}
    return [SpanRecord(r[0], None if r[1] is None else index.get(id(r[1])), r[2], r[3],
                       r[4]) for r in recs]


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
