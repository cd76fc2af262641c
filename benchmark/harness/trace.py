"""The traced slice: torch.profiler over a few units of a cell's work.

From the profiler's events: the slice's wall time, the seconds in which a
kernel ran on the card (the union of the kernels' intervals), every
kernel's launches and seconds by name, the device operations that took
most time, and the longest idle gaps named by what the host was doing
(the innermost host operation that covers the gap's middle).
"""

from __future__ import annotations

import bisect
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


def _union(intervals: list) -> tuple[float, list]:
    """(covered length, gaps between the merged intervals) in us."""
    covered, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def profile_slice(fn, units: int, label: str) -> dict:
    """Profile ``fn()`` (``units`` units of work, ending in a device
    synchronize) and read the trace."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(label):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # a user annotation (record_function) shows on the device too, as a
    # range over all its kernels: not an operation
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != label]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    intervals = [(e.time_range.start, e.time_range.end) for e in kern]
    busy_us, gaps = _union(intervals)
    by_name: dict[str, list] = {}
    for e in kern:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e.time_range.end - e.time_range.start) / 1e6
    # the host operation that covers a moment: the shortest covering span
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host),
                   key=lambda s: s[0])
    starts = [s[0] for s in spans]

    def host_at(t: float) -> str:
        """The innermost host operation running at ``t``; when the host was
        between operations (in Python), the one it started next."""
        i = bisect.bisect_right(starts, t)
        best = None
        for s, e, name in spans[max(i - 4000, 0):i]:
            if s <= t <= e and e - s < wall * 1e6 / 2 and (
                    best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        if best:
            return best[2]
        return f"python, then {spans[i][2]}" if i < len(spans) else "python"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "units": units,
        "wall_s": wall,
        "busy_s": busy_us / 1e6,
        "launches": len(kern),
        "kernels": {k: {"count": v[0], "seconds": v[1]} for k, v in by_name.items()},
        "device_ops": [[k, v[1]] for k, v in top],
        "idle_gaps": [[host_at((s + e) / 2), (e - s) / 1e6] for s, e in longest],
    }
