"""A kernel's share of its roofline: the least time the card could take
for the function on the traced slice's inputs (the larger of its
operations at the peak FLOP rate and its bytes at the peak bandwidth, from
the function's count in ``benchmark/counts`` on each launch's live pairs
as the reference counts them) over the profiler's time of the kernels
whose names match."""

from __future__ import annotations


def share(ctx: dict, kernel, work_key: str, count) -> float | None:
    """Percent; None where the slice ran no such kernel or counted no work."""
    tr, work = ctx["trace"], ctx["work"]
    if not tr or not work or not work.get(work_key):
        return None
    seconds = sum(k["seconds"] for name, k in tr["kernels"].items() if kernel.search(name))
    if seconds <= 0:
        return None
    bound = sum(max(count.flops(i) / ctx["peak_flops"],
                    count.bytes_moved(i) / ctx["peak_bytes"]) for i in work[work_key])
    return 100.0 * bound / seconds
