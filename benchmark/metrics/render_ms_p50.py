"""The median frame latency of the window, in ms, beside its 95th
percentile: each frame timed from the request to the frame synchronized
on the device (the benchmark's host clock around ``render.render``)."""


def read(ctx):
    win = ctx["window"]
    return win.get("p50_ms") if win else None
