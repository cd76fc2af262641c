"""Share of a unit's time in which no operation ran on the card, in
percent: 100 (1 - busy / time). Busy is the traced slice's union of the
profiler's device intervals (kernels, copies, fills) over its units; the
time is the untraced window's over its units, since the profiler
stretches the host's side of the slice 2-7x and would read idle time that
the window does not have."""


def read(ctx):
    tr, unit_s = ctx["trace"], ctx.get("unit_s")
    if not tr or not tr["units"] or not unit_s:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["units"] / unit_s)
