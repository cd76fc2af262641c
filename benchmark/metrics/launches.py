"""Device operations launched a unit of work (an iteration, frame, step or
call, as the metric's unit says) in the traced slice: every kernel, copy
and fill the profiler saw on the card, over the slice's units. The host
dispatches each one."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["units"]:
        return None
    return tr["launches"] / tr["units"]
