"""The whole unit's share of the card's peak, in percent: the benchmark's
count of the operations of the traced slice's units (``ctx["work"]
["flops"]``, from ``benchmark/counts``) a unit, over the untraced window's
time a unit times the peak of the precision the matmuls run in (fp32 67
TFLOP/s with TF32 off). The window's time, not the slice's: the profiler
stretches the slice."""


def read(ctx):
    tr, work, unit_s = ctx["trace"], ctx["work"], ctx.get("unit_s")
    if not tr or not tr["units"] or not work or not work.get("flops") or not unit_s:
        return None
    return 100.0 * work["flops"] / tr["units"] / (unit_s * ctx["peak_flops"])
