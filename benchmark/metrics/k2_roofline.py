"""K2 (the training forward compositor, ``ops.rasterize.tiled_train``)'s
share of its roofline, in percent (``harness/roofline.py``)."""

import re

from benchmark.counts import compositor_forward
from benchmark.harness.roofline import share


def read(ctx):
    return share(ctx, re.compile(r"\btiled_fwd_train_(span_)?kernel<"), "raster_forward",
                 compositor_forward)
