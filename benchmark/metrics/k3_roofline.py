"""K3 (the training backward compositor, ``ops.rasterize.tiled_train``)'s
share of its roofline, in percent (``harness/roofline.py``)."""

import re

from benchmark.counts import compositor_backward
from benchmark.harness.roofline import share


def read(ctx):
    return share(ctx, re.compile(r"\btiled_bwd_(reverse_)?kernel<"), "raster_backward",
                 compositor_backward)
