"""Share of the card's busy time in matrix-multiply kernels, in percent:
the profiler's time of kernels whose names are cuBLAS's or CUTLASS's
GEMMs (``gemm``, ``sgemm``, ``cutlass``, ``xmma``) over the busy time."""

import re

KERNEL = re.compile(r"gemm|cutlass|xmma", re.IGNORECASE)


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    seconds = sum(k["seconds"] for name, k in tr["kernels"].items() if KERNEL.search(name))
    return 100.0 * seconds / tr["busy_s"]
