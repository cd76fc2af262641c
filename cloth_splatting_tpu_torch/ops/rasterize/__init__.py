"""Rasterizers sharing the EWA projection front end (ops/projection.py).

  * ``reference``: per-pixel O(N * P) oracle; ground truth at small sizes.
  * ``tiled_fwd``: the serving tier, sort-binned tiles composited by the
    hand-written CUDA kernel ``csrc/tiled_fwd.cu`` (its plain PyTorch
    version on the CPU).
"""
