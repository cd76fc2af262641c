"""Rasterizers sharing the EWA projection front end (ops/projection.py).

  * ``reference``: per-pixel O(N * P) oracle; ground truth at small sizes.
  * ``tiled_fwd``: the serving tier, sort-binned tiles composited by the
    hand-written CUDA kernel ``csrc/tiled_fwd.cu`` (its plain PyTorch
    version on the CPU).
  * ``tiled_train``: the training tier, K2 forward and K3 backward
    (``csrc/tiled_train.cu``) behind one autograd Function.
  * ``tiled``: the dense tier (the JAX package's XLA tier), plain PyTorch
    on either device, with a per-tile list capacity ``k_cap``.
"""
