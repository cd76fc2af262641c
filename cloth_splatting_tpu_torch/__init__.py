"""PyTorch + CUDA port of ``cloth_splatting_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, mirroring its module layout. It imports
torch, numpy and scipy, never JAX and never ``cloth_splatting_tpu``. Every
Pallas kernel of the JAX package becomes a hand-written Hopper kernel under
``csrc/``, each with a plain PyTorch version in the same module for the CPU
and for holding the kernel to on the card.

Float32 matmuls and convolutions run in full float32 (TF32 off). The kNN
init (``ops/knn.py``) and the residual simulator MLP (``models/deform.py``)
feed Gaussian scales and vertex positions: TF32's ~10-bit mantissa in the
|q|^2 - 2 q.p + |p|^2 cross term is of the order of a nearest-neighbour
distance itself and corrupts the scale init, the way bf16 did on the TPU.
"""

import torch

# Full-fp32 geometry: see the module docstring.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
