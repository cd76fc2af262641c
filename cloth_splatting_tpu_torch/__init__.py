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

Every operation runs in a fixed order (``set_deterministic``, on at import):
the same inputs give the same bits on every run, as XLA's scatters do on a
TPU. PyTorch then sums ``index_add_``, ``index_put`` with ``accumulate`` and
the backward of gathers on CUDA by a sorted segment reduction instead of
atomics, cuDNN picks deterministic convolution algorithms, and cuBLAS uses
a fixed workspace; an operation that has no deterministic version on the
card raises instead of running. PyTorch's fill of fresh memory under the
switch (``torch.utils.deterministic.fill_uninitialized_memory``) stays off:
it changes no result of a kernel that writes what it later reads, and adds
a fill to every ``torch.empty``. ``CUBLAS_WORKSPACE_CONFIG`` is read when
the first cuBLAS handle is made, so this module sets it before any CUDA
work of the importing process.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

# Full-fp32 geometry: see the module docstring.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def set_deterministic(on: bool = True) -> None:
    """Switch PyTorch's deterministic algorithms and cuDNN's deterministic,
    non-benchmarked convolutions on or off together, without filling fresh
    memory. On by default; off only to measure what determinism costs."""
    torch.use_deterministic_algorithms(on)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


set_deterministic(True)

__version__ = "0.1.0"
