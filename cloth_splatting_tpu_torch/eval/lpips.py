"""LPIPS perceptual distance (VGG16 features and linear heads);
counterpart of ``cloth_splatting_tpu/eval/lpips_jax.py``.

Scale the inputs with the ImageNet shift and scale, run the VGG16 convolution
stack and tap it after each of its 5 blocks (relu1_2, relu2_2, relu3_3,
relu4_3, relu5_3), unit-normalize channels, weight the squared differences
with the 1x1 linear heads, take the spatial mean and sum over the taps.

Two weight sources, as in the JAX package:

  * real LPIPS-vgg weights from an ``.npz`` in the JAX package's layout
    (``conv_<b>_<i>_w`` HWIO [kh, kw, cin, cout], ``conv_<b>_<i>_b``,
    ``lin_<b>``), as ``scripts/export_lpips_weights.py`` writes it;
    ``load_weights`` turns the kernels to torch's OIHW;
  * ``fixture_weights()``: a deterministic He-initialized VGG with uniform
    heads, the same numpy arrays as the JAX package's for a seed. Its values
    are a reproducible regression metric (0 for identical images, monotone
    in feature-space distortion), not comparable to published LPIPS; the
    metrics label them ``fixture-v1``.

The convolutions are library ``conv2d`` calls in full float32 (the package
turns TF32 off at import).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cloth_splatting_tpu_torch.device import resolve_device

# VGG16 conv layout: (out_channels, n_convs) per block
VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)
FIXTURE_VERSION = "fixture-v1"


def available(path: str | None) -> bool:
    return bool(path) and os.path.exists(path)


def fixture_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic He-initialized VGG16 (HWIO) and uniform linear heads:
    one ``np.random.default_rng(seed)`` stream in a fixed key order."""
    rng = np.random.default_rng(seed)
    weights: dict[str, np.ndarray] = {}
    cin = 3
    for b, (cout, n_convs) in enumerate(VGG_BLOCKS):
        for i in range(n_convs):
            fan_in = 3 * 3 * cin
            std = np.sqrt(2.0 / fan_in)
            weights[f"conv_{b}_{i}_w"] = rng.normal(
                0.0, std, (3, 3, cin, cout)).astype(np.float32)
            weights[f"conv_{b}_{i}_b"] = np.zeros(cout, np.float32)
            cin = cout
        weights[f"lin_{b}"] = np.full(cout, 1.0 / cout, np.float32)
    return weights


def to_torch(weights: dict[str, np.ndarray],
             device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Weights in the JAX layout as tensors on ``device``, conv kernels
    turned from HWIO to OIHW."""
    dev = resolve_device(device)
    out = {}
    for k, v in weights.items():
        a = np.asarray(v, np.float32)
        if k.endswith("_w"):
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def load_weights(path: str, device: str | torch.device = "cuda"
                 ) -> dict[str, torch.Tensor]:
    """The ``.npz`` at ``path`` (the JAX package's layout) on ``device``."""
    with np.load(path) as z:
        return to_torch({k: z[k] for k in z.files}, device)


def _vgg_features(weights: dict[str, torch.Tensor],
                  x: torch.Tensor) -> list[torch.Tensor]:
    """x: [B, 3, H, W] in [-1, 1] -> the 5 tapped feature maps."""
    shift = torch.as_tensor(SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(SCALE, device=x.device)[None, :, None, None]
    h = (x - shift) / scale
    feats = []
    for b, (_, n_convs) in enumerate(VGG_BLOCKS):
        for i in range(n_convs):
            h = F.relu(F.conv2d(h, weights[f"conv_{b}_{i}_w"],
                                weights[f"conv_{b}_{i}_b"], padding=1))
        feats.append(h)
        if b < len(VGG_BLOCKS) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


@torch.no_grad()
def lpips(weights: dict[str, torch.Tensor], img1: torch.Tensor,
          img2: torch.Tensor) -> torch.Tensor:
    """Perceptual distance [B] between [B, 3, H, W] images in [0, 1];
    ``weights`` as ``to_torch`` or ``load_weights`` give them."""
    fx = _vgg_features(weights, img1 * 2.0 - 1.0)
    fy = _vgg_features(weights, img2 * 2.0 - 1.0)
    total = torch.zeros(img1.shape[0], device=img1.device)
    for b, (a, c) in enumerate(zip(fx, fy)):
        an = a / torch.sqrt((a**2).sum(dim=1, keepdim=True) + 1e-10)
        cn = c / torch.sqrt((c**2).sum(dim=1, keepdim=True) + 1e-10)
        d = (an - cn) ** 2                                    # [B, C, H, W]
        lin = weights[f"lin_{b}"]                             # [C]
        total = total + (d * lin[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total
