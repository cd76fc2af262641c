"""SSIM with an 11x11 Gaussian window (sigma 1.5), differentiable;
counterpart of ``cloth_splatting_tpu/ops/ssim.py``.

The JAX package blurs with two banded-matrix matmuls, a TPU workaround (a
1-channel depthwise conv wastes the MXU). Here the separable blur is what it
computes: two depthwise ``conv2d`` passes (along W, then H) with zero
"same" padding, in float32 (the package turns TF32 off for convolutions).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_WINDOW = 11
_SIGMA = 1.5
_xs = np.arange(_WINDOW, dtype=np.float64)
_g = np.exp(-((_xs - _WINDOW // 2) ** 2) / (2.0 * _SIGMA**2))
_KERNEL = (_g / _g.sum()).astype(np.float32)


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of [B, C, H, W] with zero 'same' padding."""
    b, c, h, w = img.shape
    k = torch.from_numpy(_KERNEL).to(img.device)
    pad = _WINDOW // 2
    x = img.reshape(b * c, 1, h, w)
    x = F.conv2d(x, k.reshape(1, 1, 1, _WINDOW), padding=(0, pad))
    x = F.conv2d(x, k.reshape(1, 1, _WINDOW, 1), padding=(pad, 0))
    return x.reshape(b, c, h, w)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         return_map: bool = False) -> torch.Tensor:
    """Structural similarity of image batches [..., C, H, W] in [0, 1]: the
    mean, or the per-pixel map with ``return_map``."""
    orig_shape = img1.shape
    img1 = img1.reshape((-1,) + tuple(orig_shape[-3:]))
    img2 = img2.reshape((-1,) + tuple(orig_shape[-3:]))

    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1) - mu1_sq
    sigma2_sq = _blur(img2 * img2) - mu2_sq
    sigma12 = _blur(img1 * img2) - mu1_mu2

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    ssim_map = ssim_map.reshape(orig_shape)
    if return_map:
        return ssim_map
    return ssim_map.mean()
