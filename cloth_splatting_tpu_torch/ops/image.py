"""Pixel-space losses and metrics (L1/L2/PSNR); counterpart of
``cloth_splatting_tpu/ops/image.py``."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean absolute error with an optional multiplicative mask."""
    diff = (pred - gt).abs()
    if mask is not None:
        diff = diff * mask
    return diff.mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over (C, H, W), keeping batch dims."""
    return ((pred - gt) ** 2).mean(dim=(-3, -2, -1))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio per image in dB."""
    m = mse(pred, gt)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(m, 1e-12)))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))
