"""Slow-but-exact splatting oracle: every Gaussian against every pixel;
counterpart of ``cloth_splatting_tpu/ops/rasterize/reference.py``.

Ground truth for the tile compositor at small sizes: it materializes
[N, P] alpha maps, so keep N * H * W modest."""

from __future__ import annotations

import torch

from cloth_splatting_tpu_torch.ops.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    ProjectedGaussians,
)


def rasterize_reference(proj: ProjectedGaussians, width: int, height: int,
                        bg_color: torch.Tensor):
    """Composite projected Gaussians front-to-back at every pixel.

    Returns rgb [3, H, W], depth [1, H, W] (alpha-weighted expected depth),
    alpha [1, H, W] (accumulated opacity)."""
    order = torch.argsort(proj.depth, stable=True)  # invalid (inf) last
    xy = proj.xy[order]
    conic = proj.conic[order]
    color = proj.color[order]
    opacity = proj.opacity[order]
    d_sorted = proj.depth[order]
    depth = torch.where(torch.isfinite(d_sorted), d_sorted,
                        torch.zeros_like(d_sorted))
    valid = proj.valid[order]
    power_cut = proj.power_cut[order]

    ys, xs = torch.meshgrid(torch.arange(height, device=xy.device),
                            torch.arange(width, device=xy.device), indexing="ij")
    pix = torch.stack([xs, ys], dim=-1).reshape(-1, 2).to(xy.dtype)  # [P, 2]

    d = pix[None, :, :] - xy[:, None, :]                               # [N, P, 2]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * d[..., 0] ** 2 + c * d[..., 1] ** 2) - b * d[..., 0] * d[..., 1]
    alpha = torch.clamp_max(opacity[:, None] * torch.exp(power), ALPHA_MAX)
    dead = ((power > 0.0) | (power < power_cut[:, None]) | (alpha < ALPHA_MIN)
            | ~valid[:, None])
    alpha = torch.where(dead, torch.zeros_like(alpha), alpha)

    one_minus = 1.0 - alpha
    trans = torch.cat([torch.ones_like(alpha[:1]),
                       torch.cumprod(one_minus, dim=0)[:-1]], dim=0)  # [N, P]
    w = trans * alpha
    rgb = color.T @ w                                                 # [3, P]
    dep = depth @ w                                                   # [P]
    acc = w.sum(dim=0)
    t_final = one_minus.prod(dim=0)
    rgb = rgb + t_final[None, :] * bg_color[:, None]
    return (rgb.reshape(3, height, width), dep.reshape(1, height, width),
            acc.reshape(1, height, width))
