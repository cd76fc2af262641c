"""Training losses: photometric + mesh and kNN regularizers; counterpart of
``cloth_splatting_tpu/train/losses.py``.

- image loss = L1 + lambda_dssim (1 - SSIM), with an optional
  multiplicative mask on the L1 and on the (1 - SSIM) map;
- regularizers over the per-camera deformed vertices [B, V, 3]: anchor to
  the predicted mesh, deformation magnitude, rigid edge lengths, momentum;
- the MD-Splatting kNN losses (isometry, spring, rigidity).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cloth_splatting_tpu_torch.models.gaussians import Mesh
from cloth_splatting_tpu_torch.ops.image import l1_loss
from cloth_splatting_tpu_torch.ops.quaternion import (
    quat_inverse,
    quat_multiply,
    quat_to_rotmat,
)
from cloth_splatting_tpu_torch.ops.smallmat import bmv3
from cloth_splatting_tpu_torch.ops.ssim import ssim


def image_losses(images: torch.Tensor, gt_images: torch.Tensor,
                 lambda_dssim: float, masks: torch.Tensor | None = None):
    """Photometric loss over a camera batch [B, 3, H, W]: (loss, dict)."""
    l1 = l1_loss(images, gt_images, masks)
    loss = l1
    loss_dict = {"l1": l1}
    if lambda_dssim != 0.0:
        if masks is None:
            ssim_loss = 1.0 - ssim(images, gt_images)
        else:
            ssim_map = ssim(images, gt_images, return_map=True)
            ssim_loss = ((1.0 - ssim_map) * masks).mean()
        loss_dict["ssim_loss"] = ssim_loss
        loss = loss + lambda_dssim * ssim_loss
    return loss, loss_dict


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum x^2 + eps): a finite gradient at zero displacement."""
    return torch.sqrt((x * x).sum(dim=-1) + 1e-12)


def regularization(all_vertices: torch.Tensor, mesh: Mesh,
                   lambda_deform_mag: float, lambda_rigid: float,
                   lambda_momentum: float, static: bool = False,
                   lambda_anchor: float = 0.0,
                   anchor_base: torch.Tensor | None = None) -> torch.Tensor:
    """Mesh-deformation regularizers over consecutive-time vertex batches
    ``all_vertices`` [B, V, 3]; ``anchor_base`` [B, V, 3] holds the
    predicted vertices at the same times for the ``lambda_anchor`` term."""
    loss = all_vertices.new_zeros(())
    if static:
        return loss
    n_cams = all_vertices.shape[0]

    if lambda_anchor > 0.0 and anchor_base is not None:
        loss = loss + lambda_anchor * _safe_norm(all_vertices - anchor_base).mean()

    if lambda_deform_mag > 0.0 and n_cams >= 3:
        d0 = _safe_norm(all_vertices[1] - all_vertices[0]).mean()
        d1 = _safe_norm(all_vertices[2] - all_vertices[1]).mean()
        loss = loss + lambda_deform_mag * 0.5 * (d0 + d1)

    if lambda_rigid > 0.0:
        disp = (all_vertices[:, mesh.edge_index[1]]
                - all_vertices[:, mesh.edge_index[0]])
        deformed_norm = _safe_norm(disp)[..., None]                  # [B, E, 1]
        static_norm = mesh.edge_norm[None].expand_as(deformed_norm)
        loss = loss + lambda_rigid * (static_norm - deformed_norm).abs().mean()

    if lambda_momentum > 0.0 and n_cams >= 3:
        second_diff = all_vertices[2] - 2.0 * all_vertices[1] + all_vertices[0]
        loss = loss + lambda_momentum * second_diff.abs().sum(dim=-1).mean()

    return loss


class KnnState(NamedTuple):
    """Neighbourhoods at the t=0 deformed state."""

    idx: torch.Tensor    # [C, k] int64
    d0: torch.Tensor     # [C, k] rest distances
    w: torch.Tensor      # [C, k] exp(-lambda_w * d0^2)
    valid: torch.Tensor  # [C, k] bool


def knn_regularization(means: torch.Tensor, rotations: torch.Tensor,
                       knn: KnnState, lambda_isometric: float,
                       lambda_spring: float, lambda_rigidity: float
                       ) -> torch.Tensor:
    """kNN losses over a consecutive-time camera batch: ``means`` [B, C, 3]
    and ``rotations`` [B, C, 4] per camera.

    - iso: mean over cams of the SIGNED mean(knn_dist - knn_dist_t0) (a
      reference quirk, kept);
    - spring: mean |knn_dist_i - knn_dist_{i-1}| between consecutive cams;
    - rigidity: weighted L2 of the current kNN offsets rotated into the
      previous frame (neighbour rotations q_prev q_curr^-1) against the
      previous offsets."""
    b = means.shape[0]
    idx, d0, w, valid = knn.idx, knn.d0, knn.w, knn.valid
    vnum = torch.clamp_min(valid.sum().to(means.dtype), 1.0)

    offs = means[:, idx] - means[:, :, None, :]                      # [B, C, k, 3]
    dists = torch.sqrt((offs * offs).sum(dim=-1) + 1e-20)             # [B, C, k]
    zero = torch.zeros((), dtype=means.dtype, device=means.device)

    loss = means.new_zeros(())
    if lambda_isometric > 0.0:
        l_iso = (torch.where(valid[None], dists - d0[None], zero).sum(dim=(1, 2))
                 / vnum).mean()
        loss = loss + lambda_isometric * l_iso

    if lambda_spring > 0.0 and b >= 2:
        diff = (dists[1:] - dists[:-1]).abs()
        l_spring = (torch.where(valid[None], diff, zero).sum(dim=(1, 2))
                    / vnum).mean()
        loss = loss + lambda_spring * l_spring

    if lambda_rigidity > 0.0 and b >= 2:
        pairs = []
        for i in range(b - 1):
            kq_prev = rotations[i][idx].reshape(-1, 4)
            kq_curr = rotations[i + 1][idx].reshape(-1, 4)
            rot = quat_to_rotmat(quat_multiply(kq_prev, quat_inverse(kq_curr)))
            cur = bmv3(rot, offs[i + 1].reshape(-1, 3))
            d2 = ((cur - offs[i].reshape(-1, 3)) ** 2).sum(dim=-1)
            val = torch.sqrt(d2 * w.reshape(-1) + 1e-20)
            pairs.append(torch.where(valid.reshape(-1), val, zero).sum() / vnum)
        loss = loss + lambda_rigidity * torch.stack(pairs).mean()

    return loss
