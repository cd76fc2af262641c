"""EWA splatting projection: 3D Gaussians -> screen-space 2D Gaussians;
counterpart of ``cloth_splatting_tpu/ops/projection.py``.

Camera-space transform, perspective Jacobian with the 3DGS frustum clamp,
2D covariance J W S W^T J^T with a +0.3 px low-pass on the diagonal, conic
inverse, 3-sigma radius from the larger eigenvalue (capped at
``max_radius``, with the support ellipse shrunk through ``power_cut``, or
uncapped with ``max_radius=None``), near cull at z <= 0.2. Covariances
travel packed as [N, 6] upper triangles.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cloth_splatting_tpu_torch.ops.quaternion import quat_to_rotmat
from cloth_splatting_tpu_torch.ops.smallmat import (
    affine4_shared,
    sym33_from_rs,
    sym33_quadform2,
)

NEAR_CULL_Z = 0.2
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
# Deterministic per-pixel 3-sigma support rule: power < power_cut => zero, so
# every renderer tier computes the same image whatever its tiling.
POWER_CUTOFF = -4.5
# Cap on screen radius; larger splats get their support ellipse shrunk
# (power_cut scaled) so it still fits the binning rect.
MAX_SPLAT_RADIUS = 24.0


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians ready for compositing, all [N, ...].

    ``valid`` marks Gaussians that survived culling AND the caller's alive
    mask; invalid entries have radius 0 and depth +inf."""

    xy: torch.Tensor         # [N, 2] pixel-space means
    depth: torch.Tensor      # [N] camera-space z
    conic: torch.Tensor      # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor     # [N] screen radius in pixels
    color: torch.Tensor      # [N, 3] RGB (SH already evaluated)
    opacity: torch.Tensor    # [N] activated opacity
    valid: torch.Tensor      # [N] bool
    power_cut: torch.Tensor  # [N] support cutoff (<= 0)


def build_covariance(scales: torch.Tensor, quats: torch.Tensor,
                     scale_modifier: float = 1.0) -> torch.Tensor:
    """Packed 3D covariance [N, 6] = R S S^T R^T from activated scales and
    WXYZ quaternions."""
    r = quat_to_rotmat(quats)
    s2 = (scales * scale_modifier) ** 2
    return sym33_from_rs(r, s2)


def covariance_strip(cov_packed: torch.Tensor) -> torch.Tensor:
    """The identity: covariances already travel packed (xx, xy, xz, yy, yz,
    zz), the 3DGS PLY layout."""
    return cov_packed


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    world_view: torch.Tensor,
    full_proj: torch.Tensor,
    width: int,
    height: int,
    tanfovx: float,
    tanfovy: float,
    alive: torch.Tensor | None = None,
    max_radius: float | None = MAX_SPLAT_RADIUS,
) -> ProjectedGaussians:
    """Project 3D Gaussians into screen space (EWA).

    ``world_view`` / ``full_proj`` are the camera's ROW-VECTOR [4, 4]
    transforms; ``alive`` is an optional [N] bool capacity mask."""
    t_cam = affine4_shared(means3d, world_view)
    tz = t_cam[:, 2]

    p_hom = affine4_shared(means3d, full_proj)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    px = (p_hom[:, 0] * p_w + 1.0) * width * 0.5 - 0.5
    py = (p_hom[:, 1] * p_w + 1.0) * height * 0.5 - 0.5
    xy = torch.stack([px, py], dim=-1)

    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    txtz = torch.clamp(t_cam[:, 0] / tz_safe, -limx, limx)
    tytz = torch.clamp(t_cam[:, 1] / tz_safe, -limy, limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    # A = J @ W with W_colvec[i, j] = world_view[j, i] (row-vector storage)
    wv = world_view
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    a0 = (j00 * wv[0, 0] + j02 * wv[0, 2], j00 * wv[1, 0] + j02 * wv[1, 2],
          j00 * wv[2, 0] + j02 * wv[2, 2])
    a1 = (j11 * wv[0, 1] + j12 * wv[0, 2], j11 * wv[1, 1] + j12 * wv[1, 2],
          j11 * wv[2, 1] + j12 * wv[2, 2])
    c00, c01, c11 = sym33_quadform2((a0, a1), cov3d)

    c00 = c00 + 0.3
    c11 = c11 + 0.3

    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_raw = torch.ceil(3.0 * torch.sqrt(lambda1))
    if max_radius is None:
        # the published rule: the whole 3-sigma support, however large
        radius = radius_raw
        power_cut = torch.full_like(radius_raw, POWER_CUTOFF)
    else:
        radius = torch.clamp_max(radius_raw, max_radius)
        power_cut = POWER_CUTOFF * (radius / torch.clamp_min(radius_raw, 1.0)) ** 2

    valid = (tz > NEAR_CULL_Z) & (det > 0.0)
    on_screen = ((px + radius > 0.0) & (px - radius < width)
                 & (py + radius > 0.0) & (py - radius < height))
    valid = valid & on_screen
    if alive is not None:
        valid = valid & alive

    radius = torch.where(valid, radius, torch.zeros_like(radius))
    depth = torch.where(valid, tz, torch.full_like(tz, math.inf))

    return ProjectedGaussians(xy=xy, depth=depth, conic=conic, radius=radius,
                              color=colors, opacity=opacities, valid=valid,
                              power_cut=power_cut)
