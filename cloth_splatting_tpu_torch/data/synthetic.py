"""Synthetic serving scene; counterpart of the scene builders in
``cloth_splatting_tpu/data/synthetic.py`` that the serving benchmark uses
(``orbit_camera``, ``target_gaussians``)."""

from __future__ import annotations

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.ops.camera import Camera
from cloth_splatting_tpu_torch.ops.image import inverse_sigmoid
from cloth_splatting_tpu_torch.ops.sh import rgb_to_sh


def orbit_camera(view: int, n_views: int, fov: float, width: int, height: int,
                 time: float, radius: float = 3.0, elevation: float = 0.6
                 ) -> Camera:
    """Camera ``view`` of ``n_views`` on an orbit around the origin."""
    ang = 2.0 * np.pi * view / n_views
    cam_pos = np.asarray([
        radius * np.cos(elevation) * np.sin(ang),
        radius * np.sin(elevation),
        -radius * np.cos(elevation) * np.cos(ang),
    ])
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    r_w2c = np.stack([right, up2, fwd], axis=0)
    t = -r_w2c @ cam_pos
    return Camera.create(R=r_w2c.T, t=t, fovx=fov, fovy=fov, width=width,
                         height=height, time=time)


def target_gaussians(mesh: G.Mesh, sh_degree: int, seed: int = 0,
                     device: str | torch.device = "cuda"):
    """A textured 'ground truth' Gaussian field anchored on the mesh."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params, state = G.init_from_mesh(
        rng, mesh, sh_degree, 2,
        capacity=G.round_capacity(2 * int(mesh.faces.shape[0])), device=dev)
    xyz = G.gaussian_positions(params, state, mesh)
    colors = torch.stack([
        0.55 + 0.4 * torch.sin(6.0 * xyz[:, 0]) * torch.cos(4.0 * xyz[:, 1]),
        0.5 + 0.35 * torch.cos(8.0 * xyz[:, 0]),
        0.45 + 0.3 * torch.sin(5.0 * xyz[:, 1]),
    ], dim=1)
    params = params._replace(
        features_dc=rgb_to_sh(torch.clamp(colors, 0.05, 0.95))[:, None, :],
        opacity=torch.full_like(params.opacity,
                                float(inverse_sigmoid(torch.tensor(0.95)))),
        scaling=params.scaling + 0.2,
    )
    return params, state
