"""Camera math; counterpart of ``cloth_splatting_tpu/ops/camera.py``.

Host-side numpy, as in the JAX package: ``world_to_view`` stores R
transposed, ``projection_matrix`` maps z into [0, zfar/(zfar-znear)], and a
``Camera`` keeps ROW-VECTOR transforms (``p_hom = [x, y, z, 1] @ full_proj``).
``render.camera_arrays`` moves a camera onto the device; ``project_points``
projects world points through one on the device."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from cloth_splatting_tpu_torch.ops.smallmat import affine4_shared


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: Optional[np.ndarray] = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix. R is the camera rotation as stored by the
    loaders (already transposed); t is the W2C translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """Perspective matrix (z_sign=+1 variant of the 3DGS rasterizer)."""
    tan_y = math.tan(fovy * 0.5)
    tan_x = math.tan(fovx * 0.5)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera with ROW-VECTOR (transposed) transforms."""

    width: int
    height: int
    fovx: float
    fovy: float
    world_view: np.ndarray     # [4, 4] transposed W2C
    full_proj: np.ndarray      # [4, 4] transposed W2C @ P
    camera_center: np.ndarray  # [3]
    time: float = 0.0
    znear: float = 0.01
    zfar: float = 100.0
    view_id: int = -1
    time_id: int = -1

    @staticmethod
    def create(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
               width: int, height: int, time: float = 0.0,
               znear: float = 0.01, zfar: float = 100.0,
               view_id: int = -1, time_id: int = -1,
               trans: Optional[np.ndarray] = None,
               scale: float = 1.0) -> "Camera":
        w2v = world_to_view(R, t, trans, scale).T  # row-vector layout
        proj = projection_matrix(znear, zfar, fovx, fovy).T
        full = (w2v @ proj).astype(np.float32)
        cam_center = np.linalg.inv(w2v)[3, :3].astype(np.float32)
        return Camera(width=width, height=height, fovx=float(fovx),
                      fovy=float(fovy), world_view=w2v.astype(np.float32),
                      full_proj=full, camera_center=cam_center,
                      time=float(time), znear=znear, zfar=zfar,
                      view_id=view_id, time_id=time_id)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)


def project_points(points: torch.Tensor, full_proj: torch.Tensor, width: int,
                   height: int, eps: float = 1e-7) -> torch.Tensor:
    """Pixel coordinates [N, 2] (x, y) of world points [N, 3] through a
    camera's row-vector ``full_proj`` [4, 4]: ``px = ((ndc + 1) W - 1) / 2``,
    the tracking projections' pixel convention."""
    hom = affine4_shared(points, full_proj)
    ndc = hom[..., :2] / (hom[..., 3:4] + eps)
    px = (ndc[..., 0] + 1.0) * width * 0.5 - 0.5
    py = (ndc[..., 1] + 1.0) * height * 0.5 - 0.5
    return torch.stack([px, py], dim=-1)
