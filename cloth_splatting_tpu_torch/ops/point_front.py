"""The point front end as one kernel: SH colour, 3D covariance and EWA
projection of every free-xyz Gaussian from one camera, in one launch of the
hand-written ``csrc/point_front.cu``.

``project_points_fused`` reads the parameters of a
``models.point_gaussians.PointGaussianParams`` as stored (no cat, no basis
tensor) and gives the ``ProjectedGaussians`` of that module's
``project_points_eager`` (the PyTorch ops, its plain version) bit for bit.
It has no autograd and no CPU path: ``project_points_view`` chooses it for
CUDA tensors when no leaf needs a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians

if TYPE_CHECKING:
    from cloth_splatting_tpu_torch.models.point_gaussians import PointGaussianParams


def check_front_inputs(params: PointGaussianParams, alive: torch.Tensor,
                       world_view: torch.Tensor, full_proj: torch.Tensor,
                       camera_center: torch.Tensor, sh_degree: int) -> None:
    """Raises ValueError unless the front-end kernel takes these inputs:
    SH degree 0-4, float32 parameters of the shapes ``PointGaussianParams``
    states with at least the degree's coefficients, a bool ``alive`` [C],
    float32 camera matrices [4, 4] and centre [3], all contiguous and on one
    CUDA device."""
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {sh_degree}")
    c = params.xyz.shape[0]
    rest = (sh_degree + 1) ** 2 - 1
    tensors = {**params._asdict(), "alive": alive, "world_view": world_view,
               "full_proj": full_proj, "camera_center": camera_center}
    shapes = {"xyz": (c, 3), "features_dc": (c, 1, 3), "scaling": (c, 3),
              "rotation": (c, 4), "opacity": (c, 1), "alive": (c,),
              "world_view": (4, 4), "full_proj": (4, 4), "camera_center": (3,)}
    for name, t in tensors.items():
        dtype = torch.bool if name == "alive" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        shape = tuple(t.shape)
        if name == "features_rest":
            if len(shape) != 3 or shape[0] != c or shape[1] < rest or shape[2] != 3:
                raise ValueError(f"features_rest must be [{c}, >= {rest}, 3] at SH "
                                 f"degree {sh_degree}, got {list(shape)}")
        elif shape != shapes[name]:
            raise ValueError(f"{name} must be {list(shapes[name])}, got {list(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the front-end kernel takes tensors on one CUDA device, "
                         f"got {sorted(map(str, devices))}")


@functools.cache
def _launcher():
    fn = kernels.load("point_front").point_front_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 3 + [i32] + [ptr] * 7 + [ctypes.c_int64, i32, i32, i32]
                   + [f32] * 4 + [i32, f32] + [ptr] * 9)
    fn.restype = ctypes.c_int
    return fn


def project_points_fused(params: PointGaussianParams, alive: torch.Tensor, cam,
                         width: int, height: int, tanfovx: float, tanfovy: float,
                         sh_degree: int,
                         max_radius: float | None = None) -> ProjectedGaussians:
    """``project_points_eager``'s outputs from one launch of
    ``csrc/point_front.cu`` on the current stream; no autograd. The camera's
    tensors may have any layout (a transposed ``world_view`` is copied, 16
    floats); raises ValueError on other inputs it does not take
    (``check_front_inputs``), before any library is loaded, and RuntimeError
    if the launch fails. ``kernels.LAUNCHES["front"]`` counts the kernel's
    launches (none for zero Gaussians)."""
    camera = [t.contiguous() for t in (cam.world_view, cam.full_proj,
                                       cam.camera_center)]
    check_front_inputs(params, alive, *camera, sh_degree)
    dev = params.xyz.device
    c = params.xyz.shape[0]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = ProjectedGaussians(xy=empty(c, 2), depth=empty(c), conic=empty(c, 3),
                             radius=empty(c), color=empty(c, 3), opacity=empty(c),
                             valid=empty(c, dtype=torch.bool), power_cut=empty(c))
    # the PyTorch path's scalars: Python floats, rounded to float32 in the call
    focal_x, focal_y = width / (2.0 * tanfovx), height / (2.0 * tanfovy)
    args = [params.xyz, params.features_dc, params.features_rest,
            params.features_rest.shape[1] * 3, params.scaling, params.rotation,
            params.opacity, alive, *camera, c, sh_degree, width, height, focal_x,
            focal_y, 1.3 * tanfovx, 1.3 * tanfovy, int(max_radius is not None),
            0.0 if max_radius is None else float(max_radius), *out]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if c > 0:
        kernels.launch("front", _launcher(), dev, *args)
    return out
