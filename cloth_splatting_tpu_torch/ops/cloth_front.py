"""The cloth field's front end as one kernel: mesh anchoring, face
rotations, SH colour, 3D covariance and EWA projection of every
mesh-anchored Gaussian from one camera, in one launch of the hand-written
``csrc/point_front.cu`` (its ``MeshAnchored`` pass, ``cloth_front_launch``).

``project_cloth_fused`` takes the deformed vertices (the simulator's, or
given) and gives ``render.project_view_eager``'s four results after the
simulator bit for bit: the ``ProjectedGaussians``, the vertices, the means
[C, 3] and the rotations [C, 4]. It has no autograd and no CPU path:
``render.project_view`` chooses it for CUDA tensors when no leaf needs a
gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS, ProjectedGaussians

if TYPE_CHECKING:
    from cloth_splatting_tpu_torch.models.gaussians import (
        GaussianParams,
        GaussianState,
        Mesh,
    )


def check_cloth_inputs(tensors: dict, sh_degree: int) -> None:
    """Raises ValueError unless the cloth front-end kernel takes ``tensors``
    (name -> tensor, as ``project_cloth_fused`` gathers them; None where an
    optional input is absent): SH degree 0-4; float32 parameters of the
    shapes ``GaussianParams`` states, with at least the degree's
    coefficients; int64 ``face_ids`` [C] and ``faces`` [F, 3]; bool
    ``alive`` [C]; float32 vertices and rest vertices [V, 3], camera
    matrices [4, 4] and centre [3], ``override_color`` [C, 3] and
    ``screen_offset`` [C, 2]; all on one CUDA device."""
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {sh_degree}")
    c = tensors["face_bary"].shape[0]
    v = tensors["rest"].shape[0]
    rest = (sh_degree + 1) ** 2 - 1
    shapes = {"face_bary": (c, 3), "features_dc": (c, 1, 3), "scaling": (c, 3),
              "rotation": (c, 4), "opacity": (c, 1), "face_ids": (c,),
              "alive": (c,), "vertices": (v, 3), "rest": (v, 3),
              "world_view": (4, 4), "full_proj": (4, 4), "camera_center": (3,),
              "override_color": (c, 3), "screen_offset": (c, 2)}
    dtypes = {"face_ids": torch.int64, "faces": torch.int64, "alive": torch.bool}
    present = {name: t for name, t in tensors.items() if t is not None}
    for name, t in present.items():
        dtype = dtypes.get(name, torch.float32)
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        shape = tuple(t.shape)
        if name == "features_rest":
            if len(shape) != 3 or shape[0] != c or shape[1] < rest or shape[2] != 3:
                raise ValueError(f"features_rest must be [{c}, >= {rest}, 3] at SH "
                                 f"degree {sh_degree}, got {list(shape)}")
        elif name == "faces":
            if len(shape) != 2 or shape[1] != 3:
                raise ValueError(f"faces must be [F, 3], got {list(shape)}")
        elif shape != shapes[name]:
            raise ValueError(f"{name} must be {list(shapes[name])}, got {list(shape)}")
    devices = {t.device for t in present.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the cloth front-end kernel takes tensors on one CUDA "
                         f"device, got {sorted(map(str, devices))}")


@functools.cache
def _launcher():
    fn = kernels.load("point_front").cloth_front_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 5 + [i32] + [ptr] * 2 + [i32, ptr, f32] + [ptr] * 7
                   + [ctypes.c_int64, i32, i32, i32] + [f32] * 5 + [ptr] * 11)
    fn.restype = ctypes.c_int
    return fn


def project_cloth_fused(params: GaussianParams, state: GaussianState, mesh: Mesh,
                        vertices: torch.Tensor, cam, width: int, height: int,
                        tanfovx: float, tanfovy: float, sh_degree: int,
                        rotate: bool, scaling_modifier: float = 1.0,
                        override_color: torch.Tensor | None = None,
                        screen_offset: torch.Tensor | None = None):
    """(ProjectedGaussians, means3d [C, 3], rotations [C, 4]) of the
    mesh-anchored Gaussians on ``vertices`` [V, 3] (their means; with
    ``rotate``, each face's rotation from ``mesh.pos`` to ``vertices`` is
    composed with the static quaternion, else the static one stands alone),
    as ``render.project_view_eager`` gives them, from one launch of
    ``csrc/point_front.cu``'s cloth pass on the current stream; no
    autograd. Inputs of another layout are copied contiguous first; raises
    ValueError on inputs it does not take (``check_cloth_inputs``), before
    any library is loaded, and RuntimeError if the launch fails.
    ``kernels.LAUNCHES["cloth_front"]`` counts the kernel's launches (none
    for zero Gaussians). With ``override_color`` the colours are that
    tensor, and the kernel computes none."""
    t = {**params._asdict(), "face_ids": state.face_ids, "alive": state.alive,
         "faces": mesh.faces, "vertices": vertices, "rest": mesh.pos,
         "world_view": cam.world_view, "full_proj": cam.full_proj,
         "camera_center": cam.camera_center, "override_color": override_color,
         "screen_offset": screen_offset}
    del t["face_offset"]
    t = {name: None if x is None else x.contiguous() for name, x in t.items()}
    check_cloth_inputs(t, sh_degree)
    dev = t["face_bary"].device
    c = t["face_bary"].shape[0]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    proj = ProjectedGaussians(
        xy=empty(c, 2), depth=empty(c), conic=empty(c, 3), radius=empty(c),
        color=empty(c, 3) if override_color is None else override_color,
        opacity=empty(c), valid=empty(c, dtype=torch.bool), power_cut=empty(c))
    means3d, rotations = empty(c, 3), empty(c, 4)
    # the PyTorch path's scalars: Python floats, rounded to float32 in the call
    focal_x, focal_y = width / (2.0 * tanfovx), height / (2.0 * tanfovy)
    args = [t["face_bary"], t["face_ids"], t["faces"], t["vertices"], t["rest"],
            int(rotate), t["features_dc"], t["features_rest"],
            t["features_rest"].shape[1] * 3, t["scaling"], float(scaling_modifier),
            t["rotation"], t["opacity"], t["alive"], t["world_view"], t["full_proj"],
            t["camera_center"], t["screen_offset"], c, sh_degree, width, height,
            focal_x, focal_y, 1.3 * tanfovx, 1.3 * tanfovy, MAX_SPLAT_RADIUS,
            proj.xy, proj.depth, proj.conic, proj.radius,
            None if override_color is not None else proj.color, proj.opacity,
            proj.valid, proj.power_cut, means3d, rotations]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if c > 0:
        kernels.launch("cloth_front", _launcher(), dev, *args)
    return proj, means3d, rotations
