"""Top-level render function; counterpart of ``cloth_splatting_tpu/render.py``.

Pipeline per camera: residual simulator -> deformed vertices -> barycentric
Gaussian means + face rotations -> SH colours -> EWA projection -> sort
binning -> tile compositor. Three backends:

- ``"tiled_fwd"`` (serving, the JAX package's ``"pallas_fwd"``): K1, run
  under ``torch.no_grad``;
- ``"tiled_train"`` (training, the JAX package's ``"pallas"``): K2 with K3
  as its backward; autograd flows through the whole front end (simulator,
  barycentric positions, face rotations, SH, EWA) and to ``screen_offset``,
  whose gradient is the density-control statistic;
- ``"tiled"`` (the JAX package's default, its dense XLA tier): the plain
  PyTorch dense tier of ``ops/rasterize/tiled.py``, differentiable, with a
  per-tile list capacity ``k_cap`` whose overflow it reports in
  ``n_dropped``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from cloth_splatting_tpu_torch.device import check_on, resolve_device
from cloth_splatting_tpu_torch.models.deform import simulate_any
from cloth_splatting_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianState,
    Mesh,
    gaussian_positions,
    gaussian_rotations,
    get_features,
    get_opacity,
    get_scaling,
)
from cloth_splatting_tpu_torch.ops.projection import (
    build_covariance,
    project_gaussians,
)
from cloth_splatting_tpu_torch.ops.quaternion import quat_normalize
from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import rasterize_tiled_fwd
from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import rasterize_tiled_train
from cloth_splatting_tpu_torch.ops.sh import eval_sh

SERVING_BACKEND = "tiled_fwd"
TRAIN_BACKEND = "tiled_train"
DENSE_BACKEND = "tiled"


class CameraArrays(NamedTuple):
    """Device-side camera tensors."""

    world_view: torch.Tensor     # [4, 4] row-vector W2C
    full_proj: torch.Tensor      # [4, 4]
    camera_center: torch.Tensor  # [3]
    time: torch.Tensor           # scalar


class RenderOutput(NamedTuple):
    rgb: torch.Tensor          # [3, H, W]
    depth: torch.Tensor        # [1, H, W]
    alpha: torch.Tensor        # [1, H, W]
    radii: torch.Tensor        # [C]
    visibility: torch.Tensor   # [C] bool (radius > 0)
    means3d: torch.Tensor      # [C, 3] deformed Gaussian centres
    vertices: torch.Tensor     # [V, 3] deformed mesh vertices
    rotations: torch.Tensor    # [C, 4]
    projections: torch.Tensor  # [C, 2] pixel-space projections
    n_dropped: torch.Tensor    # binning overflow (0 but on the dense tier)


def camera_arrays(cam, device: str | torch.device = "cuda") -> CameraArrays:
    """A ``ops.camera.Camera`` as tensors on ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    return CameraArrays(world_view=t(cam.world_view), full_proj=t(cam.full_proj),
                        camera_center=t(cam.camera_center), time=t(cam.time))


def project_view(
    cam: CameraArrays,
    width: int,
    height: int,
    tanfovx: float,
    tanfovy: float,
    params: GaussianParams,
    state: GaussianState,
    mesh: Mesh,
    simulator: torch.nn.Module | None,
    mesh_predictions: torch.Tensor | None,
    sh_degree: int,
    screen_offset: torch.Tensor | None = None,
    render_static: bool = False,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    override_vertices: torch.Tensor | None = None,
):
    """The front half of ``render``: (ProjectedGaussians, vertices, means3d,
    rotations) for one camera."""
    if override_vertices is not None:
        vertices = override_vertices
        means3d = gaussian_positions(params, state, mesh, vertices)
        rotations = gaussian_rotations(params, state, mesh, vertices)
    elif render_static or simulator is None:
        vertices = mesh.pos
        means3d = gaussian_positions(params, state, mesh)
        rotations = quat_normalize(params.rotation)
    else:
        vertices = simulate_any(simulator, mesh_predictions, cam.time)
        means3d = gaussian_positions(params, state, mesh, vertices)
        rotations = gaussian_rotations(params, state, mesh, vertices)

    cov3d = build_covariance(get_scaling(params), rotations, scaling_modifier)

    if override_color is None:
        dirs = means3d - cam.camera_center[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
        colors = torch.clamp_min(
            eval_sh(sh_degree, get_features(params), dirs) + 0.5, 0.0)
    else:
        colors = override_color

    proj = project_gaussians(means3d, cov3d, colors, get_opacity(params),
                             cam.world_view, cam.full_proj, width, height,
                             tanfovx, tanfovy, alive=state.alive)
    if screen_offset is not None:
        scale = torch.tensor([width / 2.0, height / 2.0], dtype=proj.xy.dtype,
                             device=proj.xy.device)
        proj = proj._replace(xy=proj.xy + screen_offset * scale)
    return proj, vertices, means3d, rotations


def render(
    cam: CameraArrays,
    width: int,
    height: int,
    tanfovx: float,
    tanfovy: float,
    params: GaussianParams,
    state: GaussianState,
    mesh: Mesh,
    simulator: torch.nn.Module | None,
    mesh_predictions: torch.Tensor | None,
    bg_color: tuple[float, float, float],
    sh_degree: int,
    screen_offset: torch.Tensor | None = None,
    render_static: bool = False,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    override_vertices: torch.Tensor | None = None,
    k_cap: int = 512,
    k_chunk: int = 32,
    backend: str = SERVING_BACKEND,
    pack_order: str = "fused",
    device: str | torch.device = "cuda",
) -> RenderOutput:
    """Render one camera; ``sh_degree`` is the active SH degree.

    ``backend`` is ``"tiled_fwd"`` (serving, no autograd),
    ``"tiled_train"`` (differentiable) or ``"tiled"`` (the dense tier,
    differentiable; ``k_cap`` and ``k_chunk`` are its per-tile list
    capacity and compositing chunk, as in the JAX package). ``override_vertices`` renders at explicitly given deformed vertices
    (bypassing the simulator). ``bg_color`` is a static RGB triple (it is
    part of the compositor's epilogue). ``screen_offset`` [C, 2] shifts the
    projected means by ``offset * (W/2, H/2)`` pixels. All tensors must lie
    on ``device``."""
    dev = resolve_device(device)
    if backend not in (SERVING_BACKEND, TRAIN_BACKEND, DENSE_BACKEND):
        raise ValueError(f"unknown backend {backend!r}")
    check_on(dev, face_bary=params.face_bary, alive=state.alive, mesh_pos=mesh.pos,
             world_view=cam.world_view)
    bg = tuple(float(c) for c in bg_color)
    serving = backend == SERVING_BACKEND

    with torch.no_grad() if serving else contextlib.nullcontext():
        proj, vertices, means3d, rotations = project_view(
            cam, width, height, tanfovx, tanfovy, params, state, mesh, simulator,
            mesh_predictions, sh_degree, screen_offset=screen_offset,
            render_static=render_static, scaling_modifier=scaling_modifier,
            override_color=override_color, override_vertices=override_vertices)
        if serving:
            rgb, depth, alpha, aux = rasterize_tiled_fwd(
                proj, width, height, bg, pack_order=pack_order)
            n_dropped = aux.n_dropped
        elif backend == DENSE_BACKEND:
            rgb, depth, alpha, aux = rasterize_tiled(
                proj, width, height, bg, k_cap=k_cap, k_chunk=min(k_chunk, k_cap))
            n_dropped = aux.n_dropped
        else:
            rgb, depth, alpha = rasterize_tiled_train(
                proj, width, height, bg, pack_order=pack_order)
            n_dropped = torch.zeros((), dtype=torch.int32, device=dev)

    return RenderOutput(rgb=rgb, depth=depth, alpha=alpha, radii=proj.radius,
                        visibility=proj.radius > 0, means3d=means3d,
                        vertices=vertices, rotations=rotations,
                        projections=proj.xy, n_dropped=n_dropped)
