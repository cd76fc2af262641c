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

The front end after the simulator (means, face rotations, SH, EWA) is one
launch of the hand-written kernel ``csrc/point_front.cu`` (its cloth pass,
``ops/cloth_front.py``) whenever the tensors are on the card and no leaf
needs a gradient, whatever the backend; every other call runs the PyTorch
ops (``project_view_eager``), which the kernel answers bit for bit.
"""

from __future__ import annotations

import collections
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
from cloth_splatting_tpu_torch.ops.cloth_front import project_cloth_fused
from cloth_splatting_tpu_torch.ops.projection import (
    build_covariance,
    project_gaussians,
)
from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import rasterize_tiled_fwd
from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import rasterize_tiled_train
from cloth_splatting_tpu_torch.ops.sh import eval_sh
from cloth_splatting_tpu_torch.utils.profiling import span

SERVING_BACKEND = "tiled_fwd"
TRAIN_BACKEND = "tiled_train"
DENSE_BACKEND = "tiled"

# Calls of ``project_view`` since the process started (or the caller last
# cleared it): "front_fused" ran the cloth front-end kernel after the
# simulator, "front_eager" the PyTorch ops.
COUNTS: collections.Counter = collections.Counter()


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


def serving(params: GaussianParams, simulator: torch.nn.Module | None,
            *tensors: torch.Tensor | None) -> bool:
    """True when no leaf needs a gradient: autograd is off, or none of
    ``params``, the simulator's parameters and ``tensors`` (the other
    inputs of a view; None where absent) requires one."""
    if not torch.is_grad_enabled():
        return True
    leaves = [*params, *(simulator.parameters() if simulator is not None else ()),
              *tensors]
    return not any(t is not None and t.requires_grad for t in leaves)


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
    rotations) for one camera. CUDA tensors with no leaf needing a gradient
    (``serving``) take the simulator in PyTorch and then the kernel
    (``project_view_fused``), anything else the PyTorch ops
    (``project_view_eager``); ``COUNTS`` counts which."""
    fused = params.face_bary.is_cuda and serving(
        params, simulator, mesh_predictions, screen_offset, override_color,
        override_vertices, mesh.pos, *cam)
    COUNTS["front_fused" if fused else "front_eager"] += 1
    with span("render.project_view"):
        project = project_view_fused if fused else project_view_eager
        return project(cam, width, height, tanfovx, tanfovy, params, state, mesh,
                       simulator, mesh_predictions, sh_degree, screen_offset,
                       render_static, scaling_modifier, override_color,
                       override_vertices)


def view_vertices(cam: CameraArrays, mesh: Mesh, simulator: torch.nn.Module | None,
                  mesh_predictions: torch.Tensor | None, render_static: bool,
                  override_vertices: torch.Tensor | None):
    """(the vertices [V, 3] a view's means sit on, whether its faces rotate
    with them): the given vertices, else the rest mesh when static or
    without a simulator (no face rotation), else the simulator's."""
    if override_vertices is not None:
        return override_vertices, True
    if render_static or simulator is None:
        return mesh.pos, False
    return simulate_any(simulator, mesh_predictions, cam.time), True


def project_view_fused(cam, width, height, tanfovx, tanfovy, params, state, mesh,
                       simulator, mesh_predictions, sh_degree, screen_offset=None,
                       render_static=False, scaling_modifier=1.0,
                       override_color=None, override_vertices=None):
    """``project_view`` on the card without autograd: the simulator in
    PyTorch, then one launch of the cloth front-end kernel
    (``ops.cloth_front.project_cloth_fused``), which gives
    ``project_view_eager``'s bits."""
    vertices, rotate = view_vertices(cam, mesh, simulator, mesh_predictions,
                                     render_static, override_vertices)
    proj, means3d, rotations = project_cloth_fused(
        params, state, mesh, vertices, cam, width, height, tanfovx, tanfovy,
        sh_degree, rotate, scaling_modifier, override_color, screen_offset)
    return proj, vertices, means3d, rotations


def project_view_eager(cam, width, height, tanfovx, tanfovy, params, state, mesh,
                       simulator, mesh_predictions, sh_degree, screen_offset=None,
                       render_static=False, scaling_modifier=1.0,
                       override_color=None, override_vertices=None):
    """``project_view`` in PyTorch ops, on any device and differentiable:
    the kernel's plain version."""
    vertices, rotate = view_vertices(cam, mesh, simulator, mesh_predictions,
                                     render_static, override_vertices)
    means3d = gaussian_positions(params, state, mesh, vertices)
    rotations = gaussian_rotations(params, state, mesh, vertices if rotate else None)

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
    gather_group=None,
) -> RenderOutput:
    """Render one camera; ``sh_degree`` is the active SH degree.

    ``gather_group`` (a ``parallel.mesh.Axis``, the JAX package's
    ``gather_axis``) renders with the Gaussian capacity split over that
    axis of a device mesh: the front end runs on this rank's rows, the
    projected bundle is gathered over the axis (``gather_bundle``; its
    backward reduce-scatters the gradients back to their rows) and the
    compositor sees every Gaussian. The per-Gaussian outputs (radii,
    visibility, means3d, rotations, projections) stay this rank's rows.

    ``backend`` is ``"tiled_fwd"`` (serving, no autograd),
    ``"tiled_train"`` (differentiable) or ``"tiled"`` (the dense tier,
    differentiable; ``k_cap`` and ``k_chunk`` are its per-tile list
    capacity and compositing chunk, as in the JAX package). ``override_vertices`` renders at explicitly given deformed vertices
    (bypassing the simulator). ``bg_color`` is a static RGB triple (it is
    part of the compositor's epilogue). ``screen_offset`` [C, 2] shifts the
    projected means by ``offset * (W/2, H/2)`` pixels. All tensors must lie
    on ``device``."""
    with span("render"):
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
            full = proj
            if gather_group is not None:
                from cloth_splatting_tpu_torch.parallel.mesh import gather_bundle

                full = gather_bundle(proj, gather_group)
            if serving:
                rgb, depth, alpha, aux = rasterize_tiled_fwd(
                    full, width, height, bg, pack_order=pack_order)
                n_dropped = aux.n_dropped
            elif backend == DENSE_BACKEND:
                rgb, depth, alpha, aux = rasterize_tiled(
                    full, width, height, bg, k_cap=k_cap, k_chunk=min(k_chunk, k_cap))
                n_dropped = aux.n_dropped
            else:
                rgb, depth, alpha = rasterize_tiled_train(
                    full, width, height, bg, pack_order=pack_order)
                n_dropped = torch.zeros((), dtype=torch.int32, device=dev)

        return RenderOutput(rgb=rgb, depth=depth, alpha=alpha, radii=proj.radius,
                            visibility=proj.radius > 0, means3d=means3d,
                            vertices=vertices, rotations=rotations,
                            projections=proj.xy, n_dropped=n_dropped)
