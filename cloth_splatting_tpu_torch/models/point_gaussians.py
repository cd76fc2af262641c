"""Free-xyz point-cloud Gaussians (plain 3DGS fits); counterpart of
``cloth_splatting_tpu/models/point_gaussians.py``.

The reference's base ``GaussianModel`` trains positions directly; its legacy
COLMAP / D-NeRF loaders (``data/legacy.py``) feed it. The mesh-anchored
model of ``models/gaussians.py`` is the cloth flagship; this is its free-xyz
sibling, with the same capacity-padded density control (rank-matched clone
and split into free slots, an ``alive`` mask, no dynamic shapes).

Initialization as the reference's ``create_from_pcd``: SH DC from the
points' colours, log-scales ``log(sqrt(clamp(mean 3-NN squared distance,
1e-7)))``, identity quaternions, opacity logit of 0.1.

The projection is the published one: a splat's 3-sigma radius is not
capped (``project_gaussians(max_radius=None)``), where the cloth field caps
it at 24 px. ``fit_static_scene`` trains through ``train/points.py``: the
training rasterizer (K2/K3 on the card), uncapped and exact, with the
published schedule and density control (the functions below);
``fit_static_scene_capped`` is the JAX package's capped, dense-tier fit,
kept for the tests that hold the port to it. ``render_points`` serves
through the serving rasterizer
(``ops/rasterize/tiled_fwd.py``: exact binning of every (tile, Gaussian)
pair, any frame size, K1 on the card) when no leaf needs a gradient, and
through the dense tier (``ops/rasterize/tiled.py``), as the JAX package's
goes through its XLA tier, when one does. With CUDA tensors (and a camera
needing no gradient) the front end (SH, covariance, EWA) is one launch of
the hand-written kernel ``csrc/point_front.cu`` (``ops/point_front.py``'s
``project_points_fused``), which gives the PyTorch ops' bits, and, when a
leaf needs a gradient, its adjoint one launch of ``csrc/point_front_bwd.cu``
behind the same autograd function (``project_points_autograd``); on the
CPU the front end is those ops (``project_points_eager``), differentiated
by autograd.
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.gaussians import (
    _copy_rows,
    _rank_match_targets,
    round_capacity,
)
from cloth_splatting_tpu_torch.ops.image import inverse_sigmoid
from cloth_splatting_tpu_torch.ops.knn import mean_knn_sq_dist
from cloth_splatting_tpu_torch.ops.point_front import (
    project_points_autograd,
    project_points_fused,
)
from cloth_splatting_tpu_torch.ops.projection import (
    MAX_SPLAT_RADIUS,
    ProjectedGaussians,
    build_covariance,
    project_gaussians,
)
from cloth_splatting_tpu_torch.ops.quaternion import quat_to_rotmat
from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import rasterize_tiled_fwd
from cloth_splatting_tpu_torch.ops.sh import eval_sh, rgb_to_sh, sh_to_rgb
from cloth_splatting_tpu_torch.ops.smallmat import bmv3
from cloth_splatting_tpu_torch.utils.profiling import span


# Calls of ``project_points_view`` since the process started (or the caller
# last cleared it): "front_fused" ran the front-end kernel (and, with a
# gradient, its backward kernel), "front_eager" the PyTorch ops; and what
# ``train.points.PointTrainer.host_events`` did: "events" (calls that ran a
# host event), Gaussians "cloned", "split" (parents), "pruned", and
# "overflow" (selected, but no free slot).
COUNTS: collections.Counter = collections.Counter()


class PointGaussianParams(NamedTuple):
    """Trainable per-Gaussian parameters at capacity C (raw)."""

    xyz: torch.Tensor            # [C, 3] positions
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 3] log-scales
    rotation: torch.Tensor       # [C, 4] WXYZ quaternion
    opacity: torch.Tensor        # [C, 1] logit opacity


class PointGaussianState(NamedTuple):
    alive: torch.Tensor          # [C] bool
    max_radii2d: torch.Tensor    # [C]
    grad_accum: torch.Tensor     # [C]
    denom: torch.Tensor          # [C]


def get_scaling(params: PointGaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: PointGaussianParams) -> torch.Tensor:
    """[C, 1] activated opacity."""
    return torch.sigmoid(params.opacity)


def get_features(params: PointGaussianParams) -> torch.Tensor:
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def init_from_point_cloud(rng: np.random.Generator, points: np.ndarray,
                          colors: np.ndarray | None, sh_degree: int,
                          capacity: int | None = None,
                          device: str | torch.device = "cuda",
                          ) -> tuple[PointGaussianParams, PointGaussianState]:
    """The Gaussians of a point cloud [N, 3] with colours [N, 3] in [0, 1]
    (None: D-NeRF's random SH coefficients in [0, 1/255], drawn from
    ``rng`` as the JAX package draws them) at ``capacity`` (default: N
    rounded up); the kNN runs on ``device``."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    cap = capacity or round_capacity(n)
    k = (sh_degree + 1) ** 2

    if colors is None:
        # SH coefficients, not colours: rand/255 taken as RGB would start
        # near black (rgb_to_sh(0.002) = -1.77)
        colors = sh_to_rgb(rng.random((n, 3)).astype(np.float32) / 255.0)
    fdc = np.zeros((cap, 1, 3), np.float32)
    fdc[:n, 0] = rgb_to_sh(np.asarray(colors, np.float32))
    frest = np.zeros((cap, k - 1, 3), np.float32)

    dist2 = mean_knn_sq_dist(torch.from_numpy(points).to(dev)).cpu().numpy()
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = np.log(np.sqrt(np.clip(dist2, 1e-7, None)))[:, None]

    rots = np.zeros((cap, 4), np.float32)
    rots[:, 0] = 1.0
    opac = np.full((cap, 1), float(inverse_sigmoid(torch.tensor(0.1))), np.float32)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = points
    alive = np.zeros(cap, bool)
    alive[:n] = True

    def t(a):
        return torch.from_numpy(a).to(dev)

    params = PointGaussianParams(xyz=t(xyz), features_dc=t(fdc),
                                 features_rest=t(frest), scaling=t(scales),
                                 rotation=t(rots), opacity=t(opac))
    state = PointGaussianState(
        alive=t(alive), max_radii2d=torch.zeros(cap, device=dev),
        grad_accum=torch.zeros(cap, device=dev), denom=torch.zeros(cap, device=dev))
    return params, state


# ------------------------------------------------------------ density control


class PointDensifyResult(NamedTuple):
    params: PointGaussianParams
    state: PointGaussianState
    touched: torch.Tensor   # [C] bool: slots whose Adam moments must be zeroed
    overflow: torch.Tensor  # scalar int: selected Gaussians that found no slot


def densify_clone(params: PointGaussianParams, state: PointGaussianState,
                  grads: torch.Tensor, grad_threshold, percent_dense: float,
                  scene_extent) -> PointDensifyResult:
    """Clone small high-gradient Gaussians into free slots."""
    max_scale = get_scaling(params).amax(dim=1)
    sel = ((grads >= grad_threshold)
           & (max_scale <= percent_dense * scene_extent) & state.alive)
    free = ~state.alive
    src, active = _rank_match_targets(sel, free)
    new_state = state._replace(
        alive=state.alive | active,
        max_radii2d=torch.where(active, torch.zeros_like(state.max_radii2d),
                                state.max_radii2d))
    overflow = torch.clamp_min(sel.sum() - free.sum(), 0)
    return PointDensifyResult(_copy_rows(params, src, active), new_state, active,
                              overflow)


def densify_split(params: PointGaussianParams, state: PointGaussianState,
                  grads: torch.Tensor, grad_threshold, percent_dense: float,
                  scene_extent, eps: torch.Tensor) -> PointDensifyResult:
    """Split large high-gradient Gaussians into 2 jittered children: child
    xyz = parent + R (eps_i * scales), child scales = scales / 1.6; child 0
    takes the parent's slot, child 1 a free one. ``eps`` [2, C, 3] is the
    standard-normal jitter (the JAX package draws it from a key)."""
    n_split = 2
    scaling = get_scaling(params)
    sel = ((grads >= grad_threshold)
           & (scaling.amax(dim=1) > percent_dense * scene_extent) & state.alive)

    rots = quat_to_rotmat(params.rotation)
    child_xyz = torch.stack([params.xyz + bmv3(rots, eps[i] * scaling)
                             for i in range(n_split)])
    new_scaling = torch.log(scaling / (0.8 * n_split))

    mask3 = sel[:, None]
    p1 = params._replace(xyz=torch.where(mask3, child_xyz[0], params.xyz),
                         scaling=torch.where(mask3, new_scaling, params.scaling))
    free = ~state.alive
    src, active = _rank_match_targets(sel, free)
    p2 = _copy_rows(p1, src, active, {"xyz": child_xyz[1][src],
                                      "scaling": new_scaling[src]})
    new_state = state._replace(
        alive=state.alive | active,
        max_radii2d=torch.where(active | sel, torch.zeros_like(state.max_radii2d),
                                state.max_radii2d))
    overflow = torch.clamp_min(sel.sum() - free.sum(), 0)
    return PointDensifyResult(p2, new_state, active | sel, overflow)


def prune(params: PointGaussianParams, state: PointGaussianState, min_opacity,
          scene_extent, max_screen_size: float | None) -> PointGaussianState:
    """Kill low-opacity Gaussians and, with ``max_screen_size``, oversized
    ones (on screen or in the world)."""
    mask = get_opacity(params)[:, 0] < min_opacity
    if max_screen_size is not None:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = get_scaling(params).amax(dim=1) > 0.1 * scene_extent
        mask = mask | big_vs | big_ws
    return state._replace(alive=state.alive & ~mask)


def reset_opacity(params: PointGaussianParams) -> PointGaussianParams:
    """Clamp every opacity to <= 0.01."""
    return params._replace(opacity=inverse_sigmoid(
        torch.clamp_max(torch.sigmoid(params.opacity), 0.01)))


def add_densification_stats(state: PointGaussianState, xy_grad_norm: torch.Tensor,
                            radii: torch.Tensor,
                            visibility: torch.Tensor) -> PointGaussianState:
    zero = torch.zeros_like(xy_grad_norm)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visibility, xy_grad_norm, zero),
        denom=state.denom + visibility.to(state.denom.dtype),
        max_radii2d=torch.where(visibility, torch.maximum(state.max_radii2d, radii),
                                state.max_radii2d))


# ---------------------------------------------------------------- rendering


def serving(params: PointGaussianParams) -> bool:
    """True when no leaf of ``params`` needs a gradient: ``render_points``
    then serves through the serving rasterizer without autograd."""
    return not (torch.is_grad_enabled() and any(p.requires_grad for p in params))


def project_points_view(params: PointGaussianParams, state: PointGaussianState,
                        cam, width: int, height: int, tanfovx: float,
                        tanfovy: float, sh_degree: int,
                        max_radius: float | None = None) -> ProjectedGaussians:
    """The front half of ``render_points``: SH colours and the EWA
    projection of the free-xyz model from one camera (``CameraArrays``);
    ``max_radius`` None is the published rule, a splat's whole 3-sigma
    support. CUDA tensors whose camera needs no gradient take the kernels:
    the forward alone (``project_points_fused``) when no leaf needs a
    gradient (``serving``), else the forward and its backward kernel behind
    one autograd function (``project_points_autograd``); anything else
    takes the PyTorch ops (``project_points_eager``). ``COUNTS`` counts
    which ("front_fused", "front_eager")."""
    camera = (cam.world_view, cam.full_proj, cam.camera_center)
    fused = params.xyz.is_cuda and not any(t.requires_grad for t in camera)
    COUNTS["front_fused" if fused else "front_eager"] += 1
    with span("points.project_view"):
        if not fused:
            project = project_points_eager
        elif serving(params):
            project = project_points_fused
        else:
            project = project_points_autograd
        return project(params, state.alive, cam, width, height, tanfovx, tanfovy,
                       sh_degree, max_radius)


def project_points_eager(params: PointGaussianParams, alive: torch.Tensor, cam,
                         width: int, height: int, tanfovx: float, tanfovy: float,
                         sh_degree: int,
                         max_radius: float | None = None) -> ProjectedGaussians:
    """``project_points_view`` in PyTorch ops, on any device and
    differentiable: the forward kernel's plain version (autograd through it
    is the backward kernel's yardstick)."""
    dirs = params.xyz - cam.camera_center[None]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                                  1e-8)
    colors = torch.clamp_min(eval_sh(sh_degree, get_features(params), dirs) + 0.5,
                             0.0)
    cov = build_covariance(get_scaling(params), params.rotation)
    return project_gaussians(params.xyz, cov, colors, get_opacity(params)[:, 0],
                             cam.world_view, cam.full_proj, width, height,
                             tanfovx, tanfovy, alive=alive, max_radius=max_radius)


def render_points(params: PointGaussianParams, state: PointGaussianState, cam,
                  width: int, height: int, tanfovx: float, tanfovy: float,
                  bg_color: Sequence[float] | torch.Tensor, sh_degree: int,
                  k_cap: int = 256, k_chunk: int = 32,
                  max_radius: float | None = None):
    """Render the free-xyz model from one camera: (rgb [3, H, W], depth
    [1, H, W], radii [C]); splats uncapped unless ``max_radius`` is given.

    The front end is ``project_points_view``'s (the kernels on CUDA
    tensors). When no leaf of ``params`` needs a gradient (``serving``), the
    serving rasterizer (every (tile, Gaussian) pair binned, sorted by exact
    depth, composited by K1 on the card and by its plain walk on the CPU)
    without autograd; otherwise the dense tier (per-tile list capacity
    ``k_cap``, chunk ``k_chunk``), differentiable."""
    serve = serving(params)
    with span("points.render"), torch.no_grad() if serve else contextlib.nullcontext():
        proj = project_points_view(params, state, cam, width, height, tanfovx,
                                   tanfovy, sh_degree, max_radius)
        if serve:
            bg = tuple(float(c) for c in bg_color)
            rgb, depth, _, _ = rasterize_tiled_fwd(proj, width, height, bg,
                                                   pack_order="exact")
        else:
            rgb, depth, _, _ = rasterize_tiled(proj, width, height, bg_color,
                                               k_cap=k_cap, k_chunk=k_chunk)
    return rgb, depth, proj.radius


def fit_static_scene(cams, gts, point_cloud, width: int, height: int,
                     tanfovx: float, tanfovy: float,
                     sh_degree: int = 3, iterations: int = 300,
                     lr_xyz: float = 1.6e-4, lr_rest: float = 2.5e-3,
                     seed: int = 0, white_background: bool = False,
                     device: str | torch.device = "cuda"):
    """The published free-xyz 3DGS fit over parallel lists of
    ``CameraArrays`` and ground-truth images [3, H, W] in [0, 1] on
    ``device``, through ``train.points``: iterations 1 .. ``iterations``,
    each on a view drawn as ``train.py`` draws them (``ViewStack`` seeded
    ``seed``), the training rasterizer (exact binning, splats uncapped, any
    frame size), the published loss, schedule and density control
    (``PointOptimization`` with ``lr_xyz`` and ``lr_rest`` as the initial
    position and feature rates, the positions' scaled by the cameras'
    NeRF++ radius), at four times the point cloud's capacity for the
    density events' new Gaussians. Returns (params, state, the last
    iteration's loss)."""
    from cloth_splatting_tpu_torch.train import points as TP
    from cloth_splatting_tpu_torch.train.step import adam_init

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params, state = init_from_point_cloud(
        rng, point_cloud.points, point_cloud.colors, sh_degree,
        capacity=round_capacity(4 * point_cloud.points.shape[0]), device=dev)
    opt = TP.PointOptimization(position_lr_init=lr_xyz, position_lr_final=lr_xyz / 100.0,
                               feature_lr=lr_rest)
    bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)
    trainer = TP.PointTrainer(opt, width, height, tanfovx, tanfovy, bg, sh_degree,
                              TP.camera_extent(cams), white_background)
    losses = []
    st = TP.fit_points(trainer, TP.PointTrainState(params, state, adam_init(params)),
                       cams, gts, 1, iterations, TP.ViewStack(len(cams), seed), seed,
                       on_iteration=lambda it, loss: losses.append(loss))
    loss = float(losses[-1]) if losses else float("inf")
    return st.params, st.gstate, loss


def fit_static_scene_capped(cams, gts, point_cloud, width: int, height: int,
                            tanfovx: float, tanfovy: float,
                            sh_degree: int = 3, iterations: int = 300,
                            lr_xyz: float = 1.6e-4, lr_rest: float = 2.5e-3,
                            seed: int = 0, k_cap: int = 256,
                            white_background: bool = False,
                            device: str | torch.device = "cuda"):
    """The JAX package's ``fit_static_scene``, kept for the tests that hold
    the port to it: camera ``it % len(cams)`` at iteration ``it``, the L1 +
    0.2 D-SSIM loss, and Adam (eps 1e-15) with constant per-group learning
    rates; no density control. It renders through the dense tier, whose
    tiles hold ``k_cap`` instances, so splats keep the cloth field's 24 px
    cap. Returns (params, state, the last iteration's loss)."""
    from cloth_splatting_tpu_torch.train.losses import image_losses
    from cloth_splatting_tpu_torch.train.step import adam_init, adam_update

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params, state = init_from_point_cloud(rng, point_cloud.points,
                                          point_cloud.colors, sh_degree, device=dev)
    lrs = PointGaussianParams(xyz=lr_xyz, features_dc=lr_rest,
                              features_rest=lr_rest / 20, scaling=5e-3,
                              rotation=1e-3, opacity=0.05)
    opt = adam_init(params)
    bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)

    loss = torch.tensor(float("inf"))
    for it in range(iterations):
        i = it % len(cams)
        leaves = PointGaussianParams(*(p.detach().requires_grad_() for p in params))
        rgb, _, _ = render_points(leaves, state, cams[i], width, height, tanfovx,
                                  tanfovy, bg, sh_degree, k_cap=k_cap,
                                  max_radius=MAX_SPLAT_RADIUS)
        loss, _ = image_losses(rgb[None], gts[i][None], lambda_dssim=0.2)
        grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
        grads = PointGaussianParams(*(torch.zeros_like(p) if g is None else g
                                      for p, g in zip(leaves, grads)))
        with torch.no_grad():
            updates, opt = adam_update(grads, opt, 0.9, 0.999, 1e-15)
            params = PointGaussianParams(*(p - lr * u for p, u, lr in
                                           zip(params, updates, lrs)))
        loss = loss.detach()
    return params, state, float(loss)
