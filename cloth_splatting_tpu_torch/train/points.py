"""Training of the free-xyz point model (plain 3D Gaussian Splatting,
``models/point_gaussians.py``) with the published schedule of
``graphdeco-inria/gaussian-splatting`` (its ``OptimizationParams`` and
``train.py``).

``PointTrainer`` holds the two calls of an iteration:

- ``step``: the forward (the front end, ``project_points_view``: on the
  card the hand-written forward kernel and its backward kernel behind one
  autograd function, on the CPU the PyTorch ops, ``project_points_eager``;
  and the training rasterizer, ``rasterize_tiled_train``: exact binning of
  every (tile, Gaussian) pair, splats uncapped, any frame size, K2/K3 on
  the card), the published loss (1 - ``lambda_dssim``) L1 +
  ``lambda_dssim`` D-SSIM (``train.py``'s weighting; the cloth fit's
  ``image_losses`` weighs L1 by 1), autograd, the densification statistics
  and Adam (eps 1e-15) with the published groups: positions at a learning
  rate decaying log-linearly from
  ``position_lr_init`` to ``position_lr_final`` x ``spatial_lr_scale``,
  DC features at ``feature_lr``, the higher SH at a twentieth of it,
  opacity, scaling and rotation at their own;
- ``host_events``: the density event of every ``densification_interval``-th
  iteration in (``densify_from_iter``, ``densify_until_iter``) (clone,
  split, prune, in that order, with Adam's moments zeroed on the slots they
  fill or split and the statistics restarted) and the opacity reset of
  every ``opacity_reset_interval``-th (opacities to at most 0.01, their
  moments zeroed).

The statistic is the published one: the norm of the loss's gradient with
respect to each Gaussian's screen mean on the NDC scale (the pixel
gradient times W/2, H/2), summed over the iterations that see the
Gaussian, over their count. The SH degree rises by one every
``sh_increase_interval`` iterations. As the published code orders it, the
densification restarts ``max_radii2d`` before the prune reads it, so the
screen-size rule (``max_screen_size`` after the first opacity reset)
selects nothing at a density event; the world-size rule (a scale above a
tenth of the extent) does. A run resumes at any iteration: the schedule is
a function of the iteration alone.

Counters (``point_gaussians.COUNTS``): "events" (host events that ran),
"cloned", "split" (parents), "pruned" and "overflow" (Gaussians that found
no free slot).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.models import point_gaussians as PG
from cloth_splatting_tpu_torch.models.gaussians import zero_opt_rows
from cloth_splatting_tpu_torch.ops.image import l1_loss
from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import rasterize_tiled_train
from cloth_splatting_tpu_torch.ops.ssim import ssim
from cloth_splatting_tpu_torch.train.step import AdamState, adam_update
from cloth_splatting_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class PointOptimization:
    """The published ``OptimizationParams`` and the prune rules of
    ``train.py``."""

    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    max_screen_size: float = 20.0
    sh_increase_interval: int = 1000


def position_lr(iteration: int, opt: PointOptimization, scale: float) -> float:
    """The published ``get_expon_lr_func`` (no delay) at ``iteration``."""
    t = min(max(iteration / opt.position_lr_max_steps, 0.0), 1.0)
    a, b = opt.position_lr_init * scale, opt.position_lr_final * scale
    return math.exp(math.log(a) * (1.0 - t) + math.log(b) * t)


def sh_degree_at(iteration: int, opt: PointOptimization, max_degree: int) -> int:
    """The active SH degree: 0 at first, one more every
    ``sh_increase_interval`` iterations."""
    return min(max_degree, iteration // opt.sh_increase_interval)


def events_due(iteration: int, opt: PointOptimization,
               white_background: bool = False) -> dict:
    """What ``train.py`` does after ``iteration``'s backward: "stats" (the
    densification statistics), "densify" (clone, split and prune) and
    "reset" (the opacity reset)."""
    live = iteration < opt.densify_until_iter
    return {
        "stats": live,
        "densify": live and iteration > opt.densify_from_iter
        and iteration % opt.densification_interval == 0,
        "reset": live and (iteration % opt.opacity_reset_interval == 0
                           or (white_background and iteration == opt.densify_from_iter)),
    }


def camera_extent(cams) -> float:
    """The published ``getNerfppNorm`` radius of ``CameraArrays``: 1.1 x the
    largest distance of a camera centre from their mean."""
    c = torch.stack([cam.camera_center for cam in cams]).double()
    return float(torch.linalg.norm(c - c.mean(0), dim=1).max()) * 1.1


class PointTrainState(NamedTuple):
    params: PG.PointGaussianParams
    gstate: PG.PointGaussianState
    opt: AdamState                      # moments shaped like PointGaussianParams


class ViewStack:
    """``train.py``'s draw of one training view an iteration: pop a uniformly
    random entry off a stack that is refilled with every view when empty,
    from ``np.random.default_rng(seed)``."""

    def __init__(self, n_views: int, seed: int):
        self.n_views = n_views
        self.rng = np.random.default_rng(seed)
        self.stack: list = []

    def next(self) -> int:
        if not self.stack:
            self.stack = list(range(self.n_views))
        return self.stack.pop(int(self.rng.integers(len(self.stack))))


class PointTrainer:
    """One iteration of the point model's training on one camera: ``step``
    and ``host_events`` (module docstring)."""

    def __init__(self, opt: PointOptimization, width: int, height: int,
                 tanfovx: float, tanfovy: float, bg: tuple[float, float, float],
                 sh_degree: int, spatial_lr_scale: float,
                 white_background: bool = False):
        self.opt = opt
        self.width, self.height = width, height
        self.tanfovx, self.tanfovy = tanfovx, tanfovy
        self.bg = tuple(float(c) for c in bg)
        self.sh_degree = sh_degree
        self.spatial_lr_scale = spatial_lr_scale
        self.white_background = white_background

    def lrs(self, iteration: int) -> PG.PointGaussianParams:
        o = self.opt
        return PG.PointGaussianParams(
            xyz=position_lr(iteration, o, self.spatial_lr_scale),
            features_dc=o.feature_lr, features_rest=o.feature_lr / 20.0,
            scaling=o.scaling_lr, rotation=o.rotation_lr, opacity=o.opacity_lr)

    def render(self, params: PG.PointGaussianParams, gstate: PG.PointGaussianState,
               cam, iteration: int, screen_offset: torch.Tensor):
        """(rgb [3, H, W], projected Gaussians) of one camera with autograd
        recording; ``screen_offset`` [C, 2] moves the screen means on the
        NDC scale (its gradient is the statistic)."""
        w, h = self.width, self.height
        proj = PG.project_points_view(params, gstate, cam, w, h, self.tanfovx,
                                      self.tanfovy, sh_degree_at(iteration, self.opt,
                                                                 self.sh_degree))
        scale = torch.tensor([w / 2.0, h / 2.0], device=proj.xy.device)
        proj = proj._replace(xy=proj.xy + screen_offset * scale)
        rgb = rasterize_tiled_train(proj, w, h, self.bg, pack_order="exact")[0]
        return rgb, proj

    def step(self, state: PointTrainState, cam, gt: torch.Tensor, iteration: int
             ) -> tuple[PointTrainState, torch.Tensor]:
        """One iteration's step on camera ``cam`` (``CameraArrays``) against
        ``gt`` [3, H, W] in [0, 1]: (new state, the loss, a device scalar)."""
        with span("forward"):
            leaves = PG.PointGaussianParams(*(p.detach().requires_grad_()
                                              for p in state.params))
            offset = torch.zeros((leaves.xyz.shape[0], 2), device=leaves.xyz.device,
                                 requires_grad=True)
            rgb, proj = self.render(leaves, state.gstate, cam, iteration, offset)
            lam = self.opt.lambda_dssim
            loss = (1.0 - lam) * l1_loss(rgb[None], gt[None]) \
                + lam * (1.0 - ssim(rgb[None], gt[None]))
        with span("backward"):
            grads = torch.autograd.grad(loss, list(leaves) + [offset],
                                        allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(list(leaves) + [offset], grads)]
        with span("update"), torch.no_grad():
            gstate = state.gstate
            if events_due(iteration, self.opt, self.white_background)["stats"]:
                gstate = PG.add_densification_stats(
                    gstate, torch.linalg.norm(grads[-1], dim=-1), proj.radius.detach(),
                    proj.radius.detach() > 0)
            updates, opt = adam_update(PG.PointGaussianParams(*grads[:-1]), state.opt,
                                       0.9, 0.999, 1e-15)
            params = PG.PointGaussianParams(*(p - lr * u for p, u, lr in zip(
                state.params, updates, self.lrs(iteration))))
        return PointTrainState(params, gstate, opt), loss.detach()

    @torch.no_grad()
    def host_events(self, state: PointTrainState, iteration: int,
                    gen: torch.Generator | None = None) -> PointTrainState:
        """The host events due after ``iteration``'s step (``events_due``); a
        split's jitter is ``torch.randn((2, C, 3), generator=gen)``, drawn
        only at a density event."""
        o = self.opt
        due = events_due(iteration, o, self.white_background)
        if not (due["densify"] or due["reset"]):
            return state
        with span("points.host_events"):
            params, gstate, opt = state
            extent = self.spatial_lr_scale
            if due["densify"]:
                grads = torch.nan_to_num(gstate.grad_accum / gstate.denom, nan=0.0)
                clone = PG.densify_clone(params, gstate, grads, o.densify_grad_threshold,
                                         o.percent_dense, extent)
                cap = params.xyz.shape[0]
                eps = torch.randn((2, cap, 3), generator=gen, device=params.xyz.device)
                split = PG.densify_split(clone.params, clone.state, grads,
                                         o.densify_grad_threshold, o.percent_dense,
                                         extent, eps)
                opt = zero_opt_rows(opt, clone.touched | split.touched, cap)
                params = split.params
                zero = torch.zeros_like(gstate.grad_accum)
                gstate = split.state._replace(grad_accum=zero, denom=zero.clone(),
                                              max_radii2d=zero.clone())
                alive = gstate.alive
                gstate = PG.prune(params, gstate, o.min_opacity, extent,
                                  o.max_screen_size
                                  if iteration > o.opacity_reset_interval else None)
                counts = torch.stack([clone.touched.sum(),
                                      (split.touched & clone.state.alive).sum(),
                                      (alive & ~gstate.alive).sum(),
                                      clone.overflow + split.overflow]).tolist()
                for name, n in zip(("cloned", "split", "pruned", "overflow"), counts):
                    PG.COUNTS[name] += n
            if due["reset"]:
                params = PG.reset_opacity(params)
                opt = AdamState(opt.count,
                                opt.mu._replace(opacity=torch.zeros_like(opt.mu.opacity)),
                                opt.nu._replace(opacity=torch.zeros_like(opt.nu.opacity)))
            PG.COUNTS["events"] += 1
            return PointTrainState(params, gstate, opt)


def fit_points(trainer: PointTrainer, state: PointTrainState, cams, gts,
               first: int, last: int, views: ViewStack, seed: int,
               on_iteration=None) -> PointTrainState:
    """Iterations ``first`` .. ``last`` (inclusive): each draws its view from
    ``views``, runs ``trainer.step`` on ``cams[v]`` against ``gts[v]`` ([3, H,
    W] floats, or uint8 scaled by 1/255) and then ``trainer.host_events``,
    the splits' jitter from a generator on the state's device seeded with
    ``seed``; ``on_iteration(it, loss)`` after each."""
    gen = torch.Generator(device=state.params.xyz.device)
    gen.manual_seed(int(seed))
    for it in range(first, last + 1):
        v = views.next()
        gt = gts[v]
        if gt.dtype == torch.uint8:
            gt = gt.float() / 255.0
        state, loss = trainer.step(state, cams[v], gt, it)
        state = trainer.host_events(state, it, gen)
        if on_iteration is not None:
            on_iteration(it, loss)
    return state
