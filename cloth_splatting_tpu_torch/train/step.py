"""The splat train step and the host-side density schedule; counterpart of
``cloth_splatting_tpu/train/step.py``.

One step renders the camera batch (one camera after another, each through
the differentiable backend ``tiled_train``: K2 forward, K3 backward; or,
with ``raster_backend="tiled"``, through the dense tier, whose per-tile
list capacity ``grow_k_cap`` raises), sums
the photometric loss and the regularizers, takes one backward pass to the
Gaussian parameters, the simulator's parameters and the screen-space
offsets, and then applies two Adams with per-group learning rates: the
Gaussians' (eps 1e-15; the position group follows the log-linear schedule)
and the simulator's (eps 1e-8; frozen in the static stage). The offsets'
gradient norms feed the density-control statistics.

``Trainer.step`` is ``forward`` -> ``backward`` -> ``update``; the three
are public so that a caller can time the stages. The step is functional:
it returns a new state and leaves the old one as it was.

``step_banked`` addresses (view x time) banks of cameras and uint8 images
that live on the device, so an iteration moves nothing from the host, and
threads a ``StepCarry`` of running statistics that the loop reads only at
its progress ticks. ``density_control`` runs densify (clone + split), prune
and the opacity reset on the reference's schedule, at fixed capacity;
``grow_capacity`` pads the state after a densify overflow, and
``cleanup_barycentric`` moves Gaussians whose barycentric coordinates went
negative to the neighbouring face (numpy, on the host, infrequent).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.models.deform import (
    init_embedding_simulator,
    init_residual_simulator,
    simulate_any,
    simulator_from_params,
    simulator_params,
    time_index,
)
from cloth_splatting_tpu_torch.ops.image import psnr
from cloth_splatting_tpu_torch.ops.knn import knn
from cloth_splatting_tpu_torch.render import (
    DENSE_BACKEND,
    TRAIN_BACKEND,
    CameraArrays,
    render,
)
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.losses import (
    KnnState,
    image_losses,
    knn_regularization,
    regularization,
)
from cloth_splatting_tpu_torch.train.schedules import expon_lr


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the step count and the two moments, each
    shaped like the parameters (``GaussianParams`` or a dict)."""

    count: torch.Tensor   # int32 scalar
    mu: Any
    nu: Any


def _leaves(tree) -> list[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _like(tree, leaves):
    return dict(zip(tree, leaves)) if isinstance(tree, dict) else type(tree)(*leaves)


def adam_init(params) -> AdamState:
    leaves = _leaves(params)
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=_like(params, [torch.zeros_like(p) for p in leaves]),
        nu=_like(params, [torch.zeros_like(p) for p in leaves]))


@torch.no_grad()
def adam_update(grads, state: AdamState, b1: float, b2: float, eps: float):
    """(updates, new state) of ``optax.scale_by_adam``: mu = (1-b1) g + b1 mu,
    nu = (1-b2) g^2 + b2 nu, updates = mu_hat / (sqrt(nu_hat) + eps) with
    the bias corrections of the incremented count; ``grads`` is shaped like
    the moments."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.full_like(c, b1) ** c
    bc2 = 1.0 - torch.full_like(c, b2) ** c
    mu = [(1 - b1) * g + b1 * m for g, m in zip(_leaves(grads), _leaves(state.mu))]
    nu = [(1 - b2) * (g * g) + b2 * v
          for g, v in zip(_leaves(grads), _leaves(state.nu))]
    updates = [(m / bc1) / (torch.sqrt(v / bc2) + eps) for m, v in zip(mu, nu)]
    return (_like(state.mu, updates),
            AdamState(count, _like(state.mu, mu), _like(state.nu, nu)))


class SplatTrainState(NamedTuple):
    params: G.GaussianParams
    gstate: G.GaussianState
    g_opt: AdamState                    # moments shaped like GaussianParams
    sim_params: dict[str, torch.Tensor]  # JAX field names (w_in, ... / embedding)
    sim_opt: AdamState                  # moments shaped like sim_params
    step: torch.Tensor                  # int32 scalar


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    psnr: torch.Tensor
    l1: torch.Tensor
    n_alive: torch.Tensor
    n_dropped: torch.Tensor


class StepCarry(NamedTuple):
    """Running statistics threaded through the banked step on the device, so
    the per-iteration smoothing costs no device-to-host fetch."""

    ema_loss: torch.Tensor    # per-iteration 0.4 / 0.6 exponential average
    ema_psnr: torch.Tensor
    drop_accum: torch.Tensor  # sum of n_dropped since the last fetch

    @staticmethod
    def zeros(device: str | torch.device = "cuda") -> "StepCarry":
        return StepCarry(torch.zeros((), device=device),
                         torch.zeros((), device=device),
                         torch.zeros((), dtype=torch.int32, device=device))


class Forward(NamedTuple):
    """What ``Trainer.forward`` hands to ``backward`` and ``update``: the
    loss with its graph, the leaves it was taken at, and the statistics."""

    loss: torch.Tensor
    params: G.GaussianParams                    # leaves
    sim: dict[str, torch.Tensor] | None         # leaves; None when static
    screen_offset: torch.Tensor                 # leaf [C, 2]
    psnr: torch.Tensor
    l1: torch.Tensor
    radii: torch.Tensor                         # [C] max over cameras
    visibility: torch.Tensor                    # [C] any over cameras
    n_dropped: torch.Tensor


class Trainer:
    """The train step of one scene. Tensors live on the mesh's device."""

    def __init__(self, cfg: Config, mesh: G.Mesh, mesh_predictions: torch.Tensor,
                 width: int, height: int, tanfovx: float, tanfovy: float,
                 spatial_lr_scale: float):
        self.cfg = cfg
        self.mesh = mesh
        self.mesh_predictions = mesh_predictions
        self.width, self.height = width, height
        self.tanfovx, self.tanfovy = tanfovx, tanfovy
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.device = mesh.pos.device
        self.bg = (1.0, 1.0, 1.0) if cfg.model.white_background else (0.0, 0.0, 0.0)
        # "tiled" trains through the dense tier. The JAX package's "auto"
        # means its Pallas tier off the CPU (the dense tier on it); the
        # port's counterpart of that Pallas tier is K2/K3, on the card and
        # (as their plain versions) on the CPU alike, so "auto" and "pallas"
        # both mean K2/K3 here on every device.
        backend = cfg.opt.raster_backend
        if backend == DENSE_BACKEND:
            self.backend = DENSE_BACKEND
        elif backend in ("auto", "pallas"):
            self.backend = TRAIN_BACKEND
        else:
            raise ValueError(f"unknown raster_backend {backend!r}")

    # ------------------------------------------------------------------ init

    def init_state(self, rng: np.random.Generator,
                   params: G.GaussianParams | None = None,
                   gstate: G.GaussianState | None = None,
                   sim_params: dict[str, torch.Tensor] | None = None
                   ) -> SplatTrainState:
        """Draws what is not given in the JAX package's order: Gaussians
        from the mesh, then the simulator."""
        if params is None or gstate is None:
            params, gstate = G.init_from_mesh(
                rng, self.mesh, self.cfg.model.sh_degree,
                self.cfg.opt.gaussian_init_factor, device=self.device)
        if sim_params is None:
            n_nodes = int(self.mesh.pos.shape[0])
            if self.cfg.model.simulator == "embedding":
                module = init_embedding_simulator(
                    rng, int(self.mesh_predictions.shape[0]), n_nodes,
                    device=self.device)
            else:
                module = init_residual_simulator(rng, n_nodes, device=self.device)
            sim_params = simulator_params(module)
        return SplatTrainState(
            params=params, gstate=gstate, g_opt=adam_init(params),
            sim_params=sim_params, sim_opt=adam_init(sim_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    # -------------------------------------------------------------------- lr

    def _tail_mult(self, step: torch.Tensor):
        """Cosine tail-decay multiplier over all parameter groups (1.0 = off)."""
        o = self.cfg.opt
        if o.lr_tail_start >= 1.0:
            return 1.0
        total = float(max(o.iterations, 1))
        t0 = o.lr_tail_start * total
        frac = torch.clamp((step.to(torch.float32) - t0) / max(total - t0, 1.0),
                           0.0, 1.0)
        return (o.lr_tail_floor + (1.0 - o.lr_tail_floor)
                * 0.5 * (1.0 + torch.cos(math.pi * frac)))

    def _lr_tree(self, step: torch.Tensor) -> G.GaussianParams:
        o = self.cfg.opt
        pos_lr = expon_lr(step, o.position_lr_init * self.spatial_lr_scale,
                          o.position_lr_final * self.spatial_lr_scale,
                          lr_delay_mult=o.position_lr_delay_mult,
                          max_steps=o.position_lr_max_steps)
        mult = self._tail_mult(step)
        return G.GaussianParams(
            face_bary=pos_lr * mult, face_offset=pos_lr * mult,
            features_dc=o.feature_lr * mult,
            features_rest=o.feature_lr / 20.0 * mult,
            opacity=o.opacity_lr * mult, scaling=o.scaling_lr * mult,
            rotation=o.rotation_lr * mult)

    # ------------------------------------------------------------------ step

    def forward(self, state: SplatTrainState, cams: CameraArrays,
                gt_images: torch.Tensor, masks: torch.Tensor | None,
                sh_degree: int, static: bool,
                knn_state: KnnState | None = None) -> Forward:
        """Render the camera batch (``cams`` fields stacked [B, ...]) and
        form the loss, with autograd recording."""
        o = self.cfg.opt
        cap = state.params.face_bary.shape[0]
        params = G.GaussianParams(*(p.detach().requires_grad_() for p in state.params))
        simulator, sim = None, None
        if not static:
            simulator = simulator_from_params(state.sim_params)
            sim = dict(simulator.named_parameters())
        screen_offset = torch.zeros((cap, 2), dtype=torch.float32,
                                    device=self.device, requires_grad=True)

        outs = []
        for b in range(cams.time.shape[0]):
            cam = CameraArrays(*(f[b] for f in cams))
            outs.append(render(
                cam, self.width, self.height, self.tanfovx, self.tanfovy,
                params, state.gstate, self.mesh, simulator,
                self.mesh_predictions, self.bg, sh_degree,
                screen_offset=screen_offset, render_static=static,
                k_cap=o.raster_k_cap, k_chunk=o.raster_k_chunk,
                backend=self.backend, pack_order=o.raster_pack_order,
                device=self.device))
        images = torch.stack([out.rgb for out in outs])              # [B, 3, H, W]
        loss, ldict = image_losses(images, gt_images, o.lambda_dssim, masks)
        vertices = torch.stack([out.vertices for out in outs])       # [B, V, 3]
        anchor_base = None
        if o.lambda_anchor > 0.0 and not static:
            n_times = self.mesh_predictions.shape[0]
            anchor_base = torch.stack([
                self.mesh_predictions.index_select(0, time_index(t, n_times))[0]
                for t in cams.time])
        loss = loss + regularization(
            vertices, self.mesh, o.lambda_deform_mag, o.lambda_rigid,
            o.lambda_momentum, static, lambda_anchor=o.lambda_anchor,
            anchor_base=anchor_base)
        if knn_state is not None and not static:
            loss = loss + knn_regularization(
                torch.stack([out.means3d for out in outs]),
                torch.stack([out.rotations for out in outs]), knn_state,
                o.lambda_isometric, o.lambda_spring, o.lambda_rigidity)
        with torch.no_grad():
            return Forward(
                loss=loss, params=params, sim=sim, screen_offset=screen_offset,
                psnr=psnr(images, gt_images).mean(), l1=ldict["l1"].detach(),
                radii=torch.stack([out.radii for out in outs]).amax(dim=0),
                visibility=torch.stack([out.visibility for out in outs]).any(dim=0),
                n_dropped=torch.stack([out.n_dropped for out in outs]).sum())

    @staticmethod
    def backward(fwd: Forward):
        """(Gaussian grads, simulator grads or None, screen-offset grad);
        leaves the loss does not reach get zeros."""
        leaves = list(fwd.params) + ([] if fwd.sim is None else list(fwd.sim.values()))
        leaves.append(fwd.screen_offset)
        grads = torch.autograd.grad(fwd.loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        n = len(fwd.params)
        g_grads = G.GaussianParams(*grads[:n])
        sim_grads = None if fwd.sim is None else dict(zip(fwd.sim, grads[n:-1]))
        return g_grads, sim_grads, grads[-1]

    @torch.no_grad()
    def update(self, state: SplatTrainState, fwd: Forward, grads
               ) -> tuple[SplatTrainState, StepMetrics]:
        """Density statistics, the Gaussian Adam and (unless static) the
        simulator Adam; returns the new state and the step's metrics."""
        g_grads, sim_grads, screen_grad = grads
        gstate = G.add_densification_stats(
            state.gstate, torch.linalg.norm(screen_grad, dim=-1), fwd.radii,
            fwd.visibility)

        g_updates, g_opt = adam_update(g_grads, state.g_opt, 0.9, 0.999, 1e-15)
        new_params = G.GaussianParams(*(
            p - lr * u for p, u, lr in zip(state.params, g_updates,
                                           self._lr_tree(state.step))))

        if sim_grads is None:
            new_sim, sim_opt = state.sim_params, state.sim_opt
        else:
            sim_updates, sim_opt = adam_update(
                {k: sim_grads[k] for k in state.sim_params}, state.sim_opt,
                0.9, 0.999, 1e-8)
            sim_lr = self.cfg.meshnet.lr_init * self._tail_mult(state.step)
            new_sim = {k: p - sim_lr * sim_updates[k]
                       for k, p in state.sim_params.items()}

        new_state = SplatTrainState(new_params, gstate, g_opt, new_sim, sim_opt,
                                    state.step + 1)
        metrics = StepMetrics(loss=fwd.loss.detach(), psnr=fwd.psnr, l1=fwd.l1,
                              n_alive=G.num_alive(gstate), n_dropped=fwd.n_dropped)
        return new_state, metrics

    def step(self, state: SplatTrainState, cams: CameraArrays,
             gt_images: torch.Tensor, masks: torch.Tensor | None,
             sh_degree: int, static: bool, knn_state: KnnState | None = None
             ) -> tuple[SplatTrainState, StepMetrics]:
        """One train step: ``forward`` -> ``backward`` -> ``update``."""
        fwd = self.forward(state, cams, gt_images, masks, sh_degree, static,
                           knn_state)
        return self.update(state, fwd, self.backward(fwd))

    def step_banked(self, state: SplatTrainState, cam_bank: CameraArrays,
                    gt_bank: torch.Tensor, mask_bank: torch.Tensor | None,
                    view_idx: int, time_ids, sh_degree: int, static: bool,
                    knn_state: KnnState | None = None,
                    carry: StepCarry | None = None):
        """A step on the cameras ``(view_idx, t)`` for t in ``time_ids`` of
        device banks: ``cam_bank`` fields [V, T, ...], ``gt_bank`` uint8
        [V, T, 3, H, W], ``mask_bank`` float [V, T, 1, H, W] or None. With
        ``carry`` also returns the updated carry."""
        t_ids = torch.as_tensor(time_ids, dtype=torch.int64, device=self.device)
        cams = CameraArrays(*(f[view_idx, t_ids] for f in cam_bank))
        gts = gt_bank[view_idx, t_ids].to(torch.float32) / 255.0
        masks = None if mask_bank is None else mask_bank[view_idx, t_ids]
        new_state, metrics = self.step(state, cams, gts, masks, sh_degree,
                                       static, knn_state)
        if carry is None:
            return new_state, metrics
        new_carry = StepCarry(
            ema_loss=0.4 * metrics.loss + 0.6 * carry.ema_loss,
            ema_psnr=0.4 * metrics.psnr + 0.6 * carry.ema_psnr,
            drop_accum=carry.drop_accum + metrics.n_dropped.to(torch.int32))
        return new_state, metrics, new_carry

    def grow_k_cap(self, factor: int = 2) -> int:
        """Multiply the dense tier's per-tile list capacity (the loop calls
        this under persistent overflow, as ``grow_capacity`` after a
        densify overflow); K2/K3 have no such cap. Returns the new cap."""
        o = self.cfg.opt
        o.raster_k_cap = int(o.raster_k_cap * factor)
        return o.raster_k_cap

    # ------------------------------------------------------------------- knn

    @torch.no_grad()
    def compute_knn_state(self, state: SplatTrainState) -> KnnState:
        """kNN neighbourhoods at the t=0 deformed state: distances d0 and
        weights exp(-lambda_w d0^2), valid between alive Gaussians."""
        o = self.cfg.opt
        verts0 = simulate_any(simulator_from_params(state.sim_params),
                              self.mesh_predictions,
                              torch.zeros((), device=self.device))
        means = G.gaussian_positions(state.params, state.gstate, self.mesh, verts0)
        alive = state.gstate.alive
        cap = means.shape[0]
        # park dead slots far away, each at its own spot, so they are never
        # neighbours of live Gaussians (nor of each other's queries)
        park = (~alive).to(torch.float32) * (
            1e6 + torch.arange(cap, dtype=torch.float32, device=self.device) * 1e3)
        pts = means.clone()
        pts[:, 0] += park
        d2, idx = knn(pts, k=o.k_nearest)
        finite = torch.isfinite(d2)
        d2 = torch.where(finite, d2, torch.zeros_like(d2))
        valid = alive[:, None] & alive[idx] & finite
        w = torch.where(valid, torch.exp(-o.lambda_w * d2), torch.zeros_like(d2))
        return KnnState(idx=idx, d0=torch.sqrt(d2), w=w, valid=valid)

    # ------------------------------------------------------- density control

    @torch.no_grad()
    def _densify(self, state: SplatTrainState, grad_threshold: float,
                 eps: torch.Tensor):
        """Clone, then split (``eps`` [2, C, 3]: the split's normal jitter);
        zero the touched slots' moments and reset the statistics. Returns
        (state, overflow)."""
        o = self.cfg.opt
        gs = state.gstate
        grads = gs.grad_accum / torch.clamp_min(gs.denom, 1e-12)
        grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
        res_c = G.densify_clone(state.params, gs, grads, grad_threshold,
                                o.percent_dense, self.spatial_lr_scale)
        res_s = G.densify_split(res_c.params, res_c.state, self.mesh, grads,
                                grad_threshold, o.percent_dense,
                                self.spatial_lr_scale, eps)
        cap = state.params.face_bary.shape[0]
        g_opt = G.zero_opt_rows(state.g_opt, res_c.touched | res_s.touched, cap)
        gstate = res_s.state._replace(
            grad_accum=torch.zeros_like(gs.grad_accum),
            denom=torch.zeros_like(gs.denom),
            max_radii2d=torch.zeros_like(gs.max_radii2d))
        return (state._replace(params=res_s.params, gstate=gstate, g_opt=g_opt),
                res_c.overflow + res_s.overflow)

    @torch.no_grad()
    def _prune(self, state: SplatTrainState, min_opacity: float,
               use_size_threshold: bool) -> SplatTrainState:
        return state._replace(gstate=G.prune(
            state.params, state.gstate, min_opacity, self.spatial_lr_scale,
            20.0 if use_size_threshold else None))

    @torch.no_grad()
    def _reset_opacity(self, state: SplatTrainState) -> SplatTrainState:
        """Clamp the opacities and clear the opacity leaf's moments."""
        params, _ = G.reset_opacity(state.params)
        g_opt = state.g_opt._replace(
            mu=state.g_opt.mu._replace(opacity=torch.zeros_like(params.opacity)),
            nu=state.g_opt.nu._replace(opacity=torch.zeros_like(params.opacity)))
        return state._replace(params=params, g_opt=g_opt)

    @staticmethod
    def density_control_due(cfg: Config, iteration: int) -> bool:
        """True iff ``density_control`` would act at this iteration."""
        o = cfg.opt
        if iteration >= o.densify_until_iter:
            return False
        return (
            (iteration > o.densify_from_iter
             and iteration % o.densification_interval == 0)
            or (iteration > o.pruning_from_iter
                and iteration % o.pruning_interval == 0)
            or iteration % o.opacity_reset_interval == 0
            or (cfg.model.white_background
                and iteration == o.densify_from_iter))

    def density_thresholds(self, iteration: int) -> tuple[float, float]:
        """(opacity, densify-gradient) thresholds at ``iteration``: linear
        from the ``_init`` value to the ``_after`` value at
        ``densify_until_iter``."""
        o = self.cfg.opt
        opacity = o.opacity_threshold_fine_init - iteration * (
            o.opacity_threshold_fine_init - o.opacity_threshold_fine_after
        ) / o.densify_until_iter
        densify = o.densify_grad_threshold_fine_init - iteration * (
            o.densify_grad_threshold_fine_init - o.densify_grad_threshold_after
        ) / o.densify_until_iter
        return opacity, densify

    def density_control(self, state: SplatTrainState, iteration: int,
                        generator: torch.Generator | None = None,
                        eps: torch.Tensor | None = None
                        ) -> tuple[SplatTrainState, int]:
        """The host-side schedule of one iteration: densify (growing the
        capacity after an overflow), prune, opacity reset. The split's
        standard-normal jitter is ``eps`` [2, C, 3] when given, else drawn
        from ``generator`` (on the trainer's device). Returns (state,
        overflow count)."""
        o = self.cfg.opt
        overflow = 0
        if iteration >= o.densify_until_iter:
            return state, overflow
        opacity_threshold, densify_threshold = self.density_thresholds(iteration)

        if iteration > o.densify_from_iter and iteration % o.densification_interval == 0:
            if eps is None:
                eps = torch.randn((2,) + tuple(state.params.scaling.shape),
                                  generator=generator, device=self.device)
            state, ovf = self._densify(state, densify_threshold, eps)
            overflow = int(ovf)
            if overflow > 0:
                state = self.grow_capacity(state)
        if iteration > o.pruning_from_iter and iteration % o.pruning_interval == 0:
            state = self._prune(state, opacity_threshold,
                                iteration > o.opacity_reset_interval)
        if iteration % o.opacity_reset_interval == 0 or (
                self.cfg.model.white_background
                and iteration == o.densify_from_iter):
            state = self._reset_opacity(state)
        return state, overflow

    def grow_capacity(self, state: SplatTrainState,
                      factor: float = 2.0) -> SplatTrainState:
        """Pad every capacity-leading tensor (parameters, bookkeeping, Adam
        moments) with dead slots after a densify overflow."""
        old_cap = state.params.face_bary.shape[0]
        new_cap = G.round_capacity(int(old_cap * factor))
        if new_cap <= old_cap:
            return state
        print(f"[density] growing gaussian capacity {old_cap} -> {new_cap}")
        params, gstate, g_opt = G.grow_state_arrays(
            state.params, state.gstate, state.g_opt, new_cap)
        return state._replace(params=params, gstate=gstate, g_opt=g_opt)

    # --------------------------------------------------- barycentric cleanup

    def cleanup_barycentric(self, state: SplatTrainState) -> SplatTrainState:
        """Reassign Gaussians with a negative barycentric coordinate to the
        adjacent face (on the host, infrequent)."""
        params, gstate = cleanup_barycentric_host(state.params, state.gstate,
                                                  self.mesh)
        return state._replace(params=params, gstate=gstate)


def cleanup_barycentric_host(params: G.GaussianParams, gstate: G.GaussianState,
                             mesh: G.Mesh
                             ) -> tuple[G.GaussianParams, G.GaussianState]:
    """Numpy implementation of the barycentric cleanup.

    Each alive Gaussian with a negative barycentric coordinate moves to the
    neighbouring face that shares the edge opposite the offending vertex; at
    the mesh boundary, where there is none, the coordinate is nudged back
    inside."""
    dev = params.face_bary.device
    bary = params.face_bary.cpu().numpy().copy()
    face_ids = gstate.face_ids.cpu().numpy().copy()
    alive = gstate.alive.cpu().numpy()
    faces = mesh.faces.cpu().numpy()
    pos = mesh.pos.cpu().numpy()

    affected = np.argwhere((bary < 0) & alive[:, None])
    if affected.size == 0:
        return params, gstate

    # edge (min(v1, v2), max(v1, v2)) -> faces containing it
    edge2faces = defaultdict(list)
    for f_idx, f in enumerate(faces):
        for k in range(3):
            e = (min(f[k], f[(k + 1) % 3]), max(f[k], f[(k + 1) % 3]))
            edge2faces[e].append(f_idx)

    xyz = np.einsum("cb,cbx->cx",
                    bary / np.maximum(bary.sum(1, keepdims=True), 1e-8),
                    pos[faces[face_ids]])
    for gi, bi in affected:
        f = faces[face_ids[gi]]
        others = np.delete(f, bi)
        e = (min(others[0], others[1]), max(others[0], others[1]))
        candidates = [c for c in edge2faces[e] if c != face_ids[gi]]
        if not candidates:
            bary[gi, bi] = 0.005
            bary[gi] = bary[gi] / bary[gi].sum()
        else:
            new_face = candidates[0]
            face_ids[gi] = new_face
            tri = pos[faces[new_face]]
            d = np.linalg.norm(xyz[gi][None] - tri, axis=1)
            bary[gi] = d / d.sum()

    return (params._replace(face_bary=torch.from_numpy(bary).to(dev)),
            gstate._replace(face_ids=torch.from_numpy(face_ids).to(dev)))
