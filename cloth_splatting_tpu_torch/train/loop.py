"""The full scene-optimization loop; counterpart of
``cloth_splatting_tpu/train/loop.py``: static stage, then dynamic stage with
3-step camera batches, density control and barycentric cleanup on schedule,
SH-degree annealing, running averages for progress, held-out evaluation and
PLY / simulator / train-state checkpoints.

All camera matrices and uint8 images are uploaded ONCE into (view x time)
banks on the device; an iteration addresses them by (view_idx, time_ids)
and moves nothing from the host. ``train_scene`` builds the banks from a
scene on disk and hands them to ``fit_banks``, the loop itself, which a
caller with banks made in memory can call directly (it needs neither
``h5py`` nor an image library unless it is asked to save or evaluate).

The dense tier truncates each tile's list at ``raster_k_cap``: the loop
reads the dropped count at its progress ticks and doubles the cap after two
overflowing ticks in a row, up to ``K_CAP_MAX``; a held-out evaluation
through that tier doubles it until the split drops nothing. The loop also
polls the live viewer (``utils/viewer.py``) and logs to a ``wandb``
adapter when given one. Not ported yet: the multi-device mesh (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import os
import time as time_mod
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.scene import (
    CameraGrid,
    ClothScene,
    decode_image,
    decode_mask,
)
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.models.deform import simulator_from_params
from cloth_splatting_tpu_torch.ops.image import psnr as psnr_fn
from cloth_splatting_tpu_torch.render import (
    DENSE_BACKEND,
    SERVING_BACKEND,
    CameraArrays,
    camera_arrays,
    render,
)
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.step import SplatTrainState, StepCarry, Trainer
from cloth_splatting_tpu_torch.utils import checkpoints
from cloth_splatting_tpu_torch.utils.logging import MetricsLogger

# the dense tier's k_cap grows no further (the JAX package's limit)
K_CAP_MAX = 8192


def build_banks(grid: CameraGrid, white_background: bool,
                device: str | torch.device = "cuda"):
    """Decode every frame once into device banks: (cam_bank with fields
    [V, T, ...], gt_bank uint8 [V, T, 3, H, W], mask_bank float
    [V, T, 1, H, W] or None)."""
    dev = resolve_device(device)
    v, t = grid.n_views, grid.n_times
    cam0 = grid.get(0, 0).camera
    h, w = cam0.height, cam0.width
    cams = []
    gts = np.zeros((v, t, 3, h, w), dtype=np.uint8)
    any_mask = any(r.mask_path for r in grid.records)
    masks = np.ones((v, t, 1, h, w), dtype=np.float32) if any_mask else None
    for vi in range(v):
        row = []
        for ti in range(t):
            rec = grid.get(vi, ti)
            row.append(camera_arrays(rec.camera, dev))
            if rec.image_path:
                gts[vi, ti] = decode_image(rec.image_path, white_background)
            if any_mask and rec.mask_path and os.path.exists(rec.mask_path):
                masks[vi, ti] = decode_mask(rec.mask_path)
        cams.append(row)
    cam_bank = CameraArrays(*(
        torch.stack([torch.stack([getattr(c, f) for c in row]) for row in cams])
        for f in CameraArrays._fields))
    return (cam_bank, torch.from_numpy(gts).to(dev),
            torch.from_numpy(masks).to(dev) if masks is not None else None)


class EvalFrame(NamedTuple):
    """One held-out frame: a camera and its ground truth, an image path to
    decode or a uint8 [3, H, W] tensor."""

    camera: CameraArrays
    image: str | torch.Tensor
    name: str


def eval_frames(grid: CameraGrid, device: torch.device,
                max_cameras: int = 20) -> list[EvalFrame]:
    return [EvalFrame(camera_arrays(r.camera, device), r.image_path,
                      r.image_name or str(i))
            for i, r in enumerate(grid.records[:max_cameras])]


@torch.no_grad()
def evaluate_split(trainer: Trainer, state: SplatTrainState,
                   frames: Sequence[EvalFrame] | CameraGrid,
                   white_background: bool, sh_degree: int,
                   max_cameras: int = 20,
                   save_dir: str | None = None) -> dict:
    """Held-out L1 and PSNR over (a subset of) a camera grid or a list of
    ``EvalFrame``s; ``save_dir`` dumps the first four renders as PNG.

    A trainer on K2/K3 is evaluated by the serving backend (K1), which has
    no list capacity and drops nothing. A trainer on the dense tier is
    evaluated through that tier, from its ``raster_k_cap`` doubled until no
    frame of the split drops an instance (up to ``K_CAP_MAX``), as the JAX
    package does. Returns {"psnr", "l1", "k_cap" (None on K1), "n_dropped"
    (the most any frame dropped at that cap)}."""
    if isinstance(frames, CameraGrid):
        frames = eval_frames(frames, trainer.device, max_cameras)
    frames = list(frames)[:max_cameras]
    simulator = simulator_from_params(state.sim_params)
    dense = trainer.backend == DENSE_BACKEND
    k_cap = trainer.cfg.opt.raster_k_cap if dense else None
    gts = []
    for fr in frames:
        gt = fr.image
        if isinstance(gt, str):
            gt = torch.from_numpy(decode_image(gt, white_background))
        gts.append(gt.to(trainer.device).to(torch.float32) / 255.0)
    while True:
        tier = (dict(backend=DENSE_BACKEND, k_cap=k_cap,
                     k_chunk=min(trainer.cfg.opt.raster_k_chunk, k_cap))
                if dense else dict(backend=SERVING_BACKEND))
        psnrs, l1s, images, dropped = [], [], [], 0
        for fr, gt in zip(frames, gts):
            out = render(fr.camera, trainer.width, trainer.height, trainer.tanfovx,
                         trainer.tanfovy, state.params, state.gstate, trainer.mesh,
                         simulator, trainer.mesh_predictions, trainer.bg, sh_degree,
                         device=trainer.device, **tier)
            if dense:
                dropped = max(dropped, int(out.n_dropped))
            img = torch.clamp(out.rgb, 0.0, 1.0)
            psnrs.append(psnr_fn(img, gt))
            l1s.append((img - gt).abs().mean())
            if save_dir and len(images) < 4:
                images.append((fr.name, img))
        if not dense or dropped == 0 or k_cap >= K_CAP_MAX:
            break
        k_cap *= 2
    if save_dir:
        import imageio.v2 as imageio

        os.makedirs(save_dir, exist_ok=True)
        for name, img in images:
            imageio.imwrite(os.path.join(save_dir, f"{name}_render.png"),
                            (img.permute(1, 2, 0) * 255).to(torch.uint8).cpu().numpy())
    values = torch.stack([torch.stack(psnrs).mean(), torch.stack(l1s).mean()]).cpu()
    return {"psnr": float(values[0]), "l1": float(values[1]), "k_cap": k_cap,
            "n_dropped": dropped}


def save_scene_checkpoint(out_dir: str, iteration: int, trainer: Trainer,
                          state: SplatTrainState) -> None:
    """PLY (+ mesh.hdf5) and simulator weights, in the reference's directory
    layout. Needs ``h5py``."""
    from cloth_splatting_tpu_torch.data.mesh_io import save_mesh_h5
    from cloth_splatting_tpu_torch.data.ply_io import gaussian_ply_columns, write_ply

    pc_dir = os.path.join(out_dir, "point_cloud", f"iteration_{iteration}")
    os.makedirs(pc_dir, exist_ok=True)
    alive = state.gstate.alive.cpu().numpy()
    p = state.params
    xyz = G.gaussian_positions(p, state.gstate, trainer.mesh).cpu().numpy()

    def rows(x):
        return x.detach().cpu().numpy()[alive]

    cols = gaussian_ply_columns(
        xyz[alive], rows(p.features_dc), rows(p.features_rest), rows(p.opacity),
        rows(p.scaling), rows(p.rotation), face_bary=rows(p.face_bary),
        face_offset=rows(p.face_offset), face_ids=rows(state.gstate.face_ids))
    write_ply(os.path.join(pc_dir, "point_cloud.ply"), cols)
    save_mesh_h5(os.path.join(pc_dir, "mesh.hdf5"), trainer.mesh)
    checkpoints.save_pytree(
        os.path.join(out_dir, "meshnet", f"model-{iteration}.npz"),
        state.sim_params)


def save_train_checkpoint(out_dir: str, iteration: int,
                          state: SplatTrainState) -> str:
    """The whole train state as one npz tree (``chkpnt<iteration>.npz``)."""
    path = os.path.join(out_dir, f"chkpnt{iteration}.npz")
    checkpoints.save_pytree(path, state._asdict())
    return path


def load_train_checkpoint(path: str, template: SplatTrainState) -> SplatTrainState:
    return checkpoints.restore_like(template, checkpoints.load_flat(path))


@torch.no_grad()
def _poll_viewer(trainer: Trainer, state: SplatTrainState, sh_degree: int) -> None:
    """The viewer's poll of one iteration: accept a waiting client, answer
    one render request if a camera arrived, and drop the connection on any
    error while answering (nothing renders in its place). The request
    renders through the dense tier at the trainer's ``k_cap``, with the
    request's ``scaling_modifier``, as the JAX package's poll does."""
    from cloth_splatting_tpu_torch.utils import viewer

    if viewer.conn is None:
        viewer.try_connect()
    if viewer.conn is None:
        return
    try:
        cam, _do_training, keep_alive, scaling = viewer.receive()
        if cam is not None:
            wv = np.asarray(cam["world_view"], np.float32)
            fp = np.asarray(cam["full_proj"], np.float32)
            center = np.linalg.inv(wv.T)[:3, 3]

            def t(x):
                return torch.as_tensor(np.asarray(x, np.float32), device=trainer.device)

            arr = CameraArrays(world_view=t(wv), full_proj=t(fp),
                               camera_center=t(center), time=t(cam["time"]))
            o = trainer.cfg.opt
            out = render(arr, cam["width"], cam["height"], trainer.tanfovx,
                         trainer.tanfovy, state.params, state.gstate, trainer.mesh,
                         simulator_from_params(state.sim_params),
                         trainer.mesh_predictions, trainer.bg, sh_degree,
                         scaling_modifier=scaling, k_cap=o.raster_k_cap,
                         k_chunk=o.raster_k_chunk, backend=DENSE_BACKEND,
                         device=trainer.device)
            img = torch.clamp(out.rgb, 0.0, 1.0).cpu().numpy()
            viewer.send((img.transpose(1, 2, 0) * 255).astype(np.uint8).tobytes())
        if not keep_alive:
            viewer.disconnect()
    except Exception as exc:     # a bad request must not stop the fit
        print(f"viewer: dropped the connection ({exc!r})")
        viewer.disconnect()


def sample_time_ids(rng: np.random.Generator, n_times: int,
                    three_steps_batch: bool,
                    time_sample: str = "interior") -> list[int]:
    """This iteration's timestep batch. 'interior' draws the mid time
    uniformly over [1, T-2], so the endpoint times appear in one window
    each; 'balanced' draws it over the full range and clamps the window,
    doubling the endpoints' exposure."""
    if not three_steps_batch:
        return [int(rng.integers(n_times))]
    if n_times < 3:
        return list(range(n_times))
    if time_sample == "balanced":
        mid = int(rng.integers(0, n_times))
        mid = min(max(mid, 1), n_times - 2)
    else:
        mid = int(rng.integers(1, n_times - 1))
    return [mid - 1, mid, mid + 1]


def _ema_repair(avg_g: G.GaussianParams, old_g: G.GaussianParams,
                new_g: G.GaussianParams) -> G.GaussianParams:
    """Row-wise repair of the parameter average after a host event: rows
    whose parameters the event rewrote are reloaded (a stale average would
    blend different Gaussians), untouched rows keep their average."""
    changed = None
    for old, new in zip(old_g, new_g):
        row = (old != new).reshape(old.shape[0], -1).any(dim=1)
        changed = row if changed is None else (changed | row)
    return G.GaussianParams(*(
        torch.where(changed.reshape((-1,) + (1,) * (n.dim() - 1)), n, a)
        for a, n in zip(avg_g, new_g)))


def fit_banks(
    trainer: Trainer,
    state: SplatTrainState,
    cam_bank: CameraArrays,
    gt_bank: torch.Tensor,
    mask_bank: torch.Tensor | None,
    out_dir: str | None = None,
    test_frames: Sequence[EvalFrame] | CameraGrid | None = None,
    test_iterations: Sequence[int] = (),
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    first_iter: int = 1,
    seed: int = 6666,
    progress_every: int = 50,
    on_iteration: Optional[Callable[[int, dict], None]] = None,
    three_steps_batch: bool = True,
    save_test_images: bool = False,
    wandb=None,
    viewer_enabled: bool = False,
    on_save: Optional[Callable[[int, SplatTrainState], None]] = None,
) -> SplatTrainState:
    """The optimization loop from the banks on: iterations ``first_iter`` ..
    ``cfg.opt.iterations`` on ``cam_bank`` / ``gt_bank`` / ``mask_bank``
    ([V, T, ...], on the trainer's device). One iteration, in order: the
    viewer's poll (``viewer_enabled``), SH anneal, kNN refresh, (view, time)
    sampling from the dedicated stream ``default_rng([seed, 1])``, the
    banked step, the parameter average and its row-wise repair, density
    control, barycentric cleanup, progress (and the dense tier's ``k_cap``
    growth), evaluation, saves. Metrics stay on the device between progress
    ticks; ``on_iteration(iteration, {"loss", "psnr"})`` makes every
    iteration a tick. ``wandb`` (``utils.logging.WandbAdapter``) receives
    the progress and evaluation scalars. At each of ``save_iterations`` the
    evaluation-facing state (the parameter average when ``param_ema`` is
    on) goes to ``save_scene_checkpoint`` when there is an ``out_dir`` and
    to ``on_save(iteration, state)`` when given."""
    cfg = trainer.cfg
    o = cfg.opt
    dev = trainer.device
    white_background = cfg.model.white_background
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    sample_rng = np.random.default_rng([seed, 1])
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    n_views, n_times = int(gt_bank.shape[0]), int(gt_bank.shape[1])

    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl") if out_dir
                           else None)
    sh_degree = min(first_iter // 1000, cfg.model.sh_degree)
    ema_loss = ema_psnr = loss = psnr = 0.0
    n_alive = 0
    t_start = time_mod.time()

    use_knn = (o.lambda_isometric > 0 or o.lambda_spring > 0
               or o.lambda_rigidity > 0)
    knn_state = None
    knn_capacity = -1
    carry = StepCarry.zeros(dev)
    overflow_ticks = 0

    ema_decay = float(o.param_ema)
    ema_avg = None

    def with_ema(st: SplatTrainState) -> SplatTrainState:
        """State with the evaluation-facing parameters swapped for their
        average."""
        if ema_avg is None:
            return st
        return st._replace(params=ema_avg[0], sim_params=ema_avg[1])

    for iteration in range(first_iter, o.iterations + 1):
        static = o.static_reconst and iteration < o.static_reconst_iteration

        if viewer_enabled:
            _poll_viewer(trainer, state, sh_degree)

        if iteration % 1000 == 0 and sh_degree < cfg.model.sh_degree:
            sh_degree += 1

        knn_active = use_knn and not static and iteration > o.reg_iter
        if knn_active:
            cap = state.params.face_bary.shape[0]
            if (knn_state is None or cap != knn_capacity
                    or iteration % o.knn_update_iter == 0):
                knn_state = trainer.compute_knn_state(state)
                knn_capacity = cap

        if static:
            vi = iteration % n_views
            t_ids = [0]
        else:
            vi = int(sample_rng.integers(n_views))
            t_ids = sample_time_ids(sample_rng, n_times, three_steps_batch,
                                    o.time_sample)

        state, metrics, carry = trainer.step_banked(
            state, cam_bank, gt_bank, mask_bank, vi, t_ids,
            sh_degree=sh_degree, static=static,
            knn_state=knn_state if knn_active else None, carry=carry)

        if ema_decay > 0.0:
            cur = (state.params, state.sim_params)
            if ema_avg is None:
                ema_avg = cur
            else:
                ema_avg = (
                    G.GaussianParams(*(a * ema_decay + (1.0 - ema_decay) * b
                                       for a, b in zip(ema_avg[0], cur[0]))),
                    {k: a * ema_decay + (1.0 - ema_decay) * cur[1][k]
                     for k, a in ema_avg[1].items()})

        cleanup_due = iteration % o.bary_cleanup == 0
        host_event = Trainer.density_control_due(cfg, iteration) or cleanup_due
        params_before = state.params if (ema_decay > 0.0 and host_event) else None

        state, overflow = trainer.density_control(state, iteration, generator)
        if overflow:
            print(f"[iter {iteration}] densify overflow: {overflow} "
                  f"(capacity {state.params.face_bary.shape[0]})")
        if cleanup_due:
            state = trainer.cleanup_barycentric(state)

        if params_before is not None:
            if state.params.face_bary.shape[0] != params_before.face_bary.shape[0]:
                # the capacity grew: shapes changed, restart the average
                ema_avg = (state.params, state.sim_params)
            else:
                ema_avg = (_ema_repair(ema_avg[0], params_before, state.params),
                           ema_avg[1])

        need_fetch = (iteration % progress_every == 0
                      or iteration in test_iterations
                      or on_iteration is not None)
        if need_fetch:
            # ONE device-to-host copy for everything the host reads
            fetched = torch.stack([
                metrics.loss, metrics.psnr, metrics.n_alive.to(torch.float32),
                carry.ema_loss, carry.ema_psnr,
                carry.drop_accum.to(torch.float32)]).cpu().tolist()
            loss, psnr, ema_loss, ema_psnr = (fetched[0], fetched[1],
                                              fetched[3], fetched[4])
            n_alive = int(fetched[2])
            carry = carry._replace(drop_accum=torch.zeros_like(carry.drop_accum))
            # the dense tier truncates each tile's list at k_cap, which must
            # never pass silently (K2/K3 have no cap and report 0); two
            # overflowing ticks in a row double it
            if fetched[5] > 0:
                overflow_ticks += 1
                print(f"[iter {iteration}] WARNING: rasterizer dropped "
                      f"{int(fetched[5])} tile instances since the last tick "
                      f"(k_cap={o.raster_k_cap})")
                if overflow_ticks >= 2 and o.raster_k_cap < K_CAP_MAX:
                    new_cap = trainer.grow_k_cap()
                    overflow_ticks = 0
                    print(f"[iter {iteration}] growing raster_k_cap -> {new_cap}")
            else:
                overflow_ticks = 0
        if iteration % progress_every == 0:
            rate = (iteration - first_iter + 1) / (time_mod.time() - t_start)
            print(f"[{'static' if static else 'dyn'} {iteration}/{o.iterations}] "
                  f"loss={ema_loss:.5f} psnr={ema_psnr:.2f} gaussians={n_alive} "
                  f"({rate:.1f} it/s)")
            logger.log(iteration, loss=loss, psnr=psnr, ema_loss=ema_loss,
                       ema_psnr=ema_psnr, n_gaussians=n_alive,
                       capacity=int(state.params.face_bary.shape[0]),
                       iters_per_sec=rate)
            if wandb is not None:
                wandb.log({"loss": loss, "psnr": psnr, "n_gaussians": n_alive},
                          step=iteration)

        if iteration in test_iterations and test_frames is not None:
            ev = evaluate_split(
                trainer, with_ema(state), test_frames, white_background,
                sh_degree,
                save_dir=(os.path.join(out_dir, "test_renders",
                                       f"iter_{iteration}")
                          if save_test_images and out_dir else None))
            print(f"[ITER {iteration}] test psnr={ev['psnr']:.2f} l1={ev['l1']:.4f}")
            logger.log(iteration, test_psnr=ev["psnr"], test_l1=ev["l1"])
            if wandb is not None:
                wandb.log({"test_psnr": ev["psnr"], "test_l1": ev["l1"]},
                          step=iteration)

        if iteration in save_iterations:
            # the saved PLY and mesh are what evaluation scores: averaged
            # parameters; the resume checkpoints below keep the raw iterate
            if out_dir:
                save_scene_checkpoint(out_dir, iteration, trainer, with_ema(state))
            if on_save is not None:
                on_save(iteration, with_ema(state))

        if out_dir and iteration in checkpoint_iterations:
            path = save_train_checkpoint(out_dir, iteration, state)
            print(f"[ITER {iteration}] saved checkpoint {path}")

        if on_iteration is not None:
            on_iteration(iteration, {"loss": loss, "psnr": psnr})

    logger.close()
    return state


def train_scene(
    cfg: Config,
    scene: ClothScene,
    out_dir: str,
    test_iterations: Sequence[int] = (),
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    start_checkpoint: Optional[str] = None,
    seed: int = 6666,
    progress_every: int = 50,
    on_iteration: Optional[Callable[[int, dict], None]] = None,
    three_steps_batch: bool = True,
    save_test_images: bool = False,
    wandb=None,
    viewer_enabled: bool = False,
    device: str | torch.device = "cuda",
) -> SplatTrainState:
    """Run the full static + dynamic optimization of one scene on ``device``
    (the scene's mesh must lie there). ``three_steps_batch=False`` takes ONE
    random (view, time) camera per dynamic iteration instead of the
    3-consecutive-time batch; ``wandb`` and ``viewer_enabled`` go to
    ``fit_banks``."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    mesh = scene.initial_mesh
    preds = torch.as_tensor(scene.mesh_predictions, dtype=torch.float32, device=dev)
    cam0 = scene.train.get(0, 0).camera
    trainer = Trainer(cfg, mesh, preds, cam0.width, cam0.height, cam0.tanfovx,
                      cam0.tanfovy, scene.radius)
    state = trainer.init_state(rng)
    first_iter = 1
    if start_checkpoint:
        state = load_train_checkpoint(start_checkpoint, state)
        first_iter = int(state.step) + 1
        print(f"resumed from {start_checkpoint} at iteration {first_iter}")
    cam_bank, gt_bank, mask_bank = build_banks(scene.train,
                                               scene.white_background, dev)
    return fit_banks(
        trainer, state, cam_bank, gt_bank, mask_bank, out_dir=out_dir,
        test_frames=scene.test, test_iterations=test_iterations,
        save_iterations=save_iterations,
        checkpoint_iterations=checkpoint_iterations, first_iter=first_iter,
        seed=seed, progress_every=progress_every, on_iteration=on_iteration,
        three_steps_batch=three_steps_batch, save_test_images=save_test_images,
        wandb=wandb, viewer_enabled=viewer_enabled)
