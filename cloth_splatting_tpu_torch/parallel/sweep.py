"""The scene-parallel sweep: train several same-shape scenes at once, one
per device; counterpart of ``cloth_splatting_tpu/parallel/sweep.py``.

The reference's ``run_all.sh`` trains its folding scenes one after another
on one GPU. Here scenes are grouped by a shape signature (vertex, face and
edge counts, the camera grid, resolution, field of view, prediction count,
scene radius: garments of one type share a group), a group holds at most
one scene per device, and one host loop advances every scene of the group
each iteration on its own device (``parallel/scenes.SceneRun``). With one
card, every group holds one scene: the sweep is the sequential loop.

Every scene draws what a lone ``train.loop.train_scene(seed)`` draws: its
initial state from ``default_rng(seed)``, its density control's jitter from
a generator seeded with ``seed``, and the (view, time) draw of each
iteration, shared by the group, from ``default_rng([seed, 1])``. So each
scene's final state is the sequential run's, bit for bit on one kind of
device. The dense tier's ``k_cap`` grows group-wide (the scenes share one
config), as in the JAX package, which can make a dense-tier scene differ
from its lone run. Not carried over: the JAX package re-pads every scene to
the group's largest capacity after a density event, a rule of its one
static shape that changes no result; here each scene keeps its own.

The kNN regularizers and the parameter average (``param_ema``) are refused,
as in the JAX package.
"""

from __future__ import annotations

import os
import time as time_mod
from typing import Sequence

import numpy as np
import torch

from cloth_splatting_tpu_torch.parallel.scenes import place_scene, scene_devices
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.loop import (
    K_CAP_MAX,
    evaluate_split,
    host_events,
    sample_cameras,
    save_scene_checkpoint,
)
from cloth_splatting_tpu_torch.train.step import SplatTrainState


def scene_signature(scene) -> tuple:
    """The shape signature; the scenes of one group share it."""
    mesh = scene.initial_mesh
    cam0 = scene.train.get(0, 0).camera
    return (
        int(mesh.pos.shape[0]), int(mesh.faces.shape[0]),
        int(mesh.edge_index.shape[1]),
        scene.train.n_views, scene.train.n_times,
        cam0.width, cam0.height,
        round(float(cam0.tanfovx), 6), round(float(cam0.tanfovy), 6),
        len(scene.mesh_predictions),
        round(float(scene.radius), 6),
    )


def group_scenes(scenes: Sequence, n_devices: int | None = None) -> list[list[int]]:
    """Scene indices grouped by signature, at most ``n_devices`` (default:
    the visible cards) a group."""
    n_dev = n_devices or len(scene_devices())
    by_sig: dict[tuple, list[int]] = {}
    for i, sc in enumerate(scenes):
        by_sig.setdefault(scene_signature(sc), []).append(i)
    return [idxs[k:k + n_dev] for idxs in by_sig.values()
            for k in range(0, len(idxs), n_dev)]


def train_scene_group(
    cfg: Config,
    scenes: Sequence,
    out_dirs: Sequence[str],
    devices: Sequence[str | torch.device] | None = None,
    test_iterations: Sequence[int] = (),
    save_iterations: Sequence[int] = (),
    seed: int = 6666,
    progress_every: int = 50,
    three_steps_batch: bool = True,
) -> list[SplatTrainState]:
    """Train one group of same-signature scenes together, scene i on
    ``devices[i]`` (default: the visible cards), on ``train_scene``'s
    schedule; evaluates at ``test_iterations``, writes each scene's PLY,
    mesh and simulator at ``save_iterations`` (``save_scene_checkpoint``,
    needs h5py). Returns the final states."""
    o = cfg.opt
    if o.lambda_isometric > 0 or o.lambda_spring > 0 or o.lambda_rigidity > 0:
        raise NotImplementedError(
            "kNN regularizers are not supported by the scene-parallel sweep; "
            "train these configs one scene at a time (train)")
    if o.param_ema > 0:
        raise NotImplementedError(
            "param_ema is not implemented by the scene-parallel sweep: its "
            "evaluations would score the raw iterate where a lone run scores "
            "the average; train EMA configs one scene at a time (train)")
    devs = scene_devices(len(scenes), devices)
    for d in out_dirs:
        os.makedirs(d, exist_ok=True)
    runs = [place_scene(cfg, sc, dev, seed) for sc, dev in zip(scenes, devs)]

    sample_rng = np.random.default_rng([seed, 1])
    n_views, n_times = scenes[0].train.n_views, scenes[0].train.n_times
    sh_degree = 0
    overflow_ticks = 0
    t_start = time_mod.time()
    for iteration in range(1, o.iterations + 1):
        static = o.static_reconst and iteration < o.static_reconst_iteration
        if iteration % 1000 == 0 and sh_degree < cfg.model.sh_degree:
            sh_degree += 1
        vi, t_ids = sample_cameras(sample_rng, iteration, static, n_views, n_times,
                                   three_steps_batch, o.time_sample)
        losses = []
        for run in runs:
            run.state, metrics, run.carry = run.trainer.step_banked(
                run.state, run.cam_bank, run.gt_bank, run.mask_bank, vi, t_ids,
                sh_degree=sh_degree, static=static, carry=run.carry)
            run.state = host_events(run.trainer, run.state, iteration,
                                    run.generator)
            losses.append(metrics.loss)

        if iteration % progress_every == 0:
            fetched = [torch.stack([loss, run.carry.drop_accum.to(torch.float32)])
                       .cpu().tolist() for loss, run in zip(losses, runs)]
            for run in runs:
                run.carry = run.carry._replace(
                    drop_accum=torch.zeros_like(run.carry.drop_accum))
            dropped = int(sum(f[1] for f in fetched))
            rate = iteration / (time_mod.time() - t_start)
            print(f"[sweep {'static' if static else 'dyn'} {iteration}/"
                  f"{o.iterations}] losses=[{' '.join(f'{f[0]:.4f}' for f in fetched)}] "
                  f"({rate:.1f} it/s x {len(runs)} scenes)")
            # the dense tier's truncation must never pass silently; the
            # group shares one k_cap
            if dropped > 0:
                overflow_ticks += 1
                print(f"[sweep {iteration}] WARNING: rasterizer dropped {dropped} "
                      f"tile instances since the last tick (k_cap={o.raster_k_cap})")
                if overflow_ticks >= 2 and o.raster_k_cap < K_CAP_MAX:
                    new_cap = runs[0].trainer.grow_k_cap()
                    overflow_ticks = 0
                    print(f"[sweep {iteration}] growing raster_k_cap -> {new_cap}")

        for i, (sc, run) in enumerate(zip(scenes, runs)):
            if iteration in test_iterations:
                ev = evaluate_split(run.trainer, run.state, sc.test,
                                    sc.white_background, sh_degree)
                print(f"[ITER {iteration}] scene {i} test psnr={ev['psnr']:.2f}")
            if iteration in save_iterations:
                save_scene_checkpoint(out_dirs[i], iteration, run.trainer, run.state)
    return [run.state for run in runs]


def train_scenes_parallel(
    cfg: Config,
    scenes: Sequence,
    out_dirs: Sequence[str],
    devices: Sequence[str | torch.device] | None = None,
    **kw,
) -> list[SplatTrainState]:
    """Group the scenes by signature, at most one scene a device of
    ``devices`` (default: the visible cards) a group, and train the groups
    one after another (``train_scene_group``; ``kw`` goes to it). Returns
    the final states in the order of ``scenes``."""
    devs = scene_devices(None, devices)
    results: list = [None] * len(scenes)
    for idxs in group_scenes(scenes, len(devs)):
        print(f"=== scene-parallel group {idxs} ({len(idxs)} scene(s)) ===")
        finals = train_scene_group(cfg, [scenes[i] for i in idxs],
                                   [out_dirs[i] for i in idxs], devices=devs, **kw)
        for i, st in zip(idxs, finals):
            results[i] = st
    return results
