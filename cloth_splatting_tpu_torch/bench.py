"""Benchmark: novel-view render FPS at 800x800 and train iterations per
second; counterpart of the root ``bench.py``:

    python -m cloth_splatting_tpu_torch.bench [--device cuda]

Prints ONE json line with the root's keys: the headline
``render_fps_800x800_65k_gaussians`` (40 orbit views of a static 65k-Gaussian
mesh field, SH degree 3, projection + K1, FPS as ``(n - 1) / elapsed``, the
reference ``render.py`` convention), ``vs_baseline`` against 100 FPS, and
train iterations per second of the full step (3 cameras, K2 forward, K3
backward, two Adams, density statistics) at 4k, 24k and 65k Gaussians.
``BENCH_SCALES=all`` adds the 4k and 16k render scales.

The root runs each orbit as one jitted ``lax.scan`` over a camera bank and
probes the TPU before it starts; here an orbit is a loop of frames, timed
between two ``torch.cuda.synchronize`` calls after a warm-up frame.
``--device`` defaults to ``cuda`` and raises without a card; on the CPU the
kernels' plain versions run. The timings are the card's only on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
from cloth_splatting_tpu_torch.data.synthetic import orbit_camera, target_gaussians
from cloth_splatting_tpu_torch.device import resolve_device, synchronize
from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.ops.camera import Camera
from cloth_splatting_tpu_torch.ops.projection import build_covariance, project_gaussians
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import rasterize_tiled_fwd
from cloth_splatting_tpu_torch.ops.sh import eval_sh
from cloth_splatting_tpu_torch.render import CameraArrays, camera_arrays

BASELINE_FPS = 100.0
FOV = 2.0 * math.atan(0.4)
BG = (1.0, 1.0, 1.0)
TRAIN_TIMES = (0.0, 0.5, 1.0)


class ServingScene(NamedTuple):
    """The render benchmark's scene: a textured Gaussian field on a flat
    ``res`` x ``res`` cloth mesh (4 res^2 Gaussians at SH degree 3; res 128
    is the 65k headline scale)."""

    mesh: G.Mesh
    params: G.GaussianParams
    state: G.GaussianState


def serving_scene(res: int = 128,
                  device: str | torch.device = "cuda") -> ServingScene:
    dev = resolve_device(device)
    mesh = grid_cloth_mesh(res, res, size=1.4, device=dev)
    params, state = target_gaussians(mesh, 3, seed=0, device=dev)
    return ServingScene(mesh, params, state)


@torch.no_grad()
def measure_fps(res: int, n_views: int = 40, width: int = 800, height: int = 800,
                device: str | torch.device = "cuda",
                scene: ServingScene | None = None) -> float:
    """Frames per second over ``n_views`` orbit views of the static
    ``serving_scene(res)`` (or ``scene``): per frame SH colours, EWA
    projection and the serving rasterizer (K1). One warm-up frame, then
    the orbit between two synchronizes; (n_views - 1) / elapsed."""
    dev = resolve_device(device)
    mesh, params, state = scene or serving_scene(res, dev)
    tan = math.tan(FOV / 2.0)
    cams = [camera_arrays(orbit_camera(v, n_views, FOV, width, height, 0.0), dev)
            for v in range(n_views)]
    xyz = G.gaussian_positions(params, state, mesh)
    cov = build_covariance(G.get_scaling(params), params.rotation)
    sh = G.get_features(params)
    op = G.get_opacity(params)

    def frame(c: CameraArrays) -> torch.Tensor:
        dirs = xyz - c.camera_center[None]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                                      1e-8)
        colors = torch.clamp_min(eval_sh(3, sh, dirs) + 0.5, 0.0)
        proj = project_gaussians(xyz, cov, colors, op, c.world_view, c.full_proj,
                                 width, height, tan, tan, alive=state.alive)
        return rasterize_tiled_fwd(proj, width, height, BG, pack_order="fused")[0]

    frame(cams[0])
    synchronize(dev)
    t0 = time.perf_counter()
    for c in cams:
        frame(c)
    synchronize(dev)
    return (n_views - 1) / (time.perf_counter() - t0)


def train_setup(width: int = 800, height: int = 800, mesh_res: int = 32,
                capacity: int = 4096, device: str | torch.device = "cuda"):
    """The train benchmark's configuration: (trainer, state, cams, gts).
    A flat ``mesh_res`` cloth (4 mesh_res^2 Gaussians: res 32 -> 4k, 78 ->
    24.3k, 128 -> 65.5k) at ``capacity``, default ``Config()``, three
    cameras at times 0, 0.5 and 1, a constant 0.5 ground truth."""
    from cloth_splatting_tpu_torch.train.config import Config
    from cloth_splatting_tpu_torch.train.step import Trainer

    dev = resolve_device(device)
    tan = math.tan(FOV / 2.0)
    mesh = grid_cloth_mesh(mesh_res, mesh_res, size=1.4, device=dev)
    cfg = Config()
    trainer = Trainer(cfg, mesh, mesh.pos[None].repeat(len(TRAIN_TIMES), 1, 1),
                      width, height, tan, tan, 2.0)
    rng = np.random.default_rng(0)
    params, gstate = G.init_from_mesh(rng, mesh, cfg.model.sh_degree, 2,
                                      capacity=capacity, device=dev)
    state = trainer.init_state(rng, params, gstate)
    cam = Camera.create(R=np.eye(3), t=np.asarray([0.0, 0.0, 3.0]), fovx=FOV,
                        fovy=FOV, width=width, height=height, time=0.5)
    arrs = [camera_arrays(dataclasses.replace(cam, time=t), dev)
            for t in TRAIN_TIMES]
    cams = CameraArrays(*(torch.stack([getattr(a, f) for a in arrs])
                          for f in CameraArrays._fields))
    gts = torch.full((len(TRAIN_TIMES), 3, height, width), 0.5, device=dev)
    return trainer, state, cams, gts


def measure_train_iters(width: int = 800, height: int = 800, n_iters: int = 20,
                        mesh_res: int = 32, capacity: int = 4096,
                        device: str | torch.device = "cuda") -> float:
    """Train steps per second on ``train_setup``'s configuration at
    ``sh_degree=1``: one warm-up step, then ``n_iters`` steps between two
    synchronizes."""
    trainer, state, cams, gts = train_setup(width, height, mesh_res, capacity,
                                            device)
    state, _ = trainer.step(state, cams, gts, None, sh_degree=1, static=False)
    synchronize(trainer.device)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, _ = trainer.step(state, cams, gts, None, sh_degree=1, static=False)
    synchronize(trainer.device)
    return n_iters / (time.perf_counter() - t0)


def run(device: str | torch.device = "cuda", all_scales: bool = False,
        scene: ServingScene | None = None) -> dict:
    """The benchmark's result: 65k FPS (on ``scene`` when given), train
    iterations per second at 4k, 24k and 65k, and with ``all_scales`` the
    4k and 16k FPS."""
    dev = resolve_device(device)
    fps_4k = measure_fps(32, device=dev) if all_scales else None
    fps_16k = measure_fps(64, device=dev) if all_scales else None
    fps_65k = measure_fps(128, device=dev, scene=scene)
    train_ips = measure_train_iters(device=dev)
    train_ips_24k = measure_train_iters(mesh_res=78, capacity=32768, device=dev)
    train_ips_65k = measure_train_iters(mesh_res=128, capacity=65536, device=dev)
    result = {
        "metric": "render_fps_800x800_65k_gaussians",
        "value": round(fps_65k, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_65k / BASELINE_FPS, 4),
        "train_iters_per_sec_800x800": round(train_ips, 2),
        "train_iters_per_sec_24k_gaussians": round(train_ips_24k, 2),
        "train_iters_per_sec_65k_gaussians": round(train_ips_65k, 2),
    }
    if all_scales:
        result["fps_4k_gaussians"] = round(fps_4k, 2)
        result["fps_16k_gaussians"] = round(fps_16k, 2)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.bench",
        description="Render FPS and train iterations per second")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device,
                         all_scales=os.environ.get("BENCH_SCALES", "") == "all")))


if __name__ == "__main__":
    main()
