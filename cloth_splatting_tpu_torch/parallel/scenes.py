"""Scene-level parallelism: each scene of a sweep on a device of its own;
counterpart of ``cloth_splatting_tpu/parallel/scenes.py``.

The JAX package stacks a group's scenes along a leading axis and runs one
``shard_map`` program over a ``('scene',)`` mesh, which needs one static
shape for the group. Here nothing is stacked: a ``SceneRun`` holds one
scene's trainer, train state, camera and ground-truth banks, density-control
generator and running statistics, all on that scene's device, exactly as
``train.loop.train_scene`` builds them for the scene alone. No tensor crosses
devices, so no collective is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.scene import ClothScene
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.gaussians import Mesh
from cloth_splatting_tpu_torch.render import CameraArrays
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.loop import build_banks
from cloth_splatting_tpu_torch.train.step import SplatTrainState, StepCarry, Trainer


def scene_devices(n_scenes: int | None = None,
                  devices: Sequence[str | torch.device] | None = None
                  ) -> list[torch.device]:
    """The first ``n_scenes`` of ``devices`` (default: every visible card);
    raises when there are fewer, or when no card is visible and none is
    given."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs) if n_scenes is None else n_scenes
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return devs[:n]


@dataclasses.dataclass
class SceneRun:
    """One scene of a sweep, everything on ``trainer.device``."""

    trainer: Trainer
    state: SplatTrainState
    cam_bank: CameraArrays
    gt_bank: torch.Tensor
    mask_bank: torch.Tensor | None
    generator: torch.Generator
    carry: StepCarry


def place_scene(cfg: Config, scene: ClothScene, device: torch.device,
                seed: int) -> SceneRun:
    """The run of ``scene`` on ``device``, drawn as ``train_scene(seed)``
    draws it: the initial state from ``default_rng(seed)``, the density
    generator seeded with ``seed``."""
    mesh = Mesh(*(t.to(device) for t in scene.initial_mesh))
    preds = torch.as_tensor(scene.mesh_predictions, dtype=torch.float32,
                            device=device)
    cam0 = scene.train.get(0, 0).camera
    trainer = Trainer(cfg, mesh, preds, cam0.width, cam0.height, cam0.tanfovx,
                      cam0.tanfovy, scene.radius)
    state = trainer.init_state(np.random.default_rng(seed))
    cam_bank, gt_bank, mask_bank = build_banks(scene.train, scene.white_background,
                                               device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return SceneRun(trainer, state, cam_bank, gt_bank, mask_bank, generator,
                    StepCarry.zeros(device))
