"""Continual splat optimization for closed-loop planning; counterpart of
``cloth_splatting_tpu/train/single_step.py``.

``initialize`` fits nothing yet: it builds the trainer and its state on the
first observations; ``static_reconstruction`` fits the Gaussians to the
first frame; ``update_data`` re-reads the grown scene and replaces the
trainer, keeping the state (Adam's moments live in it); and
``update_mesh_predictions`` refines the residual simulator and the
Gaussians on every observed time, sampling mid times with weights rising
linearly toward the newest; ``refined_positions`` gives the corrected mesh
states the planner feeds back into the GNN history.

The residual simulator's time axis is pinned to ``n_times_max``, so its
time-to-index map stays fixed while observations stream in; the mesh
predictions are padded by repeating the last known state.

The scene comes from a directory, as in the JAX package (``load_scene_data``:
the loader, then ``build_banks``; needs PIL and h5py), or from a callable
that returns a ``SceneData`` built in memory
(``manipulation.observation.ObservationSynthesizer.scene_data``). The
split jitter of density control is drawn from a ``torch.Generator`` seeded
with ``seed`` where the JAX package splits a ``PRNGKey``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.deform import simulate_any, simulator_from_params
from cloth_splatting_tpu_torch.models.gaussians import Mesh
from cloth_splatting_tpu_torch.ops.camera import Camera
from cloth_splatting_tpu_torch.render import CameraArrays
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.loop import build_banks, save_scene_checkpoint
from cloth_splatting_tpu_torch.train.step import SplatTrainState, Trainer


class SceneData(NamedTuple):
    """A scene as the refiner trains on it: the (view x time) banks of
    every frame (the loader's split-free grid), the mesh, the mesh
    predictions and the loader's radius."""

    cam_bank: CameraArrays          # fields [V, T, ...]
    gt_bank: torch.Tensor           # uint8 [V, T, 3, H, W]
    mask_bank: torch.Tensor | None  # float [V, T, 1, H, W]
    n_views: int
    n_times: int
    camera0: Camera                 # width, height and field of view
    initial_mesh: Mesh
    mesh_predictions: np.ndarray    # [T, V, 3] float32
    radius: float


def load_scene_data(scene_dir: str, white_background: bool,
                    device: str | torch.device = "cuda") -> SceneData:
    """A scene directory read as the JAX refiner reads it (train and test
    frames together)."""
    scene = load_cloth_scene(scene_dir, white_background, eval_split=False,
                             device=device)
    cam_bank, gt_bank, mask_bank = build_banks(scene.train, white_background,
                                               device)
    return SceneData(cam_bank, gt_bank, mask_bank, scene.train.n_views,
                     scene.train.n_times, scene.train.get(0, 0).camera,
                     scene.initial_mesh, scene.mesh_predictions, scene.radius)


class SingleStepOptimizer:
    def __init__(self, cfg: Config, scene: str | Callable[[], SceneData],
                 n_times_max: int, save_path: str | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if isinstance(scene, str):
            self.scene_dir = scene
            self._read = lambda: load_scene_data(scene, cfg.model.white_background,
                                                 self.device)
        else:
            self.scene_dir = None
            self._read = scene
        self.n_times_max = n_times_max
        self.save_path = save_path or cfg.model.model_path or \
            (self.scene_dir or "scene") + "_model"
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.last_iters = 0
        self.trainer: Trainer | None = None
        self.state: SplatTrainState | None = None

    # ------------------------------------------------------------------ data

    def _padded_predictions(self, preds: np.ndarray) -> torch.Tensor:
        t = preds.shape[0]
        if t < self.n_times_max:
            pad = np.repeat(preds[-1:], self.n_times_max - t, axis=0)
            preds = np.concatenate([preds, pad], axis=0)
        return torch.as_tensor(np.asarray(preds[: self.n_times_max], np.float32),
                               device=self.device)

    def _trainer(self, preds: np.ndarray) -> Trainer:
        cam0 = self.scene.camera0
        return Trainer(self.cfg, self.scene.initial_mesh,
                       self._padded_predictions(preds), cam0.width, cam0.height,
                       cam0.tanfovx, cam0.tanfovy, self.scene.radius)

    def initialize(self) -> None:
        self.scene = self._read()
        self.trainer = self._trainer(self.scene.mesh_predictions)
        self.state = self.trainer.init_state(self.rng)

    def update_data(self, n_times: int = -1) -> None:
        """Re-read the scene after new observations landed: the Gaussians and
        their optimizer state persist; the trainer is rebuilt on the new
        mesh and prediction buffer."""
        self.scene = self._read()
        preds = self.scene.mesh_predictions
        if n_times > 0:
            preds = preds[:n_times]
        self.trainer = self._trainer(preds)

    @property
    def n_times(self) -> int:
        return self.scene.n_times

    def _step(self, it: int, t_ids: list[int], static: bool):
        s = self.scene
        return self.trainer.step_banked(self.state, s.cam_bank, s.gt_bank,
                                        s.mask_bank, it % s.n_views, t_ids,
                                        sh_degree=0, static=static)

    # -------------------------------------------------------------- training

    def static_reconstruction(self, train_steps: int | None = None) -> None:
        steps = train_steps or self.cfg.opt.static_reconst_iteration
        for it in range(1, steps + 1):
            self.state, metrics = self._step(it, [0], static=True)
            self.state, _ = self.trainer.density_control(self.state, it,
                                                         self.generator)
            if it % self.cfg.opt.bary_cleanup == 0:
                self.state = self.trainer.cleanup_barycentric(self.state)
        self.last_iters = steps
        print(f"[single-step] static fit done: psnr={float(metrics.psnr):.2f}")

    def update_mesh_predictions(self, train_steps: int = 1000) -> None:
        """Refine the simulator and the Gaussians on all observed times: a
        step takes a mid time and its two neighbours, the mid time drawn
        with weights rising linearly toward the newest observation."""
        n_times = self.n_times
        for it in range(self.last_iters + 1, self.last_iters + train_steps + 1):
            if n_times >= 3:
                w = np.linspace(0.5, 1.5, n_times - 2)
                mid = int(self.rng.choice(np.arange(1, n_times - 1), p=w / w.sum()))
                t_ids = [mid - 1, mid, mid + 1]
            else:
                t_ids = list(range(n_times))
            self.state, _ = self._step(it, t_ids, static=False)
        self.last_iters += train_steps

    # ----------------------------------------------------------------- output

    @torch.no_grad()
    def refined_positions(self) -> np.ndarray:
        """Simulator-refined mesh states of every observed time [T, V, 3]."""
        simulator = simulator_from_params(self.state.sim_params)
        out = []
        for t_idx in range(self.n_times):
            t = torch.tensor(t_idx / max(self.n_times_max - 1, 1),
                             dtype=torch.float32, device=self.device)
            out.append(simulate_any(simulator, self.trainer.mesh_predictions, t))
        return torch.stack(out).cpu().numpy()

    def save(self) -> None:
        """PLY, mesh and simulator checkpoint at the last iteration (needs
        h5py)."""
        save_scene_checkpoint(self.save_path, self.last_iters, self.trainer,
                              self.state)
