"""Observation synthesis for the closed manipulation loop; counterpart of
``cloth_splatting_tpu/manipulation/observation.py``.

Multi-view RGBA observations of the TRUE cloth state, rendered through the
dense tier (``render(..., backend="tiled", k_cap=192, k_chunk=16)``, plain
PyTorch, no kernel) from a textured Gaussian field anchored on the
observation mesh (``data.synthetic.target_gaussians``), at orbit cameras
(``orbit_camera``; the last view is the test view).

Two forms, chosen by the caller:

  * a scene directory (``scene_dir``, as the JAX package): each frame as
    ``{train,test}/r_<view>_<time>.png``, ``transforms_{train,test}.json``
    rewritten after every state, ``init_mesh.hdf5`` and
    ``mesh_predictions/mesh_%03d.hdf5`` (needs imageio and h5py), which the
    refiner re-reads through the loader;
  * in memory (``scene_dir=None``): nothing is written; ``scene_data``
    hands the refiner the same scene built from the kept uint8 RGBA frames
    and mesh predictions: the cameras through the json's float64 round
    trip, the frames composited as the loader composites a PNG, the mesh
    built on the host as the loader reads it. The banks are bit-equal to
    what writing and re-reading gives.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.predictions import (
    mesh_from_positions,
    save_mesh_predictions,
)
from cloth_splatting_tpu_torch.data.scene import (
    CameraGrid,
    FrameRecord,
    camera_from_transform,
    nerfpp_radius,
)
from cloth_splatting_tpu_torch.data.synthetic import (
    camera_to_transform_matrix,
    composite_rgba,
    orbit_camera,
    target_gaussians,
)
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.gaussians import Mesh
from cloth_splatting_tpu_torch.render import DENSE_BACKEND, camera_arrays, render
from cloth_splatting_tpu_torch.train.loop import build_banks
from cloth_splatting_tpu_torch.train.single_step import SceneData


class ObservationSynthesizer:
    """Renders cloth states into an incrementally growing scene: a
    directory, or memory when ``scene_dir`` is None."""

    def __init__(self, scene_dir: str | None, faces: np.ndarray,
                 rest_positions: np.ndarray, n_views: int = 5,
                 image_size: int = 128, n_times_max: int = 16,
                 fov: float = 2 * np.arctan(0.4), white_background: bool = True,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.scene_dir = scene_dir
        self.n_views = n_views
        self.image_size = image_size
        self.n_times_max = n_times_max
        self.fov = fov
        self.white_background = white_background
        self.device = resolve_device(device)
        if scene_dir is not None:
            os.makedirs(scene_dir, exist_ok=True)

        self.mesh = mesh_from_positions(rest_positions, faces, self.device)
        self.faces = np.asarray(faces)
        self.appearance, self.gstate = target_gaussians(self.mesh, sh_degree=3,
                                                        seed=seed,
                                                        device=self.device)
        self.frames_train: list[dict] = []
        self.frames_test: list[dict] = []
        self.rgba: dict[str, np.ndarray] = {}   # file_path -> uint8 [H, W, 4]
        self.mesh_predictions: np.ndarray | None = None
        self.n_times = 0

    def _time_value(self, t_idx: int) -> float:
        return t_idx / max(self.n_times_max - 1, 1)

    @torch.no_grad()
    def render_state(self, positions: np.ndarray, t_idx: int) -> None:
        """Render every view of one cloth state and append its frames."""
        bg = (1.0, 1.0, 1.0) if self.white_background else (0.0, 0.0, 0.0)
        size = self.image_size
        verts = torch.as_tensor(np.asarray(positions, np.float32), device=self.device)
        # manipulation scenes are y-up; the cameras orbit above the cloth
        for vi in range(self.n_views):
            cam = orbit_camera(vi, self.n_views, self.fov, size, size,
                               self._time_value(t_idx), radius=1.2, elevation=0.9)
            out = render(camera_arrays(cam, self.device), size, size, cam.tanfovx,
                         cam.tanfovy, self.appearance, self.gstate, self.mesh, None,
                         None, bg, 3, override_vertices=verts, k_cap=192,
                         k_chunk=16, backend=DENSE_BACKEND, device=self.device)
            img = (torch.clamp(out.rgb, 0, 1) * 255).to(torch.uint8)
            alpha = (torch.clamp(out.alpha[0], 0, 1) * 255).to(torch.uint8)
            rgba = torch.cat([img, alpha[None]]).permute(1, 2, 0).cpu().numpy()
            split = "test" if vi == self.n_views - 1 else "train"
            frame = {
                "file_path": f"{split}/r_{vi}_{t_idx}",
                "time": self._time_value(t_idx),
                "transform_matrix": camera_to_transform_matrix(cam).tolist(),
            }
            self.rgba[frame["file_path"]] = rgba
            if self.scene_dir is not None:
                import imageio.v2 as imageio

                os.makedirs(os.path.join(self.scene_dir, split), exist_ok=True)
                imageio.imwrite(os.path.join(self.scene_dir,
                                             frame["file_path"] + ".png"), rgba)
            (self.frames_test if split == "test" else self.frames_train).append(frame)
        self.n_times = max(self.n_times, t_idx + 1)
        if self.scene_dir is not None:
            self._write_transforms()

    def _write_transforms(self) -> None:
        for split, frames in (("train", self.frames_train),
                              ("test", self.frames_test)):
            meta = {"camera_angle_x": float(self.fov),
                    "camera_angle_y": float(self.fov), "frames": frames}
            with open(os.path.join(self.scene_dir,
                                   f"transforms_{split}.json"), "w") as f:
                json.dump(meta, f)

    def write_mesh_predictions(self, positions_over_time: np.ndarray) -> None:
        """Keep the GNN's or the refiner's mesh states [T, V, 3]; in the
        directory form also write them in the trainer's layout."""
        self.mesh_predictions = np.array(positions_over_time, np.float32)
        if self.scene_dir is not None:
            save_mesh_predictions(self.scene_dir, self.faces,
                                  self.mesh_predictions)

    # ---------------------------------------------------------------- memory

    def scene_data(self) -> SceneData:
        """The scene the loader would read back from the directory form,
        built from memory (train frames, then test frames, as the loader
        joins them)."""
        size = self.image_size
        records, gts = [], {}
        for frame in self.frames_train + self.frames_test:
            name = os.path.basename(frame["file_path"])
            vi, ti = (int(x) for x in name.split("_")[1:])
            cam = camera_from_transform(frame["transform_matrix"], float(self.fov),
                                        float(self.fov), size, size,
                                        float(frame["time"]), vi, ti)
            records.append(FrameRecord(camera=cam, image_path=None, image_name=name))
            gts[(vi, ti)] = composite_rgba(
                torch.from_numpy(self.rgba[frame["file_path"]]).permute(2, 0, 1),
                self.white_background)
        grid = CameraGrid(records)
        cam_bank = build_banks(grid, self.white_background, self.device)[0]
        gt_bank = torch.stack([
            torch.stack([gts[(v, t)] for t in grid.time_ids]) for v in grid.view_ids
        ]).to(self.device)
        # the mesh as the loader reads init_mesh.hdf5: built on the host
        mesh = mesh_from_positions(self.mesh_predictions[0], self.faces, "cpu")
        return SceneData(
            cam_bank=cam_bank, gt_bank=gt_bank, mask_bank=None,
            n_views=grid.n_views, n_times=grid.n_times,
            camera0=grid.get(0, 0).camera,
            initial_mesh=Mesh(*(x.to(self.device) for x in mesh)),
            mesh_predictions=self.mesh_predictions,
            radius=nerfpp_radius([r.camera for r in records]))
