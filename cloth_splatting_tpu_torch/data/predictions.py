"""Mesh predictions into a scene directory; counterpart of
``cloth_splatting_tpu/data/predictions.py``: the files the trainer reads as
the GNN's rollout, ``init_mesh.hdf5`` and ``mesh_predictions/mesh_%03d.hdf5``,
from a rollout of the trained GNN, from given vertex positions or from the
noisy ground-truth ablation. Needs ``h5py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.mesh_io import save_mesh_h5, save_positions_h5
from cloth_splatting_tpu_torch.data.meshing import faces_to_edges
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.gaussians import Mesh, compute_vertex_normals


def mesh_from_positions(pos: np.ndarray, faces: np.ndarray,
                        device: str | torch.device = "cuda") -> Mesh:
    """A Mesh (edges, rest lengths, normals) of vertices ``pos`` [V, 3] and
    triangles ``faces`` [F, 3], on ``device``."""
    dev = resolve_device(device)
    edge_index = faces_to_edges(np.asarray(faces).astype(np.int32))
    disp = pos[edge_index[1]] - pos[edge_index[0]]
    edge_norm = np.linalg.norm(disp, axis=1, keepdims=True).astype(np.float32)
    pos_t = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
    faces_t = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    return Mesh(pos=pos_t, faces=faces_t,
                edge_index=torch.as_tensor(edge_index.astype(np.int64), device=dev),
                edge_norm=torch.as_tensor(edge_norm, device=dev),
                normals=compute_vertex_normals(pos_t, faces_t))


def save_mesh_predictions(scene_dir: str, faces: np.ndarray,
                          positions_over_time: np.ndarray) -> None:
    """Write ``init_mesh.hdf5`` (the positions at t = 0) and
    ``mesh_predictions/mesh_%03d.hdf5`` for every time."""
    mesh0 = mesh_from_positions(positions_over_time[0], faces, "cpu")
    save_mesh_h5(os.path.join(scene_dir, "init_mesh.hdf5"), mesh0)
    for t in range(positions_over_time.shape[0]):
        save_positions_h5(
            os.path.join(scene_dir, "mesh_predictions", f"mesh_{t:03d}.hdf5"),
            mesh0, positions_over_time[t])


def generate_gnn_predictions(scene_dir: str, sim_state: dict, ds,
                             traj_idx: int = 0, normalize: bool = True) -> np.ndarray:
    """Roll the trained GNN (``sim_state``, on its device) out over
    trajectory ``traj_idx`` of dataset ``ds`` and write the predictions into
    ``scene_dir``. Returns [T, V, 3]."""
    from cloth_splatting_tpu_torch.models.cloth_simulator import rollout

    dev = sim_state["out_norm"].acc_sum.device
    item = ds.rollout_item(traj_idx)

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    traj, _ = rollout(sim_state, tensor(item["pos"][0], np.float32),
                      tensor(item["init_velocity"], np.float32),
                      tensor(item["node_type"], np.int64),
                      tensor(item["edge_index"], np.int64),
                      tensor(item["actions"], np.float32), int(item["grasped"]),
                      n_steps=item["actions"].shape[0], normalize=normalize)
    positions = traj.cpu().numpy()
    save_mesh_predictions(scene_dir, np.asarray(item["faces"]), positions)
    return positions


def generate_noisy_gt_predictions(scene_dir: str, faces: np.ndarray,
                                  gt_positions: np.ndarray, ema: float = 0.9,
                                  noise_std: float = 0.01, seed: int = 0
                                  ) -> np.ndarray:
    """The noisy ground-truth ablation: the ground truth smoothed by an
    exponential average plus Gaussian noise, standing in for GNN rollouts;
    written with ``save_mesh_predictions`` and returned [T, V, 3]."""
    rng = np.random.default_rng(seed)
    out = np.empty_like(gt_positions)
    smoothed = gt_positions[0]
    for t in range(gt_positions.shape[0]):
        smoothed = ema * smoothed + (1 - ema) * gt_positions[t]
        out[t] = smoothed + rng.normal(0, noise_std, smoothed.shape)
    save_mesh_predictions(scene_dir, faces, out)
    return out
