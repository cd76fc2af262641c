"""HDF5 mesh IO; counterpart of ``cloth_splatting_tpu/data/mesh_io.py``, the
``init_mesh.hdf5`` / ``mesh_predictions/mesh_*.hdf5`` contract: datasets
``pos`` [V, 3], ``norm`` [V, 3], ``face`` [3, F], ``edge_index`` [2, E].

``h5py`` is imported inside the functions: a fit from banks that were
rendered in memory never needs it."""

from __future__ import annotations

import os

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.gaussians import Mesh, compute_vertex_normals


def load_mesh_h5(path: str, device: str | torch.device = "cuda") -> Mesh:
    import h5py

    dev = resolve_device(device)
    with h5py.File(path, "r") as f:
        pos = np.asarray(f["pos"][:], dtype=np.float32)
        faces = np.asarray(f["face"][:], dtype=np.int64).T        # [3, F] -> [F, 3]
        edge_index = np.asarray(f["edge_index"][:], dtype=np.int64)
        norm = np.asarray(f["norm"][:], dtype=np.float32) if "norm" in f else None
    disp = pos[edge_index[1]] - pos[edge_index[0]]
    edge_norm = np.linalg.norm(disp, axis=1, keepdims=True).astype(np.float32)
    pos_t = torch.from_numpy(pos).to(dev)
    faces_t = torch.from_numpy(faces).to(dev)
    normals = (torch.from_numpy(norm).to(dev) if norm is not None
               else compute_vertex_normals(pos_t, faces_t))
    return Mesh(pos=pos_t, faces=faces_t,
                edge_index=torch.from_numpy(edge_index).to(dev),
                edge_norm=torch.from_numpy(edge_norm).to(dev), normals=normals)


def save_mesh_h5(path: str, mesh: Mesh) -> None:
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("pos", data=mesh.pos.cpu().numpy().astype(np.float32))
        f.create_dataset("norm", data=mesh.normals.cpu().numpy().astype(np.float32))
        f.create_dataset("face", data=mesh.faces.cpu().numpy().astype(np.int64).T)
        f.create_dataset("edge_index",
                         data=mesh.edge_index.cpu().numpy().astype(np.int64))


def save_positions_h5(path: str, mesh: Mesh, positions: np.ndarray) -> None:
    """Save a mesh prediction: same topology, new vertex positions."""
    pos = torch.as_tensor(positions, dtype=torch.float32, device=mesh.pos.device)
    save_mesh_h5(path, mesh._replace(
        pos=pos, normals=compute_vertex_normals(pos, mesh.faces)))
