"""Host-side mesh construction; counterpart of
``cloth_splatting_tpu/data/meshing.py`` (numpy/scipy, once per scene)."""

from __future__ import annotations

import numpy as np
import scipy.spatial
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.gaussians import Mesh, compute_vertex_normals


def faces_to_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges [2, E] (both directions) from triangles [F, 3]."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
                       axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    both = np.concatenate([e, e[:, ::-1]], axis=0)
    return both.T.astype(np.int32)


def delaunay_mesh(points: np.ndarray, plane_axes=(0, 1),
                  device: str | torch.device = "cuda") -> Mesh:
    """Triangulate points by their projection onto a plane (default xy) into a
    Mesh (faces, bidirectional edges, rest lengths, normals) on ``device``."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    pos2d = points[:, list(plane_axes)]
    tri = scipy.spatial.Delaunay(pos2d, qhull_options="QJ")
    faces = tri.simplices.astype(np.int64)
    edge_index = faces_to_edges(faces).astype(np.int64)
    disp = points[edge_index[1]] - points[edge_index[0]]
    edge_norm = np.linalg.norm(disp, axis=1, keepdims=True).astype(np.float32)
    pos = torch.from_numpy(points).to(dev)
    faces_t = torch.from_numpy(faces).to(dev)
    return Mesh(pos=pos, faces=faces_t,
                edge_index=torch.from_numpy(edge_index).to(dev),
                edge_norm=torch.from_numpy(edge_norm).to(dev),
                normals=compute_vertex_normals(pos, faces_t))


def grid_cloth_mesh(nx: int = 10, ny: int = 10, size: float = 1.0,
                    z: float = 0.0, noise: float = 0.0, seed: int = 0,
                    device: str | torch.device = "cuda") -> Mesh:
    """A regular cloth grid mesh for tests and synthetic scenes."""
    xs = np.linspace(-size / 2, size / 2, nx)
    ys = np.linspace(-size / 2, size / 2, ny)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel(), np.full(nx * ny, z)], axis=1)
    if noise > 0:
        pts = pts + np.random.default_rng(seed).normal(0, noise, pts.shape)
    return delaunay_mesh(pts.astype(np.float32), device=device)
