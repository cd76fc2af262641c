"""Host-side mesh construction; counterpart of
``cloth_splatting_tpu/data/meshing.py`` (numpy/scipy, once per scene or
trajectory): Delaunay meshes, the GNN's thresholded Delaunay and kNN edge
sets, and farthest-point subsampling."""

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


def delaunay_edges(points: np.ndarray, plane_axes=(0, 1),
                   norm_threshold: float | None = 0.01):
    """(edge_index [2, E] single-direction, faces [F, 3]) with threshold
    pruning: an edge joins the graph only if shorter than the threshold, and a
    face survives only if all three edges do."""
    points = np.asarray(points)
    pos2d = points[:, list(plane_axes)]
    tri = scipy.spatial.Delaunay(pos2d)
    edges = set()
    faces = []
    for simplex in tri.simplices:
        ok = True
        for i in range(3):
            p1, p2 = int(simplex[i]), int(simplex[(i + 1) % 3])
            e = (min(p1, p2), max(p1, p2))
            if norm_threshold is not None and \
                    np.linalg.norm(pos2d[p1] - pos2d[p2]) > norm_threshold:
                ok = False
            else:
                edges.add(e)
        if ok:
            faces.append(simplex)
    edge_index = np.asarray(sorted(edges), dtype=np.int64).T
    faces_arr = np.asarray(faces, dtype=np.int64)
    return edge_index, faces_arr


def knn_edges(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Undirected kNN edge set [2, E] (each pair once)."""
    tree = scipy.spatial.cKDTree(points)
    _, idx = tree.query(points, k=k + 1)
    pairs = {tuple(sorted((i, int(j)))) for i, row in enumerate(idx) for j in row[1:]}
    return np.asarray(sorted(pairs), dtype=np.int64).T


def farthest_point_sampling(points: np.ndarray, num_samples: int,
                            seed: int = 0) -> np.ndarray:
    """Greedy farthest-point subsampling; returns selected indices."""
    n = points.shape[0]
    num_samples = min(num_samples, n)
    rng = np.random.default_rng(seed)
    selected = np.empty(num_samples, dtype=np.int64)
    selected[0] = rng.integers(n)
    dist = np.linalg.norm(points - points[selected[0]], axis=1)
    for i in range(1, num_samples):
        selected[i] = int(np.argmax(dist))
        dist = np.minimum(dist, np.linalg.norm(points - points[selected[i]], axis=1))
    return selected


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
