"""Capacity-padded, mesh-anchored Gaussian field (render side); counterpart
of ``cloth_splatting_tpu/models/gaussians.py``.

Every per-Gaussian tensor lives at a fixed CAPACITY ``C`` with an ``alive``
mask, so states compare row by row with the JAX package's. Positions are
barycentric coordinates on mesh faces; rotations compose a per-face rigid
rotation with a static per-Gaussian quaternion. Density control is not part
of the serving path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.ops.image import inverse_sigmoid
from cloth_splatting_tpu_torch.ops.knn import mean_knn_sq_dist
from cloth_splatting_tpu_torch.ops.quaternion import (
    quat_multiply,
    quat_normalize,
    rotmat_to_quat,
)
from cloth_splatting_tpu_torch.ops.sh import rgb_to_sh
from cloth_splatting_tpu_torch.ops.smallmat import bmm33_nt

CAPACITY_ROUND = 512


class GaussianParams(NamedTuple):
    """Per-Gaussian parameters at capacity C (raw, pre-activation)."""

    face_bary: torch.Tensor      # [C, 3] barycentric coords (normalized on use)
    face_offset: torch.Tensor    # [C, 1] normal offset (unused)
    features_dc: torch.Tensor    # [C, 1, 3] SH DC
    features_rest: torch.Tensor  # [C, K-1, 3] SH rest
    scaling: torch.Tensor        # [C, 3] log-scales
    rotation: torch.Tensor       # [C, 4] WXYZ quaternion (unnormalized)
    opacity: torch.Tensor        # [C, 1] logit opacity


class GaussianState(NamedTuple):
    """Non-trainable bookkeeping at capacity C."""

    face_ids: torch.Tensor       # [C] int64 face assignment
    alive: torch.Tensor          # [C] bool
    max_radii2d: torch.Tensor    # [C] running max screen radius
    grad_accum: torch.Tensor     # [C] accumulated viewspace-grad norms
    denom: torch.Tensor          # [C] accumulation counts


class Mesh(NamedTuple):
    """A triangle mesh (static topology) backing the Gaussians."""

    pos: torch.Tensor         # [V, 3] rest-state vertex positions
    faces: torch.Tensor       # [F, 3] int64
    edge_index: torch.Tensor  # [2, E] int64
    edge_norm: torch.Tensor   # [E, 1] rest-state edge lengths
    normals: torch.Tensor     # [V, 3] area-weighted vertex normals


def compute_vertex_normals(pos: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals."""
    v0, v1, v2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(pos)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    norm = torch.linalg.norm(vn, dim=-1, keepdim=True)
    return vn / torch.clamp_min(norm, 1e-12)


# --------------------------------------------------------------------------- #
# Activations
# --------------------------------------------------------------------------- #

def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)[:, 0]


def get_features(params: GaussianParams) -> torch.Tensor:
    """[C, K, 3] full SH stack."""
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def num_alive(state: GaussianState) -> torch.Tensor:
    return state.alive.sum()


def add_densification_stats(state: GaussianState, xy_grad_norm: torch.Tensor,
                            radii: torch.Tensor,
                            visibility: torch.Tensor) -> GaussianState:
    """Accumulate the viewspace gradient norms, visible counts and running
    max screen radii of the visible Gaussians."""
    zero = torch.zeros_like(xy_grad_norm)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visibility, xy_grad_norm, zero),
        denom=state.denom + visibility.to(state.denom.dtype),
        max_radii2d=torch.where(visibility,
                                torch.maximum(state.max_radii2d, radii),
                                state.max_radii2d))


# --------------------------------------------------------------------------- #
# Initialization
# --------------------------------------------------------------------------- #

def round_capacity(n: int) -> int:
    return max(CAPACITY_ROUND, int(np.ceil(n / CAPACITY_ROUND)) * CAPACITY_ROUND)


def init_from_mesh(
    rng: np.random.Generator,
    mesh: Mesh,
    sh_degree: int,
    gaussian_init_factor: int = 2,
    capacity: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[GaussianParams, GaussianState]:
    """``gaussian_init_factor`` Gaussians per face: bary = clip(N(1/3, 0.05),
    0, 1) renormalized, near-black SH DC, identity quaternions, opacity
    logit of 0.1, log-scales from sqrt(mean 3-NN squared distance).

    Draws the same numpy random numbers in the same order as the JAX
    package's ``init_from_mesh``; the kNN runs on ``device``."""
    dev = resolve_device(device)
    faces = mesh.faces.cpu().numpy()
    n_faces = faces.shape[0]
    n = gaussian_init_factor * n_faces
    cap = capacity or round_capacity(n)
    k = (sh_degree + 1) ** 2

    bary = np.full((cap, 3), 1.0 / 3.0, dtype=np.float32)
    if gaussian_init_factor > 1:
        noise = rng.normal(1.0 / 3.0, 0.05, size=(n, 3)).astype(np.float32)
        bary[:n] = np.clip(noise, 0.0, 1.0)
        bary[:n] /= np.maximum(bary[:n].sum(axis=1, keepdims=True), 1e-8)

    face_ids = np.zeros(cap, dtype=np.int64)
    face_ids[:n] = np.sort(np.tile(np.arange(n_faces), gaussian_init_factor))

    shs = rng.random((n, 3)).astype(np.float32) / 255.0
    fdc = np.zeros((cap, 1, 3), dtype=np.float32)
    fdc[:n, 0] = rgb_to_sh(shs)
    frest = np.zeros((cap, k - 1, 3), dtype=np.float32)

    rots = np.zeros((cap, 4), dtype=np.float32)
    rots[:, 0] = 1.0

    opac = np.full((cap, 1), float(inverse_sigmoid(torch.tensor(0.1))),
                   dtype=np.float32)

    pos_v = mesh.pos.cpu().numpy()
    tri = pos_v[faces[face_ids[:n]]]                       # [n, 3, 3]
    pts = np.einsum("nb,nbx->nx", bary[:n], tri)
    dist2 = mean_knn_sq_dist(torch.from_numpy(pts).to(dev)).cpu().numpy()
    scales = np.zeros((cap, 3), dtype=np.float32)
    scales[:n] = np.log(np.sqrt(np.clip(dist2, 1e-7, None)))[:, None]

    alive = np.zeros(cap, dtype=bool)
    alive[:n] = True

    def t(a):
        return torch.from_numpy(a).to(dev)

    params = GaussianParams(
        face_bary=t(bary),
        face_offset=torch.zeros((cap, 1), device=dev),
        features_dc=t(fdc),
        features_rest=t(frest),
        scaling=t(scales),
        rotation=t(rots),
        opacity=t(opac),
    )
    state = GaussianState(
        face_ids=t(face_ids),
        alive=t(alive),
        max_radii2d=torch.zeros(cap, device=dev),
        grad_accum=torch.zeros(cap, device=dev),
        denom=torch.zeros(cap, device=dev),
    )
    return params, state


# --------------------------------------------------------------------------- #
# Mesh anchoring: positions / rotations from (deformed) vertices
# --------------------------------------------------------------------------- #

def gaussian_positions(params: GaussianParams, state: GaussianState, mesh: Mesh,
                       vertices: torch.Tensor | None = None) -> torch.Tensor:
    """Barycentric positions on (possibly deformed) mesh faces."""
    verts = mesh.pos if vertices is None else vertices
    tri = verts[mesh.faces[state.face_ids]]                   # [C, 3, 3]
    bsum = params.face_bary.sum(dim=1, keepdim=True)
    norm_bary = params.face_bary / torch.where(
        bsum.abs() < 1e-8, torch.full_like(bsum, 1e-8), bsum)
    return (norm_bary[:, 0:1] * tri[:, 0]
            + norm_bary[:, 1:2] * tri[:, 1]
            + norm_bary[:, 2:3] * tri[:, 2])


def _triangle_frames(tri: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Orthonormal frame per triangle [N, 3, 3], columns (edge, in-plane
    perpendicular, normal); rsqrt(ss + eps) keeps degenerate triangles
    finite."""
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e1, e2)
    e1 = e1 * torch.rsqrt((e1 * e1).sum(-1, keepdim=True) + eps)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + eps)
    t = torch.linalg.cross(n, e1)
    return torch.stack([e1, t, n], dim=-1)


def face_rotations(mesh: Mesh, deformed_vertices: torch.Tensor) -> torch.Tensor:
    """Per-face rigid rotation rest -> deformed as WXYZ quaternions [F, 4]:
    R = F_deformed @ F_rest^T of the triangles' orthonormal frames."""
    f_rest = _triangle_frames(mesh.pos[mesh.faces])
    f_def = _triangle_frames(deformed_vertices[mesh.faces])
    return rotmat_to_quat(bmm33_nt(f_def, f_rest))


def gaussian_rotations(params: GaussianParams, state: GaussianState, mesh: Mesh,
                       deformed_vertices: torch.Tensor | None = None) -> torch.Tensor:
    """World-frame WXYZ rotations: face rigid rotation composed with the
    static per-Gaussian quaternion."""
    q_static = quat_normalize(params.rotation)
    if deformed_vertices is None:
        return q_static
    q_face = face_rotations(mesh, deformed_vertices)
    return quat_multiply(q_face[state.face_ids], q_static)
