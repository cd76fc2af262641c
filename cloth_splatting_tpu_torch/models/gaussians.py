"""Capacity-padded, mesh-anchored Gaussian field (render side); counterpart
of ``cloth_splatting_tpu/models/gaussians.py``.

Every per-Gaussian tensor lives at a fixed CAPACITY ``C`` with an ``alive``
mask, so states compare row by row with the JAX package's. Positions are
barycentric coordinates on mesh faces; rotations compose a per-face rigid
rotation with a static per-Gaussian quaternion. Density control (clone,
split, prune, opacity reset, capacity growth) acts at fixed capacity: a new
Gaussian takes a dead slot, a pruned one only loses its ``alive`` bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.ops.image import inverse_sigmoid
from cloth_splatting_tpu_torch.ops.knn import mean_knn_sq_dist
from cloth_splatting_tpu_torch.ops.quaternion import (
    quat_multiply,
    quat_normalize,
    quat_to_rotmat,
    rotmat_to_quat,
)
from cloth_splatting_tpu_torch.ops.sh import rgb_to_sh
from cloth_splatting_tpu_torch.ops.smallmat import bmm33_nt, bmv3

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


def compute_edge_features(pos: torch.Tensor, edge_index: torch.Tensor):
    """(displacement [E, 3], length [E, 1]) of the edges, dst - src."""
    disp = pos[edge_index[1]] - pos[edge_index[0]]
    return disp, torch.linalg.norm(disp, dim=-1, keepdim=True)


def barycentric_coordinates(points: torch.Tensor, triangles: torch.Tensor,
                            eps: float = 1e-12) -> torch.Tensor:
    """Barycentric coordinates [N, 3] of points [N, 3] with respect to
    triangles [N, 3, 3]."""
    a, b, c = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    ab, ac, ap = b - a, c - a, points - a
    d00 = (ac * ac).sum(-1)
    d01 = (ac * ab).sum(-1)
    d02 = (ac * ap).sum(-1)
    d11 = (ab * ab).sum(-1)
    d12 = (ab * ap).sum(-1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(denom.abs() < eps, torch.full_like(denom, eps), denom)
    v = (d11 * d02 - d01 * d12) / denom
    w = (d00 * d12 - d01 * d02) / denom
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=1)


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


# --------------------------------------------------------------------------- #
# Density control (static shapes)
# --------------------------------------------------------------------------- #

def _rank_match_targets(src_mask: torch.Tensor, free_mask: torch.Tensor):
    """For each selected source (by rank) the free slot of equal rank.

    Returns (src_for_slot [C] int64, active [C] bool): every slot ``i`` that
    receives a copy has ``active[i]`` set and ``src_for_slot[i]`` its source
    (0 elsewhere). More sources than free slots: the surplus is dropped, and
    the callers report it."""
    c = src_mask.shape[0]
    dev = src_mask.device
    free_rank = torch.cumsum(free_mask, 0) - 1
    n_src = src_mask.sum()
    # src_of_rank[r] = index of the r-th selected source, -1 past the last
    src_of_rank = torch.full((c,), -1, dtype=torch.int64, device=dev)
    sources = src_mask.nonzero().squeeze(1)
    src_of_rank[:sources.numel()] = sources
    src_for_slot = src_of_rank[torch.clamp(free_rank, 0, c - 1)]
    active = free_mask & (free_rank < n_src) & (src_for_slot >= 0)
    return torch.where(active, src_for_slot, torch.zeros_like(src_for_slot)), active


def _row_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _copy_rows(params, src: torch.Tensor, dst_active: torch.Tensor,
               overrides: dict[str, torch.Tensor] | None = None):
    """Copy parameter rows src -> slot wherever ``dst_active``, with optional
    per-field overrides (already gathered to slot order). Generic over a
    NamedTuple of capacity-leading tensors."""
    overrides = overrides or {}
    return type(params)(**{
        k: torch.where(_row_mask(dst_active, v), overrides.get(k, v[src]), v)
        for k, v in params._asdict().items()})


class DensifyResult(NamedTuple):
    params: GaussianParams
    state: GaussianState
    touched: torch.Tensor   # [C] bool: slots whose Adam moments must be zeroed
    overflow: torch.Tensor  # scalar int: selected Gaussians that found no slot


def densify_clone(params: GaussianParams, state: GaussianState,
                  grads: torch.Tensor, grad_threshold, percent_dense: float,
                  scene_extent) -> DensifyResult:
    """Clone small high-gradient Gaussians into free slots."""
    max_scale = get_scaling(params).amax(dim=1)
    sel = ((grads >= grad_threshold)
           & (max_scale <= percent_dense * scene_extent) & state.alive)
    free = ~state.alive
    src, active = _rank_match_targets(sel, free)
    new_state = state._replace(
        face_ids=torch.where(active, state.face_ids[src], state.face_ids),
        alive=state.alive | active,
        max_radii2d=torch.where(active, torch.zeros_like(state.max_radii2d),
                                state.max_radii2d))
    overflow = torch.clamp_min(sel.sum() - free.sum(), 0)
    return DensifyResult(_copy_rows(params, src, active), new_state, active,
                         overflow)


def densify_split(params: GaussianParams, state: GaussianState, mesh: Mesh,
                  grads: torch.Tensor, grad_threshold, percent_dense: float,
                  scene_extent, eps: torch.Tensor) -> DensifyResult:
    """Split large high-gradient Gaussians into 2 jittered children: one
    replaces the parent's slot, its sibling lands in a free slot; scales
    shrink by 1 / (0.8 * 2) and the children's barycentric coordinates are
    taken against the parent's face. ``eps`` [2, C, 3] is the children's
    standard-normal jitter (the JAX package draws it from a key)."""
    n_split = 2
    scaling = get_scaling(params)
    max_scale = scaling.amax(dim=1)
    sel = ((grads >= grad_threshold)
           & (max_scale > percent_dense * scene_extent) & state.alive)

    xyz = gaussian_positions(params, state, mesh)
    rots = quat_to_rotmat(params.rotation)
    jitter = torch.stack([bmv3(rots, eps[i] * scaling) for i in range(n_split)])
    child_xyz = xyz[None] + jitter                                     # [2, C, 3]
    tri = mesh.pos[mesh.faces[state.face_ids]]                         # [C, 3, 3]
    child_bary = [barycentric_coordinates(child_xyz[i], tri)
                  for i in range(n_split)]
    new_scaling = torch.log(scaling / (0.8 * n_split))

    # child 0 overwrites the parent's slot
    p1 = params._replace(
        face_bary=torch.where(sel[:, None], child_bary[0], params.face_bary),
        scaling=torch.where(sel[:, None], new_scaling, params.scaling))

    # child 1 goes to a free slot
    free = ~state.alive
    src, active = _rank_match_targets(sel, free)
    p2 = _copy_rows(p1, src, active, {"face_bary": child_bary[1][src],
                                      "scaling": new_scaling[src]})
    new_state = state._replace(
        face_ids=torch.where(active, state.face_ids[src], state.face_ids),
        alive=state.alive | active,
        max_radii2d=torch.where(active | sel,
                                torch.zeros_like(state.max_radii2d),
                                state.max_radii2d))
    overflow = torch.clamp_min(sel.sum() - free.sum(), 0)
    return DensifyResult(p2, new_state, active | sel, overflow)


def prune(params: GaussianParams, state: GaussianState, min_opacity,
          scene_extent, max_screen_size: float | None) -> GaussianState:
    """Kill low-opacity Gaussians and, with ``max_screen_size``, oversized
    ones (on screen or in the world)."""
    mask = get_opacity(params) < min_opacity
    if max_screen_size is not None:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = get_scaling(params).amax(dim=1) > 0.1 * scene_extent
        mask = mask | big_vs | big_ws
    return state._replace(alive=state.alive & ~mask)


def reset_opacity(params: GaussianParams) -> tuple[GaussianParams, torch.Tensor]:
    """Clamp all opacities to <= 0.01. Returns (params, the touched mask for
    zeroing the moments)."""
    new_op = inverse_sigmoid(torch.clamp_max(torch.sigmoid(params.opacity), 0.01))
    return (params._replace(opacity=new_op),
            torch.ones(params.opacity.shape[0], dtype=torch.bool,
                       device=params.opacity.device))


def map_tensors(fn, tree: Any) -> Any:
    """``fn`` over every tensor leaf of nested NamedTuples / dicts / tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def grow_arrays(tree: Any, old_cap: int, new_cap: int) -> Any:
    """Pad every tensor leaf whose leading dim equals ``old_cap`` to
    ``new_cap`` with zeros; dead slots are masked by ``alive`` everywhere
    downstream."""

    def pad(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == old_cap:
            return torch.cat([leaf, leaf.new_zeros((new_cap - old_cap,)
                                                   + tuple(leaf.shape[1:]))])
        return leaf

    return map_tensors(pad, tree)


def grow_state_arrays(params: GaussianParams, gstate: GaussianState, g_opt: Any,
                      new_cap: int):
    """Grow (params, gstate, Adam moments) to ``new_cap`` with dead slots;
    dead rotations get identity quaternions (a zero quaternion is
    degenerate). No-op when ``new_cap`` <= the current capacity."""
    old_cap = params.face_bary.shape[0]
    if new_cap <= old_cap:
        return params, gstate, g_opt
    grown = grow_arrays(params, old_cap, new_cap)
    rotation = grown.rotation.clone()
    rotation[old_cap:, 0] = 1.0
    return (grown._replace(rotation=rotation),
            grow_arrays(gstate, old_cap, new_cap),
            grow_arrays(g_opt, old_cap, new_cap))


def zero_opt_rows(opt_state: Any, touched: torch.Tensor, capacity: int) -> Any:
    """Zero the optimizer-moment rows of touched slots: every floating
    tensor of the state whose leading dim equals the Gaussian capacity."""

    def fix(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == capacity \
                and leaf.is_floating_point():
            return torch.where(_row_mask(touched, leaf), torch.zeros_like(leaf),
                               leaf)
        return leaf

    return map_tensors(fix, opt_state)
