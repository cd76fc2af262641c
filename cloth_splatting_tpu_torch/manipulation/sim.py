"""Position-based-dynamics cloth simulator; counterpart of
``cloth_splatting_tpu/manipulation/sim.py``.

Particles on a grid (or on any triangle mesh) with structural, shear and
bending distance constraints, projected by Jacobi iterations with 1.5
over-relaxation; gravity, velocity damping, a ground plane with friction,
and kinematic grasp handles. Coordinates are y-up. The constraint sums are
``index_add_``, which runs in a fixed order on every device (the package
turns PyTorch's deterministic algorithms on).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device


class ClothParams(NamedTuple):
    dt: float = 0.01
    substeps: int = 4
    iterations: int = 12
    gravity: float = -9.81
    damping: float = 0.995
    stiffness: float = 1.0
    bend_stiffness: float = 0.35
    ground_y: float = 0.0
    friction: float = 0.6


class ClothState(NamedTuple):
    pos: torch.Tensor   # [N, 3] (y up)
    vel: torch.Tensor   # [N, 3]


class ClothConstraints(NamedTuple):
    edges: torch.Tensor       # [C, 2] particle index pairs (int64)
    rest_len: torch.Tensor    # [C]
    stiff: torch.Tensor       # [C] per-constraint stiffness
    inv_degree: torch.Tensor  # [N] 1 / constraint degree (Jacobi averaging)


def _constraints(pos: np.ndarray, edges: list, stiff: list, n: int,
                 dev: torch.device) -> ClothConstraints:
    edges = np.asarray(edges, np.int32)
    rest = np.linalg.norm(pos[edges[:, 0]] - pos[edges[:, 1]], axis=1)
    degree = np.zeros(n)
    np.add.at(degree, edges[:, 0], 1)
    np.add.at(degree, edges[:, 1], 1)
    return ClothConstraints(
        edges=torch.from_numpy(edges.astype(np.int64)).to(dev),
        rest_len=torch.from_numpy(rest.astype(np.float32)).to(dev),
        stiff=torch.from_numpy(np.asarray(stiff, np.float32)).to(dev),
        inv_degree=torch.from_numpy(
            (1.0 / np.maximum(degree, 1.0)).astype(np.float32)).to(dev))


def make_cloth(nx: int = 20, ny: int = 20, size: float = 0.3,
               height: float = 0.25, seed: int = 0,
               params: ClothParams = ClothParams(),
               device: str | torch.device = "cuda"):
    """A flat cloth grid hovering at ``height`` (y up). Returns (state,
    constraints, grid shape)."""
    dev = resolve_device(device)
    xs = np.linspace(-size / 2, size / 2, nx)
    zs = np.linspace(-size / 2, size / 2, ny)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([gx.ravel(), np.full(nx * ny, height), gz.ravel()], axis=1)

    def pid(i, j):
        return i * ny + j

    edges, stiff = [], []
    for i in range(nx):
        for j in range(ny):
            if i + 1 < nx:
                edges.append((pid(i, j), pid(i + 1, j))); stiff.append(params.stiffness)
            if j + 1 < ny:
                edges.append((pid(i, j), pid(i, j + 1))); stiff.append(params.stiffness)
            if i + 1 < nx and j + 1 < ny:
                edges.append((pid(i, j), pid(i + 1, j + 1))); stiff.append(params.stiffness)
                edges.append((pid(i + 1, j), pid(i, j + 1))); stiff.append(params.stiffness)
            if i + 2 < nx:
                edges.append((pid(i, j), pid(i + 2, j))); stiff.append(params.bend_stiffness)
            if j + 2 < ny:
                edges.append((pid(i, j), pid(i, j + 2))); stiff.append(params.bend_stiffness)

    state = ClothState(pos=torch.from_numpy(pos.astype(np.float32)).to(dev),
                       vel=torch.zeros((nx * ny, 3), dtype=torch.float32, device=dev))
    return state, _constraints(pos, edges, stiff, nx * ny, dev), (nx, ny)


def constraints_from_mesh(verts: np.ndarray, faces: np.ndarray,
                          params: ClothParams = ClothParams(),
                          device: str | torch.device = "cuda"
                          ) -> tuple[ClothState, ClothConstraints]:
    """PBD state and constraints of a triangle mesh: structural constraints
    on the unique face edges, bending constraints between the opposite
    vertices of each interior edge."""
    dev = resolve_device(device)
    verts = np.array(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    n = verts.shape[0]

    edge_opposite: dict[tuple[int, int], list[int]] = {}
    for tri in faces:
        for i in range(3):
            a, b = int(tri[i]), int(tri[(i + 1) % 3])
            e = (min(a, b), max(a, b))
            edge_opposite.setdefault(e, []).append(int(tri[(i + 2) % 3]))

    edges, stiff = [], []
    for e in sorted(edge_opposite):
        edges.append(e)
        stiff.append(params.stiffness)
    for e, opp in sorted(edge_opposite.items()):
        if len(opp) == 2 and opp[0] != opp[1]:
            edges.append((min(opp), max(opp)))
            stiff.append(params.bend_stiffness)

    state = ClothState(pos=torch.from_numpy(verts).to(dev),
                       vel=torch.zeros((n, 3), dtype=torch.float32, device=dev))
    return state, _constraints(verts, edges, stiff, n, dev)


def _project_constraints(p: torch.Tensor, cons: ClothConstraints,
                         pinned: torch.Tensor, iterations: int) -> torch.Tensor:
    """Jacobi PBD distance-constraint projection (scatter-add by
    ``index_add_``)."""
    e0, e1 = cons.edges[:, 0], cons.edges[:, 1]
    for _ in range(iterations):
        d = p[e1] - p[e0]
        dist = torch.clamp_min(torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-9)
        corr = cons.stiff[:, None] * 0.5 * (dist - cons.rest_len[:, None]) * d / dist
        delta = torch.zeros_like(p).index_add_(0, e0, corr).index_add_(0, e1, -corr)
        move = delta * cons.inv_degree[:, None] * 1.5        # over-relaxation
        p = p + torch.where(pinned[:, None], torch.zeros_like(move), move)
    return p


def _active_handles(grasp_idx, grasp_active) -> tuple[list[int], list[int]]:
    """(particles, handles): for each particle held by an active handle, the
    LAST active handle that holds it ("last wins" among duplicates)."""
    idx = np.atleast_1d(np.asarray(
        grasp_idx.cpu() if isinstance(grasp_idx, torch.Tensor) else grasp_idx))
    active = np.atleast_1d(np.asarray(
        grasp_active.cpu() if isinstance(grasp_active, torch.Tensor)
        else grasp_active)).astype(bool)
    active = np.broadcast_to(active, idx.shape)
    last: dict[int, int] = {}
    for h, (i, a) in enumerate(zip(idx.tolist(), active.tolist())):
        if a:
            last[int(i)] = h
    return list(last), list(last.values())


def cloth_step_multi(state: ClothState, cons: ClothConstraints, grasp_idx,
                     grasp_target: torch.Tensor, grasp_active,
                     params: ClothParams = ClothParams()) -> ClothState:
    """One control step (``params.substeps`` PBD substeps) with P kinematic
    grasp handles.

    Args:
        grasp_idx: [P] particle indices (host ints or a tensor; duplicates
            allowed: the last active handle of a particle wins).
        grasp_target: [P, 3] world positions each handle reaches at the end
            of the step (a tensor on the state's device).
        grasp_active: [P] bool (host or tensor).
    """
    n = state.pos.shape[0]
    dev = state.pos.device
    particles, handles = _active_handles(grasp_idx, grasp_active)
    pid = torch.tensor(particles, dtype=torch.int64, device=dev)
    hid = torch.tensor(handles, dtype=torch.int64, device=dev)
    pinned = torch.zeros(n, dtype=torch.bool, device=dev)
    pinned[pid] = True
    target = grasp_target.reshape(-1, 3)[hid]                    # [K, 3]
    start = state.pos[pid]                                       # [K, 3]
    sub_dt = params.dt
    gravity = torch.tensor([0.0, params.gravity, 0.0], dtype=torch.float32,
                           device=dev) * sub_dt
    friction = torch.tensor([1.0 - params.friction, 1.0, 1.0 - params.friction],
                            dtype=torch.float32, device=dev)

    pos, vel = state.pos, state.vel
    for i in range(params.substeps):
        frac = np.float32((i + 1.0) / params.substeps)
        target_i = start + (target - start) * frac
        vel = (vel + gravity) * params.damping
        p = pos + vel * sub_dt
        p = p.index_put((pid,), target_i)
        p = _project_constraints(p, cons, pinned, params.iterations)
        p = p.index_put((pid,), target_i)
        # ground collision with friction
        below = p[:, 1] < params.ground_y
        p[:, 1].clamp_(min=params.ground_y)
        new_vel = (p - pos) / sub_dt
        vel = torch.where(below[:, None], new_vel * friction, new_vel)
        pos = p
    return ClothState(pos=pos, vel=vel)


def cloth_step(state: ClothState, cons: ClothConstraints, grasp_idx,
               grasp_target: torch.Tensor, grasp_active,
               params: ClothParams = ClothParams()) -> ClothState:
    """Single-handle form of :func:`cloth_step_multi`."""
    return cloth_step_multi(state, cons, [int(grasp_idx)],
                            grasp_target.reshape(1, 3), [bool(grasp_active)],
                            params)


def settle(state: ClothState, cons: ClothConstraints, n_steps: int = 50,
           params: ClothParams = ClothParams()) -> ClothState:
    """Let the cloth fall and settle with no grasp."""
    target = state.pos[0]
    for _ in range(n_steps):
        state = cloth_step(state, cons, 0, target, False, params)
    return state
