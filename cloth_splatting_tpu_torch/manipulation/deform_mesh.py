"""Randomized deformed-cloth-mesh generation over the PBD simulator;
counterpart of ``cloth_splatting_tpu/manipulation/deform_mesh.py``.

Per sample: randomized physical parameters, the rest mesh tilted in (x, z)
and turned by a random yaw, dropped and settled, a keypoint or random
particle grasped and folded along a circular arc biased toward the cloth
centre (ARTF) or dragged straight (ClothFunnels), released and settled;
the observed mesh sequence is exported as ``meshes/%06d.obj`` with
``cam_params/camera_params.json`` and ``images/cloth_observations.h5``
(rgb and depth per camera from a point-splat z-buffer, and the particle
history; needs ``h5py``). The cloth lives on ``device``; the draws are
numpy's, the JAX package's in its order.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.manipulation.sim import (
    ClothConstraints,
    ClothParams,
    ClothState,
    cloth_step,
    constraints_from_mesh,
    make_cloth,
)
from cloth_splatting_tpu_torch.manipulation.trajectory_gen import circular_actions


# --------------------------------------------------------------------- config


@dataclasses.dataclass
class DeformationConfig:
    pass


@dataclasses.dataclass
class ARTFDeformationConfig(DeformationConfig):
    """Drop + keypoint-biased circular fold (reference deform_mesh.py:70-95)."""

    max_bending_stiffness: float = 0.025
    max_stretch_stiffness: float = 2.0
    max_drag: float = 0.00001
    max_fold_distance: float = 0.6
    max_orientation_angle: float = np.pi / 4
    fold_probability: float = 0.6
    grasp_keypoint_vertex_probability: float = 0.5


@dataclasses.dataclass
class ClothFunnelsDeformationConfig(DeformationConfig):
    """Drop + random straight drag (reference deform_mesh.py:380-400)."""

    max_distance: float = 0.4
    max_height: float = 0.3


# ---------------------------------------------------------------------- OBJ IO


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Minimal OBJ writer (v + f records, 1-indexed faces)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(faces):
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader -> (vertices [V,3], faces [F,3] 0-indexed)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


# --------------------------------------------------------------- cheap cameras


def _rotation(angle: float, axis) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)


def camera_rig(size: int = 128, fov_deg: float = 60.0) -> dict:
    """Two fixed cameras (top-down-ish and oblique) with intrinsics and
    world->camera extrinsics, mirroring the reference's camera_params.json
    export (deform_mesh.py:239-270)."""
    f = (size / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)
    K = np.array([[f, 0, size / 2.0], [0, f, size / 2.0], [0, 0, 1.0]])
    rigs = {}
    for name, (pos, pitch, yaw) in {
        "camera_0": (np.array([0.0, 0.9, 0.0]), -np.pi / 2 + 1e-3, 0.0),
        "camera_1": (np.array([0.0, 0.6, 0.6]), -np.pi / 4, 0.0),
    }.items():
        R = _rotation(-pitch, [1, 0, 0]) @ _rotation(-yaw, [0, 1, 0])
        ext = np.eye(4)
        ext[:3, :3] = R
        ext[:3, 3] = -R @ pos
        rigs[name] = {"intrinsic": K.tolist(), "extrinsic": ext.tolist(),
                      "size": [size, size]}
    return rigs


def render_point_splat(positions: np.ndarray, cam: dict) -> tuple[np.ndarray, np.ndarray]:
    """Z-buffered point-splat rgb/depth of the particle cloud from one camera
    (stand-in for the reference's PyFleX render; rgb = depth-shaded gray)."""
    K = np.asarray(cam["intrinsic"])
    ext = np.asarray(cam["extrinsic"])
    h, w = cam["size"]
    p_cam = (ext[:3, :3] @ positions.T + ext[:3, 3:4]).T    # [N, 3]
    z = -p_cam[:, 2] if np.median(p_cam[:, 2]) < 0 else p_cam[:, 2]
    valid = z > 1e-4
    u = (K[0, 0] * p_cam[:, 0] / np.maximum(z, 1e-6) + K[0, 2]).astype(int)
    v = (K[1, 1] * p_cam[:, 1] / np.maximum(z, 1e-6) + K[1, 2]).astype(int)
    inside = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.full((h, w), np.inf, np.float32)
    # far first so near overwrites
    for i in np.flatnonzero(inside)[np.argsort(-z[inside])]:
        depth[v[i], u[i]] = z[i]
    finite = np.isfinite(depth)
    rgb = np.zeros((h, w, 3), np.float32)
    if finite.any():
        zmin, zmax = depth[finite].min(), depth[finite].max()
        shade = 1.0 - (depth - zmin) / max(zmax - zmin, 1e-6)
        rgb[finite] = shade[finite, None]
    depth[~finite] = 0.0
    return rgb, depth


# ------------------------------------------------------------------ deformation


def wait_until_stable(state: ClothState, cons: ClothConstraints,
                      params: ClothParams, max_steps: int = 200,
                      tolerance: float = 0.05) -> ClothState:
    """Step with no grasp until the largest particle speed is below
    ``tolerance``."""
    for _ in range(max_steps):
        state = cloth_step(state, cons, 0, state.pos[0], False, params)
        if float(state.vel.abs().max()) < tolerance:
            break
    return state


def grid_keypoints(nx: int, ny: int) -> dict[str, int]:
    """Corner/edge-midpoint/center keypoint vertices of the nx x ny grid
    (the reference reads these from the mesh's sibling .json)."""
    pid = lambda i, j: i * ny + j
    return {
        "corner_00": pid(0, 0), "corner_01": pid(0, ny - 1),
        "corner_10": pid(nx - 1, 0), "corner_11": pid(nx - 1, ny - 1),
        "edge_top": pid(nx // 2, 0), "edge_bottom": pid(nx // 2, ny - 1),
        "edge_left": pid(0, ny // 2), "edge_right": pid(nx - 1, ny // 2),
        "center": pid(nx // 2, ny // 2),
    }


def _sampled_params(rng: np.random.Generator,
                    config: ARTFDeformationConfig) -> ClothParams:
    """Randomized physical parameters mapped onto the PBD stepper
    (reference deform_mesh.py:230-276: friction/drag/stretch/bend draws)."""
    stretch = float(rng.uniform(0.5, config.max_stretch_stiffness))
    bend = float(rng.uniform(0.01, config.max_bending_stiffness))
    friction = float(rng.uniform(0.3, 1.0))
    drag = float(rng.uniform(config.max_drag / 5, config.max_drag))
    return ClothParams(
        stiffness=min(1.0, stretch),
        bend_stiffness=min(1.0, bend * 20.0),   # PBD stiffness is [0, 1]
        friction=friction,
        damping=0.995 - drag * 1e3,
    )


def deform_mesh(config: DeformationConfig, undeformed, out_dir: str,
                rng: np.random.Generator | None = None,
                nx: int = 16, ny: int = 16, cloth_size: float = 0.3,
                fold_steps: int = 24, image_size: int = 128,
                keypoints: dict[str, int] | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Generate one randomized deformed mesh sample.

    Args:
        undeformed: path to an .obj, or None to use the nx x ny grid cloth.
        out_dir: sample directory; writes meshes/%06d.obj,
            cam_params/camera_params.json, images/cloth_observations.h5.

    Returns a dict with the particle history and grasp metadata.
    """
    import h5py

    dev = resolve_device(device)
    rng = rng or np.random.default_rng()
    mesh_dir = os.path.join(out_dir, "meshes")
    cam_dir = os.path.join(out_dir, "cam_params")
    img_dir = os.path.join(out_dir, "images")
    for d in (mesh_dir, cam_dir, img_dir):
        os.makedirs(d, exist_ok=True)

    if isinstance(config, ARTFDeformationConfig):
        params = _sampled_params(rng, config)
    else:
        params = ClothParams()

    if undeformed is not None:
        verts, faces = load_obj(undeformed)
        kp_path = str(undeformed).replace(".obj", ".json")
        if keypoints is None and os.path.exists(kp_path):
            with open(kp_path) as f:
                keypoints = json.load(f)["keypoint_vertices"]
        # simulate the obj's own topology (structural and bending
        # constraints derived from its faces), not the grid
        state, cons = constraints_from_mesh(verts, faces, params, device=dev)
        if keypoints is None:
            # fall back to the mesh's bounding-box extremes as keypoints
            idx = [int(np.argmin(verts[:, 0] + verts[:, 2])),
                   int(np.argmax(verts[:, 0] - verts[:, 2])),
                   int(np.argmin(verts[:, 0] - verts[:, 2])),
                   int(np.argmax(verts[:, 0] + verts[:, 2]))]
            keypoints = {f"corner_{i}": v for i, v in enumerate(idx)}
    else:
        verts = faces = None
        state, cons, _ = make_cloth(nx, ny, cloth_size, height=0.3,
                                    params=params, device=dev)
        if keypoints is None:
            keypoints = grid_keypoints(nx, ny)

    # random orientation: (x, z) tilt then free yaw (deform_mesh.py:298-318)
    if isinstance(config, ARTFDeformationConfig):
        tilt = _rotation(rng.uniform(0, config.max_orientation_angle), [1, 0, 0]) \
            @ _rotation(rng.uniform(0, config.max_orientation_angle), [0, 0, 1])
    else:
        tilt = np.eye(3)
    yaw = _rotation(rng.uniform(0, 2 * np.pi), [0, 1, 0])
    pos0 = state.pos.cpu().numpy()
    center = pos0.mean(axis=0)
    pos0 = (pos0 - center) @ (tilt @ yaw).T
    pos0[:, 1] += 0.3 - pos0[:, 1].min()
    state = ClothState(pos=torch.as_tensor(np.asarray(pos0, np.float32), device=dev),
                       vel=state.vel)

    # drop
    state = wait_until_stable(state, cons, params, max_steps=300)
    history = [state.pos.cpu().numpy()]
    n_particles = state.pos.shape[0]

    grasp_idx = 0
    if isinstance(config, ARTFDeformationConfig):
        if rng.uniform() < config.grasp_keypoint_vertex_probability:
            grasp_idx = int(list(keypoints.values())[
                rng.integers(len(keypoints))])
        else:
            grasp_idx = int(rng.integers(n_particles))

        fold_distance = float(rng.uniform(0.1, config.max_fold_distance))
        cloth_center = history[0].mean(axis=0)
        vpos = history[0][grasp_idx]
        center_dir = np.arctan2(cloth_center[2] - vpos[2],
                                cloth_center[0] - vpos[0])
        fold_dir = rng.normal(center_dir, np.pi / 6)
        fold_vec = np.array([np.cos(fold_dir), 0.0, np.sin(fold_dir)]) * fold_distance
        actions = circular_actions(vpos, vpos + fold_vec, fold_steps,
                                   max_angle=np.pi * 0.9)
    else:
        grasp_idx = int(rng.integers(n_particles))
        distance = rng.uniform(0, config.max_distance)
        height = rng.uniform(0, config.max_height)
        angle = rng.uniform(0, 2 * np.pi)
        offset = np.array([np.cos(angle) * distance, height,
                           np.sin(angle) * distance])
        vpos = history[0][grasp_idx]
        path = np.linspace(vpos, vpos + offset, fold_steps + 1)
        actions = np.diff(path, axis=0)

    for a in actions:
        target = state.pos[grasp_idx] + torch.as_tensor(np.asarray(a, np.float32),
                                                        device=dev)
        state = cloth_step(state, cons, grasp_idx, target, True, params)
        history.append(state.pos.cpu().numpy())

    # release + settle
    state = wait_until_stable(state, cons, params, max_steps=200)
    history.append(state.pos.cpu().numpy())
    history = np.stack(history)

    # ------------------------------------------------------------- exports
    rig = camera_rig(size=image_size)
    with open(os.path.join(cam_dir, "camera_params.json"), "w") as f:
        json.dump(rig, f)

    if faces is None:
        from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh

        faces = grid_cloth_mesh(nx, ny, size=cloth_size, device="cpu").faces.numpy()
    for idx, pos in enumerate(history):
        write_obj(os.path.join(mesh_dir, f"{idx:06d}.obj"), pos, faces)

    obs = {}
    for name, cam in rig.items():
        rgb, depth = render_point_splat(history[-1], cam)
        obs[f"{name}_rgb"] = rgb
        obs[f"{name}_depth"] = depth
    with h5py.File(os.path.join(img_dir, "cloth_observations.h5"), "w") as hf:
        for k, v in obs.items():
            hf.create_dataset(k, data=v)
        hf.create_dataset("particles", data=history)

    return {"particles": history, "grasp_idx": grasp_idx, "faces": faces,
            "keypoints": keypoints}


def generate_deformed_meshes(config: DeformationConfig, out_root: str,
                             n_samples: int = 4, seed: int = 0,
                             **kwargs) -> list[str]:
    """``n_samples`` samples of ``deform_mesh``, one subdirectory each, from
    one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    dirs = []
    for i in range(n_samples):
        d = os.path.join(out_root, f"sample_{i:04d}")
        deform_mesh(config, None, d, rng=rng, **kwargs)
        dirs.append(d)
    return dirs
