"""Demo recording and imitation over the PBD cloth environment; counterpart
of ``cloth_splatting_tpu/manipulation/imitation.py``: record a scripted
fold demo with a tracked subsampled graph, replay it on a new cloth by
keypoint correspondence, and score it by the covered area (Cloth-Funnels'
grid-stamp coverage). numpy over ``manipulation.env.ClothEnv``; ``h5py`` is
imported by the functions that write or read ``data.h5``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from cloth_splatting_tpu_torch.data.meshing import (
    delaunay_edges,
    farthest_point_sampling,
)
from cloth_splatting_tpu_torch.manipulation.env import ClothEnv
from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions


# ------------------------------------------------------------------ coverage


def covered_area(positions: np.ndarray, particle_radius: float = 0.00625,
                 grid: int = 100) -> float:
    """Ground-plane area covered by particle disks (eval_utils.py:22-57):
    discretize the xz bounding box into a grid x grid lattice, stamp each
    particle's radius footprint, count cells x cell area. y-up convention."""
    pos2d = positions[:, [0, 2]]
    lo = pos2d.min(axis=0)
    hi = pos2d.max(axis=0)
    span = np.maximum((hi - lo) / grid, 1e-9)
    covered = np.zeros((grid + 1, grid + 1), bool)
    offset = pos2d - lo
    x_lo = np.maximum(np.round((offset[:, 0] - particle_radius) / span[0]).astype(int), 0)
    x_hi = np.minimum(np.round((offset[:, 0] + particle_radius) / span[0]).astype(int), grid)
    y_lo = np.maximum(np.round((offset[:, 1] - particle_radius) / span[1]).astype(int), 0)
    y_hi = np.minimum(np.round((offset[:, 1] + particle_radius) / span[1]).astype(int), grid)
    for a, b, c, d in zip(x_lo, x_hi, y_lo, y_hi):
        covered[a:b + 1, c:d + 1] = True
    return float(covered.sum() * span[0] * span[1])


# ---------------------------------------------------------------------- demos


@dataclasses.dataclass
class HalfFoldConfig:
    """Two corner-to-corner pick/places (imitation.py:58-68)."""

    num_pick_places: int = 2
    picks: tuple[int, ...] = (0, 3)    # keypoint indices into env corners
    places: tuple[int, ...] = (1, 2)
    height: float = 0.1
    n_steps: int = 12


def record_demo(env: ClothEnv, config: HalfFoldConfig,
                num_graph_samples: int = 50,
                out_path: str | None = None,
                particle_radius: float = 0.02) -> dict:
    """Execute the scripted fold and record a demo dict: particle history,
    tracked subsampled graph, keypoint ids, pick/place actions, coverage.

    The tracked graph is FPS-subsampled from the first observation and its
    Delaunay edge_index is fixed for the whole demo (imitation.py:91-115)."""
    env.reset()
    points0 = env.positions
    n = points0.shape[0]
    num_graph_samples = min(num_graph_samples, n)
    graph_ids = farthest_point_sampling(points0, num_graph_samples)
    graph0 = points0[graph_ids]
    edge_index, _ = delaunay_edges(graph0, plane_axes=(0, 2),
                                   norm_threshold=0.1)
    keypoints = env.keypoint_ids()
    graph_keypoints = np.array([
        int(np.argmin(np.linalg.norm(graph0 - points0[k], axis=1)))
        for k in keypoints])

    demo = {
        "graph_ids": np.asarray(graph_ids), "edge_index": edge_index,
        "keypoints_ids": np.asarray(keypoints),
        "graph_keypoints_ids": graph_keypoints,
        "pos": [points0], "graph": [graph0],
        "coverage": [covered_area(points0, particle_radius)],
        "actions": [],
    }

    corners = env.corner_ids
    for pick_slot, place_slot in zip(config.picks, config.places):
        pick_idx = corners[pick_slot]
        place = env.positions[corners[place_slot]]
        pick = env.positions[pick_idx]
        env.grasp_particle(pick_idx)
        for a in bezier_actions(pick, place, config.height, config.n_steps):
            env.step(a)
        env.release()
        demo["actions"].append(np.concatenate([pick, place]))
        demo["pos"].append(env.positions)
        demo["graph"].append(env.positions[graph_ids])
        demo["coverage"].append(covered_area(env.positions, particle_radius))

    demo["pos"] = np.stack(demo["pos"])
    demo["graph"] = np.stack(demo["graph"])
    demo["coverage"] = np.asarray(demo["coverage"])
    demo["actions"] = np.stack(demo["actions"])

    if out_path is not None:
        import h5py

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with h5py.File(out_path, "w") as hf:
            for k, v in demo.items():
                hf.create_dataset(k, data=np.asarray(v))
    return demo


def load_demo(path: str) -> dict:
    """A demo written by ``record_demo`` (``data.h5``) as a dict."""
    import h5py

    with h5py.File(path, "r") as f:
        return {key: np.array(f[key]) for key in f.keys()}


def imitate_demo(demo: dict, env: ClothEnv, height: float = 0.1,
                 n_steps: int = 12, particle_radius: float = 0.02) -> dict:
    """Replay a demo on a (possibly different) cloth instance: map each
    recorded pick/place onto the new cloth by nearest-keypoint
    correspondence, execute bezier pick-and-places, and score the imitation
    by coverage ratio + final graph-position error (imitation.py:130+)."""
    env.reset()
    new_kp = env.keypoint_ids()

    for action in demo["actions"]:
        pick_w, place_w = action[:3], action[3:]
        # nearest recorded keypoint to the demo pick -> same slot on new cloth
        demo_kp_pos = demo["pos"][0][demo["keypoints_ids"]]
        slot = int(np.argmin(np.linalg.norm(demo_kp_pos - pick_w, axis=1)))
        pick_idx = new_kp[slot]
        pick = env.positions[pick_idx]
        place = pick + (place_w - pick_w)      # demo-relative displacement
        env.grasp_particle(pick_idx)
        for a in bezier_actions(pick, place, height, n_steps):
            env.step(a)
        env.release()

    final_cov = covered_area(env.positions, particle_radius)
    demo_cov = float(demo["coverage"][-1])
    # graph error: compare the tracked demo graph against the same FPS graph
    # on the imitation cloth (valid when cloth resolutions match)
    err = None
    if env.positions.shape[0] == demo["pos"].shape[1]:
        err = float(np.linalg.norm(
            env.positions[demo["graph_ids"]] - demo["graph"][-1], axis=1).mean())
    return {"coverage": final_cov, "demo_coverage": demo_cov,
            "coverage_ratio": final_cov / max(demo_cov, 1e-9),
            "graph_error": err}
