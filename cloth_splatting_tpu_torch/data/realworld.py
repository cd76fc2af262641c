"""Real-world capture preprocessing; counterpart of
``cloth_splatting_tpu/data/realworld.py`` (numpy/scipy; the same arrays).

Real trajectories are tracked point clouds with a separately tracked
gripper: (1) the gripper position, offset by the calibration constant
[0, -0.03, 0.02], joins as an extra particle (the grasped cloth point is
hidden by the gripper), (2) per-step actions come from the gripper's
displacement, (3) every frame is smoothed by a kNN Gaussian kernel (k = 20,
sigma = 0.1), and (4) z is flattened to 0 (the cloth lies on a table).
The rest (meshing, velocities, the grasped particle) is the simulated
path's ``process_trajectory`` with ``sim_data=False``.
"""

from __future__ import annotations

import numpy as np

GRIPPER_OFFSET = np.asarray([0.0, -0.03, 0.02], np.float32)


def gaussian_smoothing(point_cloud: np.ndarray, k: int = 20,
                       sigma: float = 0.1) -> np.ndarray:
    """kNN Gaussian smoothing of one frame, vectorized over points with one
    cKDTree query."""
    from scipy.spatial import cKDTree

    n = point_cloud.shape[0]
    k = min(k, n)
    tree = cKDTree(point_cloud)
    dists, idx = tree.query(point_cloud, k=k)
    if k == 1:
        dists, idx = dists[:, None], idx[:, None]
    weights = np.exp(-dists ** 2 / (2.0 * sigma ** 2))
    weights /= weights.sum(axis=1, keepdims=True)
    return (weights[:, :, None] * point_cloud[idx]).sum(axis=1)


def preprocess_rw_trajectory(raw: dict[str, np.ndarray], dt: float = 1.0,
                             num_samples: int = 200, subsample: bool = True,
                             smooth_k: int = 20, smooth_sigma: float = 0.1,
                             seed: int = 0) -> dict:
    """Raw real-world capture -> processed trajectory dict.

    Args:
        raw: dict with ``pos`` [T, V, 3] tracked cloth points,
            ``gripper_pos`` [T, 3], ``pick`` [3], ``place`` [3].

    Returns the process_trajectory dict (pos/velocity/actions/node_type/
    edge_index/faces/grasped/...) with gripper fields added.
    """
    from cloth_splatting_tpu_torch.data.trajectories import process_trajectory

    pos = np.asarray(raw["pos"], np.float32)
    gripper = np.asarray(raw["gripper_pos"], np.float32)

    # 1. gripper merge: the occluded grasped point rides with the gripper
    grip_particle = (gripper + GRIPPER_OFFSET[None])[:, None, :]
    traj = np.concatenate([pos, grip_particle], axis=1)

    # 2. actions from gripper displacement (a_t moves state t -> t+1)
    actions = np.zeros_like(gripper)
    actions[1:] = gripper[1:] - gripper[:-1]

    # 3. per-frame kNN Gaussian smoothing
    traj = np.stack([gaussian_smoothing(f, k=smooth_k, sigma=smooth_sigma)
                     for f in traj])

    # 4. z-flatten (tabletop capture; z deviations are tracking noise)
    traj[:, :, 2] = 0.0

    processed = process_trajectory(
        {"pos": traj,
         # actions stored as (a_t, s_{t+1})
         "actions": actions[1:],
         "pick": np.asarray(raw["pick"], np.float32),
         "place": np.asarray(raw["place"], np.float32)},
        dt=dt, num_samples=num_samples, subsample=subsample, sim_data=False,
        norm_threshold=0.1, seed=seed,
    )
    processed["actions"] = np.concatenate(
        [np.zeros((1, 3), np.float32), actions[1:]], axis=0)
    processed["gripper_pos"] = gripper
    gripper_vel = np.zeros_like(gripper)
    gripper_vel[1:] = (gripper[1:] - gripper[:-1]) / dt
    processed["gripper_vel"] = gripper_vel
    return processed
