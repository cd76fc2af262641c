"""GNN trajectory datasets; counterpart of
``cloth_splatting_tpu/data/trajectories.py`` (numpy; the same arrays and
the same draws): h5 or in-memory simulated trajectories into padded
training samples.

  * axis flip [x, y, z] -> [x, z, y] for simulated (y-up) data, so the cloth
    plane is the first two coordinates;
  * farthest-point subsampling to ``num_samples`` nodes;
  * Delaunay triangulation of the t = 0 cloth plane with edges and faces
    pruned by ``norm_threshold``; graph edges are the faces' bidirectional
    edges (or a kNN graph);
  * velocity[t] = (pos[t] - pos[t-1]) / dt with velocity[0] = 0;
  * grasped particle = argmin ||pos[0] - pick||, node type 1 (else 0);
  * the first frame is repeated for the velocity history.

``actions[t]`` is the gripper's displacement from state t to t+1, so the
sample at time index ti consumes ``actions[ti-1 : ti-1+future]``. Samples
are padded to one (V, E_max), with an edge mask over the padding. Reading
h5 files needs ``h5py``.
"""

from __future__ import annotations

import glob
import os
from typing import Any

import numpy as np

from cloth_splatting_tpu_torch.data.meshing import (
    delaunay_edges,
    faces_to_edges,
    farthest_point_sampling,
    knn_edges,
)


def load_sim_trajectory(traj_dir: str, action_steps: int = 1) -> dict[str, np.ndarray]:
    """Load one trajectory h5 (``pos``, ``vel``, ``actions``,
    ``gripper_pos``, ``pick``, ``place``, ...); ``action_steps`` > 1
    subsamples the states and sums the actions in between."""
    import h5py

    files = glob.glob(os.path.join(traj_dir, "*h5")) + glob.glob(
        os.path.join(traj_dir, "*.hdf5"))
    if not files:
        raise FileNotFoundError(f"no h5 in {traj_dir}")
    with h5py.File(files[0], "r") as f:
        data = {k: np.asarray(f[k]) for k in f.keys()}
    if action_steps > 1:
        for k in ("pos", "vel", "gripper_pos"):
            if k in data:
                data[k] = data[k][::action_steps]
        a = data["actions"]
        n_full = (a.shape[0] // action_steps) * action_steps
        head = a[:n_full].reshape(-1, action_steps, 3).sum(1)
        if a.shape[0] % action_steps:
            head = np.concatenate([head, a[n_full:].sum(0)[None]], 0)
        data["actions"] = head
    return data


def env_trajectory_dirs(data_root: str) -> list[str]:
    """The trajectory directories of ``root/ENV/traj_*/`` (or ``root/ENV``
    itself when it holds the h5 files)."""
    envs = sorted(glob.glob(os.path.join(data_root, "*")))
    dirs = []
    for env in envs:
        subs = sorted(glob.glob(os.path.join(env, "*")))
        if any(s.endswith((".h5", ".hdf5")) for s in subs):
            dirs.append(env)
        else:
            dirs.extend(s for s in subs if os.path.isdir(s))
    return dirs


def process_trajectory(
    raw: dict[str, np.ndarray],
    dt: float = 1.0,
    num_samples: int = 200,
    subsample: bool = True,
    sim_data: bool = True,
    norm_threshold: float = 0.1,
    seed: int = 0,
    use_delaunay: bool = True,
    knn: int = 10,
) -> dict[str, Any]:
    """Raw h5 dict -> processed trajectory dict (numpy, pre-expansion).

    ``use_delaunay=False`` builds a kNN graph instead of the Delaunay mesh's
    edges; the faces still come from the thresholded Delaunay pass (the
    mesh-anchored renderer needs them).
    """
    pos = raw["pos"].astype(np.float32)
    actions = raw["actions"].astype(np.float32)
    pick = raw["pick"].astype(np.float32)

    if sim_data:
        pos = pos[:, :, [0, 2, 1]]
        actions = actions[:, [0, 2, 1]]
        pick = pick[[0, 2, 1]]

    if subsample and num_samples < pos.shape[1]:
        idx = farthest_point_sampling(pos[0], num_samples, seed=seed)
    else:
        idx = np.arange(pos.shape[1])
    pos = pos[:, idx]

    edge_single, faces = delaunay_edges(pos[0], plane_axes=(0, 1),
                                        norm_threshold=norm_threshold)
    if faces.size == 0:
        raise ValueError("no valid faces survive the norm threshold")
    if use_delaunay:
        # face-derived bidirectional edges (FaceToEdge semantics)
        edge_index = faces_to_edges(faces.astype(np.int32))
    else:
        single = knn_edges(pos[0], k=knn)
        edge_index = np.concatenate([single, single[::-1]], axis=1).astype(np.int32)

    vel = np.zeros_like(pos)
    vel[1:] = (pos[1:] - pos[:-1]) / dt

    grasped = int(np.argmin(np.linalg.norm(pos[0] - pick[None], axis=1)))
    node_type = np.zeros(pos.shape[1], np.int32)
    node_type[grasped] = 1

    return {
        "pos": pos,                      # [T, V, 3]
        "velocity": vel,                 # [T, V, 3]
        "actions": actions,              # [T-1, 3]: state t -> t+1
        "node_type": node_type,          # [V]
        "edge_index": edge_index,        # [2, E] bidirectional
        "faces": faces.astype(np.int32),
        "grasped": grasped,
        "pick": pick,
        "place": raw["place"].astype(np.float32)[[0, 2, 1]] if sim_data
        else raw["place"].astype(np.float32),
    }


class ClothSampleDataset:
    """Flat sample indexing across trajectories with future-sequence
    targets. ``trajectories``: processed trajectory dicts in memory, instead
    of the h5 files under ``data_root``."""

    def __init__(self, data_root: str | None, input_seq_len: int = 2,
                 future_seq_len: int = 1, dt: float = 1.0,
                 num_samples: int = 200, sim_data: bool = True,
                 norm_threshold: float = 0.1,
                 trajectories: list[dict] | None = None,
                 subsample: bool = True, use_delaunay: bool = True,
                 knn: int = 10):
        self.input_seq_len = input_seq_len
        self.future_seq_len = future_seq_len
        self.dt = dt
        if trajectories is not None:
            self.trajs = trajectories
        elif data_root is not None:
            self.trajs = [
                process_trajectory(load_sim_trajectory(d), dt=dt,
                                   num_samples=num_samples, sim_data=sim_data,
                                   norm_threshold=norm_threshold,
                                   subsample=subsample,
                                   use_delaunay=use_delaunay, knn=knn)
                for d in env_trajectory_dirs(data_root)
            ]
        else:
            self.trajs = []
        self._recompute_lengths()

    # -- bookkeeping ---------------------------------------------------------

    def set_future_seq_len(self, future: int) -> None:
        self.future_seq_len = future
        self._recompute_lengths()

    def _recompute_lengths(self) -> None:
        h, fut = self.input_seq_len, self.future_seq_len
        self.lengths = [max(t["pos"].shape[0] - 1 - fut + 1, 0) for t in self.trajs]
        self.cum = np.cumsum([0] + self.lengths)
        self.n_nodes = self.trajs[0]["pos"].shape[1] if self.trajs else 0
        self.e_max = max((t["edge_index"].shape[1] for t in self.trajs), default=0)

    def __len__(self) -> int:
        return int(self.cum[-1])

    # -- sampling ------------------------------------------------------------

    def sample(self, idx: int) -> dict[str, np.ndarray]:
        """One training sample: all arrays padded to (V, e_max)."""
        traj_idx = int(np.searchsorted(self.cum[1:], idx, side="right"))
        local = idx - self.cum[traj_idx]
        t = self.trajs[traj_idx]
        h, fut = self.input_seq_len, self.future_seq_len
        ti = 1 + local                       # predict pos[ti..ti+fut-1]

        pos_t = t["pos"][ti - 1]             # [V, 3]
        # velocity history with first-frame padding
        vel_hist = []
        for k in range(h):
            src = max(ti - h + k, 0)
            vel_hist.append(t["velocity"][src])
        velocity = np.concatenate(vel_hist, axis=1)         # [V, 3h]

        target_vel = t["velocity"][ti:ti + fut].transpose(1, 0, 2)   # [V, fut, 3]
        target_pos = t["pos"][ti:ti + fut].transpose(1, 0, 2)
        acts = t["actions"][ti - 1:ti - 1 + fut]                     # [fut, 3]

        grasped = t["grasped"]
        particle_actions = np.zeros((self.n_nodes, fut, 3), np.float32)
        particle_actions[grasped] = acts

        # the grasped node's position advances by the first action and its
        # newest history slot carries the action-induced target velocity
        pos_in = pos_t.copy()
        pos_in[grasped] += acts[0]
        vel_in = velocity.copy()
        vel_in[grasped, -3:] = target_vel[grasped, 0]

        e = t["edge_index"]
        edge_index = np.zeros((2, self.e_max), np.int32)
        edge_index[:, : e.shape[1]] = e
        edge_mask = np.zeros(self.e_max, bool)
        edge_mask[: e.shape[1]] = True

        return {
            "velocity": vel_in.astype(np.float32),
            "node_type": t["node_type"],
            "positions": pos_in.astype(np.float32),
            "edge_index": edge_index,
            "edge_mask": edge_mask,
            "target_vel": target_vel.astype(np.float32),
            "target_pos": target_pos.astype(np.float32),
            "particle_actions": particle_actions,
            "grasped": np.int32(grasped),
        }

    def batch(self, rng: np.random.Generator, batch_size: int) -> dict[str, np.ndarray]:
        ids = rng.integers(0, len(self), size=batch_size)
        samples = [self.sample(int(i)) for i in ids]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    # -- validation / rollout ------------------------------------------------

    def rollout_item(self, traj_idx: int) -> dict[str, np.ndarray]:
        """Whole-trajectory features for autoregressive rollout eval."""
        t = self.trajs[traj_idx]
        h = self.input_seq_len
        init_vel = np.zeros((h, self.n_nodes, 3), np.float32)
        return {
            "pos": t["pos"],
            "velocity": t["velocity"],
            "init_velocity": init_vel,
            "actions": t["actions"],
            "node_type": t["node_type"],
            "edge_index": t["edge_index"],
            "faces": t["faces"],
            "grasped": t["grasped"],
        }
