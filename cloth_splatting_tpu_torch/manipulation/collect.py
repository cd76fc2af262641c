"""Trajectory data collection; counterpart of
``cloth_splatting_tpu/manipulation/collect.py``: the PBD cloth driven through
pick-and-place bezier actions, the trajectories returned in memory
(``collect_trajectories``) or written as one ``trajectory.h5`` per
trajectory directory (``collect_dataset``): ``pos`` [T, N, 3], ``vel``
[T, N, 3], ``actions`` [T-1, 3], ``gripper_pos`` [T, 3], ``pick`` [3],
``place`` [3], ``trajectory_params``. Coordinates are y-up. Writing needs
``h5py``; collecting in memory does not.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.manipulation.sim import (
    ClothParams,
    cloth_step,
    cloth_step_multi,
    make_cloth,
    settle,
)
from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions


def run_pick_place(state, cons, grasp_idx: int, actions: np.ndarray,
                   params: ClothParams = ClothParams()):
    """Execute per-step gripper displacements; returns (pos [T, N, 3], vel
    [T, N, 3], gripper [T, 3], the final state) with T = len(actions) + 1.
    The states stay on the device until the end, then come to the host
    once."""
    dev = state.pos.device
    poses, vels = [state.pos], [state.vel]
    acts = torch.from_numpy(np.asarray(actions, np.float32)).to(dev)
    for a in acts:
        target = state.pos[grasp_idx] + a
        state = cloth_step(state, cons, grasp_idx, target, True, params)
        poses.append(state.pos)
        vels.append(state.vel)
    pos = torch.stack(poses).cpu().numpy()
    return pos, torch.stack(vels).cpu().numpy(), pos[:, grasp_idx], state


def write_trajectory_h5(out_dir: str, pos, vel, actions, gripper_pos, pick, place,
                        trajectory_params=None) -> str:
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trajectory.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("pos", data=np.asarray(pos, np.float32))
        f.create_dataset("vel", data=np.asarray(vel, np.float32))
        f.create_dataset("actions", data=np.asarray(actions, np.float32))
        f.create_dataset("gripper_pos", data=np.asarray(gripper_pos, np.float32))
        f.create_dataset("pick", data=np.asarray(pick, np.float32))
        f.create_dataset("place", data=np.asarray(place, np.float32))
        f.create_dataset(
            "trajectory_params",
            data=np.asarray(trajectory_params if trajectory_params is not None else [0.0],
                            np.float32),
        )
    return path


def run_pick_place_batch(state, cons, grasp_ids: list[int], actions: np.ndarray,
                         params: ClothParams = ClothParams()):
    """B pick-and-place runs of one cloth at once: the cloth copied B times
    into one particle system (copy b's constraints offset by b·N), copy b
    carried by its own handle on particle ``grasp_ids[b]`` through
    ``actions[b]`` ([B, T-1, 3]). Copies share no constraint, so each one's
    sums are those of ``run_pick_place`` on it alone. Returns (pos [B, T, N,
    3], vel [B, T, N, 3], gripper [B, T, 3]) on the host."""
    n = state.pos.shape[0]
    b = len(grasp_ids)
    dev = state.pos.device
    offsets = torch.arange(b, device=dev) * n
    cons = cons._replace(
        edges=(cons.edges[None] + offsets[:, None, None]).reshape(-1, 2),
        rest_len=cons.rest_len.repeat(b), stiff=cons.stiff.repeat(b),
        inv_degree=cons.inv_degree.repeat(b))
    state = state._replace(pos=state.pos.repeat(b, 1), vel=state.vel.repeat(b, 1))
    handles = [i * n + g for i, g in enumerate(grasp_ids)]
    acts = torch.from_numpy(np.asarray(actions, np.float32)).to(dev)
    poses, vels = [state.pos], [state.vel]
    for t in range(acts.shape[1]):
        target = state.pos[handles] + acts[:, t]
        state = cloth_step_multi(state, cons, handles, target, [True] * b, params)
        poses.append(state.pos)
        vels.append(state.vel)
    pos = torch.stack(poses).reshape(-1, b, n, 3).transpose(0, 1).cpu().numpy()
    vel = torch.stack(vels).reshape(-1, b, n, 3).transpose(0, 1).cpu().numpy()
    return pos, vel, pos[np.arange(b), :, grasp_ids]


def collect_trajectories(n_trajectories: int = 4, nx: int = 12, ny: int = 12,
                         cloth_size: float = 0.3, n_steps: int = 20,
                         seed: int = 0, params: ClothParams = ClothParams(),
                         device: str | torch.device = "cuda") -> list[dict]:
    """Random pick-and-place trajectories of a settled cloth: a corner
    grasped and carried across the cloth along a bezier arc. Returns one
    dict per trajectory (``pos``, ``vel``, ``actions``, ``gripper_pos``,
    ``pick``, ``place``; numpy), the h5 file's fields. Every trajectory
    starts from the same settled cloth, so it is settled once; the draws
    are the JAX package's, in its order; the runs go through
    ``run_pick_place_batch`` together."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    state, cons, (gx, gy) = make_cloth(nx, ny, cloth_size, height=0.0,
                                       params=params, device=dev)
    state = settle(state, cons, n_steps=10, params=params)
    settled = state.pos.cpu().numpy()
    corner_ids = [0, gy - 1, (gx - 1) * gy, gx * gy - 1]
    plans = []
    for _ in range(n_trajectories):
        # pick a corner particle, place across the cloth (fold-like)
        grasp_idx = int(rng.choice(corner_ids))
        pick = settled[grasp_idx]
        opposite = settled[corner_ids[3 - corner_ids.index(grasp_idx)]]
        place = pick + (opposite - pick) * rng.uniform(0.6, 1.0) \
            + rng.normal(0, 0.02, 3) * np.asarray([1.0, 0.0, 1.0])
        height = rng.uniform(0.08, 0.2) * np.linalg.norm(place - pick) / max(cloth_size, 1e-6)
        plans.append((grasp_idx, pick, place, bezier_actions(pick, place, height, n_steps)))
    if not plans:
        return []
    pos, vel, gripper = run_pick_place_batch(
        state, cons, [g for g, *_ in plans], np.stack([a for *_, a in plans]), params)
    return [{"pos": pos[i], "vel": vel[i], "actions": actions, "gripper_pos": gripper[i],
             "pick": pick, "place": place}
            for i, (_, pick, place, actions) in enumerate(plans)]


def collect_dataset(out_root: str, n_trajectories: int = 4, nx: int = 12,
                    ny: int = 12, cloth_size: float = 0.3, n_steps: int = 20,
                    seed: int = 0, params: ClothParams = ClothParams(),
                    device: str | torch.device = "cuda") -> str:
    """``collect_trajectories`` written as ``out_root/TOWEL/traj_<i>/
    trajectory.h5`` (the layout ``data.trajectories.env_trajectory_dirs``
    walks)."""
    env_dir = os.path.join(out_root, "TOWEL")
    trajs = collect_trajectories(n_trajectories, nx, ny, cloth_size, n_steps,
                                 seed, params, device)
    for i, t in enumerate(trajs):
        write_trajectory_h5(os.path.join(env_dir, f"traj_{i:04d}"), t["pos"],
                            t["vel"], t["actions"], t["gripper_pos"], t["pick"],
                            t["place"])
    return out_root
