"""Scripted keypoint-to-keypoint data collection from the command line;
counterpart of the root ``scripted_datacollection.py``:

    python -m cloth_splatting_tpu_torch.scripted_datacollection

Sweeps (pick keypoint, place keypoint) combinations per cloth instance,
executes bezier folds in the PBD simulator (``manipulation.env.ClothEnv``)
and writes the per-trajectory ``data.h5`` schema (pos, vel, grasp,
gripper_pos, done, actions, grasped_particle, keypoints_ids, pick, place,
trajectory_params, cloth_params; needs ``h5py``). The flags of the root
script, plus ``--device`` (default ``cuda``; raises without a card unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def collect_trajectory(env, pick_kp: int, place_kp: int, height: float,
                       velocity: float, dt: float, out_dir: str | None) -> dict:
    """One scripted fold: grasp keypoint ``pick_kp`` and carry it along a
    bezier to keypoint ``place_kp`` in steps of ``velocity * dt``; returns
    the recorded data and writes ``<out_dir>/data.h5`` when ``out_dir`` is
    given."""
    from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions

    env.reset()
    keypoints = env.keypoint_ids()
    pick_idx = keypoints[pick_kp]
    pick = env.positions[pick_idx]
    place = env.positions[keypoints[place_kp]]

    dist = float(np.linalg.norm(place - pick))
    n_steps = max(int(np.ceil(dist / max(velocity * dt, 1e-6))), 2)
    actions = bezier_actions(pick, place, height, n_steps)

    data = {"pos": [env.positions], "vel": [np.zeros_like(env.positions)],
            "grasp": [1], "gripper_pos": [pick], "done": [False],
            "actions": [np.zeros(3)]}
    env.grasp_particle(pick_idx)
    prev = env.positions
    for a in actions:
        cur = env.step(a)
        data["pos"].append(cur)
        data["vel"].append(cur - prev)
        data["grasp"].append(1)
        data["gripper_pos"].append(cur[pick_idx])
        data["done"].append(False)
        data["actions"].append(np.asarray(a))
        prev = cur
    env.release()
    data["done"][-1] = True

    out = {k: np.asarray(v, np.float32) for k, v in data.items()}
    out["grasp"] = np.asarray(data["grasp"], np.int32)
    out["done"] = np.asarray(data["done"], bool)
    out["grasped_particle"] = np.int32(pick_idx)
    out["keypoints_ids"] = np.asarray(keypoints, np.int32)
    out["pick"] = pick.astype(np.float32)
    out["place"] = place.astype(np.float32)
    out["trajectory_params"] = np.asarray([height, 0.0, velocity, dt], np.float32)
    out["cloth_params"] = np.asarray(
        [env.params.friction, env.params.stiffness, env.params.bend_stiffness,
         env.params.damping], np.float32)

    if out_dir is not None:
        import h5py

        os.makedirs(out_dir, exist_ok=True)
        with h5py.File(os.path.join(out_dir, "data.h5"), "w") as hf:
            for k, v in out.items():
                hf.create_dataset(k, data=v)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Scripted keypoint fold collection")
    p.add_argument("--dataset_path", type=str, default="./sim_datasets")
    p.add_argument("--dataset_name", type=str, default="scripted")
    p.add_argument("--cloth_type", type=str, default="TOWEL")
    p.add_argument("--n_meshes", type=int, default=2,
                   help="cloth instances (seeds)")
    p.add_argument("--n_trajs", type=int, default=4,
                   help="keypoint pick/place combos per cloth")
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--height", type=float, default=0.1)
    p.add_argument("--velocity", type=float, default=2.0)
    p.add_argument("--traj_dt", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)

    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.manipulation.env import ClothEnv

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    root = os.path.join(args.dataset_path, args.dataset_name, args.cloth_type)
    n_kp = 9  # corners, edge midpoints, centre
    dirs = []
    for mesh_idx in range(args.n_meshes):
        env = ClothEnv(nx=args.nx, ny=args.ny, seed=args.seed + mesh_idx, device=dev)
        for traj_idx in range(args.n_trajs):
            pick_kp = int(rng.integers(n_kp))
            place_kp = int((pick_kp + 1 + rng.integers(n_kp - 1)) % n_kp)
            out_dir = os.path.join(root, f"{mesh_idx:05d}", f"{traj_idx:05d}")
            collect_trajectory(env, pick_kp, place_kp, args.height,
                               args.velocity, args.traj_dt, out_dir)
            dirs.append(out_dir)
            print(f"mesh {mesh_idx} traj {traj_idx}: kp {pick_kp}->{place_kp} "
                  f"-> {out_dir}/data.h5")
    return dirs


if __name__ == "__main__":
    main()
