"""Keypoint inspection over collected simulated datasets from the command
line; counterpart of the root ``keypoint_inspection.py``:

    python -m cloth_splatting_tpu_torch.keypoint_inspection --dataset DIR --out FIGS

For each mesh id of a dataset, the first frame of one trajectory drawn as a
top-down particle scatter with the grid's keypoints (corners, edge
midpoints, centre) circled and labelled, saved as
``FIGS/<mesh id>/<iteration>/img_0.png``, for choosing grasp indices by
hand. Needs h5py and matplotlib (imported inside the functions). The flags
of the root script, plus ``--device`` (default ``cuda``; raises without a
card unless ``--device cpu``): the script runs on the host, the flag
only checks the device as every entry point does.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _grid_keypoints(n_particles: int) -> list[int]:
    """Corners + edge midpoints + center of an (assumed square) grid cloth."""
    n = int(round(np.sqrt(n_particles)))
    if n * n != n_particles:
        return []
    def idx(i, j):
        return i * n + j
    m = n // 2
    return [idx(0, 0), idx(0, n - 1), idx(n - 1, 0), idx(n - 1, n - 1),
            idx(0, m), idx(n - 1, m), idx(m, 0), idx(m, n - 1), idx(m, m)]


def inspect_dataset(dataset_root: str, out_root: str,
                    iteration_id: int = 0) -> list[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cloth_splatting_tpu_torch.data.trajectories import load_sim_trajectory

    written = []
    env_dirs = sorted(d for d in glob.glob(os.path.join(dataset_root, "*"))
                      if os.path.isdir(d))
    for env_dir in env_dirs:
        mesh_id = os.path.basename(env_dir)
        trajs = sorted(d for d in glob.glob(os.path.join(env_dir, "*"))
                       if os.path.isdir(d))
        if iteration_id >= len(trajs):
            continue
        data = load_sim_trajectory(trajs[iteration_id])
        pos0 = np.asarray(data["pos"][0])

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(pos0[:, 0], pos0[:, 1], s=4, c=pos0[:, 2], cmap="viridis")
        for k in _grid_keypoints(pos0.shape[0]):
            ax.scatter(pos0[k, 0], pos0[k, 1], s=60, facecolors="none",
                       edgecolors="r")
            ax.annotate(str(k), (pos0[k, 0], pos0[k, 1]), color="r",
                        fontsize=8)
        ax.set_aspect("equal")
        ax.set_title(f"{mesh_id} traj {iteration_id:05d}")

        out_dir = os.path.join(out_root, mesh_id, f"{iteration_id:05d}")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, "img_0.png")
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        written.append(out_path)
        print(f"wrote {out_path}")
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True,
                   help="sim dataset root (ENV/traj_* dirs)")
    p.add_argument("--out", type=str, default="data/figs")
    p.add_argument("--iteration_id", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from cloth_splatting_tpu_torch.device import resolve_device

    resolve_device(args.device)
    return inspect_dataset(args.dataset, args.out, args.iteration_id)


if __name__ == "__main__":
    main()
