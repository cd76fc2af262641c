"""Mesh visualization; counterpart of ``cloth_splatting_tpu/eval/mesh_viz.py``:
3D scatter plus edge wireframe plots of cloth meshes, prediction-vs-ground
truth frames of a GNN rollout, and GIF assembly. Needs matplotlib and
imageio, imported inside the functions.
"""

from __future__ import annotations

import os

import numpy as np


def _axes3d(center=None, extent=0.3, elev=20, azim=30):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(4, 4), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=elev, azim=azim)
    if center is not None:
        for set_lim, c in zip((ax.set_xlim, ax.set_ylim, ax.set_zlim), center):
            set_lim(c - extent, c + extent)
    ax.set_axis_off()
    return fig, ax


def _wireframe(ax, points, edges, color, alpha=0.6):
    segs = points[np.asarray(edges).T.reshape(-1, 2)]
    for a, b in segs:
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                color=color, linewidth=0.5, alpha=alpha)


def _fig_to_rgb(fig) -> np.ndarray:
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def plot_mesh(points, edges, save_path: str | None = None,
              elev: float = 20, azim: float = 30) -> np.ndarray:
    """Wireframe render of one mesh; returns the RGB image array."""
    points = np.asarray(points)
    fig, ax = _axes3d(points.mean(axis=0), elev=elev, azim=azim)
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=2, c="tab:blue")
    _wireframe(ax, points, edges, "tab:blue")
    img = _fig_to_rgb(fig)
    if save_path:
        import imageio.v2 as imageio

        imageio.imwrite(save_path, img)
    return img


def plot_mesh_predictions(gt_points, pred_points, edges,
                          save_path: str | None = None,
                          elev: float = 20, azim: float = 30) -> np.ndarray:
    """Ground truth (blue) vs predicted (red) wireframes in one frame."""
    gt_points = np.asarray(gt_points)
    pred_points = np.asarray(pred_points)
    center = 0.5 * (gt_points.mean(axis=0) + pred_points.mean(axis=0))
    fig, ax = _axes3d(center, elev=elev, azim=azim)
    ax.scatter(gt_points[:, 0], gt_points[:, 1], gt_points[:, 2],
               s=2, c="tab:blue", label="gt")
    ax.scatter(pred_points[:, 0], pred_points[:, 1], pred_points[:, 2],
               s=2, c="tab:red", label="pred")
    _wireframe(ax, gt_points, edges, "tab:blue", alpha=0.3)
    _wireframe(ax, pred_points, edges, "tab:red", alpha=0.3)
    ax.legend(loc="upper right", fontsize=7)
    img = _fig_to_rgb(fig)
    if save_path:
        import imageio.v2 as imageio

        imageio.imwrite(save_path, img)
    return img


def rollout_frames(gt_traj, pred_traj, edges, out_dir: str,
                   stride: int = 1) -> list[str]:
    """Per-timestep prediction-vs-GT frames for a rollout."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t in range(0, min(len(gt_traj), len(pred_traj)), stride):
        path = os.path.join(out_dir, f"rollout_{t:04d}.png")
        plot_mesh_predictions(gt_traj[t], pred_traj[t], edges, save_path=path)
        paths.append(path)
    return paths


def create_gif(image_paths: list[str], gif_path: str, fps: int = 4) -> str:
    """Assemble saved frames into a GIF."""
    import imageio.v2 as imageio

    frames = [imageio.imread(p) for p in image_paths]
    imageio.mimwrite(gif_path, frames, duration=1.0 / fps, loop=0)
    return gif_path
