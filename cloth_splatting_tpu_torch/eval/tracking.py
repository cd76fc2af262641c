"""3D tracking evaluation: trajectory alignment and the Mean Trajectory
Error; counterpart of ``cloth_splatting_tpu/eval/tracking.py``.

For every ground-truth point at t=0, find the nearest inferred trajectory,
carry the offset between them through time with that trajectory's rotations,
and report MTE = the mean L2 error over time (in the dataset's length
units). numpy, with the port's ``quat_to_rotmat`` on the CPU in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from cloth_splatting_tpu_torch.ops.quaternion import quat_to_rotmat


def _rotmats(q: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()


def align_trajectories(pred_traj: np.ndarray, pred_rot: np.ndarray | None,
                       gt_traj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Match each GT point to its nearest predicted trajectory at t=0 and
    carry the offset over time.

    Args:
        pred_traj: [T, N, 3] inferred point trajectories.
        pred_rot: [T, N, 4] WXYZ rotations per point per time (or None for
            translation-only transport).
        gt_traj: [T, M, 3] ground-truth trajectories.

    Returns:
        (aligned [T, M, 3] predicted positions for each GT point, mte [M]).
    """
    t_steps = gt_traj.shape[0]

    d0 = np.linalg.norm(gt_traj[0][:, None, :] - pred_traj[0][None, :, :], axis=-1)
    nearest = np.argmin(d0, axis=1)                      # [M]
    offset0 = gt_traj[0] - pred_traj[0][nearest]         # [M, 3]

    aligned = np.zeros_like(gt_traj)
    if pred_rot is not None:
        rot0 = _rotmats(pred_rot[0][nearest])
        for t in range(t_steps):
            rt = _rotmats(pred_rot[t][nearest])
            # transport the t0 offset by the relative rotation R_t R_0^T
            rel = np.einsum("mij,mkj->mik", rt, rot0)
            off_t = np.einsum("mij,mj->mi", rel, offset0)
            aligned[t] = pred_traj[t][nearest] + off_t
    else:
        for t in range(t_steps):
            aligned[t] = pred_traj[t][nearest] + offset0

    err = np.linalg.norm(aligned - gt_traj, axis=-1)     # [T, M]
    mte = err.mean(axis=0)                               # [M]
    return aligned, mte


def score_tracking(pred: np.ndarray, rot: np.ndarray | None, gt: np.ndarray,
                   save_aligned: str | None = None) -> dict:
    """MTE of inferred trajectories ``pred`` [T, N, 3] (with rotations
    [T, N, 4], or None) against ground truth ``gt`` [T', M, 3], over their
    common times; ``save_aligned`` writes {'aligned', 'mte'}."""
    t = min(pred.shape[0], gt.shape[0])
    aligned, mte = align_trajectories(pred[:t], rot[:t] if rot is not None else None,
                                      gt[:t])
    if save_aligned:
        np.savez(save_aligned, aligned=aligned, mte=mte)
    return {"mte_mean": float(mte.mean()), "mte_median": float(np.median(mte)),
            "n_points": int(mte.shape[0]), "n_times": int(t)}


def evaluate_tracking(all_trajs_path: str, gt_path: str,
                      save_aligned: str | None = None) -> dict:
    """``all_trajs.npz`` (from ``eval.render --log_deform``) against the
    dataset's ``gt.npz`` {'traj': [T, M, 3]}."""
    data = np.load(all_trajs_path)
    rot = data["rotations"] if "rotations" in data.files else None
    gt = np.load(gt_path, allow_pickle=True)["traj"]
    return score_tracking(data["traj"], rot, gt, save_aligned)
