"""Decompose a run's Mean Trajectory Error into its mechanism terms;
counterpart of the root ``scripts/mte_decompose.py``, over the port's
``eval.tracking.align_trajectories``:

    python -m cloth_splatting_tpu_torch.mte_decompose --trajs EXP/all_trajs.npz \
        --gt SCENE/gt.npz

The tracking metric matches each GT point to its nearest inferred trajectory
at t=0 and carries the residual offset with the per-Gaussian rotations. The
terms, in millimetres (``--scale_mm`` per dataset unit):

  * match offset: |gt(t0) - nearest pred(t0)|, how far the nearest Gaussian
    sits at match time (it bounds the transport's lever arm);
  * fit error: MTE with the offset carried by the ground truth's own motion;
  * rotation transport against translation-only transport: what carrying
    the offset with the quaternions adds or saves;
  * the oracle floor: each GT point's nearest predicted point matched anew
    at every frame (the surface's coverage, free of tracking).

Prints one JSON line with the root script's keys. numpy on the host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from cloth_splatting_tpu_torch.eval.tracking import align_trajectories


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m cloth_splatting_tpu_torch.mte_decompose")
    p.add_argument("--trajs", type=str, required=True)
    p.add_argument("--gt", type=str, required=True)
    p.add_argument("--scale_mm", type=float, default=1000.0)
    args = p.parse_args(argv)

    data = np.load(args.trajs)
    pred = data["traj"]                                   # [T, N, 3]
    rot = data["rotations"] if "rotations" in data.files else None
    gt = np.load(args.gt, allow_pickle=True)["traj"]      # [T, M, 3]
    t = min(pred.shape[0], gt.shape[0])
    pred, gt = pred[:t], gt[:t]
    rot = rot[:t] if rot is not None else None

    d0 = np.linalg.norm(gt[0][:, None] - pred[0][None], axis=-1)
    nearest = np.argmin(d0, axis=1)
    match_off = d0[np.arange(gt.shape[1]), nearest]       # [M]

    # headline (rotation transport) and translation-only variants
    _, mte_rot = align_trajectories(pred, rot, gt)
    _, mte_trans = align_trajectories(pred, None, gt)

    # fit error: the offset carried by the TRUE local motion, the matched
    # predicted point's error against the gt point's own displacement;
    # algebraically equal to translation-only transport, (pred_t - pred_0)
    # - (gt_t - gt_0) = (pred_t + offset0) - gt_t, kept so that the equality
    # shows in the output
    gt_disp = gt - gt[0][None]                            # [T, M, 3]
    fit = np.linalg.norm(
        (pred[:, nearest] - pred[0][None, nearest]) - gt_disp, axis=-1)
    mte_fit = fit.mean(axis=0)                            # [M]

    # per-frame oracle NN: distance from each gt point to the NEAREST
    # predicted point matched independently AT EACH FRAME, the
    # tracking-free surface-coverage floor. If this is large, the fitted
    # surface itself is off (coherent mesh drift); if small while MTE is
    # large, the loss is in t0-matching/transport.
    oracle = np.empty((t, gt.shape[1]), np.float32)
    for ti in range(t):
        dt_ = np.linalg.norm(gt[ti][:, None] - pred[ti][None], axis=-1)
        oracle[ti] = dt_.min(axis=1)
    oracle_mean = oracle.mean()
    oracle_last = oracle[-1].mean()

    s = args.scale_mm
    print(json.dumps({
        "metric": "mte_decomposition_mm",
        "n_points": int(gt.shape[1]),
        "n_times": int(t),
        "mte_rot_transport": round(float(mte_rot.mean()) * s, 3),
        "mte_translation_only": round(float(mte_trans.mean()) * s, 3),
        "mte_fit_true_transport": round(float(mte_fit.mean()) * s, 3),
        "match_offset_mean": round(float(match_off.mean()) * s, 3),
        "match_offset_p95": round(float(np.percentile(match_off, 95)) * s, 3),
        "oracle_nn_mean": round(float(oracle_mean) * s, 3),
        "oracle_nn_last_frame": round(float(oracle_last) * s, 3),
    }))


if __name__ == "__main__":
    main()
