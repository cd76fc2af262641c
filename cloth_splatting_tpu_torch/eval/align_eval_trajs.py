"""3D tracking alignment and MTE from the command line; counterpart of
``scripts/align_eval_trajs.py``:

    python -m cloth_splatting_tpu_torch.eval.align_eval_trajs \
        --trajs MODEL/all_trajs.npz --gt SCENE/gt.npz

Matches each ground-truth point to its nearest inferred trajectory at t = 0,
carries the offset with that trajectory's rotations, prints
``MTE mean: X mm (median Y mm, M points x T times)`` and writes
``<name>_aligned.npz`` {'aligned', 'mte'}. numpy only.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.eval.align_eval_trajs")
    p.add_argument("--trajs", type=str, required=True,
                   help="all_trajs.npz written by eval.render --log_deform")
    p.add_argument("--gt", type=str, required=True,
                   help="the scene's gt.npz with key 'traj' [T, M, 3]")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--scale_mm", type=float, default=1000.0,
                   help="scene unit -> mm for the printed MTE")
    args = p.parse_args(argv)

    from cloth_splatting_tpu_torch.eval.tracking import evaluate_tracking

    out = args.out or args.trajs.replace(".npz", "_aligned.npz")
    res = evaluate_tracking(args.trajs, args.gt, save_aligned=out)
    print(f"MTE mean: {res['mte_mean'] * args.scale_mm:.3f} mm "
          f"(median {res['mte_median'] * args.scale_mm:.3f} mm, "
          f"{res['n_points']} points x {res['n_times']} times)")
    print(f"aligned trajectories -> {out}")


if __name__ == "__main__":
    main()
