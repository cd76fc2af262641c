"""Scripted fold demonstrations from the command line; counterpart of the
root ``collect_demos.py``:

    python -m cloth_splatting_tpu_torch.collect_demos --cloth TOWEL

Deterministic corner-to-corner folds of a settled PBD cloth for the TOWEL,
SHORTS and TSHIRT fold plans (``manipulation.collect.run_pick_place``),
each written as ``<out>/<cloth>/demo_<i>/trajectory.h5`` (needs ``h5py``).
The flags of the root script, plus ``--device`` (default ``cuda``; raises
without a card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

FOLDS = {
    "TOWEL": [(0, 3), (1, 2)],          # corner k -> the opposite corner
    "SHORTS": [(0, 1), (3, 2)],
    "TSHIRT": [(0, 2), (1, 3)],
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Collect scripted fold demos")
    p.add_argument("--out", type=str, default="./sim_datasets/demos")
    p.add_argument("--cloth", choices=sorted(FOLDS), default="TOWEL")
    p.add_argument("--n_demos", type=int, default=4)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--n_steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    import numpy as np

    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.manipulation.collect import (
        run_pick_place,
        write_trajectory_h5,
    )
    from cloth_splatting_tpu_torch.manipulation.sim import make_cloth, settle
    from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    env_dir = os.path.join(args.out, args.cloth)
    folds = FOLDS[args.cloth]
    for i in range(args.n_demos):
        state, cons, (gx, gy) = make_cloth(args.nx, args.ny, height=0.0, device=dev)
        state = settle(state, cons, n_steps=10)
        settled = state.pos.cpu().numpy()
        corners = [0, gy - 1, (gx - 1) * gy, gx * gy - 1]
        src_k, dst_k = folds[i % len(folds)]
        pick_idx = corners[src_k]
        pick = settled[pick_idx]
        place = settled[corners[dst_k]] \
            + rng.normal(0, 0.005, 3) * np.asarray([1.0, 0.0, 1.0])
        actions = bezier_actions(pick, place,
                                 0.15 * np.linalg.norm(place - pick) + 0.03,
                                 args.n_steps)
        pos, vel, gripper, _ = run_pick_place(state, cons, pick_idx, actions)
        write_trajectory_h5(os.path.join(env_dir, f"demo_{i:04d}"),
                            pos, vel, actions, gripper, pick, place)
        print(f"demo {i}: {args.cloth} fold corner {src_k}->{dst_k}")
    print(f"-> {env_dir}")
    return env_dir


if __name__ == "__main__":
    main()
