"""Simulated trajectory collection from the command line; counterpart of
the root ``datacollection.py``:

    python -m cloth_splatting_tpu_torch.datacollection --out DIR

Random pick-and-place bezier trajectories of the PBD cloth
(``manipulation.collect``), written as ``DIR/TOWEL/traj_<i>/trajectory.h5``
(needs ``h5py``). The flags of the root script, plus ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Collect cloth sim trajectories")
    p.add_argument("--out", type=str, default="./sim_datasets/train_dataset")
    p.add_argument("--n_trajectories", type=int, default=20)
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--ny", type=int, default=20)
    p.add_argument("--cloth_size", type=float, default=0.3)
    p.add_argument("--n_steps", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.manipulation.collect import collect_dataset

    dev = resolve_device(args.device)
    out = collect_dataset(args.out, args.n_trajectories, args.nx, args.ny,
                          args.cloth_size, args.n_steps, args.seed, device=dev)
    print(f"collected {args.n_trajectories} trajectories -> {out}")
    return out


if __name__ == "__main__":
    main()
