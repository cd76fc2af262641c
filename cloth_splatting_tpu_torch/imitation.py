"""Demo imitation from the command line; counterpart of the root
``imitation.py``:

    python -m cloth_splatting_tpu_torch.imitation --mode both

Records a scripted half-fold demo on one cloth (``data.h5`` at ``--demo``;
needs ``h5py``), then imitates it on a fresh cloth by keypoint
correspondence and reports the coverage ratio
(``manipulation.imitation``). The flags of the root script, plus
``--device`` (default ``cuda``; raises without a card unless ``--device
cpu``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Record + imitate fold demos")
    p.add_argument("--mode", choices=["record", "imitate", "both"], default="both")
    p.add_argument("--demo", type=str, default="./demos/halffold/data.h5")
    p.add_argument("--nx", type=int, default=12)
    p.add_argument("--ny", type=int, default=12)
    p.add_argument("--num_samples", type=int, default=50,
                   help="FPS graph subsample size")
    p.add_argument("--n_steps", type=int, default=12)
    p.add_argument("--height", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict | None:
    args = build_parser().parse_args(argv)

    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.manipulation.env import ClothEnv
    from cloth_splatting_tpu_torch.manipulation.imitation import (
        HalfFoldConfig,
        imitate_demo,
        load_demo,
        record_demo,
    )

    dev = resolve_device(args.device)
    config = HalfFoldConfig(height=args.height, n_steps=args.n_steps)
    result = None
    if args.mode in ("record", "both"):
        env = ClothEnv(nx=args.nx, ny=args.ny, seed=args.seed, device=dev)
        demo = record_demo(env, config, num_graph_samples=args.num_samples,
                           out_path=args.demo)
        print(f"recorded demo -> {args.demo} "
              f"(coverage {demo['coverage'][0]:.4f} -> {demo['coverage'][-1]:.4f})")
    if args.mode in ("imitate", "both"):
        demo = load_demo(args.demo)
        env = ClothEnv(nx=args.nx, ny=args.ny, seed=args.seed + 1, device=dev)
        result = imitate_demo(demo, env, height=args.height, n_steps=args.n_steps)
        print(f"imitation coverage {result['coverage']:.4f} "
              f"(demo {result['demo_coverage']:.4f}, "
              f"ratio {result['coverage_ratio']:.3f}, "
              f"graph err {result['graph_error']})")
    return result


if __name__ == "__main__":
    main()
