"""The scene-parallel sweep from the command line; counterpart of the root
``train_scenes.py``:

    python -m cloth_splatting_tpu_torch.train_scenes --scenes DIR [DIR ...] \\
        --out_root OUT [train flags]

Every flag of ``python -m cloth_splatting_tpu_torch.train`` (config file
and field overrides, iterations to test and save, skips, ``--seed``,
``--three_steps_batch``, ``--quiet``), plus ``--scenes`` and ``--out_root``:
scene ``DIR`` trains into ``OUT/<basename of DIR>``, which gets its own
``cfg_args`` (the arguments with that scene's ``source_path`` and
``model_path``), so ``eval.render`` and ``eval.metrics`` read it as a
``train`` output. The coarse stage maps onto the static stage as in
``train``. Same-signature scenes train together, one per card
(``parallel/sweep.py``); ``--device cuda`` uses every visible card,
``cuda:N`` or ``cpu`` one device (one scene a group). ``--mesh`` (the
train flag) raises: a scene's device mesh is ``train --mesh``'s.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    from cloth_splatting_tpu_torch.train.__main__ import build_parser as train_parser

    parser = train_parser()
    parser.prog = "python -m cloth_splatting_tpu_torch.train_scenes"
    parser.add_argument("--scenes", nargs="+", required=True,
                        help="scene source directories")
    parser.add_argument("--out_root", type=str, default="./output",
                        help="per-scene outputs land in <out_root>/<scene name>")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh!r}: neither package runs an intra-scene device "
            "mesh from train_scenes (the JAX package's train_scenes accepts the "
            "flag and reads nothing of it); train one scene over a mesh with "
            "python -m cloth_splatting_tpu_torch.train --mesh DxM")

    import torch

    from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.parallel.sweep import train_scenes_parallel
    from cloth_splatting_tpu_torch.train.__main__ import training_config
    from cloth_splatting_tpu_torch.utils.logging import seed_everything, timestamp_stdout

    cfg = training_config(args)
    device = resolve_device(args.device)
    devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
               if device.type == "cuda" and device.index is None else [device])
    stdout = sys.stdout
    timestamp_stdout(args.quiet)
    try:
        seed_everything(args.seed)
        time_skip = args.time_skip if args.time_skip > 1 else None
        view_skip = args.view_skip if args.view_skip > 1 else None
        scenes, out_dirs = [], []
        for src in args.scenes:
            scenes.append(load_cloth_scene(
                src, cfg.model.white_background, cfg.model.eval,
                time_skip=time_skip, view_skip=view_skip, device=devices[0]))
            out = os.path.join(args.out_root, os.path.basename(os.path.normpath(src)))
            out_dirs.append(out)
            os.makedirs(out, exist_ok=True)
            # the scene's own cfg_args, so the eval entry points read it
            replay = dict(vars(args), source_path=src, model_path=out)
            replay.pop("scenes")
            replay.pop("out_root")
            with open(os.path.join(out, "cfg_args"), "w") as f:
                f.write(repr(argparse.Namespace(**replay)))

        train_scenes_parallel(
            cfg, scenes, out_dirs, devices=devices,
            test_iterations=args.test_iterations,
            save_iterations=args.save_iterations, seed=args.seed,
            three_steps_batch=args.three_steps_batch)
        print("\nSweep complete.")
    finally:
        sys.stdout = stdout


if __name__ == "__main__":
    main()
