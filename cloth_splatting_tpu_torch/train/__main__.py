"""Dynamic cloth-scene optimization from the command line:

    python -m cloth_splatting_tpu_torch.train -s SCENE -m OUT --iterations N

The flags of the JAX package's root ``train.py`` that map to ported code:
``--configs FILE`` (a config file such as
``cloth_splatting_tpu/configs/cloth_splatting/default.py``, overlaid first),
every field of the port's config groups as ``--<name>`` (over the file),
``-s/--source_path``, ``-m/--model_path``, test / save / checkpoint
iterations, ``--expname``, view and time skips, ``--three_steps_batch``,
``--seed``, ``--save_test_images`` (on by default, as there). ``--device``
defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_parser() -> argparse.ArgumentParser:
    from cloth_splatting_tpu_torch.train.config import (
        MeshnetConfig,
        ModelConfig,
        OptimizationConfig,
    )

    parser = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.train",
        description="Cloth-Splatting trainer (PyTorch + CUDA)")
    shorthand = {"source_path": "-s", "model_path": "-m", "white_background": "-w"}
    for group_cls in (ModelConfig, OptimizationConfig, MeshnetConfig):
        for f in dataclasses.fields(group_cls):
            args = [f"--{f.name}"]
            if f.name in shorthand:
                args.append(shorthand[f.name])
            if isinstance(f.default, bool):
                parser.add_argument(*args, default=None,
                                    type=lambda v: v.lower() not in ("0", "false"),
                                    nargs="?", const=True)
            else:
                parser.add_argument(*args, default=None, type=type(f.default))
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[500, 1500, 3000, 4500, 6000, 7000, 7500, 8000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[8000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--expname", type=str, default="cloth_torch")
    parser.add_argument("--configs", type=str, default="")
    parser.add_argument("--three_steps_batch",
                        type=lambda v: v.lower() not in ("0", "false"),
                        default=True,
                        help="3-consecutive-time camera batches (default); "
                             "False = one random camera per iteration")
    parser.add_argument("--view_skip", type=int, default=1)
    parser.add_argument("--time_skip", type=int, default=1)
    parser.add_argument("--seed", type=int, default=6666)
    parser.add_argument("--save_test_images", action="store_true", default=True)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def config_from_args(args):
    from cloth_splatting_tpu_torch.train.config import Config, load_config_file

    cfg = Config()
    if args.configs:
        cfg = load_config_file(cfg, args.configs)
    for group in (cfg.model, cfg.opt, cfg.meshnet):
        for f in dataclasses.fields(group):
            v = getattr(args, f.name, None)
            if v is not None:
                setattr(group, f.name, v)
    return cfg


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.train.loop import train_scene

    if not cfg.model.source_path:
        parser.error("--source_path/-s is required")
    device = resolve_device(args.device)
    if not cfg.model.model_path:
        cfg.model.model_path = os.path.join("./output/", args.expname)
    os.makedirs(cfg.model.model_path, exist_ok=True)
    with open(os.path.join(cfg.model.model_path, "cfg_args"), "w") as f:
        f.write(repr(argparse.Namespace(**vars(args))))

    # a "coarse" stage optimizes with the deformation frozen, which is the
    # static stage here; a config that enables coarse without its own static
    # stage runs the static stage for coarse_iterations
    if not cfg.opt.no_coarse and not cfg.opt.static_reconst \
            and cfg.opt.coarse_iterations > 0:
        cfg.opt.static_reconst = True
        cfg.opt.static_reconst_iteration = cfg.opt.coarse_iterations

    print(f"Optimizing {cfg.model.model_path}")
    scene = load_cloth_scene(
        cfg.model.source_path, cfg.model.white_background, cfg.model.eval,
        time_skip=args.time_skip if args.time_skip > 1 else None,
        view_skip=args.view_skip if args.view_skip > 1 else None,
        device=device)
    train_scene(
        cfg, scene, cfg.model.model_path,
        test_iterations=args.test_iterations,
        save_iterations=args.save_iterations,
        checkpoint_iterations=args.checkpoint_iterations,
        start_checkpoint=args.start_checkpoint, seed=args.seed,
        three_steps_batch=args.three_steps_batch,
        save_test_images=args.save_test_images, device=device)
    print("\nTraining complete.")


if __name__ == "__main__":
    main()
