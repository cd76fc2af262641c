"""Dynamic cloth-scene optimization from the command line:

    python -m cloth_splatting_tpu_torch.train -s SCENE -m OUT --iterations N

Every flag of the JAX package's root ``train.py``: ``--configs FILE`` (a
config file such as ``cloth_splatting_tpu/configs/cloth_splatting/default.py``,
overlaid first), every config field as ``--<name>`` (over the file; the
fields that neither package reads, ``train.config.IGNORED``, are accepted and
dropped), ``-s/--source_path``, ``-m/--model_path``, test / save /
checkpoint iterations, ``--expname``, view and time skips,
``--three_steps_batch``, ``--seed`` (seeds Python, numpy and torch),
``--save_test_images`` (on by default, as there), the live viewer's
``--ip``/``--port``/``--protocol {json,sibr}``, ``--detect_anomaly``
(``utils.profiling.enable_debug_checks``), ``--use_wandb``, ``--quiet``
(silences stdout), ``--single_cam_video``; ``--debug_from`` and
``--no_shadow`` are accepted and read by neither package. ``--mesh DxM``
trains over a (data, model) mesh of D x M ranks, one a device
(``parallel.launch``: NCCL, rank r on ``cuda:r``; with ``--device cpu``,
D x M gloo ranks on the CPU); ``--mesh auto`` builds one only when more
than one card is visible. ``--device`` defaults to ``cuda`` and raises
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _flag_type(default):
    """``add_argument`` keywords of a config field's flag: unset by default;
    a bool flag takes an optional value (``--eval`` or ``--eval false``)."""
    if isinstance(default, bool):
        return dict(default=None, type=lambda v: v.lower() not in ("0", "false"),
                    nargs="?", const=True)
    return dict(default=None, type=type(default))


def build_parser() -> argparse.ArgumentParser:
    from cloth_splatting_tpu_torch.train.config import (
        IGNORED,
        MeshnetConfig,
        ModelConfig,
        OptimizationConfig,
    )

    parser = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.train",
        description="Cloth-Splatting trainer (PyTorch + CUDA)")
    shorthand = {"source_path": "-s", "model_path": "-m", "images": "-i",
                 "resolution": "-r", "white_background": "-w"}
    seen = set()
    for group_cls in (ModelConfig, OptimizationConfig, MeshnetConfig):
        for f in dataclasses.fields(group_cls):
            seen.add(f.name)
            args = [f"--{f.name}"] + ([shorthand[f.name]] if f.name in shorthand else [])
            parser.add_argument(*args, **_flag_type(f.default))
    for fields in IGNORED.values():
        for name, default in (fields or {}).items():
            if name not in seen:
                seen.add(name)
                args = [f"--{name}"] + ([shorthand[name]] if name in shorthand else [])
                parser.add_argument(*args, **_flag_type(default),
                                    help="accepted; read by neither package")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--protocol", type=str, default="json",
                        choices=["json", "sibr"],
                        help="the live viewer's wire protocol: the JSON codec "
                             "or the SIBR remote viewer's byte protocol")
    parser.add_argument("--debug_from", type=int, default=-1,
                        help="accepted; read by neither package")
    parser.add_argument("--detect_anomaly", action="store_true")
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
    parser.add_argument("--single_cam_video", action="store_true")
    parser.add_argument("--no_shadow", action="store_true", default=True,
                        help="accepted; read by neither package")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--seed", type=int, default=6666)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--save_test_images", action="store_true", default=True)
    parser.add_argument("--mesh", type=str, default="",
                        help="multi-device training over a (data, model) "
                             "device mesh: 'auto' (every visible card, the "
                             "data axis chosen), 'DxM' (e.g. '2x4'), or '' "
                             "(one device, the default). Camera rows split "
                             "over 'data', the Gaussian capacity over 'model'; "
                             "one rank a device (gloo ranks with --device cpu)")
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


def training_config(args):
    """The config a run trains with: ``config_from_args``, then the coarse
    stage as a static stage. A "coarse" stage optimizes with the
    deformation frozen, which is the static stage here; a config that
    enables coarse (``no_coarse`` False) without its own static stage runs
    the static stage for ``coarse_iterations``."""
    cfg = config_from_args(args)
    if not cfg.opt.no_coarse and not cfg.opt.static_reconst \
            and cfg.opt.coarse_iterations > 0:
        cfg.opt.static_reconst = True
        cfg.opt.static_reconst_iteration = cfg.opt.coarse_iterations
    return cfg


def mesh_from_args(parser, spec: str, device) -> tuple[int, int] | None:
    """(D, M) of ``--mesh`` on ``device``, or None for one device: 'auto'
    is every visible card when there are several (none on the CPU); 'DxM'
    needs D x M visible cards (any number of CPU ranks)."""
    import torch

    from cloth_splatting_tpu_torch.parallel.mesh import mesh_shape

    on_card = device.type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    if not spec:
        return None
    if spec == "auto":
        return mesh_shape(n_cards) if n_cards > 1 else None
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        parser.error(f"--mesh must be 'auto' or 'DxM', got {spec!r}")
    if d < 1 or m < 1:
        parser.error(f"--mesh must be 'auto' or 'DxM', got {spec!r}")
    if on_card and d * m > n_cards:
        parser.error(f"--mesh {spec} needs {d * m} devices, have {n_cards}")
    return d, m


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = training_config(args)

    import torch.distributed as dist

    from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.train.loop import train_scene
    from cloth_splatting_tpu_torch.utils import viewer
    from cloth_splatting_tpu_torch.utils.logging import (
        WandbAdapter,
        seed_everything,
        timestamp_stdout,
    )

    if not cfg.model.source_path:
        parser.error("--source_path/-s is required")
    device = resolve_device(args.device)
    shape = mesh_from_args(parser, args.mesh, device)
    device_mesh, lead = None, True
    if shape is not None:
        if not dist.is_initialized():
            from cloth_splatting_tpu_torch.parallel.launch import launch, main_rank

            launch(main_rank, shape[0] * shape[1], device,
                   args=("cloth_splatting_tpu_torch.train.__main__",
                         list(sys.argv[1:] if argv is None else argv)))
            return
        from cloth_splatting_tpu_torch.parallel.mesh import make_mesh

        device_mesh = make_mesh(shape[0] * shape[1], data=shape[0])
        lead = dist.get_rank() == 0
    stdout = sys.stdout
    timestamp_stdout(args.quiet)
    try:
        seed_everything(args.seed)
        if args.detect_anomaly:
            from cloth_splatting_tpu_torch.utils.profiling import enable_debug_checks

            enable_debug_checks()
        if not cfg.model.model_path:
            cfg.model.model_path = os.path.join("./output/", args.expname)
        if lead:
            os.makedirs(cfg.model.model_path, exist_ok=True)
            with open(os.path.join(cfg.model.model_path, "cfg_args"), "w") as f:
                f.write(repr(argparse.Namespace(**vars(args))))

        print(f"Optimizing {cfg.model.model_path}")
        scene = load_cloth_scene(
            cfg.model.source_path, cfg.model.white_background, cfg.model.eval,
            time_skip=args.time_skip if args.time_skip > 1 else None,
            view_skip=args.view_skip if args.view_skip > 1 else None,
            single_cam_video=args.single_cam_video, device=device)
        viewer_enabled = False
        if lead:
            try:
                viewer.init(args.ip, args.port, wire_protocol=args.protocol)
                viewer_enabled = True
            except OSError as exc:
                print(f"viewer disabled ({exc})")
        if device_mesh is not None:
            from cloth_splatting_tpu_torch.parallel.mesh import agree, mesh_axes

            viewer_enabled = agree(viewer_enabled, mesh_axes(device_mesh).world)
        wandb = (WandbAdapter(project=args.expname, name=args.expname,
                              config=vars(args), enabled=True)
                 if args.use_wandb and lead else None)
        train_scene(
            cfg, scene, cfg.model.model_path,
            test_iterations=args.test_iterations,
            save_iterations=args.save_iterations,
            checkpoint_iterations=args.checkpoint_iterations,
            start_checkpoint=args.start_checkpoint, seed=args.seed,
            three_steps_batch=args.three_steps_batch,
            save_test_images=args.save_test_images, wandb=wandb,
            viewer_enabled=viewer_enabled, device=device, device_mesh=device_mesh)
        if wandb is not None:
            wandb.finish()
        print("\nTraining complete.")
    finally:
        viewer.shutdown()
        sys.stdout = stdout


if __name__ == "__main__":
    main()
