"""Evaluation rendering from the command line; counterpart of the root
``render.py``:

    python -m cloth_splatting_tpu_torch.eval.render -m MODEL [-s SCENE]

Renders the train, test and video splits of a trained model (``--skip_*``
leave one out), prints FPS as ``(n_views - 1) / elapsed``, writes per-frame
PNGs and ``video_rgb.mp4``, and with ``--log_deform`` exports the tracked 3D
trajectories (``all_trajs.npz``; ``--track_vertices`` tracks the mesh
vertices instead of the Gaussians). The scene path comes from the model's
``cfg_args`` unless ``-s`` gives it. ``--device`` defaults to ``cuda`` and
raises without a card.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.eval.render",
        description="Cloth-Splatting renderer (PyTorch + CUDA)")
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--log_deform", action="store_true")
    parser.add_argument("--track_vertices", action="store_true")
    parser.add_argument("--show_flow", action="store_true")
    parser.add_argument("--flow_skip", type=int, default=None,
                        help="track every N-th Gaussian in --show_flow overlays")
    parser.add_argument("--view_skip", type=int, default=1)
    parser.add_argument("--time_skip", type=int, default=1)
    parser.add_argument("--single_cam_video", action="store_true")
    parser.add_argument("--white_background", "-w", action="store_true", default=True)
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--configs", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    # the scene path saved by the trainer (cfg_args, a Namespace repr)
    cfg_path = os.path.join(args.model_path, "cfg_args")
    if os.path.exists(cfg_path) and args.source_path is None:
        with open(cfg_path) as f:
            saved = eval(f.read(), {"Namespace": argparse.Namespace})
        args.source_path = getattr(saved, "source_path", None)
    if not args.source_path:
        parser.error("--source_path required (not found in cfg_args)")

    import torch

    from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.eval.render_sets import load_trained_model, render_set

    dev = resolve_device(args.device)
    scene = load_cloth_scene(
        args.source_path, args.white_background, True,
        time_skip=args.time_skip if args.time_skip > 1 else None,
        view_skip=args.view_skip if args.view_skip > 1 else None,
        single_cam_video=args.single_cam_video, device=dev)
    params, state, mesh, simulator, iteration = load_trained_model(
        args.model_path, args.iteration, device=dev)
    preds = torch.as_tensor(scene.mesh_predictions, dtype=torch.float32, device=dev)

    def run(split, cams, paths, log_deform):
        return render_set(
            args.model_path, split, iteration, cams, paths, params, state, mesh,
            simulator, preds, args.white_background, args.sh_degree,
            log_deform=log_deform, track_vertices=args.track_vertices,
            show_flow=args.show_flow, flow_skip=args.flow_skip, device=dev)

    results = {}
    for split, grid, skip in (("train", scene.train, args.skip_train),
                              ("test", scene.test, args.skip_test)):
        if not skip:
            results[split] = run(split, [r.camera for r in grid.records],
                                 [r.image_path for r in grid.records],
                                 args.log_deform)
    if not args.skip_video:
        results["video"] = run("video", scene.video_cameras, None, False)
    for split, r in results.items():
        print(f"{split}: FPS {r['fps']:.2f} -> {r['out_dir']}")
    return results


if __name__ == "__main__":
    main()
