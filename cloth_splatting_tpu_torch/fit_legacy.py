"""Static free-xyz 3DGS fit of a legacy scene (COLMAP or NeRF-synthetic /
D-NeRF); counterpart of the root ``fit_legacy.py``:

    python -m cloth_splatting_tpu_torch.fit_legacy -s SCENE --type Colmap
    python -m cloth_splatting_tpu_torch.fit_legacy -s SCENE --type Blender -w

Loads the scene (``data/legacy.py``), keeps the training cameras that share
the first one's intrinsics (at most ``--max_cameras``), initializes the
free-xyz model from the scene's point cloud, fits it
(``models.point_gaussians.fit_static_scene``: the training rasterizer, K2/K3
on the card, exact and uncapped, with the published schedule and density
control), renders up to 10 held-out cameras (else the first 4 training
cameras) through the serving rasterizer (K1 on the card), uncapped too, and
writes ``point_cloud.ply`` (the live Gaussians) and ``results.json``
({"ours_static": {"PSNR", "final_loss", "iterations"}}) under
``--model_path``. Every flag of the root script but ``--k_cap`` (its dense
tier's instances a tile: the port's fit and render keep every instance),
plus ``--device`` (default ``cuda``; raises without a card).
Decoding the images needs PIL.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m cloth_splatting_tpu_torch.fit_legacy",
                                description="Static 3DGS fit on legacy scenes")
    p.add_argument("--source_path", "-s", type=str, required=True)
    p.add_argument("--model_path", "-m", type=str, default="./output/legacy")
    p.add_argument("--type", choices=["Colmap", "Blender"], default="Colmap")
    p.add_argument("--images", type=str, default=None,
                   help="COLMAP images subdirectory")
    p.add_argument("--eval", action="store_true", default=False,
                   help="hold out every llffhold-th camera")
    p.add_argument("--llffhold", type=int, default=8)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--max_cameras", type=int, default=50,
                   help="cap on decoded training cameras (memory)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import torch

    from cloth_splatting_tpu_torch.data.legacy import load_colmap_scene, load_dnerf_scene
    from cloth_splatting_tpu_torch.data.ply_io import gaussian_ply_columns, write_ply
    from cloth_splatting_tpu_torch.data.scene import decode_image
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.image import psnr
    from cloth_splatting_tpu_torch.render import camera_arrays

    dev = resolve_device(args.device)
    if args.type == "Colmap":
        scene = load_colmap_scene(args.source_path, images=args.images,
                                  eval_split=args.eval, llffhold=args.llffhold)
    else:
        scene = load_dnerf_scene(args.source_path,
                                 white_background=args.white_background,
                                 eval_split=args.eval, seed=args.seed)
    if scene.point_cloud is None:
        raise SystemExit("scene has no point cloud to initialize from")

    cam0 = scene.train[0].camera
    w, h = cam0.width, cam0.height
    tanx, tany = np.tan(cam0.fovx / 2), np.tan(cam0.fovy / 2)
    # a COLMAP reconstruction can mix camera models and sizes; the fit runs
    # at one (w, h, fov), so only cameras matching the first one are kept
    same_cam = [r for r in scene.train
                if (r.camera.width, r.camera.height) == (w, h)
                and abs(r.camera.fovx - cam0.fovx) < 1e-9]
    if len(same_cam) < len(scene.train):
        print(f"dropping {len(scene.train) - len(same_cam)} cameras with "
              f"differing intrinsics (fit is single-intrinsics)")
    recs = same_cam[:args.max_cameras]

    def image(rec):
        img = decode_image(rec.image_path, args.white_background)
        return torch.from_numpy(img).to(dev).to(torch.float32) / 255.0

    cams = [camera_arrays(r.camera, dev) for r in recs]
    gts = [image(r) for r in recs]
    print(f"{args.type} scene: {len(recs)} train cams {w}x{h}, "
          f"{scene.point_cloud.points.shape[0]} init points, "
          f"radius {scene.radius:.3f}")

    params, state, loss = PG.fit_static_scene(
        cams, gts, scene.point_cloud, w, h, tanx, tany,
        sh_degree=args.sh_degree, iterations=args.iterations, seed=args.seed,
        white_background=args.white_background, device=dev)
    print(f"final train loss: {loss:.5f}")

    # held-out evaluation (same-size cameras only)
    test = [r for r in scene.test
            if (r.camera.width, r.camera.height) == (w, h)][:10] or recs[:4]
    bg = (1.0, 1.0, 1.0) if args.white_background else (0.0, 0.0, 0.0)
    psnrs = []
    with torch.no_grad():
        for r in test:
            rgb, _, _ = PG.render_points(params, state, camera_arrays(r.camera, dev),
                                         w, h, tanx, tany, bg, args.sh_degree)
            psnrs.append(float(psnr(torch.clamp(rgb, 0, 1)[None], image(r)[None])[0]))
    mean_psnr = float(np.mean(psnrs))
    print(f"test PSNR: {mean_psnr:.2f} dB over {len(test)} cameras")

    os.makedirs(args.model_path, exist_ok=True)
    alive = state.alive.cpu().numpy()

    def rows(x):
        return x.cpu().numpy()[alive]

    cols = gaussian_ply_columns(rows(params.xyz), rows(params.features_dc),
                                rows(params.features_rest), rows(params.opacity),
                                rows(params.scaling), rows(params.rotation))
    write_ply(os.path.join(args.model_path, "point_cloud.ply"), cols)
    with open(os.path.join(args.model_path, "results.json"), "w") as f:
        json.dump({"ours_static": {"PSNR": mean_psnr, "final_loss": loss,
                                   "iterations": args.iterations}}, f, indent=2)
    print(f"-> {args.model_path}")


if __name__ == "__main__":
    main()
