"""Novel-view metrics from the command line; counterpart of the root
``metrics.py``:

    python -m cloth_splatting_tpu_torch.eval.metrics -m MODEL [--splits test train]

Walks ``<model>/<split>/<method>/{renders,gt}``, scores each pair with SSIM,
PSNR and LPIPS-vgg, and writes ``results.json``, ``per_view.json`` and
``results.txt`` in the root CLI's schema (test-split keys are method names,
other splits ``<split>/<method>``; each result says which ``lpips_weights``
it used). Without ``--lpips_weights`` LPIPS runs on the deterministic
``fixture-v1`` weights (``eval/lpips.py``). ``--device`` defaults to
``cuda`` and raises without a card. Reading PNGs needs PIL;
``score_images`` scores tensors held in memory and needs none.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterable

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.eval import lpips as L
from cloth_splatting_tpu_torch.ops.image import psnr as psnr_fn
from cloth_splatting_tpu_torch.ops.ssim import ssim as ssim_fn


@torch.no_grad()
def score_images(pairs: Iterable[tuple[torch.Tensor, torch.Tensor]],
                 lpips_weights: dict[str, torch.Tensor] | None = None
                 ) -> dict[str, list[float]]:
    """Per-image {'SSIM', 'PSNR', 'LPIPS'} of (render, ground truth) pairs of
    [3, H, W] float images in [0, 1] on one device; LPIPS is empty without
    weights (``lpips.to_torch`` / ``lpips.load_weights``)."""
    out: dict[str, list[float]] = {"SSIM": [], "PSNR": [], "LPIPS": []}
    for r, g in pairs:
        out["SSIM"].append(float(ssim_fn(r, g)))
        out["PSNR"].append(float(psnr_fn(r, g)))
        if lpips_weights is not None:
            out["LPIPS"].append(float(L.lpips(lpips_weights, r[None], g[None])[0]))
    return out


def _read_png(path: str, dev: torch.device) -> torch.Tensor:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32).transpose(2, 0, 1) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def evaluate(model_paths, lpips_weights_path: str | None = None,
             splits=("test",), device: str | torch.device = "cuda") -> None:
    """Score every method directory of ``splits`` under each model path and
    write its ``results.json``, ``per_view.json`` and ``results.txt``."""
    dev = resolve_device(device)
    if L.available(lpips_weights_path):
        lpips_w = L.load_weights(lpips_weights_path, dev)
        lpips_kind = "pretrained"
    else:
        lpips_w = L.to_torch(L.fixture_weights(), dev)
        lpips_kind = L.FIXTURE_VERSION
        print("LPIPS: no pretrained weights provided; using the "
              f"deterministic {lpips_kind} weights "
              "(see scripts/export_lpips_weights.py for real LPIPS-vgg)")

    for model_path in model_paths:
        print(f"Scene: {model_path}")
        full, per_view = {}, {}
        split_methods = []
        for split in splits:
            split_dir = os.path.join(model_path, split)
            if not os.path.isdir(split_dir):
                print(f"  no {split} dir in {model_path}")
                continue
            for method in sorted(os.listdir(split_dir)):
                split_methods.append((split, method))
        for split, method in split_methods:
            mdir = os.path.join(model_path, split, method)
            renders_dir = os.path.join(mdir, "renders")
            gt_dir = os.path.join(mdir, "gt")
            if not (os.path.isdir(renders_dir) and os.path.isdir(gt_dir)):
                continue
            key = method if split == "test" else f"{split}/{method}"
            print(f"  method: {key}")
            names = [n for n in sorted(os.listdir(renders_dir))
                     if os.path.exists(os.path.join(gt_dir, n))]
            scores = score_images(
                ((_read_png(os.path.join(renders_dir, n), dev),
                  _read_png(os.path.join(gt_dir, n), dev)) for n in names),
                lpips_w)
            res = {k: float(np.mean(v)) if v else None
                   for k, v in scores.items()}
            print(f"    SSIM: {res['SSIM']}  PSNR: {res['PSNR']}  LPIPS: {res['LPIPS']}")
            res["lpips_weights"] = lpips_kind
            full[key] = res
            per_view[key] = {k: dict(zip(names, v)) for k, v in scores.items()}
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        with open(os.path.join(model_path, "results.txt"), "w") as f:
            for method, res in full.items():
                f.write(f"{method}: SSIM {res['SSIM']} PSNR {res['PSNR']} "
                        f"LPIPS {res['LPIPS']}\n")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.eval.metrics",
        description="NVS metric evaluation (PyTorch + CUDA)")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--splits", nargs="+", default=["test"],
                        help="render splits to score (default: test, the "
                             "reference schema; add train for diagnostics)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, args.lpips_weights, splits=tuple(args.splits),
             device=args.device)


if __name__ == "__main__":
    main()
