"""Randomized deformed-cloth-mesh generation from the command line;
counterpart of the root ``deform_mesh.py``:

    python -m cloth_splatting_tpu_torch.deform_mesh --config artf

Drops a cloth with randomized physics, folds it along a keypoint-biased
circular arc (ARTF) or drags it (ClothFunnels), and exports each sample's
observed mesh sequence (``manipulation.deform_mesh``; the observations file
needs ``h5py``). The flags of the root script, plus ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate randomized deformed cloth meshes")
    p.add_argument("--out", type=str, default="./deformed_meshes")
    p.add_argument("--config", choices=["artf", "clothfunnels"], default="artf")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--cloth_size", type=float, default=0.3)
    p.add_argument("--fold_steps", type=int, default=24)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)

    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.manipulation.deform_mesh import (
        ARTFDeformationConfig,
        ClothFunnelsDeformationConfig,
        generate_deformed_meshes,
    )

    config = (ARTFDeformationConfig() if args.config == "artf"
              else ClothFunnelsDeformationConfig())
    dirs = generate_deformed_meshes(
        config, args.out, n_samples=args.n_samples, seed=args.seed,
        nx=args.nx, ny=args.ny, cloth_size=args.cloth_size,
        fold_steps=args.fold_steps, image_size=args.image_size,
        device=resolve_device(args.device))
    for d in dirs:
        print(d)
    return dirs


if __name__ == "__main__":
    main()
