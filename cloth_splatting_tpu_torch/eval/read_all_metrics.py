"""Every ``results.json`` under a root, printed per experiment and averaged;
counterpart of ``scripts/read_all_metrics.py``, with the same lines:

    python -m cloth_splatting_tpu_torch.eval.read_all_metrics --root ./output
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m cloth_splatting_tpu_torch.eval.read_all_metrics")
    p.add_argument("--root", type=str, default="./output",
                   help="directory holding the experiment directories")
    args = p.parse_args(argv)

    metrics: dict[str, list[float]] = {}
    for path in sorted(glob.glob(os.path.join(args.root, "**", "results.json"),
                                 recursive=True)):
        with open(path) as f:
            results = json.load(f)
        exp = os.path.relpath(os.path.dirname(path), args.root)
        for method, vals in results.items():
            line = "  ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                             for k, v in vals.items())
            print(f"{exp}/{method}:  {line}")
            for k, v in vals.items():
                if isinstance(v, float):
                    metrics.setdefault(k, []).append(v)

    if metrics:
        print("\n== means across experiments ==")
        for k, vs in metrics.items():
            print(f"{k}: {np.mean(vs):.4f} (n={len(vs)})")


if __name__ == "__main__":
    main()
