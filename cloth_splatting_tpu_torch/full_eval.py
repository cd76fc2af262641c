"""Train, render and score a list of scenes, then read every result;
counterpart of the root ``full_eval.py``:

    python -m cloth_splatting_tpu_torch.full_eval -d DATA_ROOT [-o OUTPUT_ROOT]

For each scene under ``DATA_ROOT``: ``train`` (with ``--configs`` and
``--view_skip``), ``eval.render --skip_train --log_deform`` and
``eval.metrics``, each the port's command line in a process of its own;
then ``eval.read_all_metrics`` over ``OUTPUT_ROOT``. ``--device`` goes to
each of them.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m cloth_splatting_tpu_torch.full_eval")
    p.add_argument("--data_root", "-d", type=str, required=True)
    p.add_argument("--output_root", "-o", type=str, default="./output")
    p.add_argument("--scenes", nargs="+",
                   default=["TOWEL_00_03", "TSHIRT_01_00", "TSHIRT_01_01",
                            "SHORTS_01_00", "SHORTS_01_01"])
    p.add_argument("--configs", type=str,
                   default="cloth_splatting_tpu/configs/cloth_splatting/default.py")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--view_skip", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    def cli(module: str, *rest: str) -> list[str]:
        return [sys.executable, "-m", f"cloth_splatting_tpu_torch.{module}", *rest]

    dev = ["--device", args.device]
    for scene in args.scenes:
        src = os.path.join(args.data_root, scene)
        out = os.path.join(args.output_root, scene)
        if not args.skip_training:
            run(cli("train", "-s", src, "-m", out, "--configs", args.configs,
                    "--view_skip", str(args.view_skip), "--expname", scene, *dev))
        if not args.skip_rendering:
            run(cli("eval.render", "-m", out, "-s", src, "--skip_train",
                    "--log_deform", *dev))
        if not args.skip_metrics:
            run(cli("eval.metrics", "-m", out, *dev))
    run(cli("eval.read_all_metrics", "--root", args.output_root))


if __name__ == "__main__":
    main()
