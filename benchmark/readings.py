"""The two readings each limit of ``correct`` is set from, on the card.

    python3 -m benchmark.readings --workload NAME --seeds 11 12 13 ... \
        [--seconds S] [--control-seeds 11 12 13]

For each seed: the cell's set-up and a window of ``--seconds`` (long
enough to finish the answers a serving cell compares), then the program's
compared numbers (the lower reading is their largest over the seeds), and
on the ``--control-seeds`` the control's: the reference computed in TF32,
the precision below the configuration's float32 with TF32 off, put in the
program's place (the upper reading is their smallest), and on the
``--fault-seeds`` a training cell's faults planted in the reference put in
the program's place (``Driver.faults``). One JSON line a seed; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

import torch

from benchmark import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    run.set_cache_dirs(run.ROOT)
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, config, traffic = run.cell_entries(manifest, args.workload)
    cfg = run.load_json(run.ROOT / config["file"])
    from cloth_splatting_tpu_torch import kernels

    kernels.build_all()
    dev = torch.device("cuda")
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    print(f"readings: {args.workload} [{run.gpu_line()}]", file=sys.stderr)
    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        d = mod.Driver(cfg, traffic, seed, dev)
        d.setup()
        d.window(args.seconds)
        d.release()
        gc.collect()
        torch.cuda.empty_cache()
        rec = {"seed": seed}
        if seed in args.seeds:
            rec["program"] = d.check()
        if seed in args.fault_seeds:
            rec["faults"] = d.faults()
        if seed in args.control_seeds:
            rec["control"] = d.control()
        print(json.dumps(rec), flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
