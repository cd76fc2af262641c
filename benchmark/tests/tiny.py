"""Tiny CPU versions of the benchmark's configurations and mixes, for the
harness's own tests."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(kind: str, name: str) -> dict:
    with open(ROOT / "benchmark" / kind / f"{name}.json") as f:
        return json.load(f)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cs_config() -> dict:
    cfg = copy.deepcopy(load("configs", "cs-field-65k"))
    cfg["image"].update(width=32, height=32)
    cfg["mesh"]["vertices_per_side"] = 6
    cfg["capacity"] = 512
    cfg["orbit"]["radius"] = 2.2
    return cfg


def mgn_config() -> dict:
    cfg = copy.deepcopy(load("configs", "mgn-15x128"))
    cfg["network"].update(message_passing_steps=2, latent_size=16, mlp_hidden_size=16)
    cfg["data"].update(trajectories=3, particles_per_side=8, steps=8)
    return cfg


def traffic(name: str) -> dict:
    tr = copy.deepcopy(load("traffic", name))
    if tr["driver"] == "fit":
        tr.update(segment=5, trace_iterations=1, enlarged={"share": 0.1, "factor": 5.0},
                  faded={"share": 0.1, "opacity": 0.001})
    elif tr["driver"] == "render":
        tr.update(warm_frames=1, check_frames=3, trace_frames=2)
    elif tr["driver"] == "gnn_train":
        tr.update(batch=4, nodes=20, pool_per_unroll=2, trace_blocks=1)
    elif tr["driver"] == "rollout":
        tr.update(candidates=3, horizon=2, nodes=12, edge_max_len=0.3,
                  normalizer_batch=4, normalizer_batches=2, warm_calls=1,
                  check_calls=2, trace_calls=2)
    return tr


CELLS = {"fit-cs65k": (cs_config, "fit-3199"), "render-cs65k": (cs_config, "novel-views"),
         "gnn-train-mgn15": (mgn_config, "curriculum-b32"),
         "rollout-mpc16": (mgn_config, "mpc-a16h4")}


def run_cpu(cell: str, seed: int = 3, seconds: float = 0.5) -> dict:
    import time

    import torch

    from benchmark import run

    make_cfg, mix = CELLS[cell]
    return run.run_loaded(manifest(), cell, make_cfg(), traffic(mix), seed, seconds,
                          False, torch.device("cpu"), time.perf_counter())
