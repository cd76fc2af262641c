"""What the MeshGraphNet drivers share: the raw trajectories and the
program's view of a network made by ``harness.graphs``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import graphs


def raw_trajectories(data: dict, device) -> list:
    """Raw pick-and-place trajectories of a settled cloth, made by the
    program's particle simulator from the configuration's fixed data seed:
    the data both sides read."""
    from cloth_splatting_tpu_torch.manipulation.collect import collect_trajectories

    return collect_trajectories(data["trajectories"], nx=data["particles_per_side"],
                                ny=data["particles_per_side"],
                                cloth_size=data["cloth_size"], n_steps=data["steps"],
                                seed=data["seed"], device=device)


def processed(cfg: dict, n_nodes: int, max_len: float, device) -> list:
    data = cfg["data"]
    rng = np.random.default_rng(data["seed"])
    return [graphs.process(r, n_nodes, max_len, rng) for r in raw_trajectories(data, device)]


def program_state(weights: dict, norms: dict | None, device) -> dict:
    """The program's simulator state: the parameter tree (copies) and
    normalizers holding ``norms``' sums (zero when None)."""
    from cloth_splatting_tpu_torch.models.meshnet import NormalizerState

    def normalizer(acc, dim):
        if acc is None:
            z = torch.zeros(dim, device=device)
            acc = {"sum": z, "sum_sq": z, "count": torch.zeros((), device=device)}
        return NormalizerState(acc_sum=acc["sum"].clone()[None],
                               acc_sum_sq=acc["sum_sq"].clone()[None],
                               acc_count=acc["count"].clone().float(),
                               num_accumulations=torch.zeros((), device=device))

    node_dim = weights["encoder/node/layers/0/w"].shape[0]
    return {"gnn": graphs.tree({k: v.clone() for k, v in weights.items()}),
            "node_norm": normalizer(None if norms is None else norms["node"], node_dim),
            "out_norm": normalizer(None if norms is None else norms["out"], 3)}
