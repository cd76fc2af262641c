"""Inputs of the MeshGraphNet configurations: graphs, batches and weights.

Raw cloth trajectories (particle positions over time, the grasped
particle's actions, pick and place points) are the data both sides read.
From them this module makes, with its own code: the sampled graphs
(farthest-point subsampling of the particles, Delaunay edges of the rest
pose in the cloth's plane, long edges dropped), the padded training
batches in the layout the program's training step takes, the planner's
rollout requests, and the network's weights and normalizer sums from a
seed on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial import Delaunay

from benchmark.reference import mgn


def farthest_points(points: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Indices of ``k`` points chosen one at a time farthest from those
    chosen, from a random first one."""
    chosen = [int(rng.integers(points.shape[0]))]
    d = np.linalg.norm(points - points[chosen[0]], axis=1)
    for _ in range(k - 1):
        i = int(np.argmax(d))
        chosen.append(i)
        d = np.minimum(d, np.linalg.norm(points - points[i], axis=1))
    return np.asarray(chosen)


def delaunay_graph(points: np.ndarray, max_len: float) -> np.ndarray:
    """Both directions [2, E] of the edges of the Delaunay triangles of the
    points' (x, y) whose three edges are all shorter than ``max_len``."""
    tri = Delaunay(points[:, :2]).simplices
    edges = set()
    for a, b, c in tri:
        sides = ((a, b), (b, c), (c, a))
        if all(np.linalg.norm(points[i] - points[j]) < max_len for i, j in sides):
            edges.update((min(i, j), max(i, j)) for i, j in sides)
    e = np.asarray(sorted(edges), np.int64).T
    return np.concatenate([e, e[::-1]], 1)


def process(raw: dict, n_nodes: int, max_len: float, rng: np.random.Generator) -> dict:
    """A raw trajectory (y up) as the network sees it (z up), on ``n_nodes``
    sampled particles: positions, velocities, actions, edges, node types."""
    pos = raw["pos"][:, :, [0, 2, 1]].astype(np.float32)
    actions = raw["actions"][:, [0, 2, 1]].astype(np.float32)
    pick = raw["pick"][[0, 2, 1]].astype(np.float32)
    pos = pos[:, farthest_points(pos[0], n_nodes, rng)]
    vel = np.zeros_like(pos)
    vel[1:] = pos[1:] - pos[:-1]
    grasped = int(np.argmin(np.linalg.norm(pos[0] - pick[None], axis=1)))
    node_type = np.zeros(pos.shape[1], np.int64)
    node_type[grasped] = 1
    return {"pos": pos, "vel": vel, "actions": actions, "grasped": grasped,
            "node_type": node_type, "edges": delaunay_graph(pos[0], max_len)}


def sample_batch(trajs: list, rng: np.random.Generator, batch: int, future: int,
                 hist: int) -> dict:
    """A padded batch of ``batch`` samples, each a trajectory and a time
    drawn from ``rng``: the velocity history before the time, the positions
    with the grasped particle moved by its first action, the next
    ``future`` velocities as targets and the grasped particle's actions."""
    e_max = max(t["edges"].shape[1] for t in trajs)
    out = {k: [] for k in ("velocity", "node_type", "positions", "edge_index",
                           "edge_mask", "target_vel", "particle_actions")}
    for _ in range(batch):
        t = trajs[int(rng.integers(len(trajs)))]
        n_t, v = t["pos"].shape[:2]
        ti = 1 + int(rng.integers(n_t - future))
        vel = np.concatenate([t["vel"][max(ti - hist + k, 0)] for k in range(hist)], 1)
        target = t["vel"][ti:ti + future].transpose(1, 0, 2)
        acts = t["actions"][ti - 1:ti - 1 + future]
        g = t["grasped"]
        pa = np.zeros((v, future, 3), np.float32)
        pa[g] = acts
        pos = t["pos"][ti - 1].copy()
        pos[g] += acts[0]
        vel = vel.copy()
        vel[g, -3:] = target[g, 0]
        e = t["edges"]
        ei = np.zeros((2, e_max), np.int64)
        ei[:, :e.shape[1]] = e
        mask = np.zeros(e_max, bool)
        mask[:e.shape[1]] = True
        for k, x in (("velocity", vel), ("node_type", t["node_type"]), ("positions", pos),
                     ("edge_index", ei), ("edge_mask", mask), ("target_vel", target),
                     ("particle_actions", pa)):
            out[k].append(x)
    return {k: np.stack(v).astype(np.float32 if v[0].dtype.kind == "f" else v[0].dtype)
            for k, v in out.items()}


def batch_tensors(batch: dict, device) -> dict:
    """A numpy batch as the reference's tensors [B, V, ...]."""
    t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    t["src"], t["dst"] = t["edge_index"][:, 0], t["edge_index"][:, 1]
    t["edge_mask"] = t["edge_mask"].float()
    return t


def mlp_sizes(cfg: dict) -> dict:
    """Layer sizes of every MLP of the network, by its path."""
    lat, hid, nl = cfg["latent_size"], cfg["mlp_hidden_size"], cfg["mlp_hidden_layers"]
    node_in = 3 * cfg["input_sequence_length"] + cfg["node_types"]
    sizes = {"encoder/node": [node_in] + [hid] * nl + [lat],
             "encoder/edge": [cfg["edge_features"]] + [hid] * nl + [lat]}
    for k in range(cfg["message_passing_steps"]):
        sizes[f"processor/{k}/edge"] = [3 * lat] + [hid] * nl + [lat]
        sizes[f"processor/{k}/node"] = [2 * lat] + [hid] * nl + [lat]
    sizes["decoder"] = [lat] + [hid] * nl + [cfg["output_size"]]
    return sizes


def weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """The network's parameters by path, U(+-1/sqrt(in)) weights and biases
    drawn in one call, LayerNorm scales 1 and biases 0."""
    sizes = mlp_sizes(cfg)
    shapes = []
    for path, s in sizes.items():
        for i in range(len(s) - 1):
            shapes += [(f"{path}/layers/{i}/w", (s[i], s[i + 1]), s[i]),
                       (f"{path}/layers/{i}/b", (s[i + 1],), s[i])]
    total = sum(math.prod(shape) for _, shape, _ in shapes)
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        out[name] = u[at:at + n].reshape(shape) / math.sqrt(fan_in)
        at += n
    for path in sizes:
        if path != "decoder":
            out[f"{path}/ln_scale"] = torch.ones(sizes[path][-1], device=device)
            out[f"{path}/ln_bias"] = torch.zeros(sizes[path][-1], device=device)
    return out


def tree(flat: dict):
    """The program's nested parameter tree of leaves by path."""
    root: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def listify(x):
        if isinstance(x, dict):
            if x and all(k.isdigit() for k in x):
                return [listify(x[str(i)]) for i in range(len(x))]
            return {k: listify(v) for k, v in x.items()}
        return x

    return listify(root)


def normalizer_sums(batches: list, hist: int, device) -> dict:
    """Normalizer sums ({"node", "out"}) over the first-step node features
    and target accelerations of ``batches``."""
    node_dim = 3 * hist + 2
    norms = {"node": {"sum": torch.zeros(node_dim, device=device),
                      "sum_sq": torch.zeros(node_dim, device=device),
                      "count": torch.zeros((), device=device)},
             "out": {"sum": torch.zeros(3, device=device),
                     "sum_sq": torch.zeros(3, device=device),
                     "count": torch.zeros((), device=device)}}
    for b in batches:
        t = batch_tensors(b, device)
        norms["node"] = mgn.accumulate(norms["node"],
                                       mgn.node_features(t["velocity"], t["node_type"]))
        norms["out"] = mgn.accumulate(norms["out"],
                                      t["target_vel"][:, :, 0] - t["velocity"][..., -3:])
    return norms
