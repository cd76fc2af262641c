"""Plain PyTorch reference of the action-conditioned MeshGraphNet.

Encode-process-decode after Pfaff et al. (ICLR 2021): node and edge MLPs
(two hidden layers, ReLU, LayerNorm on every MLP but the decoder),
``n`` residual message-passing layers whose edge update sees [x_target,
x_source, e] and whose messages are summed at the target node, and a
decoder to per-node accelerations. Node features are the velocity history
and a one-hot node type, edge features the displacement and its length;
inputs and outputs pass through accumulated mean/std normalizers.

Each sample is its own graph here: a batch is a leading dimension and the
edges of a sample index its own nodes, so nothing is flattened into one
graph the way the program does. A parameter tree is the program's layout
(``encoder``/``processor``/``decoder`` dicts of ``layers`` lists of ``w``
[in, out] and ``b``, with ``ln_scale``/``ln_bias``), its leaves by their
``a/b/0/w`` paths.
Imports torch only.
"""

from __future__ import annotations

import torch

STD_EPS = 1e-8


def mlp(p: dict, prefix: str, x: torch.Tensor, n_layers: int, norm: bool) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"{prefix}/layers/{i}/w"] + p[f"{prefix}/layers/{i}/b"]
        if i < n_layers - 1:
            x = torch.relu(x)
    if norm:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5) * p[f"{prefix}/ln_scale"] \
            + p[f"{prefix}/ln_bias"]
    return x


def gnn(p: dict, nodes: torch.Tensor, edges: torch.Tensor, src: torch.Tensor,
        dst: torch.Tensor, n_layers: int, n_mp: int,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-node outputs [B, V, out] of node features [B, V, F] and edge
    features [B, E, 4] over each sample's edges (src, dst [B, E]); an edge
    whose ``mask`` is False (padding) sends no message."""
    x = mlp(p, "encoder/node", nodes, n_layers, True)
    e = mlp(p, "encoder/edge", edges, n_layers, True)

    def take(t, idx):
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    for k in range(n_mp):
        msg = mlp(p, f"processor/{k}/edge", torch.cat([take(x, dst), take(x, src), e], -1),
                  n_layers, True)
        sent = msg if mask is None else msg * mask[..., None]
        agg = torch.zeros_like(x).scatter_add(1, dst[..., None].expand_as(msg), sent)
        x = x + mlp(p, f"processor/{k}/node", torch.cat([agg, x], -1), n_layers, True)
        e = e + msg
    return mlp(p, "decoder", x, n_layers, False)


def edge_features(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    idx = lambda i: i[..., None].expand(-1, -1, 3)  # noqa: E731
    d = torch.gather(pos, 1, idx(dst)) - torch.gather(pos, 1, idx(src))
    return torch.cat([d, torch.linalg.vector_norm(d, dim=-1, keepdim=True)], -1)


def node_features(vel: torch.Tensor, node_type: torch.Tensor) -> torch.Tensor:
    onehot = torch.stack([(node_type == 0), (node_type == 1)], -1).float()
    return torch.cat([vel, onehot], -1)


def norm_stats(acc: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and std (floored at 1e-8) of accumulated sums."""
    n = torch.clamp_min(acc["count"], 1.0)
    mean = acc["sum"] / n
    std = torch.sqrt(torch.clamp_min(acc["sum_sq"] / n - mean * mean, 0.0))
    return mean, torch.clamp_min(std, STD_EPS)


def accumulate(acc: dict, data: torch.Tensor) -> dict:
    """Sums of rows of ``data`` [..., D] added to the normalizer's."""
    d = data.reshape(-1, data.shape[-1])
    return {"sum": acc["sum"] + d.sum(0), "sum_sq": acc["sum_sq"] + (d * d).sum(0),
            "count": acc["count"] + d.shape[0]}


def predict_acc(p, norms, vel, node_type, efeat, src, dst, n_layers, n_mp, mask=None):
    """Normalized predicted accelerations [B, V, 3]."""
    mean, std = norm_stats(norms["node"])
    return gnn(p, (node_features(vel, node_type) - mean) / std, efeat, src, dst,
               n_layers, n_mp, mask)


def train_loss(p, norms, batch, future: int, n_layers: int, n_mp: int) -> torch.Tensor:
    """Mean squared error of normalized accelerations, summed over the
    unroll; the state advances by the predicted (unnormalized)
    accelerations, grasped nodes by their actions."""
    vel, pos = batch["velocity"], batch["positions"]
    src, dst, mask = batch["src"], batch["dst"], batch["edge_mask"]
    acts, tvel = batch["particle_actions"], batch["target_vel"]
    node_type = batch["node_type"]
    out_mean, out_std = norm_stats(norms["out"])
    efeat = edge_features(pos, src, dst)
    loss = 0.0
    for f in range(future):
        pred = predict_acc(p, norms, vel, node_type, efeat, src, dst, n_layers, n_mp,
                           mask)
        target = (tvel[:, :, f] - vel[..., -3:] - out_mean) / out_std
        loss = loss + ((pred - target) ** 2).mean()
        if f < future - 1:
            new_vel = vel[..., -3:] + pred * out_std + out_mean
            a0, a1 = acts[:, :, f], acts[:, :, f + 1]
            new_vel = torch.where(a0 != 0, a0, new_vel)
            pos = torch.where(a1 == 0, pos + new_vel, pos) + a1
            efeat = edge_features(pos, src, dst)
            vel = torch.cat([vel[..., 3:], torch.where(a1 != 0, a1, vel[..., -3:])], -1)
    return loss


def train_step(st: dict, batch: dict, future: int, lr: float, n_layers: int,
               n_mp: int) -> tuple[dict, float]:
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8) on a batch whose tensors
    are [B, V, ...], after adding the batch's first-step node features and
    target accelerations to the normalizers. ``st``: ``params`` (by path),
    ``m``, ``v``, ``count``, ``norms`` ({"node", "out"} sums)."""
    vel = batch["velocity"]
    norms = {"node": accumulate(st["norms"]["node"],
                                node_features(vel, batch["node_type"])),
             "out": accumulate(st["norms"]["out"],
                               batch["target_vel"][:, :, 0] - vel[..., -3:])}
    leaves = {k: v.detach().requires_grad_() for k, v in st["params"].items()}
    with torch.enable_grad():
        loss = train_loss(leaves, norms, batch, future, n_layers, n_mp)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    count = st["count"] + 1
    new = {"params": {}, "m": {}, "v": {}, "count": count, "norms": norms}
    with torch.no_grad():
        for (k, p), g in zip(st["params"].items(), grads):
            m = 0.9 * st["m"][k] + 0.1 * g
            v = 0.999 * st["v"][k] + 0.001 * g * g
            upd = (m / (1 - 0.9 ** count)) / (torch.sqrt(v / (1 - 0.999 ** count)) + 1e-8)
            new["params"][k], new["m"][k], new["v"][k] = p - lr * upd, m, v
    return new, float(loss.detach())


@torch.no_grad()
def rollout(p: dict, norms: dict, pos0: torch.Tensor, vel_hist: torch.Tensor,
            node_type: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            grasped: int, actions: torch.Tensor, n_layers: int, n_mp: int) -> torch.Tensor:
    """Positions [A, S+1, V, 3] of each candidate's rollout from one state:
    ``pos0`` [V, 3], ``vel_hist`` [hist, V, 3], ``actions`` [A, S, 3] the
    grasped node's displacement each step. Each step the grasped node is
    moved by the action, the GNN predicts every velocity, the grasped one is
    set to the action, and positions integrate."""
    a_n, steps = actions.shape[0], actions.shape[1]
    pos = pos0[None].expand(a_n, -1, -1).clone()
    vel = torch.cat(list(vel_hist), -1)[None].expand(a_n, -1, -1).clone()
    types = node_type[None].expand(a_n, -1)
    src_b, dst_b = src[None].expand(a_n, -1), dst[None].expand(a_n, -1)
    out_mean, out_std = norm_stats(norms["out"])
    traj = [pos]
    for s in range(steps):
        act = actions[:, s]                                    # [A, 3]
        pos_in = pos.clone()
        pos_in[:, grasped] += act
        vel_in = vel.clone()
        vel_in[:, grasped, -3:] = act
        pred = predict_acc(p, norms, vel_in, types, edge_features(pos_in, src_b, dst_b),
                           src_b, dst_b, n_layers, n_mp)
        nxt = vel_in[..., -3:] + pred * out_std + out_mean
        nxt[:, grasped] = act
        pos = pos + nxt
        vel = torch.cat([vel[..., 3:], nxt], -1)
        traj.append(pos)
    return torch.stack(traj, 1)
