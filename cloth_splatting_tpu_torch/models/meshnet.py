"""MeshGraphNet-style Encode-Process-Decode GNN; counterpart of
``cloth_splatting_tpu/models/meshnet.py``.

  * Encoder: node MLP (in -> 128 -> 128 -> 128) + LayerNorm, edge MLP the
    same.
  * Processor: N residual interaction networks; edge update
    MLP([x_target, x_source, e]) with LayerNorm, node update
    MLP([aggregated messages, x]) with LayerNorm; messages are summed at the
    TARGET node (``edge_index`` = [source, target]) by ``index_add``, which
    runs in a fixed order on every device.
  * Decoder: MLP (128 -> 128 -> 128 -> out), no LayerNorm.

Parameters are plain trees of tensors in the JAX package's layout: dicts
of ``layers`` lists of {"w": [in, out], "b": [out]} and ``ln_scale`` /
``ln_bias``, so a checkpoint of either package loads into the other without
a transpose, and ``init_*`` draws them from a numpy Generator in the JAX
package's order (PyTorch-Linear U(-1/sqrt(in), 1/sqrt(in))): the same seed
gives the same model in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.utils.profiling import span

LATENT = 128


# --------------------------------------------------------------------------- #
# Parameter trees
# --------------------------------------------------------------------------- #

def flat_params(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every leaf of a parameter tree by its ``a/b/0/w`` path (the key the
    checkpoints of both packages give it), in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}{k}/"))
    return out


def unflat_params(template, flat: dict, prefix: str = ""):
    """The tree of ``template``'s structure with the leaves of ``flat``."""
    if isinstance(template, dict):
        return {k: unflat_params(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflat_params(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
    return flat[prefix[:-1]]


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #

def init_linear(rng: np.random.Generator, n_in: int, n_out: int,
                device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    bound = 1.0 / np.sqrt(n_in)
    w = rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, (n_out,)).astype(np.float32)
    return {"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)}


def init_mlp(rng: np.random.Generator, sizes: list[int], layer_norm: bool,
             device: str | torch.device = "cuda"):
    layers = [init_linear(rng, sizes[i], sizes[i + 1], device)
              for i in range(len(sizes) - 1)]
    params = {"layers": layers}
    if layer_norm:
        dev = layers[0]["w"].device
        params["ln_scale"] = torch.ones(sizes[-1], dtype=torch.float32, device=dev)
        params["ln_bias"] = torch.zeros(sizes[-1], dtype=torch.float32, device=dev)
    return params


def apply_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """Linear layers with ReLU between them, then LayerNorm (biased
    variance, eps 1e-5) when the MLP has one."""
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = torch.addmm(layer["b"], x, layer["w"])
        if i < len(layers) - 1:
            x = torch.relu(x)
    if "ln_scale" in params:
        x = F.layer_norm(x, x.shape[-1:], params["ln_scale"], params["ln_bias"], 1e-5)
    return x


# --------------------------------------------------------------------------- #
# Encode-Process-Decode
# --------------------------------------------------------------------------- #

def init_encode_process_decode(
    rng: np.random.Generator,
    nnode_in: int,
    nnode_out: int,
    nedge_in: int,
    latent: int = LATENT,
    n_message_passing: int = 15,
    n_mlp_layers: int = 2,
    mlp_hidden: int = LATENT,
    device: str | torch.device = "cuda",
):
    hidden = [mlp_hidden] * n_mlp_layers
    return {
        "encoder": {
            "node": init_mlp(rng, [nnode_in] + hidden + [latent], True, device),
            "edge": init_mlp(rng, [nedge_in] + hidden + [latent], True, device),
        },
        "processor": [
            {
                "edge": init_mlp(rng, [3 * latent] + hidden + [latent], True, device),
                "node": init_mlp(rng, [2 * latent] + hidden + [latent], True, device),
            }
            for _ in range(n_message_passing)
        ],
        "decoder": init_mlp(rng, [latent] + hidden + [nnode_out], False, device),
    }


def apply_encode_process_decode(
    params,
    node_features: torch.Tensor,   # [V, nnode_in]
    edge_index: torch.Tensor,      # [2, E] int64 (source, target)
    edge_features: torch.Tensor,   # [E, nedge_in]
    edge_mask: torch.Tensor | None = None,  # [E] bool, False for padding
) -> torch.Tensor:
    """Per-node outputs [V, nnode_out]. A masked edge sends no message to
    its target; its own latent still updates (as in the JAX package)."""
    n_nodes = node_features.shape[0]
    src, dst = edge_index[0], edge_index[1]

    with span("meshnet.encode"):
        x = apply_mlp(params["encoder"]["node"], node_features)
        e = apply_mlp(params["encoder"]["edge"], edge_features)

    with span("meshnet.process"):
        for block in params["processor"]:
            # the message of edge j -> i: MLP([x_i, x_j, e]), i the target
            msg_in = torch.cat([x.index_select(0, dst), x.index_select(0, src), e], -1)
            msg = apply_mlp(block["edge"], msg_in)
            msg_agg = msg if edge_mask is None else \
                torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))
            agg = msg.new_zeros((n_nodes, msg.shape[1])).index_add(0, dst, msg_agg)
            x = x + apply_mlp(block["node"], torch.cat([agg, x], -1))
            e = e + msg

    with span("meshnet.decode"):
        return apply_mlp(params["decoder"], x)


# --------------------------------------------------------------------------- #
# Online normalizer (accumulated statistics as explicit state)
# --------------------------------------------------------------------------- #

class NormalizerState(NamedTuple):
    """Accumulated sums; stops accumulating after MAX_ACCUMULATIONS
    batches."""

    acc_sum: torch.Tensor            # [1, D]
    acc_sum_sq: torch.Tensor         # [1, D]
    acc_count: torch.Tensor          # scalar float
    num_accumulations: torch.Tensor  # scalar float


MAX_ACCUMULATIONS = 1e6
STD_EPSILON = 1e-8


def init_normalizer(size: int, device: str | torch.device = "cuda") -> NormalizerState:
    dev = resolve_device(device)
    return NormalizerState(
        acc_sum=torch.zeros((1, size), dtype=torch.float32, device=dev),
        acc_sum_sq=torch.zeros((1, size), dtype=torch.float32, device=dev),
        acc_count=torch.zeros((), dtype=torch.float32, device=dev),
        num_accumulations=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _norm_stats(state: NormalizerState):
    safe = torch.clamp_min(state.acc_count, 1.0)
    mean = state.acc_sum / safe
    std = torch.sqrt(torch.clamp_min(state.acc_sum_sq / safe - mean ** 2, 0.0))
    return mean, torch.clamp_min(std, STD_EPSILON)


def normalizer_apply(state: NormalizerState, data: torch.Tensor,
                     accumulate: bool) -> tuple[torch.Tensor, NormalizerState]:
    """Normalize ``data`` [n, D]; with ``accumulate``, first add its
    statistics (training mode)."""
    if accumulate:
        do = state.num_accumulations < MAX_ACCUMULATIONS
        d = data.detach()

        def add(acc, value):
            return acc + torch.where(do, value, torch.zeros_like(value))

        state = NormalizerState(
            acc_sum=add(state.acc_sum, d.sum(0, keepdim=True)),
            acc_sum_sq=add(state.acc_sum_sq, (d ** 2).sum(0, keepdim=True)),
            acc_count=add(state.acc_count, torch.full_like(state.acc_count,
                                                           float(data.shape[0]))),
            num_accumulations=add(state.num_accumulations,
                                  torch.ones_like(state.num_accumulations)),
        )
    mean, std = _norm_stats(state)
    return (data - mean) / std, state


def normalizer_inverse(state: NormalizerState, data: torch.Tensor) -> torch.Tensor:
    mean, std = _norm_stats(state)
    return data * std + mean
