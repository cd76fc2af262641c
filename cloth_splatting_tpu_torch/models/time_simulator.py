"""Time-conditioned GNN mesh simulator (the legacy ``train_meshnet`` path);
counterpart of ``cloth_splatting_tpu/models/time_simulator.py``: node
features [noised positions (3), time (1), node-type one-hot (1)] ->
Encode-Process-Decode -> normalized DISPLACEMENT; ``predict_position`` adds
the denormalized displacement to the input positions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cloth_splatting_tpu_torch.models.meshnet import (
    apply_encode_process_decode,
    init_encode_process_decode,
    init_normalizer,
    normalizer_apply,
    normalizer_inverse,
)

NODE_TYPE_EMBED = 1


def init_time_simulator(rng: np.random.Generator, n_message_passing: int = 15,
                        latent: int = 128,
                        device: str | torch.device = "cuda") -> dict:
    nnode_in = 3 + 1 + NODE_TYPE_EMBED
    return {
        "gnn": init_encode_process_decode(
            rng, nnode_in=nnode_in, nnode_out=3, nedge_in=4, latent=latent,
            n_message_passing=n_message_passing, n_mlp_layers=2,
            mlp_hidden=latent, device=device),
        "node_norm": init_normalizer(nnode_in, device),
        "out_norm": init_normalizer(3, device),
    }


def predict_displacement(state: dict, positions, time_vector, node_type,
                         edge_index, edge_features, target_positions=None,
                         position_noise=None, edge_mask=None, training=False):
    """(normalized prediction, normalized target or None, the state with the
    normalizers of this call)."""
    pos = positions if position_noise is None else positions + position_noise
    onehot = F.one_hot(node_type.long(), NODE_TYPE_EMBED).to(torch.float32)
    tv = time_vector.reshape(-1, 1) if time_vector.ndim == 1 else time_vector
    feats = torch.cat([pos, tv, onehot], -1)
    feats, node_norm = normalizer_apply(state["node_norm"], feats,
                                        accumulate=training)
    pred = apply_encode_process_decode(state["gnn"], feats, edge_index,
                                       edge_features, edge_mask)
    out_norm = state["out_norm"]
    target_norm = None
    if target_positions is not None:
        target_norm, out_norm = normalizer_apply(out_norm, target_positions - pos,
                                                 accumulate=training)
    return pred, target_norm, {**state, "node_norm": node_norm, "out_norm": out_norm}


def predict_position(state: dict, positions, time_vector, node_type,
                     edge_index, edge_features, edge_mask=None):
    pred, _, _ = predict_displacement(state, positions, time_vector, node_type,
                                      edge_index, edge_features,
                                      edge_mask=edge_mask, training=False)
    return positions + normalizer_inverse(state["out_norm"], pred)
