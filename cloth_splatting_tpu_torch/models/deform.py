"""Residual mesh deformation models; counterpart of
``cloth_splatting_tpu/models/deform.py``.

``vertices(t) = mesh_predictions[round(t / dt)] + residual(t)``, where the
residual is either a time-conditioned MLP over sinusoidal features
(``ResidualSimulator``: 13 -> 256 -> ReLU -> 256 -> ReLU -> V*3, output layer
N(0, 1e-5), bias 0) or a per-timestep table (``EmbeddingSimulator``).
Weights keep the JAX package's [in, out] layout. The MLP runs in full
float32: its output is vertex positions, where TF32 rounding is
screen-space noise (the package turns TF32 off).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from cloth_splatting_tpu_torch.device import resolve_device

NUM_FREQS = 6
ENC_DIM = 1 + 2 * NUM_FREQS  # identity + (sin, cos) per frequency
HIDDEN = 256


def time_index(t: torch.Tensor, n_times: int) -> torch.Tensor:
    """Frame index [1] (int64) of normalized time t in [0, 1]: round(t / dt)
    half to even, clipped to [0, n_times - 1]; dt = 1 for a single frame."""
    dt = 1.0 if n_times == 1 else 1.0 / (n_times - 1)
    return torch.clamp(torch.round(t / dt).to(torch.int64), 0,
                       n_times - 1).reshape(1)


def sinusoidal_encode(t: torch.Tensor) -> torch.Tensor:
    """Scalar time -> [13] features [t, sin(f0 t), cos(f0 t), ..., cos(f5 t)],
    f_k = 2^k, cos computed as sin(x + pi/2)."""
    freqs = 2.0 ** torch.arange(NUM_FREQS, dtype=torch.float32, device=t.device)
    angles = t * freqs
    feats = torch.stack([angles, angles + math.pi / 2], dim=-1).reshape(-1)
    return torch.cat([t.reshape(1), torch.sin(feats)])


class ResidualSimulator(nn.Module):
    """Time-conditioned residual MLP over sinusoidal time features."""

    def __init__(self, w_in, b_in, w_h, b_h, w_out, b_out):
        super().__init__()
        self.w_in = nn.Parameter(w_in)    # [13, 256]
        self.b_in = nn.Parameter(b_in)    # [256]
        self.w_h = nn.Parameter(w_h)      # [256, 256]
        self.b_h = nn.Parameter(b_h)      # [256]
        self.w_out = nn.Parameter(w_out)  # [256, V*3]
        self.b_out = nn.Parameter(b_out)  # [V*3]

    def forward(self, mesh_predictions: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """Deformed vertices [V, 3] at normalized time t from the GNN rollout
        ``mesh_predictions`` [T, V, 3]."""
        h = sinusoidal_encode(t)
        h = torch.relu(h @ self.w_in + self.b_in)
        h = torch.relu(h @ self.w_h + self.b_h)
        residual = (h @ self.w_out + self.b_out).reshape(-1, 3)
        tid = time_index(t, mesh_predictions.shape[0])
        return mesh_predictions.index_select(0, tid)[0] + residual


class EmbeddingSimulator(nn.Module):
    """Per-timestep residual table: each discrete time id owns a [V*3] row."""

    def __init__(self, embedding: torch.Tensor):
        super().__init__()
        self.embedding = nn.Parameter(embedding)  # [T, V*3]

    def forward(self, mesh_predictions: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        tid = time_index(t, mesh_predictions.shape[0])
        residual = self.embedding.index_select(0, tid).reshape(-1, 3)
        return mesh_predictions.index_select(0, tid)[0] + residual


def init_residual_simulator(rng: np.random.Generator, n_nodes: int,
                            device: str | torch.device = "cuda"
                            ) -> ResidualSimulator:
    """U(-1/sqrt(in), 1/sqrt(in)) hidden layers, N(0, 1e-5) zero-bias output;
    the same numpy draws, in the same order, as the JAX package."""
    dev = resolve_device(device)

    def linear(n_in, n_out):
        bound = 1.0 / np.sqrt(n_in)
        w = rng.uniform(-bound, bound, size=(n_in, n_out)).astype(np.float32)
        b = rng.uniform(-bound, bound, size=(n_out,)).astype(np.float32)
        return torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)

    w_in, b_in = linear(ENC_DIM, HIDDEN)
    w_h, b_h = linear(HIDDEN, HIDDEN)
    w_out = rng.normal(0.0, 1e-5, size=(HIDDEN, n_nodes * 3)).astype(np.float32)
    return ResidualSimulator(w_in, b_in, w_h, b_h,
                             torch.from_numpy(w_out).to(dev),
                             torch.zeros(n_nodes * 3, device=dev))


def init_embedding_simulator(rng: np.random.Generator, n_times: int,
                             n_nodes: int, device: str | torch.device = "cuda"
                             ) -> EmbeddingSimulator:
    """N(0, 1e-3) table."""
    dev = resolve_device(device)
    table = rng.normal(0.0, 1e-3, size=(n_times, n_nodes * 3)).astype(np.float32)
    return EmbeddingSimulator(torch.from_numpy(table).to(dev))


def simulate_any(simulator: nn.Module, mesh_predictions: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Deformed vertices [V, 3] at time t from either simulator type."""
    return simulator(mesh_predictions, t)


RESIDUAL_FIELDS = ("w_in", "b_in", "w_h", "b_h", "w_out", "b_out")


def simulator_from_params(params: Mapping[str, torch.Tensor]) -> nn.Module:
    """The simulator whose parameters share storage with ``params``: an
    ``EmbeddingSimulator`` for ``{"embedding"}``, else a
    ``ResidualSimulator`` from the fields ``RESIDUAL_FIELDS`` (the JAX
    package's field names)."""
    if set(params) == {"embedding"}:
        return EmbeddingSimulator(params["embedding"])
    missing = set(RESIDUAL_FIELDS) - set(params)
    if missing:
        raise KeyError(f"residual simulator needs fields {sorted(missing)}")
    return ResidualSimulator(*(params[k] for k in RESIDUAL_FIELDS))


def simulator_params(simulator: nn.Module) -> dict[str, torch.Tensor]:
    """The simulator's parameters as a dict of plain (detached) tensors."""
    return {k: p.detach() for k, p in simulator.named_parameters()}
