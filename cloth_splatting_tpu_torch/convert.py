"""Convert the JAX package's state into the port's structures.

Inputs are dicts of numpy arrays, one per JAX NamedTuple, e.g.
``{k: np.asarray(v) for k, v in p._asdict().items()}``; this module never
imports JAX. Field names and layouts are the same in both packages; integer
index fields become int64 (torch's index type).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.deform import (
    EmbeddingSimulator,
    ResidualSimulator,
)
from cloth_splatting_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianState,
    Mesh,
)
from cloth_splatting_tpu_torch.render import CameraArrays

Arrays = Mapping[str, np.ndarray]


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64)).to(dev)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(dev)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _build(cls, arrays: Arrays, dev: torch.device):
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {sorted(missing)}")
    return cls(**{k: _tensor(arrays[k], dev) for k in cls._fields})


def gaussian_params(arrays: Arrays, device: str | torch.device = "cuda"
                    ) -> GaussianParams:
    return _build(GaussianParams, arrays, resolve_device(device))


def gaussian_state(arrays: Arrays, device: str | torch.device = "cuda"
                   ) -> GaussianState:
    return _build(GaussianState, arrays, resolve_device(device))


def mesh(arrays: Arrays, device: str | torch.device = "cuda") -> Mesh:
    return _build(Mesh, arrays, resolve_device(device))


def camera_arrays(arrays: Arrays, device: str | torch.device = "cuda"
                  ) -> CameraArrays:
    return _build(CameraArrays, arrays, resolve_device(device))


def simulator(arrays: Arrays, device: str | torch.device = "cuda"
              ) -> torch.nn.Module:
    """A ``ResidualSimulatorParams`` dict (w_in, b_in, w_h, b_h, w_out, b_out)
    or an ``EmbeddingSimulatorParams`` dict (embedding) as the port's module."""
    dev = resolve_device(device)
    if set(arrays) == {"embedding"}:
        return EmbeddingSimulator(_tensor(arrays["embedding"], dev))
    names = ("w_in", "b_in", "w_h", "b_h", "w_out", "b_out")
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"residual simulator needs fields {sorted(missing)}")
    return ResidualSimulator(*(_tensor(arrays[k], dev) for k in names))
