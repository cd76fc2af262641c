"""Convert the JAX package's state into the port's structures.

Inputs are dicts of numpy arrays, one per JAX NamedTuple, e.g.
``{k: np.asarray(v) for k, v in p._asdict().items()}``, nested where the
JAX structure nests (an optax ``ScaleByAdamState`` is ``{"count", "mu",
"nu"}`` with ``mu`` and ``nu`` dicts of the parameters' fields); this module
never imports JAX. Field names and layouts are the same in both packages;
integer index fields become int64 (torch's index type), except the Adam
and step counters, which stay int32 as in JAX. The GNN's converters also
take a flat npz checkpoint (``model-N.npz``, ``train_state-N.npz``).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.deform import simulator_from_params
from cloth_splatting_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianState,
    Mesh,
)
from cloth_splatting_tpu_torch.render import CameraArrays
from cloth_splatting_tpu_torch.train.step import AdamState, SplatTrainState

Arrays = Mapping[str, np.ndarray]


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64)).to(dev)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(dev)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _counter(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)


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


def point_gaussian_params(arrays: Arrays, device: str | torch.device = "cuda"):
    """A JAX ``PointGaussianParams`` (free-xyz model) as the port's."""
    from cloth_splatting_tpu_torch.models.point_gaussians import PointGaussianParams

    return _build(PointGaussianParams, arrays, resolve_device(device))


def point_gaussian_state(arrays: Arrays, device: str | torch.device = "cuda"):
    """A JAX ``PointGaussianState`` as the port's."""
    from cloth_splatting_tpu_torch.models.point_gaussians import PointGaussianState

    return _build(PointGaussianState, arrays, resolve_device(device))


def mesh(arrays: Arrays, device: str | torch.device = "cuda") -> Mesh:
    return _build(Mesh, arrays, resolve_device(device))


def camera_arrays(arrays: Arrays, device: str | torch.device = "cuda"
                  ) -> CameraArrays:
    return _build(CameraArrays, arrays, resolve_device(device))


def simulator_params(arrays: Arrays, device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
    """A ``ResidualSimulatorParams`` or ``EmbeddingSimulatorParams`` dict as
    the port's parameter dict (what a ``SplatTrainState`` holds)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in arrays.items()}


def simulator(arrays: Arrays, device: str | torch.device = "cuda"
              ) -> torch.nn.Module:
    """A ``ResidualSimulatorParams`` dict (w_in, b_in, w_h, b_h, w_out, b_out)
    or an ``EmbeddingSimulatorParams`` dict (embedding) as the port's module."""
    return simulator_from_params(simulator_params(arrays, device))


def adam_state(arrays: Mapping, like, device: str | torch.device = "cuda"
               ) -> AdamState:
    """An optax ``ScaleByAdamState`` dict {"count", "mu", "nu"} as the port's
    ``AdamState``; ``like`` is ``GaussianParams`` for the Gaussian optimizer
    or ``dict`` for the simulator's."""
    dev = resolve_device(device)

    def tree(a):
        if like is dict:
            return {k: _tensor(v, dev) for k, v in a.items()}
        return _build(like, a, dev)

    return AdamState(count=_counter(arrays["count"], dev), mu=tree(arrays["mu"]),
                     nu=tree(arrays["nu"]))


def train_state(arrays: Mapping, device: str | torch.device = "cuda"
                ) -> SplatTrainState:
    """A whole JAX ``SplatTrainState`` dict {"params", "gstate", "g_opt",
    "sim_params", "sim_opt", "step"} as the port's."""
    dev = resolve_device(device)
    return SplatTrainState(
        params=gaussian_params(arrays["params"], dev),
        gstate=gaussian_state(arrays["gstate"], dev),
        g_opt=adam_state(arrays["g_opt"], GaussianParams, dev),
        sim_params=simulator_params(arrays["sim_params"], dev),
        sim_opt=adam_state(arrays["sim_opt"], dict, dev),
        step=_counter(arrays["step"], dev))


def nest(flat: Mapping[str, np.ndarray]) -> dict:
    """A flat ``{"a/b/c": array}`` dict, as the checkpoints of both packages
    store a tree in an npz file, as nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def train_state_from_checkpoint(path: str, device: str | torch.device = "cuda"
                                ) -> SplatTrainState:
    """A ``chkpnt<iteration>.npz`` written by either package's
    ``save_train_checkpoint`` as the port's state, at whatever capacity it
    was saved."""
    with np.load(path) as data:
        return train_state(nest({k: data[k] for k in data.files}), device)


# --------------------------------------------------------------------------- #
# The GNN dynamics: parameter trees, normalizers and Adam state
# --------------------------------------------------------------------------- #

def _as_tree(arrays) -> dict:
    """A JAX pytree of numpy arrays (NamedTuples as dicts), or the tree of a
    flat npz file of either package (``nest``), or that file's path."""
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as data:
            return nest({k: data[k] for k in data.files})
    if hasattr(arrays, "_asdict"):
        return dict(arrays._asdict())
    return arrays


def meshnet_params(arrays, device: str | torch.device = "cuda"):
    """An Encode-Process-Decode parameter tree (``models/meshnet.py``; the
    same layout in both packages: ``w`` is [in, out]) as tensors; lists
    that a flat file stores as "0", "1", ... keys come back as lists."""
    dev = resolve_device(device)

    def tree(a):
        a = _as_tree(a)
        if isinstance(a, dict):
            if a and all(k.isdigit() for k in a):
                return [tree(a[str(i)]) for i in range(len(a))]
            return {k: tree(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [tree(v) for v in a]
        return _tensor(a, dev)

    return tree(arrays)


def normalizer_state(arrays, device: str | torch.device = "cuda"):
    from cloth_splatting_tpu_torch.models.meshnet import NormalizerState

    return _build(NormalizerState, _as_tree(arrays), resolve_device(device))


def cloth_simulator_state(arrays, device: str | torch.device = "cuda") -> dict:
    """A cloth (or time) simulator state {"gnn", "node_norm", "out_norm"}:
    the JAX state as numpy arrays, or a ``model-N.npz`` of either package."""
    tree = _as_tree(arrays)
    return {"gnn": meshnet_params(tree["gnn"], device),
            "node_norm": normalizer_state(tree["node_norm"], device),
            "out_norm": normalizer_state(tree["out_norm"], device)}


time_simulator_state = cloth_simulator_state


def meshnet_adam_state(arrays, device: str | torch.device = "cuda") -> AdamState:
    """An optax ``ScaleByAdamState`` of the GNN parameters (as numpy arrays,
    or a ``train_state-N.npz`` of either package, whose "opt" it reads) as
    the port's ``AdamState``: the moments keyed by each parameter's path, as
    ``MeshnetTrainer.init_opt`` keys them."""
    from cloth_splatting_tpu_torch.models.meshnet import flat_params

    dev = resolve_device(device)
    tree = _as_tree(arrays)
    tree = _as_tree(tree.get("opt", tree))
    return AdamState(count=_counter(tree["count"], dev),
                     mu=flat_params(meshnet_params(tree["mu"], dev)),
                     nu=flat_params(meshnet_params(tree["nu"], dev)))
