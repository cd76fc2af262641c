"""Checkpointing: a whole train state saved and restored as one tree of
arrays in a numpy ``.npz`` file; counterpart of
``cloth_splatting_tpu/utils/checkpoints.py`` (its npz backend; same flat
``a/b/c`` key layout, so either package reads the other's files)."""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        leaf = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        return {prefix.rstrip("/"): leaf}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def save_pytree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **_flatten(tree))


def load_flat(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore_like(template: Any, flat: dict[str, np.ndarray], prefix: str = "") -> Any:
    """Rebuild a tree with the structure of ``template`` from a flat dict
    made by ``save_pytree``. A tensor leaf of the template takes its dtype
    and device, not its shape: a checkpoint saved after the capacity grew
    restores at the grown capacity."""
    if isinstance(template, dict):
        return {k: restore_like(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if hasattr(template, "_asdict") and hasattr(template, "_replace"):
        return type(template)(**{k: restore_like(v, flat, f"{prefix}{k}/")
                                 for k, v in template._asdict().items()})
    if isinstance(template, (list, tuple)):
        return type(template)(
            restore_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(template))
    arr = flat[prefix.rstrip("/")]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=template.dtype,
                                                   device=template.device)
    return arr
