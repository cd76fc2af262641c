"""Configuration dataclasses: the fields of
``cloth_splatting_tpu/train/config.py`` that the port reads, under the same
group and field names, with the same defaults.

The port has only the fields its code reads; density control, the loop,
data loading and the dense tier bring theirs with slice 3. So an override
of a field the port does not have raises instead of doing nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    """Reference ModelParams."""

    sh_degree: int = 3
    simulator: str = "mlp"          # 'mlp' residual MLP | 'embedding' table
    white_background: bool = True


@dataclasses.dataclass
class OptimizationConfig:
    """Reference OptimizationParams plus the JAX package's additions."""

    iterations: int = 8_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    # cosine tail decay over all Gaussian groups from lr_tail_start *
    # iterations down to lr_tail_floor * lr; 1.0 = off
    lr_tail_start: float = 1.0
    lr_tail_floor: float = 0.01
    lambda_dssim: float = 0.1
    lambda_rigid: float = 0.3
    lambda_deform_mag: float = 0.01
    lambda_momentum: float = 0.1
    # |deformed - predicted| vertex penalty (0 = reference parity)
    lambda_anchor: float = 0.0
    lambda_isometric: float = 0.0
    lambda_spring: float = 0.0
    lambda_rigidity: float = 0.0
    lambda_w: float = 2000.0
    k_nearest: int = 20
    gaussian_init_factor: int = 2
    # "auto" and "pallas" both render through K2/K3 in the port; the dense
    # tier "tiled" comes with slice 3
    raster_backend: str = "auto"
    raster_pack_order: str = "fused"


@dataclasses.dataclass
class MeshnetConfig:
    """Reference MeshnetParams."""

    lr_init: float = 3e-4


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    meshnet: MeshnetConfig = dataclasses.field(default_factory=MeshnetConfig)


_GROUP_MAP = {
    "ModelParams": "model",
    "OptimizationParams": "opt",
    "MeshnetParams": "meshnet",
}


def apply_overrides(cfg: Config, group_dicts: dict[str, dict[str, Any]]) -> Config:
    """Merge ``{'OptimizationParams': {...}, ...}`` dicts over ``cfg``;
    unknown groups and fields raise."""
    for group_name, values in group_dicts.items():
        if group_name not in _GROUP_MAP:
            raise KeyError(f"Unknown config group: {group_name}")
        group = getattr(cfg, _GROUP_MAP[group_name])
        for key, value in values.items():
            if not hasattr(group, key):
                raise KeyError(f"{group_name} has no field {key!r} in the port")
            setattr(group, key, value)
    return cfg
