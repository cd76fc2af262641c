"""Configuration dataclasses: the fields of
``cloth_splatting_tpu/train/config.py`` that the port reads, under the same
group and field names, with the same defaults.

The port has only the fields its code reads (the train step, density
control, the loop and its command line); the dense tier's ``raster_k_cap``
and ``raster_k_chunk`` come with that tier. So an override of a field the
port does not have raises instead of doing nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    """Reference ModelParams."""

    sh_degree: int = 3
    simulator: str = "mlp"          # 'mlp' residual MLP | 'embedding' table
    source_path: str = ""
    model_path: str = ""
    white_background: bool = True
    eval: bool = True               # keep the test split out of training


@dataclasses.dataclass
class OptimizationConfig:
    """Reference OptimizationParams plus the JAX package's additions."""

    iterations: int = 8_000
    coarse_iterations: int = 3000
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
    # 3-step window placement: 'interior' draws the mid time over [1, T-2]
    # (the reference regime), 'balanced' over [0, T-1] and clamps
    time_sample: str = "interior"
    percent_dense: float = 0.01
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
    reg_iter: int = 5000
    knn_update_iter: int = 1000
    opacity_reset_interval: int = 3000
    densification_interval: int = 100
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold_fine_init: float = 0.0002
    densify_grad_threshold_after: float = 0.0002
    pruning_from_iter: int = 500
    pruning_interval: int = 100
    opacity_threshold_fine_init: float = 0.005
    opacity_threshold_fine_after: float = 0.005
    static_reconst: bool = False
    static_reconst_iteration: int = 2000
    bary_cleanup: int = 200
    gaussian_init_factor: int = 2
    no_coarse: bool = False
    # "auto" and "pallas" both render through K2/K3 in the port; the dense
    # tier "tiled" comes with slice 4
    raster_backend: str = "auto"
    raster_pack_order: str = "fused"
    # evaluate and save an exponential moving average of (Gaussian,
    # simulator) parameters with this decay; 0 = off
    param_ema: float = 0.0


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

