"""Configuration dataclasses: the fields of
``cloth_splatting_tpu/train/config.py`` that the port reads, under the same
group and field names, with the same defaults.

The port has only the fields its code reads (the train step, the dense
tier's ``raster_k_cap`` and ``raster_k_chunk``, density control, the loop
and its command line). The fields that nothing reads in the JAX package
either are ``IGNORED``: accepted (the published config files under
``cloth_splatting_tpu/configs/`` set some, and the root ``train.py`` has a
flag for each) and dropped. An override of any other field raises instead
of doing nothing.
"""

from __future__ import annotations

import dataclasses
import runpy
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
    # the dense tier's per-tile list capacity (grown on overflow by the
    # loop) and compositing chunk
    raster_k_cap: int = 512
    raster_k_chunk: int = 32
    # "auto" and "pallas" both render through K2/K3 in the port; "tiled"
    # trains through the dense tier
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

# What the JAX package accepts and never reads, with its defaults there, so
# the port accepts and ignores it too: the k-planes group (vestigial in the
# reference), PipelineParams, and the fields of the other groups that the
# JAX package keeps for the reference's config files and command line (its
# renderer reads ModelParams' white_background, not OptimizationParams').
IGNORED = {
    "ModelHiddenParams": None,            # the whole group
    "ModelParams": {"images": "images", "resolution": -1, "data_device": "tpu",
                    "render_process": False},
    "PipelineParams": {"convert_SHs_python": False, "compute_cov3D_python": False,
                       "debug": False},
    "OptimizationParams": {
        "dataloader": False, "position_lr_static": 0.0016,
        "deformation_lr_init": 0.00016, "deformation_lr_final": 0.000016,
        "deformation_lr_delay_mult": 0.01, "grid_lr_init": 0.0016,
        "grid_lr_final": 0.00016, "lambda_lpips": 0.0,
        "weight_constraint_init": 1.0, "weight_constraint_after": 0.2,
        "weight_decay_iteration": 5000, "densify_grad_threshold_coarse": 0.0002,
        "pruningy_until_iter": 4500, "opacity_threshold_coarse": 0.005,
        "initial_gaussians": 2000, "mesh_type": "multi",
        "white_background": True},
    "MeshnetParams": {"meshnet_path": "", "meshnet_file": "latest",
                      "lr_decay_rate": 0.1, "lr_decay_steps": 5e6},
}


def apply_overrides(cfg: Config, group_dicts: dict[str, dict[str, Any]]) -> Config:
    """Merge ``{'OptimizationParams': {...}, ...}`` dicts over ``cfg``;
    what ``IGNORED`` lists is skipped, other unknown groups and fields
    raise."""
    for group_name, values in group_dicts.items():
        ignored = IGNORED.get(group_name, {})
        if ignored is None:
            continue
        if group_name not in _GROUP_MAP and group_name not in IGNORED:
            raise KeyError(f"Unknown config group: {group_name}")
        group = getattr(cfg, _GROUP_MAP[group_name]) if group_name in _GROUP_MAP \
            else None
        for key, value in values.items():
            if key in ignored:
                continue
            if group is None or not hasattr(group, key):
                raise KeyError(f"{group_name} has no field {key!r} in the port")
            setattr(group, key, value)
    return cfg


def load_config_file(cfg: Config, path: str) -> Config:
    """Overlay a python config file that defines ``OptimizationParams =
    dict(...)`` and the like (``cloth_splatting_tpu/configs/*/*.py``) over
    ``cfg``: the file is run by path and its group dicts go through
    ``apply_overrides``. Counterpart of the JAX package's
    ``load_config_file``, which ignores every unknown field where this
    raises on one that is not in ``IGNORED``."""
    ns = runpy.run_path(path)
    groups = {k: v for k, v in ns.items()
              if k.endswith("Params") and isinstance(v, dict)}
    return apply_overrides(cfg, groups)

