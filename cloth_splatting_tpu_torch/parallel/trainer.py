"""The mesh-aware trainer; counterpart of
``cloth_splatting_tpu/parallel/trainer.py``.

``ShardedTrainer`` wraps one scene's ``train.step.Trainer`` and exposes the
API ``train.loop.fit_banks`` drives (``step_banked``, ``density_control``,
``cleanup_barycentric``, ``compute_knn_state``, ``grow_k_cap``), so the loop
takes either with one branch. Every rank holds one instance:

  * the step is ``parallel.mesh.make_banked_sharded_step``, one per
    (cameras, SH degree, stage, masks, kNN, capacity, k_cap);
  * the host-scheduled events (densify, prune, opacity reset, capacity
    growth, barycentric cleanup, kNN refresh) run the Trainer's own code on
    the full state gathered on every rank (``host_state``), identically on
    every rank (the same generator draws, the same numpy), and
    ``place_state`` keeps this rank's block again.

Single-device runs never import this module.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.parallel.mesh import (
    gather_splat_state,
    make_banked_sharded_step,
    mesh_axes,
    shard_splat_state,
)
from cloth_splatting_tpu_torch.train.step import StepCarry


class ShardedTrainer:
    """Drive one scene's optimization over a (data, model) device mesh."""

    def __init__(self, trainer, mesh):
        self.trainer = trainer
        self.mesh = mesh
        self.cfg = trainer.cfg
        self.axes = mesh_axes(mesh)
        self.d_rows, self.m_cols = self.axes.data.size, self.axes.model.size
        self.is_lead = self.axes.world.rank == 0
        self._steps: dict[tuple, Any] = {}

    # ------------------------------------------------------------ placement

    def _mesh_capacity(self, n: int) -> int:
        """Capacity rounding that also divides evenly over the model axis."""
        step = math.lcm(G.CAPACITY_ROUND, self.m_cols)
        return max(step, math.ceil(n / step) * step)

    def place_state(self, state):
        """This rank's block of a full state, its capacity first rounded to
        a multiple of the model axis (grown with dead slots if needed)."""
        cap = state.params.face_bary.shape[0]
        want = self._mesh_capacity(cap)
        if want != cap:
            params, gstate, g_opt = G.grow_state_arrays(
                state.params, state.gstate, state.g_opt, want)
            state = state._replace(params=params, gstate=gstate, g_opt=g_opt)
        return shard_splat_state(state, self.axes.model)

    def host_state(self, state):
        """The full state, in the single-device layout, on every rank (a
        collective: every rank calls it)."""
        return gather_splat_state(state, self.axes.model)

    # ----------------------------------------------------------------- step

    def step_banked(self, state, cam_bank, gt_bank, mask_bank, view_idx,
                    time_ids, sh_degree: int, static: bool, knn_state=None,
                    carry=None):
        n_cams = len(time_ids)
        cap = state.params.face_bary.shape[0]
        key = (n_cams, sh_degree, static, mask_bank is not None,
               knn_state is not None, cap, self.cfg.opt.raster_k_cap)
        step = self._steps.get(key)
        if step is None:
            step = make_banked_sharded_step(
                self.trainer, self.mesh, sh_degree, static, n_cams=n_cams,
                has_masks=mask_bank is not None, use_knn=knn_state is not None)
            self._steps[key] = step
        if carry is None:
            carry = StepCarry.zeros(self.trainer.device)
        return step(state, cam_bank, gt_bank, mask_bank, view_idx, time_ids,
                    knn_state, carry)

    # ------------------------------------------------------- host schedule

    def density_control(self, state, iteration: int,
                        generator: torch.Generator | None = None):
        if not self.trainer.density_control_due(self.cfg, iteration):
            return state, 0
        new_state, overflow = self.trainer.density_control(
            self.host_state(state), iteration, generator)
        return self.place_state(new_state), overflow

    def cleanup_barycentric(self, state):
        return self.place_state(
            self.trainer.cleanup_barycentric(self.host_state(state)))

    def compute_knn_state(self, state):
        """Capacity-global kNN neighbourhoods on every rank (the step's
        gathered means make the regularizer the unsharded one)."""
        return self.trainer.compute_knn_state(self.host_state(state))

    def grow_k_cap(self, factor: int = 2) -> int:
        new_cap = self.trainer.grow_k_cap(factor)
        self._steps.clear()
        return new_cap
