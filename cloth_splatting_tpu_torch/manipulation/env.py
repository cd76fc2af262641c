"""Pick-and-place cloth environment over the PBD simulator; counterpart of
``cloth_splatting_tpu/manipulation/env.py``.

A settled grid cloth (y-up), its corner and keypoint particles, fold-style
pick/place sampling, a grasp handle moved by per-step displacements, and the
history in the sim-dataset layout. The random draws are numpy's, seeded as
in the JAX package, so both packages draw the same picks; the cloth lives on
``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.manipulation.sim import (
    ClothConstraints,
    ClothParams,
    ClothState,
    cloth_step,
    make_cloth,
    settle,
)


@dataclasses.dataclass
class ClothEnv:
    """Pick-and-place cloth environment (y-up coordinates)."""

    nx: int = 12
    ny: int = 12
    cloth_size: float = 0.3
    params: ClothParams = dataclasses.field(default_factory=ClothParams)
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.rng = np.random.default_rng(self.seed)
        self.state: Optional[ClothState] = None
        self.cons: Optional[ClothConstraints] = None
        self.grasped: Optional[int] = None
        self._history: list[np.ndarray] = []
        self._gripper_history: list[np.ndarray] = []
        self._action_history: list[np.ndarray] = []

    # ------------------------------------------------------------- lifecycle

    def reset(self) -> np.ndarray:
        self.state, self.cons, _ = make_cloth(
            self.nx, self.ny, self.cloth_size, height=0.0, params=self.params,
            device=self.device)
        self.state = settle(self.state, self.cons, n_steps=10, params=self.params)
        self.grasped = None
        self._history = [self.positions]
        self._gripper_history = []
        self._action_history = []
        return self._history[0]

    @property
    def positions(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()

    @property
    def corner_ids(self) -> list[int]:
        gx, gy = self.nx, self.ny
        return [0, gy - 1, (gx - 1) * gy, gx * gy - 1]

    def keypoint_ids(self) -> list[int]:
        """Corners, edge midpoints and the centre."""
        gx, gy = self.nx, self.ny

        def mid(i, j):
            return i * gy + j

        return self.corner_ids + [
            mid(gx // 2, 0), mid(gx // 2, gy - 1), mid(0, gy // 2),
            mid(gx - 1, gy // 2), mid(gx // 2, gy // 2),
        ]

    # ------------------------------------------------------------ pick/place

    def sample_pick_place(self):
        """A corner pick and a fold-style place across the cloth."""
        corners = self.corner_ids
        k = int(self.rng.integers(len(corners)))
        pick_idx = corners[k]
        opposite = corners[len(corners) - 1 - k]
        positions = self.positions
        pick = positions[pick_idx]
        place = pick + (positions[opposite] - pick) * self.rng.uniform(0.6, 1.0)
        place = place + self.rng.normal(0, 0.02, 3) * np.asarray([1.0, 0.0, 1.0])
        return pick_idx, pick, place

    def grasp_particle(self, idx: int) -> None:
        self.grasped = int(idx)
        self._gripper_history = [self.positions[self.grasped]]

    def release(self) -> None:
        self.grasped = None

    # ------------------------------------------------------------------ step

    def step(self, action: np.ndarray, repetitions: int = 1) -> np.ndarray:
        """Move the grasped particle by ``action``, split over
        ``repetitions`` PBD control steps; records the history. Returns the
        new positions."""
        if self.grasped is None:
            raise RuntimeError("no particle grasped")
        delta = torch.as_tensor(np.asarray(action / repetitions, np.float32),
                                device=self.device)
        for _ in range(repetitions):
            target = self.state.pos[self.grasped] + delta
            self.state = cloth_step(self.state, self.cons, self.grasped, target,
                                    True, self.params)
        positions = self.positions
        self._history.append(positions)
        self._gripper_history.append(positions[self.grasped])
        self._action_history.append(np.asarray(action, np.float32))
        return positions

    # ------------------------------------------------------------------- obs

    def trajectory_dict(self) -> dict[str, np.ndarray]:
        """History in the sim-dataset layout (``collect.py``'s h5 fields)."""
        pos = np.stack(self._history)
        vel = np.zeros_like(pos)
        if pos.shape[0] > 1:
            vel[1:] = pos[1:] - pos[:-1]
        return {
            "pos": pos,
            "vel": vel,
            "actions": (np.stack(self._action_history)
                        if self._action_history else np.zeros((0, 3), np.float32)),
            "gripper_pos": (np.stack(self._gripper_history)
                            if self._gripper_history else pos[:, 0]),
            "pick": (self.positions[self.grasped]
                     if self.grasped is not None else pos[0, 0]),
            "place": pos[-1, 0],
        }


def goal_fold(init_particles: np.ndarray, pick: np.ndarray,
              place: np.ndarray) -> np.ndarray:
    """Fold-in-half goal: the particles on the pick side of the pick->place
    midplane reflected across it."""
    axis = place - pick
    axis = axis / max(np.linalg.norm(axis), 1e-9)
    midpoint = 0.5 * (pick + place)
    proj = (init_particles - midpoint) @ axis
    reflected = init_particles - 2.0 * proj[:, None] * axis[None, :]
    return np.where((proj < 0)[:, None], reflected, init_particles)
