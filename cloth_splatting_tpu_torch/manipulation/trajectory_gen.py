"""Action trajectory generators, bezier and circular pick-and-place arcs;
counterpart of ``cloth_splatting_tpu/manipulation/trajectory_gen.py``
(numpy; the same arrays): a gripper path from pick to place as a quadratic
bezier whose control point is lifted above the midpoint, cut into per-step
displacement actions.
"""

from __future__ import annotations

import numpy as np


def bezier_path(pick: np.ndarray, place: np.ndarray, height: float,
                n_steps: int) -> np.ndarray:
    """Quadratic bezier gripper positions [n_steps + 1, 3] (y-up)."""
    mid = 0.5 * (pick + place)
    mid = mid + np.asarray([0.0, height, 0.0])
    ts = np.linspace(0.0, 1.0, n_steps + 1)[:, None]
    return ((1 - ts) ** 2) * pick[None] + 2 * (1 - ts) * ts * mid[None] \
        + (ts**2) * place[None]


def bezier_actions(pick: np.ndarray, place: np.ndarray, height: float,
                   n_steps: int) -> np.ndarray:
    """Per-step gripper displacements [n_steps, 3]."""
    path = bezier_path(pick, place, height, n_steps)
    return np.diff(path, axis=0)


def circular_actions(pick: np.ndarray, place: np.ndarray, n_steps: int,
                     max_angle: float = np.pi) -> np.ndarray:
    """Circular-arc fold in the vertical plane through pick->place, sweeping
    ``max_angle`` of the semicircle (pi lands exactly on ``place``; a
    smaller angle leaves the fold unflattened)."""
    chord = place - pick
    radius = np.linalg.norm(chord) / 2.0
    mid = 0.5 * (pick + place)
    ts = np.linspace(0.0, max_angle, n_steps + 1)
    up = np.asarray([0.0, 1.0, 0.0])
    axis = chord / max(np.linalg.norm(chord), 1e-9)
    path = np.stack([
        mid - axis * radius * np.cos(t) + up * radius * np.sin(t) for t in ts
    ])
    return np.diff(path, axis=0)


def sample_candidate_actions(rng: np.random.Generator, pick: np.ndarray,
                             goal_place: np.ndarray, n_candidates: int,
                             n_steps: int, place_noise: float = 0.1,
                             height_range: tuple[float, float] = (0.05, 0.25)
                             ) -> np.ndarray:
    """MPC candidate action sequences [A, n_steps, 3]: bezier arcs to noisy
    placements around the goal."""
    candidates = []
    for _ in range(n_candidates):
        place = goal_place + rng.normal(0, place_noise, 3) * np.asarray([1.0, 0.0, 1.0])
        height = rng.uniform(*height_range)
        candidates.append(bezier_actions(pick, place, height, n_steps))
    return np.stack(candidates)
