"""Sampling-based MPC over the GNN dynamics model; counterpart of
``cloth_splatting_tpu/manipulation/mpc.py``.

``MPC(sim_state, A, H, input_sequence_length)`` samples A bezier candidate
action sequences toward the goal (numpy, the JAX package's draws in its
order), rolls all of them out through the GNN at once
(``models.cloth_simulator.rollout_batched``: one graph of A·V nodes on the
state's device) and scores each by the mean squared distance of its final
predicted state to the goal.
"""

from __future__ import annotations

import numpy as np
import torch

from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions
from cloth_splatting_tpu_torch.models.cloth_simulator import rollout_batched
from cloth_splatting_tpu_torch.utils.profiling import span


def state_device(sim_state: dict) -> torch.device:
    """The device a GNN simulator state lives on."""
    return sim_state["out_norm"].acc_sum.device


class MPC:
    def __init__(self, sim_state: dict, n_candidates: int = 16, horizon: int = 5,
                 input_sequence_length: int = 2, normalize: bool = True,
                 seed: int = 0):
        self.sim_state = sim_state
        self.A = n_candidates
        self.H = horizon
        self.hist = input_sequence_length
        self.normalize = normalize
        self.rng = np.random.default_rng(seed)
        self.candidates: np.ndarray | None = None   # [A, steps, 3]
        self.step_idx = 0
        self.device = state_device(sim_state)

    def _batched_rollout(self, sim_state, pos0, init_vel, node_type, edge_index,
                         actions_batch, grasped, n_steps) -> torch.Tensor:
        """Rollouts [A, n_steps + 1, V, 3] on the state's device of the
        candidates ``actions_batch`` [A, >= n_steps, 3]; the arguments of the
        JAX package's jitted function, as host arrays."""
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

        return rollout_batched(
            sim_state, t(pos0, np.float32), t(init_vel, np.float32),
            t(node_type, np.int64), t(edge_index, np.int64),
            t(actions_batch, np.float32), int(grasped), n_steps,
            normalize=self.normalize)

    # ------------------------------------------------------------- candidates

    def init_sampler(self, velocity: float, action_repetition: int,
                     pick: np.ndarray, goal_place: np.ndarray, traj_len: int,
                     invert_yz: bool = False) -> None:
        self.velocity = velocity
        self.action_repetition = action_repetition
        self.pick = np.asarray(pick, np.float32)
        self.goal_place = np.asarray(goal_place, np.float32)
        self.traj_len = traj_len
        self.step_idx = 0
        self.sample_candidate_actions()

    def sample_candidate_actions(self) -> np.ndarray:
        """Bezier arcs from the current pick to noisy placements around the
        goal; candidate 0 aims exactly at the goal."""
        cands = []
        span = np.linalg.norm(self.goal_place - self.pick)
        for a in range(self.A):
            place = self.goal_place.copy()
            if a > 0:
                place = place + self.rng.normal(0, 0.15 * span, 3) \
                    * np.asarray([1.0, 0.0, 1.0])
            height = self.rng.uniform(0.1, 0.5) * span
            cands.append(bezier_actions(self.pick, place, height, self.traj_len))
        self.candidates = np.stack(cands).astype(np.float32)
        return self.candidates

    def update_candidates(self, gripper_pos: np.ndarray,
                          action_repetition: int = 1) -> None:
        """Re-plan the remaining actions from the executed gripper position."""
        self.pick = np.asarray(gripper_pos, np.float32)
        self.step_idx += 1
        self.traj_len = max(self.traj_len - self.step_idx, 1)
        self.sample_candidate_actions()

    # ---------------------------------------------------------------- rollout

    def model_rollout(self, features: dict, horizon: int | None = None
                      ) -> np.ndarray:
        """GNN rollouts of every candidate from the current state.

        Args:
            features: pos0 [V, 3], velocity_history [hist, V, 3], node_type
                [V], edge_index [2, E], grasped (int).
        Returns [A, h+1, V, 3] predicted positions (host).
        """
        with span("mpc.model_rollout"):
            h = min(horizon or self.H, self.candidates.shape[1])
            trajs = self._batched_rollout(
                self.sim_state, features["pos0"], features["velocity_history"],
                features["node_type"], features["edge_index"],
                self.candidates[:, :h], features["grasped"], h)
            with span("mpc.to_host"):
                return trajs.cpu().numpy()

    # ------------------------------------------------------------------- cost

    @staticmethod
    def compute_cost(rollouts: np.ndarray, goal_particles: np.ndarray
                     ) -> np.ndarray:
        """Mean squared distance of each rollout's final state to the goal:
        per-candidate costs [A]."""
        final = rollouts[:, -1]                       # [A, V, 3]
        return np.mean((final - goal_particles[None]) ** 2, axis=(1, 2))

    def best_action(self, rollouts: np.ndarray, goal_particles: np.ndarray
                    ) -> tuple[int, np.ndarray]:
        costs = self.compute_cost(rollouts, goal_particles)
        best = int(np.argmin(costs))
        return best, self.candidates[best, 0]
