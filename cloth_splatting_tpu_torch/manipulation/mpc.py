"""Sampling-based MPC over the GNN dynamics model; counterpart of
``cloth_splatting_tpu/manipulation/mpc.py``.

``MPC(sim_state, A, H, input_sequence_length)`` samples A bezier candidate
action sequences toward the goal (numpy, the JAX package's draws in its
order), rolls all of them out through the GNN at once
(``models.cloth_simulator.rollout_batched``: one graph of A·V nodes on the
state's device) and scores each by the mean squared distance of its final
predicted state to the goal.

On a CUDA state a rollout whose shapes and state repeat runs as a captured
CUDA graph (``RolloutGraphs``): its ~700 small kernels a step are one launch
a call from the host, which otherwise spends ~10x the device's time
dispatching them. On the CPU it runs eagerly.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions
from cloth_splatting_tpu_torch.models.cloth_simulator import rollout_batched
from cloth_splatting_tpu_torch.models.meshnet import flat_params
from cloth_splatting_tpu_torch.utils.profiling import span


def state_device(sim_state: dict) -> torch.device:
    """The device a GNN simulator state lives on."""
    return sim_state["out_norm"].acc_sum.device


def state_leaves(sim_state: dict) -> list[torch.Tensor]:
    """Every tensor of a GNN simulator state: the parameter tree's leaves in
    its order, then the two normalizers' fields."""
    return list(flat_params([sim_state["gnn"], sim_state["node_norm"],
                             sim_state["out_norm"]]).values())


def rollout_key(sim_state: dict, inputs: tuple, n_steps: int, normalize: bool) -> tuple:
    """What a captured rollout bakes in: the state's device, the shapes and
    dtypes of the inputs (A, V, E, history and steps among them),
    ``n_steps``, ``normalize`` and each state leaf's identity (address,
    shape, strides). A state whose tensors are replaced gets another key;
    one updated in place keeps its key."""
    return (str(state_device(sim_state)),
            tuple((x.shape, x.dtype) for x in inputs), int(n_steps), bool(normalize),
            tuple((t.data_ptr(), t.shape, t.stride()) for t in state_leaves(sim_state)))


class CapturedRollout:
    """``rollout_batched`` captured as one CUDA graph over static device
    buffers: ``inputs`` (pos0, velocity history, node type, edge index,
    actions, the grasped node as a 0-d tensor) and ``out`` [A, h+1, V, 3].
    It holds the state's leaves it captured, so none of their addresses is
    freed and reused while the graph lives."""

    def __init__(self, sim_state: dict, host: tuple, n_steps: int, normalize: bool):
        """Capture the rollout of ``host``'s shapes; it wants a warm process
        (lazy initialisation, cuBLAS workspaces): an eager call of the same
        shapes first. Captured on a side stream with ``capture_begin`` and
        ``capture_end`` rather than ``torch.cuda.graph``, whose entry
        synchronizes and releases the allocator's cached blocks, which the
        planner's refiner then has to allocate again."""
        dev = state_device(sim_state)
        self.leaves = state_leaves(sim_state)
        self.inputs = [torch.as_tensor(x, device=dev) for x in host]
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                self.out = rollout_batched(sim_state, *self.inputs, n_steps,
                                           normalize=normalize)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

    def replay(self, host: tuple) -> torch.Tensor:
        """The rollout of ``host``'s inputs: the static output, valid until
        the next replay."""
        for buf, x in zip(self.inputs, host):
            buf.copy_(torch.from_numpy(x))
        self.graph.replay()
        return self.out


# keys an MPC keeps: a planner's candidates at its horizon, its one-step
# prediction, and the shorter horizons of a plan's last steps
GRAPHS_KEPT = 4


def eager_rollout(sim_state: dict, host: tuple, n_steps: int, normalize: bool
                  ) -> torch.Tensor:
    """``rollout_batched`` of the host arrays, op by op."""
    dev = state_device(sim_state)
    return rollout_batched(sim_state, *(torch.as_tensor(x, device=dev) for x in host),
                           n_steps, normalize=normalize)


class RolloutGraphs:
    """``rollout_batched`` for an MPC. On a CUDA state a key
    (``rollout_key``) runs eagerly on its first call, is captured
    (``CapturedRollout``) and replayed on its second, and is replayed on
    every later call: a key called once costs no capture. The
    ``GRAPHS_KEPT`` most recently used keys are kept, seen or captured. A
    CPU state runs eagerly. ``captures``, ``replays`` and ``eager`` count
    the calls of each kind."""

    def __init__(self):
        self.graphs: OrderedDict[tuple, CapturedRollout | None] = OrderedDict()
        self.captures = self.replays = self.eager = 0

    def insert(self, key: tuple, entry: CapturedRollout | None) -> None:
        """Keep ``entry`` under ``key`` as the most recently used, dropping
        the least recently used key beyond ``GRAPHS_KEPT``."""
        self.graphs[key] = entry
        self.graphs.move_to_end(key)
        while len(self.graphs) > GRAPHS_KEPT:
            self.graphs.popitem(last=False)

    def __call__(self, sim_state: dict, host: tuple, n_steps: int,
                 normalize: bool) -> torch.Tensor:
        """Rollouts [A, n_steps + 1, V, 3] on the state's device of the host
        arrays ``host`` = (pos0 [V, 3] float32, velocity history
        [hist, V, 3] float32, node type [V] int64, edge index [2, E] int64,
        actions [A, n_steps, 3] float32, grasped node () int64)."""
        if state_device(sim_state).type == "cuda":
            key = rollout_key(sim_state, host, n_steps, normalize)
            seen = key in self.graphs
            entry = self.graphs.get(key)
            if entry is not None:
                self.insert(key, entry)
                with span("rollout.replay"):
                    self.replays += 1
                    return entry.replay(host)
            if seen:
                with span("rollout.capture"):
                    entry = CapturedRollout(sim_state, host, n_steps, normalize)
                    self.insert(key, entry)
                    self.captures += 1
                    return entry.replay(host)
            self.insert(key, None)
        self.eager += 1
        return eager_rollout(sim_state, host, n_steps, normalize)


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
        self.rollouts = RolloutGraphs()

    def _batched_rollout(self, sim_state, pos0, init_vel, node_type, edge_index,
                         actions_batch, grasped, n_steps) -> torch.Tensor:
        """Rollouts [A, n_steps + 1, V, 3] on the state's device of the
        candidates ``actions_batch`` [A, >= n_steps, 3]; the arguments of the
        JAX package's jitted function, as host arrays. On a CUDA state the
        result may be a captured graph's output, overwritten by the next
        call of the same shapes: copy it out first."""
        n_steps = min(int(n_steps), np.shape(actions_batch)[1])

        def a(x, dtype):
            return np.ascontiguousarray(x, dtype)

        host = (a(pos0, np.float32), a(init_vel, np.float32), a(node_type, np.int64),
                a(edge_index, np.int64), a(np.asarray(actions_batch)[:, :n_steps], np.float32),
                a(grasped, np.int64))
        return self.rollouts(sim_state, host, n_steps, self.normalize)

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
