"""Closed-loop cloth manipulation, the paper's predict-update loop;
counterpart of ``cloth_splatting_tpu/manipulation/planning.py``.

Modalities:

  * ``fixed``      - the precomputed bezier to the goal, open loop;
  * ``random``     - a random bezier toward a noisy goal each step;
  * ``mpc-oracle`` - MPC with GNN rollouts re-seeded from the TRUE states;
  * ``mpc-ol``     - MPC on the GNN's own (open-loop) predicted history;
  * ``mpc-cs``     - the GNN history corrected by cloth-splatting refinement
    of rendered observations (``ObservationSynthesizer`` +
    ``SingleStepOptimizer``), closing the perception loop. The refiner
    trains through the ``Trainer``'s default backend: K2 and K3 on the card.

Cost = mean squared distance of the cloth to the half-fold goal. The
planner works in flipped (x, z, y) estimation coordinates, the environment
in y-up world coordinates.

``PlanningConfig.in_memory`` runs ``mpc-cs`` without files: the
synthesizer keeps its frames and the refiner reads the scene from it
(no imageio, PIL or h5py); the default writes the JAX package's scene
directory and re-reads it. An in-memory run writes only the result record.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.meshing import farthest_point_sampling
from cloth_splatting_tpu_torch.data.trajectories import process_trajectory
from cloth_splatting_tpu_torch.manipulation.env import ClothEnv, goal_fold
from cloth_splatting_tpu_torch.manipulation.mpc import MPC
from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions


@dataclasses.dataclass
class PlanningConfig:
    modality: str = "mpc-cs"
    n_candidates: int = 16
    horizon: int = 4
    traj_len: int = 12
    max_steps: int = 20
    action_repetition: int = 1
    input_sequence_length: int = 2
    num_samples: int = 64
    refine_steps: int = 200
    static_steps: int = 150
    n_views: int = 5
    image_size: int = 96
    seed: int = 0
    in_memory: bool = False


def _estimator_features(traj_proc: dict, history: np.ndarray, hist_len: int):
    """The GNN rollout's inputs from the (possibly refined) position history
    of the estimation mesh."""
    v = history.shape[1]
    vel_hist = np.zeros((hist_len, v, 3), np.float32)
    for k in range(hist_len):
        idx = history.shape[0] - hist_len + k
        if idx >= 1:
            vel_hist[k] = history[idx] - history[idx - 1]
    return {
        "pos0": history[-1].astype(np.float32),
        "velocity_history": vel_hist,
        "node_type": traj_proc["node_type"],
        "edge_index": traj_proc["edge_index"],
        "grasped": traj_proc["grasped"],
    }


def splat_config():
    """The refiner's splatting configuration: white background, density
    control from iteration 40 every 50, no opacity reset."""
    from cloth_splatting_tpu_torch.train.config import Config

    cfg = Config()
    cfg.model.white_background = True
    cfg.opt.raster_k_cap = 128
    cfg.opt.raster_k_chunk = 16
    cfg.opt.densify_from_iter = 40
    cfg.opt.densification_interval = 50
    cfg.opt.pruning_from_iter = 40
    cfg.opt.pruning_interval = 50
    cfg.opt.opacity_reset_interval = 100000
    return cfg


def closed_loop_planning(sim_state: Optional[dict], cfg: PlanningConfig,
                         out_dir: str | None = None,
                         device: str | torch.device = "cuda",
                         episode: dict | None = None) -> dict:
    """Run one pick-to-goal episode on ``device`` (the GNN's state lives on
    it too); returns the result record. ``episode``, when given, receives
    the episode's objects: the final ``history``, ``env`` and, for the MPC
    modalities, ``mpc``; for ``mpc-cs`` the ``synth`` and ``refiner``."""
    rng = np.random.default_rng(cfg.seed)
    env = ClothEnv(seed=cfg.seed, device=device)
    env.reset()
    pick_idx, pick, _ = env.sample_pick_place()
    opposite = env.positions[env.corner_ids[3 - env.corner_ids.index(pick_idx)]]
    goal_place = opposite.copy()
    goal_particles = goal_fold(env.positions, pick, goal_place)
    env.grasp_particle(pick_idx)

    # the estimation mesh: the FPS-subsampled Delaunay graph of the observed
    # cloth, the GNN's world representation
    full0 = env.positions
    base_traj = {
        "pos": np.stack([full0, full0]),
        "actions": np.zeros((1, 3), np.float32),
        "pick": pick, "place": goal_place,
    }
    proc = process_trajectory(base_traj, num_samples=cfg.num_samples,
                              sim_data=True, norm_threshold=0.2, seed=cfg.seed)
    # process_trajectory flips the axes and FPS-subsamples with the same
    # seed: the same index map translates env states to estimation states
    obs_flip = full0[:, [0, 2, 1]]
    fps_ids = (farthest_point_sampling(obs_flip, cfg.num_samples, seed=cfg.seed)
               if cfg.num_samples < full0.shape[0] else np.arange(full0.shape[0]))

    def observe() -> np.ndarray:
        """The TRUE estimation-mesh state (flipped axes)."""
        return env.positions[fps_ids][:, [0, 2, 1]].astype(np.float32)

    goal_est = goal_particles[fps_ids][:, [0, 2, 1]].astype(np.float32)
    history = observe()[None]           # [1, V, 3] estimation history

    fixed_plan = bezier_actions(pick, goal_place,
                                0.25 * np.linalg.norm(goal_place - pick),
                                cfg.traj_len)

    mpc = None
    if cfg.modality.startswith("mpc"):
        if sim_state is None:
            raise ValueError("the mpc modalities need a trained GNN")
        mpc = MPC(sim_state, cfg.n_candidates, cfg.horizon,
                  cfg.input_sequence_length, seed=cfg.seed)
        # the planner works in flipped (estimation) coordinates
        mpc.init_sampler(velocity=1.0, action_repetition=cfg.action_repetition,
                         pick=pick[[0, 2, 1]], goal_place=goal_place[[0, 2, 1]],
                         traj_len=cfg.traj_len)

    def one_step(action_flip: np.ndarray) -> np.ndarray:
        """The GNN's one-step prediction [V, 3] from the current history."""
        feats = _estimator_features(proc, history, cfg.input_sequence_length)
        one = mpc._batched_rollout(
            sim_state, feats["pos0"], feats["velocity_history"],
            feats["node_type"], feats["edge_index"],
            np.asarray(action_flip, np.float32)[None, None], feats["grasped"], 1)
        return one[0, -1].cpu().numpy()

    synth = refiner = None
    if cfg.modality == "mpc-cs":
        from cloth_splatting_tpu_torch.manipulation.observation import (
            ObservationSynthesizer,
        )
        from cloth_splatting_tpu_torch.train.single_step import SingleStepOptimizer

        root = out_dir or "./planning_out"
        synth = ObservationSynthesizer(
            None if cfg.in_memory else os.path.join(root, "cs_scene"),
            proc["faces"], history[0], n_views=cfg.n_views,
            image_size=cfg.image_size, n_times_max=cfg.max_steps + 2,
            seed=cfg.seed, device=device)
        synth.render_state(history[0], 0)
        synth.write_mesh_predictions(history)
        refiner = SingleStepOptimizer(
            splat_config(), synth.scene_data if cfg.in_memory else synth.scene_dir,
            n_times_max=cfg.max_steps + 2,
            save_path=os.path.join(root, "cs_model"), seed=cfg.seed, device=device)
        refiner.initialize()
        refiner.static_reconstruction(cfg.static_steps)

    costs = []
    for step in range(cfg.max_steps):
        if cfg.modality == "fixed":
            action_flip = (fixed_plan[step][[0, 2, 1]]
                           if step < len(fixed_plan) else np.zeros(3))
        elif cfg.modality == "random":
            cands = bezier_actions(env.positions[pick_idx],
                                   goal_place + rng.normal(0, 0.1, 3),
                                   rng.uniform(0.05, 0.3), cfg.traj_len)
            action_flip = cands[0][[0, 2, 1]]
        else:
            feats = _estimator_features(proc, history, cfg.input_sequence_length)
            rollouts = mpc.model_rollout(feats)
            _, action_flip = mpc.best_action(rollouts, goal_est)

        # execute in the sim (un-flipped back to y-up world)
        action = np.asarray(action_flip)[[0, 2, 1]]
        env.step(action, cfg.action_repetition)

        # update the estimation history per modality
        if cfg.modality in ("fixed", "random", "mpc-oracle"):
            history = np.concatenate([history, observe()[None]])
        elif cfg.modality == "mpc-ol":
            history = np.concatenate([history, one_step(action_flip)[None]])
        else:  # mpc-cs: render the true state, refine, feed the refined back
            t_idx = step + 1
            synth.render_state(observe(), t_idx)
            history_pred = np.concatenate([history, history[-1:]])  # GNN prior
            history_pred[-1] = one_step(action_flip)
            synth.write_mesh_predictions(history_pred)
            refiner.update_data(n_times=t_idx + 1)
            refiner.update_mesh_predictions(cfg.refine_steps)
            history = refiner.refined_positions()[: t_idx + 1]

        if mpc is not None:
            mpc.update_candidates(env.positions[pick_idx][[0, 2, 1]],
                                  cfg.action_repetition)
        costs.append(float(np.mean((env.positions - goal_particles) ** 2)))

    env.release()
    result = {
        "modality": cfg.modality,
        "final_cost": costs[-1],
        "initial_cost": float(np.mean((full0 - goal_particles) ** 2)),
        "costs": costs,
    }
    if episode is not None:
        episode.update(history=history, env=env, mpc=mpc, synth=synth,
                       refiner=refiner)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"result_{cfg.modality}.json"), "w") as f:
            json.dump(result, f, indent=2)
        if refiner is not None and not cfg.in_memory:
            refiner.save()
    return result
