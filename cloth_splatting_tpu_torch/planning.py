"""Closed-loop cloth manipulation from the command line; counterpart of the
root ``planning.py``:

    python -m cloth_splatting_tpu_torch.planning --modality mpc-cs --in_memory

Runs pick-and-place fold episodes in the PBD cloth simulator with the chosen
planning modality (``manipulation.planning``) and prints the final costs;
each episode writes ``<out_dir>/exp_<i>/result_<modality>.json``. The MPC
modalities plan with the GNN of ``--meshnet_dir`` (``model-N.npz`` of either
package), or an untrained one. ``mpc-cs`` writes the JAX package's scene
directory and refiner checkpoint (needs imageio, PIL and h5py) unless
``--in_memory`` is given. The flags of the root script, plus ``--device``
(default ``cuda``; raises without a card unless ``--device cpu``) and
``--in_memory``.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Closed-loop cloth manipulation")
    p.add_argument("--modality", default="mpc-cs",
                   choices=["random", "fixed", "mpc-oracle", "mpc-ol", "mpc-cs"])
    p.add_argument("--meshnet_dir", type=str, default=None,
                   help="Directory with trained GNN checkpoints (model-*.npz)")
    p.add_argument("--n_experiments", type=int, default=1)
    p.add_argument("--n_candidates", "-A", type=int, default=16)
    p.add_argument("--horizon", "-H", dest="horizon", type=int, default=4)
    p.add_argument("--traj_len", type=int, default=12)
    p.add_argument("--max_steps", type=int, default=20)
    p.add_argument("--action_repetition", type=int, default=1)
    p.add_argument("--input_sequence_length", type=int, default=2)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--refine_steps", type=int, default=200)
    p.add_argument("--static_steps", type=int, default=150)
    p.add_argument("--message_passing", type=int, default=15)
    p.add_argument("--out_dir", type=str, default="./planning_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--in_memory", action="store_true",
                   help="mpc-cs without files: observations and the refiner's "
                        "scene stay in memory")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)

    import numpy as np

    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.manipulation.planning import (
        PlanningConfig,
        closed_loop_planning,
    )
    from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer

    dev = resolve_device(args.device)
    sim_state = None
    if args.modality.startswith("mpc"):
        sim_state = init_cloth_simulator(
            np.random.default_rng(0), input_sequence_length=args.input_sequence_length,
            n_message_passing=args.message_passing, device=dev)
        if args.meshnet_dir:
            trainer = MeshnetTrainer(input_seq_len=args.input_sequence_length,
                                     device=dev)
            sim_state = trainer.load(args.meshnet_dir, sim_state)
        else:
            print("WARNING: no --meshnet_dir; using an UNTRAINED dynamics model")

    rows = []
    for i in range(args.n_experiments):
        cfg = PlanningConfig(
            modality=args.modality, n_candidates=args.n_candidates,
            horizon=args.horizon, traj_len=args.traj_len,
            max_steps=args.max_steps, action_repetition=args.action_repetition,
            input_sequence_length=args.input_sequence_length,
            num_samples=args.num_samples, refine_steps=args.refine_steps,
            static_steps=args.static_steps, seed=args.seed + i,
            in_memory=args.in_memory)
        res = closed_loop_planning(sim_state, cfg,
                                   os.path.join(args.out_dir, f"exp_{i}"), device=dev)
        rows.append(res)
        print(f"[exp {i}] {res['modality']}: initial {res['initial_cost']:.5f} "
              f"-> final {res['final_cost']:.5f}")

    finals = [r["final_cost"] for r in rows]
    print(f"\n{args.modality}: mean final cost "
          f"{float(np.mean(finals)):.5f} +- {float(np.std(finals)):.5f} "
          f"over {len(rows)} episodes")
    return rows


if __name__ == "__main__":
    main()
