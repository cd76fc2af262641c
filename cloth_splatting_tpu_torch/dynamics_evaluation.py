"""GNN dynamics evaluation on held-out simulated trajectories from the
command line; counterpart of the root ``dynamics_evaluation.py``:

    python -m cloth_splatting_tpu_torch.dynamics_evaluation --data_path DIR --meshnet_dir CKPT

Autoregressive rollouts against the ground truth, per-step and mean MSE,
written as JSON. The flags of the root script, plus ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate GNN dynamics rollouts")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--meshnet_dir", type=str, required=True)
    p.add_argument("--input_sequence_length", type=int, default=2)
    p.add_argument("--message_passing", type=int, default=15)
    p.add_argument("--num_samples", type=int, default=200)
    p.add_argument("--out", type=str, default="dynamics_eval.json")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np

    from cloth_splatting_tpu_torch.data.trajectories import ClothSampleDataset
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer

    dev = resolve_device(args.device)
    ds = ClothSampleDataset(args.data_path, args.input_sequence_length,
                            1, num_samples=args.num_samples)
    state = init_cloth_simulator(np.random.default_rng(0),
                                 args.input_sequence_length,
                                 args.message_passing, device=dev)
    trainer = MeshnetTrainer(input_seq_len=args.input_sequence_length, device=dev)
    state = trainer.load(args.meshnet_dir, state)

    reports = []
    for i in range(len(ds.trajs)):
        out = trainer.validate_rollout(state, ds.rollout_item(i))
        reports.append({"traj": i, "mean_mse": out["mean_mse"],
                        "per_step_mse": out["per_step_mse"].tolist()})
        print(f"traj {i}: rollout MSE {out['mean_mse']:.6f}")

    mean = float(np.mean([r["mean_mse"] for r in reports]))
    print(f"mean rollout MSE over {len(reports)} trajectories: {mean:.6f}")
    result = {"mean_mse": mean, "trajectories": reports}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
