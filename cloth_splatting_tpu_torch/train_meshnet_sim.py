"""Action-conditioned GNN dynamics training from the command line (the
paper's dynamics model); counterpart of the root ``train_meshnet_sim.py``:

    python -m cloth_splatting_tpu_torch.train_meshnet_sim --data_path DIR

Modes train / valid / rollout, curriculum, message-passing depth, history
length, velocity noise, subsampling, Delaunay or kNN graphs, exponential
learning-rate decay, periodic checkpoints (``model-N.npz``,
``train_state-N.npz``, the JAX package's layout: either package reads the
other's). The flags of the root script, plus ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``).
``--data_parallel 1`` trains on one rank a visible card
(``parallel.launch``, NCCL), the batch split over them; with
``--device cpu``, a world of one rank (gloo). Reading the h5 trajectories
needs ``h5py``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Cloth GNN dynamics trainer")
    p.add_argument("--mode", choices=["train", "valid", "rollout"], default="train")
    p.add_argument("--model_file", type=str, default=None)
    p.add_argument("--data_path", type=str, default="./sim_datasets/train_dataset/TOWEL")
    p.add_argument("--data_val_path", type=str, default="./sim_datasets/test_dataset/TOWEL")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model_path", type=str, default="data/model_checkpoint_sim/")
    p.add_argument("--output_path", type=str, default="data/rollouts_pos_sim/")
    p.add_argument("--rollout_filename", type=str, default="rollout")
    p.add_argument("--ntraining_steps", type=int, default=300)
    p.add_argument("--nsave_steps", type=int, default=10)
    p.add_argument("--input_sequence_length", type=int, default=2)
    p.add_argument("--future_sequence_length", type=int, default=1)
    p.add_argument("--curriculum", type=int, default=0)
    p.add_argument("--action_steps", type=int, default=1)
    p.add_argument("--message_passing", type=int, default=15)
    p.add_argument("--noise_std", type=float, default=0.0)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--lr_init", type=float, default=3e-4)
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--lr_decay_steps", type=int, default=300)
    p.add_argument("--normalize", type=int, default=1)
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--delaunay", type=int, default=1)
    p.add_argument("--subsample", type=int, default=1)
    p.add_argument("--num_samples", type=int, default=200)
    p.add_argument("--viz_dir", type=str, default=None,
                   help="write prediction-vs-ground-truth rollout frames and "
                        "a GIF at validation epochs")
    p.add_argument("--viz_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="1: split each batch over one rank a visible card "
                        "(one rank on the CPU)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.trajectories import ClothSampleDataset
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
    from cloth_splatting_tpu_torch.train.meshnet_train import (
        MeshnetTrainer,
        train_meshnet,
    )

    dev = resolve_device(args.device)
    if args.mode == "train" and args.data_parallel \
            and not torch.distributed.is_initialized():
        from cloth_splatting_tpu_torch.parallel.launch import launch, main_rank

        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        argv = list(sys.argv[1:] if argv is None else argv)
        return launch(main_rank, n, dev, args=("cloth_splatting_tpu_torch.train_meshnet_sim", argv))[0]
    state = init_cloth_simulator(
        np.random.default_rng(args.seed),
        input_sequence_length=args.input_sequence_length,
        n_message_passing=args.message_passing,
        normalize=bool(args.normalize), device=dev)
    trainer = MeshnetTrainer(
        lr_init=args.lr_init, lr_decay_rate=args.lr_decay_rate,
        lr_decay_steps=args.lr_decay_steps, noise_std=args.noise_std,
        normalize=bool(args.normalize),
        input_seq_len=args.input_sequence_length, device=dev, seed=args.seed)

    exp_name = (f"cloth-splatting-SIM-curr{args.curriculum}-astep{args.action_steps}"
                f"-propagation{args.message_passing}-noise{args.noise_std}"
                f"-nodes{args.num_samples}")
    model_dir = os.path.join(args.model_path, exp_name)
    graph_kw = dict(subsample=bool(args.subsample),
                    use_delaunay=bool(args.delaunay), knn=args.knn)

    if args.mode == "train":
        ds = ClothSampleDataset(args.data_path, args.input_sequence_length,
                                args.future_sequence_length, args.dt,
                                args.num_samples, **graph_kw)
        val_ds = None
        if os.path.isdir(args.data_val_path):
            val_ds = ClothSampleDataset(args.data_val_path,
                                        args.input_sequence_length,
                                        args.future_sequence_length, args.dt,
                                        args.num_samples, **graph_kw)
        print(f"Experiment: {exp_name} | {len(ds.trajs)} trajectories, "
              f"{len(ds)} samples")
        state, losses = train_meshnet(
            trainer, state, ds, val_ds,
            n_epochs=args.ntraining_steps, batch_size=args.batch_size,
            curriculum=bool(args.curriculum),
            base_future=args.future_sequence_length,
            save_every=args.nsave_steps, model_dir=model_dir, seed=args.seed,
            steps_per_epoch=args.steps_per_epoch,
            viz_dir=args.viz_dir, viz_every=args.viz_every,
            data_parallel=bool(args.data_parallel))
        print(f"final loss: {losses[-1]:.6f}; checkpoints at {model_dir}")
        return losses

    ds = ClothSampleDataset(args.data_path, args.input_sequence_length,
                            args.future_sequence_length, args.dt,
                            args.num_samples, **graph_kw)
    state = trainer.load(model_dir, state,
                         args.model_file if args.model_file else "latest")
    os.makedirs(args.output_path, exist_ok=True)
    results = []
    for i in range(len(ds.trajs)):
        out = trainer.validate_rollout(state, ds.rollout_item(i))
        results.append(out)
        print(f"traj {i}: rollout MSE {out['mean_mse']:.6f}")
    with open(os.path.join(args.output_path,
                           f"{args.rollout_filename}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
