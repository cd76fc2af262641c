"""The legacy time-conditioned GNN trainer from the command line;
counterpart of the root ``train_meshnet.py``:

    python -m cloth_splatting_tpu_torch.train_meshnet --data_path TRAJ.npz

Trains the time simulator (``models/time_simulator.py``), which maps
(positions, time, node type) to the next positions, on one npz trajectory
(``{"traj": [T, N, 3]}``); ``--mode rollout`` predicts the positions
autoregressively and writes ``rollout.pkl``. The flags of the root script,
plus ``--device`` (default ``cuda``; raises without a card unless
``--device cpu``). The batch's time indices and position noise come from a
``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import pickle


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Time-conditioned mesh GNN trainer")
    p.add_argument("--mode", choices=["train", "rollout"], default="train")
    p.add_argument("--data_path", type=str, required=True,
                   help="npz file with key 'traj' [T, N, 3]")
    p.add_argument("--model_path", type=str, default="data/model_checkpoint/")
    p.add_argument("--output_path", type=str, default="data/rollouts_pos/")
    p.add_argument("--model_file", type=str, default="latest")
    p.add_argument("--ntraining_steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--message_passing", type=int, default=15)
    p.add_argument("--noise_std", type=float, default=0.0)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--lr_init", type=float, default=3e-4)
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--lr_decay_steps", type=int, default=200)
    p.add_argument("--knn", type=int, default=3)
    p.add_argument("--delaunay", type=int, default=1)
    p.add_argument("--num_samples", type=int, default=300)
    p.add_argument("--subsample", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def train_step(state, opt_state, traj, times, edge_index, node_type, t_ids,
               noise, lr: float):
    """One step over the batch of time indices ``t_ids`` [B] with position
    noise [B, V, 3]: the normalizers accumulate the batch's first sample,
    and the loss, the mean over samples of each one's MSE, uses the
    normalizers the step started from (as the JAX trainer does). The B
    samples run as one graph of B·V nodes. Returns (state, opt_state,
    loss)."""
    import torch

    from cloth_splatting_tpu_torch.models.cloth_simulator import (
        edge_features_from_positions,
    )
    from cloth_splatting_tpu_torch.models.meshnet import (
        flat_params,
        normalizer_apply,
        unflat_params,
    )
    from cloth_splatting_tpu_torch.models.time_simulator import predict_displacement
    from cloth_splatting_tpu_torch.train.meshnet_train import adam_step

    b = t_ids.shape[0]
    v = traj.shape[1]
    pos0 = traj[t_ids[0]] + noise[0]
    feats0 = torch.cat([pos0, times[t_ids[0]].expand(v, 1),
                        torch.ones((v, 1), device=pos0.device)], -1)
    _, node_norm = normalizer_apply(state["node_norm"], feats0, True)
    _, out_norm = normalizer_apply(state["out_norm"], traj[t_ids[0] + 1] - pos0, True)

    pos = traj[t_ids].reshape(b * v, 3)
    nz = noise.reshape(b * v, 3)
    ei = torch.cat([edge_index + i * v for i in range(b)], 1)
    tv = times[t_ids].repeat_interleave(v)[:, None]
    flat = flat_params(state["gnn"])
    leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
    with torch.enable_grad():
        st = {**state, "gnn": unflat_params(state["gnn"], leaves)}
        ef = edge_features_from_positions(pos + nz, ei)
        pred, target, _ = predict_displacement(
            st, pos, tv, node_type.repeat(b), ei, ef,
            target_positions=traj[t_ids + 1].reshape(b * v, 3), position_noise=nz)
        loss = torch.mean((pred - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    new, opt_state = adam_step(flat, dict(zip(leaves, grads)), opt_state, lr)
    return ({"gnn": unflat_params(state["gnn"], new), "node_norm": node_norm,
             "out_norm": out_norm}, opt_state, loss.detach())


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.meshing import (
        delaunay_edges,
        faces_to_edges,
        farthest_point_sampling,
    )
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.models.cloth_simulator import (
        edge_features_from_positions,
    )
    from cloth_splatting_tpu_torch.models.meshnet import flat_params
    from cloth_splatting_tpu_torch.models.time_simulator import (
        init_time_simulator,
        predict_position,
    )
    from cloth_splatting_tpu_torch.train.step import adam_init
    from cloth_splatting_tpu_torch.utils.checkpoints import (
        latest_checkpoint,
        load_flat,
        restore_like,
        save_pytree,
    )

    dev = resolve_device(args.device)
    traj = np.load(args.data_path, allow_pickle=True)["traj"].astype(np.float32)
    if args.subsample and args.num_samples < traj.shape[1]:
        idx = farthest_point_sampling(traj[0], args.num_samples, seed=args.seed)
        traj = traj[:, idx]
    _, faces = delaunay_edges(traj[0], norm_threshold=None)
    edge_index = torch.from_numpy(
        faces_to_edges(faces.astype(np.int32)).astype(np.int64)).to(dev)
    t_steps, v, _ = traj.shape
    node_type = torch.zeros(v, dtype=torch.int64, device=dev)
    traj_t = torch.from_numpy(traj).to(dev)
    times = torch.arange(t_steps, dtype=torch.float32, device=dev) * args.dt

    state = init_time_simulator(np.random.default_rng(args.seed),
                                args.message_passing, device=dev)
    os.makedirs(args.model_path, exist_ok=True)

    if args.mode == "train":
        opt_state = adam_init(flat_params(state["gnn"]))
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        losses = []
        for epoch in range(args.ntraining_steps):
            t_ids = torch.randint(0, t_steps - 1, (args.batch_size,),
                                  generator=gen, device=dev)
            noise = torch.randn((args.batch_size, v, 3), generator=gen,
                                device=dev) * args.noise_std
            lr = args.lr_init * (args.lr_decay_rate ** (epoch / args.lr_decay_steps)) + 1e-6
            state, opt_state, loss = train_step(
                state, opt_state, traj_t, times, edge_index, node_type, t_ids,
                noise, float(np.float32(lr)))
            losses.append(float(loss))
            if epoch % 20 == 0:
                print(f"[epoch {epoch}] loss={losses[-1]:.6f}")
            if epoch % 50 == 0 or epoch == args.ntraining_steps - 1:
                save_pytree(os.path.join(args.model_path, f"model-{epoch}.npz"), state)
        print(f"checkpoints at {args.model_path}")
        return losses

    ckpt = (latest_checkpoint(args.model_path) if args.model_file == "latest"
            else os.path.join(args.model_path, args.model_file))
    state = restore_like(state, load_flat(ckpt))
    pos = traj_t[0]
    preds = [traj[0]]
    with torch.no_grad():
        for t in range(t_steps - 1):
            ef = edge_features_from_positions(pos, edge_index)
            tv = times[t].expand(v, 1)
            pos = predict_position(state, pos, tv, node_type, edge_index, ef)
            preds.append(pos.cpu().numpy())
    preds = np.stack(preds)
    mse = float(np.mean((preds - traj) ** 2))
    os.makedirs(args.output_path, exist_ok=True)
    with open(os.path.join(args.output_path, "rollout.pkl"), "wb") as f:
        pickle.dump({"predicted": preds, "ground_truth": traj, "mse": mse}, f)
    print(f"rollout MSE {mse:.6f} -> {args.output_path}/rollout.pkl")
    return mse


if __name__ == "__main__":
    main()
