"""Real-world GNN mesh predictions from the command line; counterpart of
the root ``generate_rw_predictions.py``:

    python -m cloth_splatting_tpu_torch.generate_rw_predictions \
        --data_path CAPTURE --model_file model-N.npz --output_path SCENE

Loads a real-world capture (tracked cloth points and gripper track, .npz or
.h5), preprocesses it (``data.realworld``: gripper merge, smoothing,
z-flatten), rolls the trained cloth simulator out with the
edge-length-preserving refinement, and writes ``init_mesh.hdf5`` and
``mesh_predictions/mesh_%03d.hdf5`` into the scene directory (needs
``h5py``). The model file is a ``model-N.npz`` of either package. The flags
of the root script, plus ``--device`` (default ``cuda``; raises without a
card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import glob
import os


def load_rw_capture(path: str) -> dict:
    """A raw real-world capture from .npz or .h5 (keys: pos [T, V, 3],
    gripper_pos [T, 3], pick [3], place [3]); a directory's first file."""
    import numpy as np

    if os.path.isdir(path):
        files = (glob.glob(os.path.join(path, "*.h5"))
                 + glob.glob(os.path.join(path, "*.hdf5"))
                 + glob.glob(os.path.join(path, "*.npz")))
        if not files:
            raise FileNotFoundError(f"no capture files in {path}")
        path = files[0]
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Real-world GNN rollout -> scene meshes")
    p.add_argument("--data_path", type=str, required=True,
                   help="raw capture (.npz/.h5 or a directory holding one)")
    p.add_argument("--model_file", type=str, required=True,
                   help="trained cloth simulator checkpoint (.npz)")
    p.add_argument("--output_path", type=str, required=True,
                   help="scene directory to write init_mesh.hdf5 + mesh_predictions/")
    p.add_argument("--num_samples", type=int, default=200)
    p.add_argument("--input_sequence_length", type=int, default=2)
    p.add_argument("--refine_steps", type=int, default=10)
    p.add_argument("--refine_lr", type=float, default=1e-3)
    p.add_argument("--no_refine", action="store_true",
                   help="skip the edge-length-preserving inner optimization")
    p.add_argument("--latent", type=int, default=128)
    p.add_argument("--message_passing", type=int, default=15)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.predictions import save_mesh_predictions
    from cloth_splatting_tpu_torch.data.realworld import preprocess_rw_trajectory
    from cloth_splatting_tpu_torch.device import resolve_device
    from cloth_splatting_tpu_torch.models.cloth_simulator import (
        init_cloth_simulator,
        rollout,
    )
    from cloth_splatting_tpu_torch.utils.checkpoints import load_flat, restore_like

    dev = resolve_device(args.device)
    raw = load_rw_capture(args.data_path)
    traj = preprocess_rw_trajectory(raw, num_samples=args.num_samples)
    print(f"preprocessed: {traj['pos'].shape[0]} steps, "
          f"{traj['pos'].shape[1]} particles, "
          f"{traj['edge_index'].shape[1]} edges, grasped={traj['grasped']}")

    template = init_cloth_simulator(
        np.random.default_rng(0),
        input_sequence_length=args.input_sequence_length,
        n_message_passing=args.message_passing, latent=args.latent, device=dev)
    state = restore_like(template, load_flat(args.model_file))

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    hist = args.input_sequence_length
    init_vel = np.zeros((hist, traj["pos"].shape[1], 3), np.float32)
    actions = traj["actions"][1:]            # a_t advances state t -> t+1
    pred, _ = rollout(state, tensor(traj["pos"][0], np.float32),
                      tensor(init_vel, np.float32),
                      tensor(traj["node_type"], np.int64),
                      tensor(traj["edge_index"], np.int64),
                      tensor(actions, np.float32), int(traj["grasped"]),
                      n_steps=actions.shape[0], real_world=not args.no_refine,
                      refine_steps=args.refine_steps, refine_lr=args.refine_lr)
    positions = pred.cpu().numpy()
    os.makedirs(args.output_path, exist_ok=True)
    save_mesh_predictions(args.output_path, traj["faces"], positions)
    err = np.linalg.norm(positions[: traj["pos"].shape[0]] - traj["pos"],
                         axis=-1).mean()
    print(f"rollout: {positions.shape[0]} meshes -> {args.output_path} "
          f"(mean L2 vs capture {err:.4f})")
    return positions


if __name__ == "__main__":
    main()
