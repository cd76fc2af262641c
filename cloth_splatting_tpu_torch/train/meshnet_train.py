"""GNN dynamics training; counterpart of
``cloth_splatting_tpu/train/meshnet_train.py``.

One training step over a batch of samples: the batch is flattened into one
graph of B·V nodes, each sample's edges offset by b·V and its padded edges
dropped (the same sums as the JAX package's masked, vmapped samples: a
padded edge sends nothing to a node), so every MLP is one matmul over all
B·E edge rows. The future-sequence unroll advances the state with
``update_prediction``; the loss is the mean over samples of each sample's
MSE, summed over the unroll; Adam (optax ``scale_by_adam`` defaults, over
all parameters as one vector) with the exponential epoch decay ``lr = lr_init * decay^(epoch / decay_steps) +
1e-6``; the curriculum 1 -> 2 -> 3 future steps at 1/3 and 2/3 of the
epochs; velocity noise only at the first unroll step, drawn from the
trainer's ``torch.Generator``.

Normalizer statistics are accumulated once a batch, on the flattened
first-step features and targets, before the unroll, which then runs with
``training=False``, as in the JAX package.

Data parallelism (``train_step(..., group=)``, ``train_meshnet(...,
data_parallel=True)``; the JAX package's ``make_sharded_meshnet_step``) runs
inside a ``torch.distributed`` group of W ranks: every rank draws the same
batch and the same noise, accumulates the normalizers on the whole batch
(so every rank's statistics are the single process's), and trains on its
rows ``[r B/W, (r+1) B/W)``; the loss is each rank's mean scaled by its
share of the batch's nodes, and one all-reduce sums the loss and the
gradients, so the identical Adam on every rank keeps identical states.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models.cloth_simulator import (
    edge_features_from_positions,
    node_type_onehot,
    predict_acceleration,
    rollout,
    update_prediction,
)
from cloth_splatting_tpu_torch.models.meshnet import (
    flat_params,
    normalizer_apply,
    normalizer_inverse,
    unflat_params,
)
from cloth_splatting_tpu_torch.train.step import AdamState, adam_init, adam_update
from cloth_splatting_tpu_torch.utils.checkpoints import (
    latest_checkpoint,
    load_flat,
    restore_like,
    save_pytree,
)
from cloth_splatting_tpu_torch.utils.profiling import span


def flatten_batch(batch: dict[str, np.ndarray], device: torch.device) -> dict:
    """A padded batch of samples ([B, V, ...] arrays, ``edge_index`` [B, 2,
    E_max] with ``edge_mask``) as one graph of B·V nodes on ``device``:
    sample b's edges offset by b·V, its padded edges dropped."""
    b, v = batch["velocity"].shape[:2]
    ei = batch["edge_index"].astype(np.int64) + (np.arange(b) * v)[:, None, None]
    edge_index = np.concatenate([ei[i][:, batch["edge_mask"][i]] for i in range(b)], 1)

    def nodes(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape((b * v,) + a.shape[2:]))).to(device)

    return {"edge_index": torch.from_numpy(edge_index).to(device),
            "velocity": nodes(batch["velocity"]),
            "node_type": nodes(batch["node_type"].astype(np.int64)),
            "positions": nodes(batch["positions"]),
            "target_vel": nodes(batch["target_vel"]),
            "particle_actions": nodes(batch["particle_actions"])}


def adam_step(params: dict, grads: dict, opt_state: AdamState, lr: float):
    """``params - lr * adam_update(grads)`` over every leaf at once: the
    leaves (keyed by path, in the moments' order) concatenated into one
    vector, so the hand-written Adam issues a dozen kernels, not a dozen a
    leaf; the same elementwise arithmetic, so the same bits. Returns (new
    params, new opt_state), each leaf a view into one buffer."""
    keys = list(opt_state.mu)
    sizes = [params[k].numel() for k in keys]

    def cat(tree):
        return torch.cat([tree[k].reshape(-1) for k in keys])

    def split(vector):
        return {k: v.view_as(params[k]) for k, v in zip(keys, vector.split(sizes))}

    updates, st = adam_update({"p": cat(grads)},
                              AdamState(opt_state.count, {"p": cat(opt_state.mu)},
                                        {"p": cat(opt_state.nu)}), 0.9, 0.999, 1e-8)
    with torch.no_grad():
        new = cat(params) - lr * updates["p"]
    return split(new), AdamState(st.count, split(st.mu["p"]), split(st.nu["p"]))


class MeshnetTrainer:
    def __init__(self, lr_init: float = 3e-4, lr_decay_rate: float = 0.1,
                 lr_decay_steps: float = 300.0, noise_std: float = 0.0,
                 normalize: bool = True, input_seq_len: int = 2,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.lr_init = lr_init
        self.lr_decay_rate = lr_decay_rate
        self.lr_decay_steps = lr_decay_steps
        self.noise_std = noise_std
        self.normalize = normalize
        self.input_seq_len = input_seq_len
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def lr(self, epoch: float) -> float:
        return self.lr_init * (self.lr_decay_rate ** (epoch / self.lr_decay_steps)) + 1e-6

    def init_opt(self, state: dict) -> AdamState:
        """Adam moments keyed by each parameter's path (the layout of the
        JAX package's ``train_state-N.npz``)."""
        return adam_init(flat_params(state["gnn"]))

    def draw_noise(self, shape) -> torch.Tensor:
        if self.noise_std > 0:
            return torch.randn(tuple(shape), generator=self.generator,
                               device=self.device) * self.noise_std
        return torch.zeros(tuple(shape), dtype=torch.float32, device=self.device)

    def train_step(self, state: dict, opt_state: AdamState,
                   batch: dict[str, np.ndarray], epoch: float, future: int,
                   noise: torch.Tensor | None = None,
                   group: dist.ProcessGroup | None = None):
        """One step on a padded numpy batch (``data.trajectories``'
        ``ClothSampleDataset.batch``); ``noise`` [B, V, 3·hist] replaces the
        trainer's draw. With ``group``, one data-parallel step: every rank
        of the group passes the same batch and trains on its rows. Returns
        (state, opt_state, loss as a tensor)."""
        with span("gnn.train_step"):
            with span("gnn.batch_upload"):
                graph = flatten_batch(batch, self.device)
                if noise is None:
                    noise = self.draw_noise(batch["velocity"].shape)
                noise = noise.to(self.device).reshape(graph["velocity"].shape)
            lr = float(np.float32(self.lr(epoch)))
            with span("gnn.normalizers"):
                state = self._accumulate(state, graph, noise)
            b, v = batch["velocity"].shape[:2]
            rows, local = slice(0, b), graph
            if group is not None:
                w, r = dist.get_world_size(group), dist.get_rank(group)
                rows = slice(r * b // w, (r + 1) * b // w)
                with span("gnn.batch_upload"):
                    local = flatten_batch({k: a[rows] for k, a in batch.items()},
                                          self.device)
            return self._train_step(state, opt_state, local,
                                    noise[rows.start * v:rows.stop * v], lr, future,
                                    group=group, share=(rows.stop - rows.start) / b)

    def _accumulate(self, state, graph, noise):
        """The normalizers with this batch's first-step statistics added."""
        if not self.normalize:
            return state
        vel = graph["velocity"] + noise
        feats0 = torch.cat([vel, node_type_onehot(graph["node_type"])], -1)
        _, node_norm = normalizer_apply(state["node_norm"], feats0, accumulate=True)
        _, out_norm = normalizer_apply(state["out_norm"],
                                       graph["target_vel"][:, 0] - vel[:, -3:],
                                       accumulate=True)
        return {**state, "node_norm": node_norm, "out_norm": out_norm}

    def _train_step(self, state, opt_state, graph, noise, lr, future, group, share):
        """The step on ``graph``, this rank's ``share`` of the batch (the
        whole batch, 1.0, without a ``group``), from normalizers that have
        the whole batch's statistics: the mean squared error scaled by the
        share, summed with the other ranks' over ``group``."""
        edge_index = graph["edge_index"]
        vel = graph["velocity"] + noise               # first-step noise only
        pos = graph["positions"]
        target_vel = graph["target_vel"]              # [B·V, future, 3]
        actions = graph["particle_actions"]           # [B·V, future, 3]

        flat = flat_params(state["gnn"])
        leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
        st = {**state, "gnn": unflat_params(state["gnn"], leaves)}
        with torch.enable_grad():
            with span("forward"):
                edge_feats = edge_features_from_positions(pos, edge_index)
                loss = 0.0
                for f in range(future):
                    pred, target, _ = predict_acceleration(
                        st, vel, graph["node_type"], edge_index, edge_feats,
                        target_velocity=target_vel[:, f], normalize=self.normalize,
                        training=False)
                    loss = loss + torch.mean((pred - target) ** 2) * share
                    if f < future - 1:
                        acc = (normalizer_inverse(st["out_norm"], pred)
                               if self.normalize else pred)
                        vel, edge_feats, pos = update_prediction(
                            vel, acc, pos, edge_index, actions[:, f], actions[:, f + 1])
            with span("backward"):
                grads = torch.autograd.grad(loss, list(leaves.values()))
        if group is not None:
            from cloth_splatting_tpu_torch.parallel.mesh import Axis, reduce_packed

            axis = Axis("world", group, dist.get_world_size(group),
                        dist.get_rank(group))
            loss, *grads = reduce_packed([loss.detach()] + list(grads), axis)
        with span("update"):
            new, opt_state = adam_step(flat, dict(zip(leaves, grads)), opt_state, lr)
        return ({**state, "gnn": unflat_params(state["gnn"], new)}, opt_state,
                loss.detach())

    # ------------------------------------------------------------- rollout

    def validate_rollout(self, state: dict, item: dict[str, np.ndarray],
                         n_steps: int | None = None) -> dict[str, np.ndarray]:
        """Autoregressive rollout against the ground truth: predictions and
        per-step MSE."""
        t_total = item["pos"].shape[0]
        n = n_steps or (t_total - 1)
        n = min(n, item["actions"].shape[0], t_total - 1)
        dev = self.device
        traj, _ = rollout(
            state,
            torch.from_numpy(np.asarray(item["pos"][0], np.float32)).to(dev),
            torch.from_numpy(np.asarray(item["init_velocity"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(item["node_type"], np.int64)).to(dev),
            torch.from_numpy(np.asarray(item["edge_index"], np.int64)).to(dev),
            torch.from_numpy(np.asarray(item["actions"], np.float32)).to(dev),
            int(item["grasped"]), n_steps=n, normalize=self.normalize)
        traj = traj.cpu().numpy()
        gt = item["pos"][1:n + 1]
        err = np.mean((traj[1:] - gt) ** 2, axis=(1, 2))
        return {"predicted_positions": traj,
                "ground_truth": item["pos"][:n + 1],
                "per_step_mse": err,
                "mean_mse": float(err.mean())}

    # --------------------------------------------------------- checkpoints

    def save(self, model_dir: str, step: int, state: dict, opt_state=None):
        """``model-<step>.npz`` and ``train_state-<step>.npz`` in the JAX
        package's flat layout."""
        os.makedirs(model_dir, exist_ok=True)
        save_pytree(os.path.join(model_dir, f"model-{step}.npz"), state)
        if opt_state is not None:
            save_pytree(os.path.join(model_dir, f"train_state-{step}.npz"),
                        {"opt": opt_state, "step": np.asarray(step)})

    def load(self, model_dir: str, template: dict, file: str = "latest") -> dict:
        """A ``model-N.npz`` of either package restored into ``template``'s
        structure, dtypes and device."""
        path = (latest_checkpoint(model_dir) if file == "latest"
                else os.path.join(model_dir, file))
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"no meshnet checkpoint in {model_dir}")
        return restore_like(template, load_flat(path))


def curriculum_future(epoch: int, n_epochs: int) -> int:
    """The unroll length of ``epoch``: 1, 2, 3 over the thirds of training."""
    frac = epoch / max(n_epochs, 1)
    return 1 if frac < 0.33 else (2 if frac < 0.66 else 3)


def train_meshnet(
    trainer: MeshnetTrainer,
    state: dict,
    train_ds,
    val_ds=None,
    n_epochs: int = 300,
    batch_size: int = 32,
    curriculum: bool = True,
    base_future: int = 1,
    save_every: int = 10,
    model_dir: str | None = None,
    seed: int = 0,
    log_every: int = 1,
    steps_per_epoch: int | None = None,
    viz_dir: str | None = None,
    viz_every: int = 50,
    data_parallel: bool = False,
) -> tuple[dict, list[float]]:
    """The epoch loop with the 1/3-2/3 unroll curriculum. Batches are drawn
    by ``numpy.random.default_rng(seed)`` (the JAX package's draws), the
    noise by the trainer's generator seeded with ``seed``. Returns (state,
    per-epoch mean loss).

    ``data_parallel=True`` runs on every rank of the initialized
    ``torch.distributed`` world (``parallel.launch.launch`` starts one a
    device): the batch is split over the ranks (``train_step(group=)``),
    ``batch_size`` must divide by the world size, and rank 0 alone logs and
    saves."""
    group, lead = None, True
    if data_parallel:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "data_parallel=True runs inside an initialized torch.distributed "
                "group, one rank a device: start the ranks with "
                "cloth_splatting_tpu_torch.parallel.launch.launch")
        group, n_dev = dist.group.WORLD, dist.get_world_size()
        if batch_size % n_dev:
            raise ValueError(
                f"--data_parallel needs batch_size ({batch_size}) divisible "
                f"by the device count ({n_dev})")
        lead = dist.get_rank() == 0
        if lead:
            print(f"meshnet data-parallel over {n_dev} devices")
    rng = np.random.default_rng(seed)
    trainer.generator.manual_seed(seed)
    opt_state = trainer.init_opt(state)
    losses = []

    for epoch in range(n_epochs):
        future = curriculum_future(epoch, n_epochs) if curriculum else base_future
        if train_ds.future_seq_len != future:
            train_ds.set_future_seq_len(future)

        n_steps = steps_per_epoch or max(len(train_ds) // batch_size, 1)
        epoch_loss = torch.zeros((), dtype=torch.float64, device=trainer.device)
        for _ in range(n_steps):
            batch = train_ds.batch(rng, batch_size)
            state, opt_state, loss = trainer.train_step(state, opt_state, batch,
                                                        epoch, future, group=group)
            epoch_loss += loss.double()
        losses.append(float(epoch_loss) / n_steps)

        if epoch % log_every == 0 and lead:
            msg = f"[meshnet epoch {epoch}/{n_epochs}] future={future} loss={losses[-1]:.6f}"
            if val_ds is not None and len(val_ds.trajs) > 0:
                item = val_ds.rollout_item(0)
                val = trainer.validate_rollout(state, item)
                msg += f" val_rollout_mse={val['mean_mse']:.6f}"
                if viz_dir and epoch % viz_every == 0:
                    # prediction-vs-ground-truth rollout frames and a GIF
                    from cloth_splatting_tpu_torch.eval.mesh_viz import (
                        create_gif,
                        rollout_frames,
                    )

                    frame_dir = os.path.join(viz_dir, f"epoch_{epoch:05d}")
                    paths = rollout_frames(val["ground_truth"],
                                           val["predicted_positions"],
                                           item["edge_index"], frame_dir)
                    if paths:
                        create_gif(paths, os.path.join(frame_dir, "rollout.gif"))
                        msg += f" viz={frame_dir}"
            print(msg)

        if model_dir and lead and epoch % save_every == 0:
            trainer.save(model_dir, epoch, state, opt_state)

    if model_dir and lead:
        trainer.save(model_dir, n_epochs, state, opt_state)
    return state, losses
