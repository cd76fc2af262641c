"""Training the dynamics model: ``MeshnetTrainer.train_step`` on batches of
sampled cloth graphs.

Set-up makes the network's weights from the seed, a pool of padded
batches of each unroll length from the configuration's trajectories
(samples drawn from the seed), and drives one trainer and optimizer state
through ``check_steps`` steps (unroll lengths 1, 2, 3 in an order drawn
from the seed), keeping what the check compares. The window goes on with
the same state: each block of three steps takes the three unroll lengths
in an order drawn from the seed, each step a batch of the pool.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.counts import mgn_forward
from benchmark.drivers import gnn_common
from benchmark.harness import checks, graphs, scene as scene_mod
from benchmark.reference import mgn


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, int(seed), device

    def setup(self) -> None:
        from cloth_splatting_tpu_torch.models.meshnet import flat_params
        from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer

        cfg, tr, dev = self.cfg, self.tr, self.dev
        net = cfg["network"]
        self.hist = net["input_sequence_length"]
        trajs = gnn_common.processed(cfg, tr["nodes"], cfg["data"]["edge_max_len"], dev)
        rng = np.random.default_rng([self.seed, 4])
        self.pool = {f: [graphs.sample_batch(trajs, rng, tr["batch"], f, self.hist)
                         for _ in range(tr["pool_per_unroll"])]
                     for f in tr["unroll"]}
        self.order = np.random.default_rng([self.seed, 5])
        self.weights = graphs.weights(net, scene_mod.generator(self.seed, 6, dev), dev)
        t = cfg["trainer"]
        if t["noise_std"] != 0.0 or not t["normalize"]:
            raise ValueError("the check follows a trainer with normalizers and no "
                             "velocity noise")
        self.trainer = MeshnetTrainer(lr_init=t["lr_init"], lr_decay_rate=t["lr_decay_rate"],
                                      lr_decay_steps=t["lr_decay_steps"], noise_std=0.0,
                                      normalize=True, input_seq_len=self.hist, device=dev,
                                      seed=self.seed % (1 << 62))
        self.state = gnn_common.program_state(self.weights, None, dev)
        self.opt = self.trainer.init_opt(self.state)
        self.epoch = tr["epoch"]
        self.lr = float(np.float32(self.trainer.lr(self.epoch)))

        # the check's steps, by the window's own call
        self.check_batches = []
        losses = []
        for i, f in enumerate(self._block()):
            batch = self._batch(f)
            self.check_batches.append((f, batch))
            self.state, self.opt, loss = self.trainer.train_step(
                self.state, self.opt, batch, self.epoch, f)
            losses.append(float(loss))
            if i == 0:
                grad1 = {k: v.clone() / 0.1 for k, v in self.opt.mu.items()}
        self.prog = {"losses": losses, "grad1": grad1,
                     "end": {k: v.clone() for k, v in flat_params(self.state["gnn"]).items()}}
        self._sync()

    def _block(self) -> list:
        return [int(f) for f in self.order.permutation(self.tr["unroll"])]

    def _batch(self, future: int) -> dict:
        pool = self.pool[future]
        return pool[int(self.order.integers(len(pool)))]

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _steps(self, n_blocks: int | None, seconds: float | None) -> tuple[int, list]:
        steps, futures = 0, []
        t0 = time.perf_counter()
        while True:
            for f in self._block():
                self.state, self.opt, _ = self.trainer.train_step(
                    self.state, self.opt, self._batch(f), self.epoch, f)
                steps += 1
                futures.append(f)
                if seconds is not None and time.perf_counter() - t0 >= seconds:
                    return steps, futures
            if n_blocks is not None:
                n_blocks -= 1
                if n_blocks == 0:
                    return steps, futures

    def window(self, seconds: float) -> dict:
        self._sync()
        t0 = time.perf_counter()
        steps, _ = self._steps(None, seconds)
        self._sync()
        elapsed = time.perf_counter() - t0
        return {"metrics": {"gnn_train_steps_per_s": steps / elapsed}, "attempted": steps,
                "failed": 0, "elapsed_s": elapsed}

    def trace(self, profile) -> tuple[dict, dict]:
        n_blocks = self.tr["trace_blocks"]
        holder = {}

        def run():
            holder["steps"] = self._steps(n_blocks, None)

        tr = profile(run, n_blocks * len(self.tr["unroll"]), "train_step")
        sizes = graphs.mlp_sizes(self.cfg["network"])
        batch = self.tr["batch"]
        flops = 0.0
        for f in holder["steps"][1]:
            edges = float(np.mean([b["edge_mask"].sum() for b in self.pool[f]]))
            nodes = batch * self.tr["nodes"]
            flops += 3 * f * mgn_forward.flops(sizes, nodes, int(round(edges)))
        return tr, {"flops": flops}

    def release(self) -> None:
        self.state = self.opt = self.trainer = None

    def check(self) -> dict:
        return checks.training_numbers(dict(self.prog, start=self.weights),
                                       dict(self.reference_run(), start=self.weights))

    def control(self) -> dict:
        """The numbers of the reference run in TF32 in the program's place."""
        with checks.tf32():
            low = self.reference_run()
        return checks.training_numbers(dict(low, start=self.weights),
                                       dict(self.reference_run(), start=self.weights))

    def faults(self) -> dict:
        """The numbers of the reference with half of each batch left out
        (its first half kept; the mean over the rest) in the program's
        place."""
        return {"half_batch": checks.training_numbers(
            dict(self.reference_run(rows=self.tr["batch"] // 2), start=self.weights),
            dict(self.reference_run(), start=self.weights))}

    def reference_run(self, rows: int | None = None) -> dict:
        """The reference's steps from the same start on the same batches
        (their first ``rows`` samples)."""
        net = self.cfg["network"]
        n_layers = net["mlp_hidden_layers"] + 1
        n_mp = net["message_passing_steps"]
        dev = self.dev
        zeros = {k: torch.zeros_like(v) for k, v in self.weights.items()}
        node_dim = 3 * self.hist + net["node_types"]
        st = {"params": {k: v.clone() for k, v in self.weights.items()},
              "m": dict(zeros), "v": dict(zeros), "count": 0,
              "norms": {"node": {"sum": torch.zeros(node_dim, device=dev),
                                 "sum_sq": torch.zeros(node_dim, device=dev),
                                 "count": torch.zeros((), device=dev)},
                        "out": {"sum": torch.zeros(3, device=dev),
                                "sum_sq": torch.zeros(3, device=dev),
                                "count": torch.zeros((), device=dev)}}}
        losses = []
        for i, (f, batch) in enumerate(self.check_batches):
            batch = {k: v[:rows] for k, v in batch.items()}
            st, loss = mgn.train_step(st, graphs.batch_tensors(batch, dev), f, self.lr,
                                      n_layers, n_mp)
            losses.append(loss)
            if i == 0:
                grad1 = {k: v / 0.1 for k, v in st["m"].items()}
        return {"losses": losses, "grad1": grad1, "end": st["params"]}
