"""A planner's candidate evaluation: ``manipulation.mpc.MPC.model_rollout``.

Set-up makes the network's weights from the seed and its normalizers'
sums from batches of the configuration's trajectories, samples the
planner's graph (``nodes`` particles of one trajectory), and warms the
call. Each request is a state of that trajectory (a time drawn from the
seed: the positions and the velocity history before it) and
``candidates`` action sequences of ``horizon`` steps drawn from the seed
(a direction and a speed per candidate, and a small jitter per step); the
planner waits for each answer. A reservoir drawn from the seed keeps
``check_calls`` answers of the window, which the reference rolls out again
once the window has closed.
"""

from __future__ import annotations

import math
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
        from cloth_splatting_tpu_torch.manipulation.mpc import MPC

        cfg, tr, dev = self.cfg, self.tr, self.dev
        net = cfg["network"]
        self.hist = net["input_sequence_length"]
        trajs = gnn_common.processed(cfg, tr["nodes"], tr["edge_max_len"], dev)
        rng = np.random.default_rng([self.seed, 7])
        stats = [graphs.sample_batch(trajs, rng, tr["normalizer_batch"], 1, self.hist)
                 for _ in range(tr["normalizer_batches"])]
        self.norms = graphs.normalizer_sums(stats, self.hist, dev)
        self.weights = graphs.weights(net, scene_mod.generator(self.seed, 8, dev), dev)
        self.traj = trajs[tr["trajectory"]]
        self.mpc = MPC(gnn_common.program_state(self.weights, self.norms, dev),
                       tr["candidates"], tr["horizon"], self.hist, normalize=True,
                       seed=self.seed % (1 << 31))
        self.rng = np.random.default_rng([self.seed, 9])
        self.kept_rng = np.random.default_rng([self.seed, 10])
        for _ in range(tr["warm_calls"]):
            self._serve(self._request())

    def _request(self) -> tuple:
        tr = self.tr
        n_t = self.traj["pos"].shape[0]
        ti = int(self.rng.integers(self.hist, n_t))
        a, h = tr["candidates"], tr["horizon"]
        heading = self.rng.uniform(0.0, 2 * math.pi, a)
        rise = self.rng.uniform(*tr["rise"], a)
        speed = self.rng.uniform(*tr["speed"], a)
        direction = np.stack([np.cos(heading), np.sin(heading), rise], 1)
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        acts = (speed[:, None, None] * direction[:, None, :]
                + self.rng.normal(0.0, tr["jitter"], (a, h, 3)))
        return ti, acts.astype(np.float32)

    def _features(self, ti: int) -> dict:
        pos = self.traj["pos"]
        vel = np.stack([pos[ti - self.hist + k] - pos[ti - self.hist + k - 1]
                        if ti - self.hist + k >= 1 else np.zeros_like(pos[0])
                        for k in range(self.hist)]).astype(np.float32)
        return {"pos0": pos[ti], "velocity_history": vel,
                "node_type": self.traj["node_type"], "edge_index": self.traj["edges"],
                "grasped": self.traj["grasped"]}

    def _serve(self, req: tuple) -> np.ndarray:
        ti, acts = req
        self.mpc.candidates = acts
        return self.mpc.model_rollout(self._features(ti), horizon=self.tr["horizon"])

    def window(self, seconds: float) -> dict:
        k = self.tr["check_calls"]
        self.kept, lat, seen = [], [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            req = self._request()
            a = time.perf_counter()
            out = self._serve(req)
            lat.append((time.perf_counter() - a) * 1e3)
            if seen < k:
                self.kept.append((req, out))
            else:
                j = int(self.kept_rng.integers(seen + 1))
                if j < k:
                    self.kept[j] = (req, out)
            seen += 1
        elapsed = time.perf_counter() - t0
        self.latencies = lat
        q = np.percentile(lat, [50, 95])
        return {"metrics": {"rollout_ms_p95": float(q[1])}, "attempted": len(lat),
                "failed": 0, "elapsed_s": elapsed, "latency_ms": lat, "p50_ms": float(q[0])}

    def trace(self, profile) -> tuple[dict, dict]:
        n = self.tr["trace_calls"]
        reqs = [self._request() for _ in range(n)]

        def run():
            for req in reqs:
                self._serve(req)

        tr = profile(run, n, "model_rollout")
        sizes = graphs.mlp_sizes(self.cfg["network"])
        a = self.tr["candidates"]
        nodes = a * self.traj["pos"].shape[1]
        edges = a * self.traj["edges"].shape[1]
        flops = n * self.tr["horizon"] * mgn_forward.flops(sizes, nodes, edges)
        return tr, {"flops": flops}

    def release(self) -> None:
        self.mpc = None

    def reference_rollout(self, req: tuple) -> torch.Tensor:
        net = self.cfg["network"]
        dev = self.dev
        ti, acts = req
        e = torch.as_tensor(self.traj["edges"], device=dev)
        f = self._features(ti)
        return mgn.rollout(self.weights, self.norms, torch.as_tensor(f["pos0"], device=dev),
                           torch.as_tensor(f["velocity_history"], device=dev),
                           torch.as_tensor(f["node_type"], device=dev), e[0], e[1],
                           int(f["grasped"]), torch.as_tensor(acts, device=dev),
                           net["mlp_hidden_layers"] + 1, net["message_passing_steps"])

    def control(self) -> dict:
        """The numbers of the reference in TF32 in the program's place."""
        with checks.tf32():
            self.kept = [(req, self.reference_rollout(req).cpu().numpy())
                         for req, _ in self.kept]
        return self.check()

    def check(self) -> dict:
        dev = self.dev
        worst = 0.0
        for req, out in self.kept:
            ref = self.reference_rollout(req)
            worst = max(worst, float((torch.as_tensor(out, device=dev) - ref).abs().max()))
        if not self.kept:
            worst = math.inf
        return {"positions_max_abs": worst}
