"""Novel views, one request at a time: ``render.render`` on the serving
backend.

Set-up builds the scene of a ``cs`` configuration from the seed and serves
its target field with its simulator and predicted trajectory. Each request
is a camera on the orbit's sphere, drawn from the seed (azimuth and
elevation uniform in the mix's ranges, a radius in its range) at a time
uniform in [0, 1], so the simulator runs every frame. One client sends
the next request when the last frame is done: each latency runs from the
request (the camera's upload included) to the frame synchronized on the
device. A reservoir drawn from the seed keeps ``check_frames``
answers of the window, which the reference renders again once the window
has closed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.counts import compositor_forward, front_end
from benchmark.drivers import splat_common as common
from benchmark.harness import checks, scene as scene_mod
from benchmark.reference import splat


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, int(seed), device

    def setup(self) -> None:
        from cloth_splatting_tpu_torch.models.deform import simulator_from_params

        sc = scene_mod.make_scene(self.cfg, self.seed, self.dev)
        self.sc = sc
        self.params, self.gstate = common.program_field(sc["target"], sc["face_ids"],
                                                        sc["alive"])
        self.mesh = common.program_mesh(sc["mesh"])
        self.sim = simulator_from_params({k: v.clone() for k, v in sc["sim"].items()})
        self.rng = np.random.default_rng([self.seed, 2])
        self.kept_rng = np.random.default_rng([self.seed, 3])
        for _ in range(self.tr["warm_frames"]):
            self._serve(self._request())
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _request(self) -> tuple:
        tr = self.tr
        az = self.rng.uniform(*tr["azimuth"])
        el = self.rng.uniform(*tr["elevation"])
        r = self.rng.uniform(*tr["radius"])
        t = self.rng.uniform(0.0, 1.0)
        return (float(az), float(el), float(r), float(np.float32(t)))

    def _camera(self, req: tuple) -> dict:
        img = self.cfg["image"]
        return scene_mod.look_at(req[0], req[1], req[2], img["fov"], img["width"],
                                 img["height"], req[3], self.dev)

    def _serve(self, req: tuple) -> torch.Tensor:
        from cloth_splatting_tpu_torch.render import render

        ref = self.sc["ref"]
        cam = common.camera_arrays(self._camera(req))
        out = render(cam, ref["width"], ref["height"], ref["tan_fov"], ref["tan_fov"],
                     self.params, self.gstate, self.mesh, self.sim, self.sc["predictions"],
                     tuple(self.cfg["image"]["background"]), self.cfg["sh_degree"],
                     backend="tiled_fwd", device=self.dev,
                     pack_order=self.cfg["program_config"]["OptimizationParams"][
                         "raster_pack_order"])
        return out.rgb

    def window(self, seconds: float) -> dict:
        k = self.tr["check_frames"]
        self.kept = []
        lat = []
        seen = 0
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            req = self._request()
            a = time.perf_counter()
            rgb = self._serve(req)
            self._sync()
            lat.append((time.perf_counter() - a) * 1e3)
            # reservoir sampling of the answers to check
            if seen < k:
                self.kept.append((req, rgb.clone()))
            else:
                j = int(self.kept_rng.integers(seen + 1))
                if j < k:
                    self.kept[j] = (req, rgb.clone())
            seen += 1
        elapsed = time.perf_counter() - t0
        self.latencies = lat
        q = np.percentile(lat, [50, 95])
        return {"metrics": {"render_ms_p95": float(q[1])}, "attempted": len(lat),
                "failed": 0, "elapsed_s": elapsed, "latency_ms": lat,
                "p50_ms": float(q[0])}

    def trace(self, profile) -> tuple[dict, dict]:
        n = self.tr["trace_frames"]
        reqs = [self._request() for _ in range(n)]

        def run():
            for req in reqs:
                self._serve(req)

        tr = profile(run, n, "render")
        ref = self.sc["ref"]
        sim = self.sc["sim"]
        items, flops = [], 0.0
        for req in reqs:
            cam = self._camera(req)
            with torch.no_grad():
                verts = splat.simulate(sim, ref["predictions"], cam["time"])
            item = common.count_item(self.sc["target"], self.sc["alive"], ref, verts, cam,
                                     self.cfg["sh_degree"])
            items.append(item)
            flops += compositor_forward.flops(item) + front_end.flops(
                int(self.sc["alive"].sum()), verts.shape[0])
        return tr, {"raster_forward": items, "flops": flops}

    def release(self) -> None:
        self.params = self.gstate = self.sim = None

    def reference_frame(self, req: tuple) -> torch.Tensor:
        sc, ref = self.sc, self.sc["ref"]
        cam = self._camera(req)
        with torch.no_grad():
            verts = splat.simulate(sc["sim"], ref["predictions"], cam["time"])
        return splat.render(sc["target"], sc["alive"], ref, verts, cam,
                            self.cfg["sh_degree"])[0]

    def control(self) -> dict:
        """The numbers of the reference in TF32 in the program's place."""
        with checks.tf32():
            self.kept = [(req, self.reference_frame(req)) for req, _ in self.kept]
        return self.check()

    def check(self) -> dict:
        worst_max, worst_mean = 0.0, 0.0
        for req, rgb in self.kept:
            img = self.reference_frame(req)
            d = (rgb - img).abs()
            worst_max = max(worst_max, float(d.max()))
            worst_mean = max(worst_mean, float(d.mean()))
        if not self.kept:
            worst_max = worst_mean = math.inf
        return {"frame_mean_abs": worst_mean, "_details": {"frame_max_abs": worst_max}}
