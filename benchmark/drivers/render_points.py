"""Novel views of a plain 3D Gaussian Splatting scene, one request at a
time: the port's point model (``models.point_gaussians.render_points``)
on its serving path.

Set-up draws the field of a ``gs`` configuration from the seed on the
device (``make_field``): an object region and a background shell, with
the distributions the configuration states. Each request is a camera
looking at the origin from a point drawn from the seed (azimuth, elevation
and radius uniform in the mix's ranges). One client sends the next request
when the last frame is done: each latency runs from the request (the
camera's upload included) to the frame synchronized on the device. A
reservoir drawn from the seed keeps ``check_frames`` answers of the window
with the instances the program's binning emitted for them, which the
reference renders and counts again once the window has closed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.counts import compositor_forward, point_front_end
from benchmark.harness import checks, scene as scene_mod
from benchmark.reference import points
from benchmark.reference.splat import SH_C0


def make_field(cfg: dict, seed: int, device) -> dict:
    """The configuration's Gaussians as leaves with the names of the
    program's ``PointGaussianParams``, drawn with one generator on
    ``device``."""
    gen = scene_mod.generator(seed, 1, device)
    f = cfg["field"]
    n = cfg["gaussians"]
    n_obj = int(round(n * f["object"]["share"]))
    n_shell = n - n_obj
    k = (cfg["sh_degree"] + 1) ** 2

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def directions(m):
        d = randn(m, 3)
        return d / torch.linalg.norm(d, dim=1, keepdim=True).clamp_min(1e-12)

    obj = f["object"]
    r_obj = obj["radius"] * rand(n_obj, 1) ** (1.0 / 3.0)
    lo, hi = f["shell"]["radius"]
    r_shell = lo * (hi / lo) ** rand(n_shell, 1)
    xyz = torch.cat([directions(n_obj) * r_obj, directions(n_shell) * r_shell])
    log_base = torch.cat([torch.full((n_obj, 1), obj["log_scale_mean"], device=device),
                          torch.log(f["shell"]["angular_scale"] * r_shell)])
    std = torch.cat([torch.full((n_obj, 1), obj["log_scale_std"], device=device),
                     torch.full((n_shell, 1), f["shell"]["log_scale_std"], device=device)])
    scaling = log_base + std * randn(n, 3)
    c_lo, c_hi = f["color"]
    color = c_lo + (c_hi - c_lo) * rand(n, 3)
    o_lo, o_hi = f["opacity"]
    opacity = o_lo + (o_hi - o_lo) * rand(n, 1)
    return {
        "xyz": xyz.contiguous(),
        "features_dc": ((color - 0.5) / SH_C0)[:, None, :],
        "features_rest": f["sh_rest_std"] * randn(n, k - 1, 3),
        "scaling": scaling,
        "rotation": randn(n, 4),
        "opacity": torch.log(opacity / (1.0 - opacity)),
    }


def camera(req: tuple, tan_x: float, tan_y: float, device) -> dict:
    """A camera at (azimuth, elevation, radius) looking at the origin (y up;
    azimuth 0 looks along +z), as row-vector world-view and full projection
    matrices (z mapped into [0, 1], znear 0.01, zfar 100)."""
    az, el, radius = req
    pos = np.array([radius * math.cos(el) * math.sin(az), radius * math.sin(el),
                    -radius * math.cos(el) * math.cos(az)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    w2c = np.eye(4)
    w2c[:3, :3] = np.stack([right, up, fwd])
    w2c[:3, 3] = -w2c[:3, :3] @ pos
    znear, zfar = 0.01, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tan_x, 1.0 / tan_y
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -zfar * znear / (zfar - znear)
    proj[3, 2] = 1.0
    wv = w2c.T

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"world_view": t(wv), "full_proj": t(wv @ proj.T), "center": t(pos)}


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, int(seed), device
        img = cfg["image"]
        self.width, self.height = img["width"], img["height"]
        self.tan_x = img["tan_half_fov_x"]
        self.tan_y = self.tan_x * self.height / self.width
        self.bg = tuple(float(c) for c in img["background"])
        self.tile = cfg["instance_tile"]

    def setup(self) -> None:
        from cloth_splatting_tpu_torch.models.point_gaussians import (
            PointGaussianParams,
            PointGaussianState,
        )
        from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd

        if self.cfg["raster_pack_order"] != "exact":
            raise ValueError("render_points packs in exact depth order only")
        program_tile = tiled_fwd.tile_size_for(self.width, self.height)
        if program_tile != self.tile:
            raise ValueError(f"the program bins on {program_tile} px tiles, the "
                             f"check counts on {self.tile} px")
        self.counts = tiled_fwd.COUNTS
        self.field = make_field(self.cfg, self.seed, self.dev)
        n = self.cfg["gaussians"]
        self.params = PointGaussianParams(**{k: v.clone() for k, v in self.field.items()})
        self.state = PointGaussianState(
            alive=torch.ones(n, dtype=torch.bool, device=self.dev),
            max_radii2d=torch.zeros(n, device=self.dev),
            grad_accum=torch.zeros(n, device=self.dev),
            denom=torch.zeros(n, device=self.dev))
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
        return (float(self.rng.uniform(*tr["azimuth"])),
                float(self.rng.uniform(*tr["elevation"])),
                float(self.rng.uniform(*tr["radius"])))

    def _serve(self, req: tuple) -> torch.Tensor:
        from cloth_splatting_tpu_torch.models.point_gaussians import render_points
        from cloth_splatting_tpu_torch.render import CameraArrays

        cam = camera(req, self.tan_x, self.tan_y, self.dev)
        arrays = CameraArrays(world_view=cam["world_view"], full_proj=cam["full_proj"],
                              camera_center=cam["center"],
                              time=torch.zeros((), device=self.dev))
        rgb, _, _ = render_points(self.params, self.state, arrays, self.width,
                                  self.height, self.tan_x, self.tan_y, self.bg,
                                  self.cfg["sh_degree"],
                                  max_radius=self.cfg["max_splat_radius"])
        return rgb

    def window(self, seconds: float) -> dict:
        k = self.tr["check_frames"]
        self.kept = []
        lat = []
        seen = 0
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            req = self._request()
            emitted = self.counts["instances"]
            a = time.perf_counter()
            rgb = self._serve(req)
            self._sync()
            lat.append((time.perf_counter() - a) * 1e3)
            answer = (req, rgb.clone(), self.counts["instances"] - emitted)
            # reservoir sampling of the answers to check
            if seen < k:
                self.kept.append(answer)
            else:
                j = int(self.kept_rng.integers(seen + 1))
                if j < k:
                    self.kept[j] = answer
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
        items, flops = [], 0.0
        for req in reqs:
            _, pairs, proj = self.reference_frame(req)
            item = {"pairs": pairs, "gaussians": int(proj["valid"].sum()),
                    "pixels": self.width * self.height}
            items.append(item)
            flops += compositor_forward.flops(item) + point_front_end.flops(
                self.cfg["gaussians"])
        return tr, {"raster_forward": items, "flops": flops}

    def release(self) -> None:
        self.params = self.state = None

    def reference_frame(self, req: tuple):
        """(rgb [3, H, W], live pairs, projected Gaussians) of the reference."""
        cam = camera(req, self.tan_x, self.tan_y, self.dev)
        bg = torch.tensor(self.bg, dtype=torch.float32, device=self.dev)
        return points.render(self.field, cam, self.width, self.height, self.tan_x,
                             self.tan_y, self.cfg["sh_degree"], bg)

    def control(self) -> dict:
        """The numbers of the reference in TF32 in the program's place."""
        with checks.tf32():
            kept = []
            for req, _, _ in self.kept:
                rgb, _, proj = self.reference_frame(req)
                kept.append((req, rgb, points.tile_pairs(proj, self.width, self.height,
                                                         self.tile)))
        self.kept = kept
        return self.check()

    def check(self) -> dict:
        worst_max = worst_mean = worst_gap = 0.0
        emitted, pairs = [], []
        for req, rgb, n_inst in self.kept:
            img, _, proj = self.reference_frame(req)
            d = (rgb - img).abs()
            worst_max = max(worst_max, float(d.max()))
            worst_mean = max(worst_mean, float(d.mean()))
            want = points.tile_pairs(proj, self.width, self.height, self.tile)
            worst_gap = max(worst_gap, abs(n_inst - want) / max(want, 1))
            emitted.append(n_inst)
            pairs.append(want)
        if not self.kept:
            worst_max = worst_mean = worst_gap = math.inf
        return {"frame_mean_abs": worst_mean, "instances_rel_gap": worst_gap,
                "_details": {"frame_max_abs": worst_max, "instances_emitted": emitted,
                             "reference_tile_pairs": pairs}}
