#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``cloth_splatting_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build every kernel of the port from ``cloth_splatting_tpu_torch/csrc``
     and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card: K1 on
     the packs of the 65k-Gaussian 800x800 serving scene for two orbit
     views, and on deep synthetic packs (thousands of instances per tile, so
     the transmittance exit fires) at both tile sizes;
  3. time K1, its plain version and the stages of one frame;
  4. serve frames of the scene at different views and times through the
     port's ``render`` with the launch counters set to 0 just before, and
     check that every kernel of the path was launched once per frame and
     that the frames are finite with nonzero coverage;
  5. check a small render against the O(N*P) oracle.

Prints a {"kernels": [...]} line and, last, {"ok": true, "device": ...}.
Exits non-zero and prints no result when CUDA is unavailable, when the port
package is missing, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 0
WIDTH = HEIGHT = 800
MESH_RES = 128           # grid_cloth_mesh(128, 128): 65,024 Gaussians
N_FRAMES = 8
FOV = 2.0 * math.atan(0.4)
BG = (1.0, 1.0, 1.0)
# K1 against its plain version: both walk the same chunks in the same order
# and stop at the same chunk, so they differ only by rounding (sequential
# products in K1, cumprod in the plain version); sound runs read at most
# 2.4e-6 in any channel. 1e-5 catches a splat that crosses its power cut or
# a chunk walked by one side only, each of which moves pixels by ~1e-4.
TOL_PLAIN = {"r": 1e-5, "g": 1e-5, "b": 1e-5, "depth": 1e-5, "alpha": 1e-5}
CHANNELS = ("r", "g", "b", "depth", "alpha")
# A render against the O(N*P) oracle, which composites each pixel on its own
# and has no tile-wide exit: the tolerances of tests/test_pallas_raster.py.
TOL_ORACLE = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# fp32 operations per instance-pixel pair in K1: every walked pair computes
# dx, dy and the quadratic form (11) and alpha (exp, scale, min: 3); a pair
# with nonzero alpha also does w = alpha T, five multiply-adds and T update (13).
OPS_PER_WALKED_PAIR = 14
OPS_PER_CONTRIBUTING_PAIR = 13


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare_k1(packed, width, height, tile_size, label: str):
    """(max abs difference of K1 and its plain version, walk statistics) on
    one pack; raises above TOL_PLAIN, on non-finite output, or on nonzero
    padding rows."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        raster_forward_tiles,
        raster_forward_tiles_plain,
        walk_stats,
    )

    out_k = raster_forward_tiles(packed, width, height, tile_size, BG)
    torch.cuda.synchronize()
    out_p, walk = raster_forward_tiles_plain(packed, width, height, tile_size, BG)
    if not bool(torch.isfinite(out_k).all()):
        raise RuntimeError(f"K1 {label}: non-finite output")
    if float(out_k[:, 5:8].abs().max()) != 0.0:
        raise RuntimeError(f"K1 {label}: padding rows 5..7 not zero")
    errs = {ch: float((out_k[:, i] - out_p[:, i]).abs().max())
            for i, ch in enumerate(CHANNELS)}
    stats = walk_stats(packed, walk, tile_size)
    log(f"K1 vs plain [{label}] max|diff| {json.dumps(errs)} walk {json.dumps(stats)}")
    bad = {ch: e for ch, e in errs.items() if not e <= TOL_PLAIN[ch]}
    if bad:
        raise RuntimeError(f"K1 {label}: disagrees with its plain version {bad}")
    return max(errs.values()), stats


def profile_frames(frame, cams) -> dict:
    """Device kernels of a few frames under torch.profiler: launches per
    frame, device busy share of the wall time, and the kernels that take
    most device time. Busy share is None when the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            frame(cam)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "kernels_per_frame": sum(e.count for e in kernels) / len(cams),
        "device_busy_share": busy_us / wall_us if busy_us > 0 else None,
        "device_ms_per_frame": busy_us / 1e3 / len(cams),
        "wall_ms_per_frame_profiled": wall_us / 1e3 / len(cams),
        "top_kernels_ms_per_frame": {
            e.key[:60]: e.self_device_time_total / 1e3 / len(cams) for e in top},
    }


def deep_proj(n: int, width: int, height: int, gen, device):
    """Synthetic projected Gaussians piled on the frame's centre: sigma ~8 px,
    radius 24, opacity 0.05..0.4, so central tiles hold thousands of
    instances and their transmittance falls below 1e-4 mid-walk."""
    import torch

    from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    centre = torch.tensor([width / 2.0, height / 2.0], device=device)
    xy = centre + (rand(n, 2) - 0.5) * torch.tensor([width / 2.0, height / 2.0],
                                                    device=device)
    conic = torch.tensor([1.0 / 64.0, 0.0, 1.0 / 64.0], device=device).repeat(n, 1)
    return ProjectedGaussians(
        xy=xy, depth=1.0 + 4.0 * rand(n), conic=conic,
        radius=torch.full((n,), 24.0, device=device), color=rand(n, 3),
        opacity=0.05 + 0.35 * rand(n),
        valid=torch.ones(n, dtype=torch.bool, device=device),
        power_cut=torch.full((n,), -4.5, device=device))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera, target_gaussians
    from cloth_splatting_tpu_torch.models.deform import init_residual_simulator
    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        raster_forward_tiles,
        raster_forward_tiles_plain,
        sorted_pack,
        tile_and_win,
        tiles_to_images,
    )
    from cloth_splatting_tpu_torch.render import camera_arrays, project_view, render

    t_start = time.time()
    dev = torch.device("cuda")

    # 1. build ---------------------------------------------------------------
    t0 = time.time()
    for name in kernels.SOURCES:
        text = kernels.build(name)
        if text is not None:
            log(f"nvcc {name}:\n{text.strip()}")
    log(f"build: {time.time() - t0:.1f} s")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # the serving scene (bench.py's 65k headline scene)
    tan = math.tan(FOV / 2.0)
    mesh = grid_cloth_mesh(MESH_RES, MESH_RES, size=1.4, device=dev)
    params, state = target_gaussians(mesh, 3, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    simulator = init_residual_simulator(rng, int(mesh.pos.shape[0]), device=dev)
    preds = mesh.pos[None].repeat(3, 1, 1)
    n_alive = int(state.alive.sum())
    log(f"scene: {n_alive} Gaussians (capacity {state.alive.numel()}), "
        f"{mesh.pos.shape[0]} vertices, {WIDTH}x{HEIGHT}")
    times = np.linspace(0.0, 1.0, N_FRAMES)
    cams = [camera_arrays(orbit_camera(v, N_FRAMES, FOV, WIDTH, HEIGHT,
                                       float(times[v])), device=dev)
            for v in range(N_FRAMES)]
    tile, win = tile_and_win(WIDTH, HEIGHT)   # as render's rasterizer picks
    tw, th = WIDTH // tile, HEIGHT // tile

    def project(cam):
        return project_view(cam, WIDTH, HEIGHT, tan, tan, params, state, mesh,
                            simulator, preds, 3)[0]

    # 2. kernels against their plain versions ----------------------------------
    k1_err = 0.0
    packs = []
    for v in (0, 3):
        packed = sorted_pack(project(cams[v]), tw, th, tile, win, order="fused")
        err, stats = compare_k1(packed, WIDTH, HEIGHT, tile, f"65k view {v}")
        k1_err = max(k1_err, err)
        packs.append((packed, stats))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for ts, size, n in ((32, 256, 20000), (16, 128, 6000)):
        proj = deep_proj(n, size, size, gen, dev)
        packed = sorted_pack(proj, size // ts, size // ts, ts,
                             3 if ts == 32 else 5, order="exact")
        err, stats = compare_k1(packed, size, size, ts, f"deep {size}px/{ts}px tiles")
        if stats["tiles_exited_early"] == 0:
            raise RuntimeError("deep pack: the transmittance exit never fired")
        k1_err = max(k1_err, err)

    # 3. times at the serving shapes ------------------------------------------
    packed, stats = packs[0]
    k1_ms = time_ms(lambda: raster_forward_tiles(packed, WIDTH, HEIGHT, tile, BG), 50)
    plain_ms = time_ms(
        lambda: raster_forward_tiles_plain(packed, WIDTH, HEIGHT, tile, BG), 3, 1)
    ops = (stats["pairs_walked"] * OPS_PER_WALKED_PAIR
           + stats["pairs_contributing"] * OPS_PER_CONTRIBUTING_PAIR)
    n_tiles = tw * th
    n_bytes = (stats["instances_walked"] * 11 * 4 + n_tiles * 2 * 4
               + n_tiles * 8 * tile * tile * 4)
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"K1 65k view 0: {k1_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({ops:.4g} fp32 ops -> {ops_ms:.4f} ms, "
        f"{n_bytes} B -> {bytes_ms:.4f} ms) [{gpu}]")
    proj0 = project(cams[0])
    stage_ms = {
        "project_view": time_ms(lambda: project(cams[0]), 10),
        "sorted_pack": time_ms(
            lambda: sorted_pack(proj0, tw, th, tile, win, order="fused"), 10),
        "k1": k1_ms,
        "tiles_to_images": time_ms(
            lambda: tiles_to_images(
                raster_forward_tiles(packed, WIDTH, HEIGHT, tile, BG),
                WIDTH, HEIGHT, tile), 10) - k1_ms,
    }
    log(f"stages of one frame (ms): {json.dumps(stage_ms)}")

    # 4. the main path: serve frames through render ----------------------------
    def frame(cam):
        return render(cam, WIDTH, HEIGHT, tan, tan, params, state, mesh,
                      simulator, preds, BG, 3, device=dev)

    frame(cams[0])                          # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    raster_forward_tiles.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    outs = [frame(c) for c in cams]
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / N_FRAMES
    k1_launches = raster_forward_tiles.launches
    frame_ms = start.elapsed_time(end) / N_FRAMES
    if k1_launches != N_FRAMES:
        raise RuntimeError(f"K1 launched {k1_launches} times for {N_FRAMES} frames")
    coverages = []
    for i, out in enumerate(outs):
        if tuple(out.rgb.shape) != (3, HEIGHT, WIDTH):
            raise RuntimeError(f"frame {i}: rgb shape {tuple(out.rgb.shape)}")
        for name in ("rgb", "depth", "alpha"):
            if not bool(torch.isfinite(getattr(out, name)).all()):
                raise RuntimeError(f"frame {i}: non-finite {name}")
        coverages.append(float(out.alpha.mean()))
    if min(coverages) <= 0.0:
        raise RuntimeError(f"a frame has no coverage: {coverages}")
    log(f"serving: {N_FRAMES} frames, {frame_ms:.4f} ms/frame (device), "
        f"{host_ms:.4f} ms/frame (host), K1 launches {k1_launches}, "
        f"alpha coverage {min(coverages):.4f}..{max(coverages):.4f} [{gpu}]")
    trace = profile_frames(frame, cams[:2])
    log(f"profile of 2 frames: {json.dumps(trace)}")
    print(json.dumps({"serving": {
        "frames": N_FRAMES, "gaussians": n_alive, "width": WIDTH,
        "height": HEIGHT, "ms_per_frame": frame_ms,
        "host_ms_per_frame": host_ms, "stage_ms": stage_ms,
        "device_busy_share": trace["device_busy_share"],
        "kernels_per_frame": trace["kernels_per_frame"], "gpu": gpu}}))

    # 5. a small render against the oracle --------------------------------------
    small_mesh = grid_cloth_mesh(8, 8, size=1.2, device=dev)
    s_params, s_state = target_gaussians(small_mesh, 3, seed=SEED, device=dev)
    s_cam = camera_arrays(orbit_camera(1, 8, FOV, 64, 64, 0.0), device=dev)
    out = render(s_cam, 64, 64, tan, tan, s_params, s_state, small_mesh, None,
                 None, BG, 3, device=dev)
    proj = project_view(s_cam, 64, 64, tan, tan, s_params, s_state, small_mesh,
                        None, None, 3)[0]
    ref = rasterize_reference(proj, 64, 64, torch.tensor(BG, device=dev))
    ref_err = {name: float((getattr(out, name) - r).abs().max())
               for name, r in zip(("rgb", "depth", "alpha"), ref)}
    log(f"64x64 render vs oracle max|diff| {json.dumps(ref_err)}")
    if any(not ref_err[k] <= TOL_ORACLE[k] for k in TOL_ORACLE):
        raise RuntimeError(f"render disagrees with the oracle: {ref_err}")
    if float(out.alpha.mean()) <= 0.0:
        raise RuntimeError("small render has no coverage")

    log(f"total: {time.time() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "K1 tiled_fwd compositor",
        "route": "cuda",
        "source": "cloth_splatting_tpu_torch/csrc/tiled_fwd.cu",
        "replaces": "cloth_splatting_tpu/ops/rasterize/pallas_tiled.py:305",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
