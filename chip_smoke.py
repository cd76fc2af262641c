#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``cloth_splatting_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build every kernel of the port from ``cloth_splatting_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together), read each kernel's
     registers, shared memory and spills from the build log, and print the
     card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card: K1 on
     the packs of the 65k-Gaussian 800x800 serving scene for two orbit
     views, and K2 and K3 on the pack of the 65k training scene; all three
     also on deep synthetic packs (thousands of instances per tile, so the
     transmittance exit fires) at both tile sizes; K3 and K4 also against a
     second launch of themselves, bit for bit; audit the footprint cull that
     all six kernels share on the serving packs of view 0 at 32 px and 16
     px (every chunk, a superset of K1's and K1-span's), on the training
     packs at 32 px and 16 px and on the deep packs (the chunks K2 started,
     which K1, K2, K3 and K4 walk): no pair it skips may be alive; then the
     span forms K1-span, K2-span and K4 (the rasterizer's
     ``tiles_per_program`` and ``span_cap`` options; all three are cluster
     launches, one CTA per tile) on the same packs at 32 px and 16 px tiles,
     with a window most programs fit and with a window of one chunk:
     K1-span and K2-span bit-identical to K1 and K2, K2's output
     bit-identical to K1-span's on the training packs, K4 also against K3;
     each span kernel bit-identical across ``span_cap`` 34, 41 and 96 at
     ``tpp`` 5 (the window decides only where a chunk is read from); and the
     three at ``tpp`` 11 over 121 tiles, clusters of one CTA, with
     ``span_cap`` 96 (clamped to what one CTA holds);
  3. time the six kernels, their plain versions and the stages of one frame;
  4. serve frames of the scene at different views and times through the
     port's ``render`` with the launch counters set to 0 just before, and
     check that K1 was launched once per frame and that the frames are
     finite with nonzero coverage; then the same frames with the span
     options on (K1-span), beside the default's time;
  5. check a small render, and the gradients of the differentiable
     rasterizer (K2 forward, K3 backward, under autograd; once more with
     the span options: K2-span, K4), against the O(N*P) oracle;
  6. train: a warm-up step and 5 timed steps of the port's ``Trainer`` on
     bench.py's 65k training configuration (3 cameras, 800x800) with the
     launch counters set to 0 just before, checking that K2 and K3 ran 3
     times per step, that the loss is finite and that the Gaussians and the
     simulator moved; then 5 steps with the span options on (K2-span, K4),
     beside the default's time;
  7. fit: a scene built in memory (the 65k mesh on an inextensible wave over
     5 times, 4 orbit views rendered at 800x800 by the port's serving path
     into uint8 banks) fitted for 300 iterations of ``fit_banks`` with
     density control, barycentric cleanup, one held-out evaluation and one
     checkpoint, checking the launch counts, that every event ran, finite
     values, a rising PSNR and that the checkpoint reloads equal;
  8. eval: the fit's final state, as the fit hands it to
     ``save_scene_checkpoint``, through ``eval.render_sets.render_frames``
     over the fit's 5 held-out frames and the 80-pose spherical video orbit
     at 800x800 (FPS per split; K1 launched 2 n + 1 times a split and no
     other kernel), the held-out frames scored in memory by
     ``eval.metrics.score_images`` (PSNR, SSIM, LPIPS on the ``fixture-v1``
     weights; the mean PSNR equal to the fit's own held-out evaluation
     within 1e-3 dB, a frame's LPIPS against itself 0), and the tracked
     trajectories (Gaussians, then vertices) written as ``all_trajs.npz``
     and scored against the fit's true vertex trajectory by
     ``eval.tracking.evaluate_tracking`` (finite MTE);
  9. bench: ``cloth_splatting_tpu_torch.bench.run`` at the root bench.py's
     default scales (65k FPS over 40 views on the serving scene; train
     iterations per second at 4k, 24k and 65k over 20 steps), checking its
     launch counts, and its JSON line;
 10. dense: the dense tier (``ops/rasterize/tiled.py``, plain PyTorch) on
     the card against the same function on the CPU at 128x128 with a k_cap
     that drops (values and gradients within 1e-5, the same dropped count
     and deepest tile); the 65k serving frames through
     ``render(backend="tiled")`` at k_cap 512 (launching none of the port's
     kernels; ms per frame, dropped instances, the k_cap at which nothing
     drops, PSNR against K1's frame); the fit's scene fitted through the
     tier from k_cap 64: ``grow_k_cap`` runs and the final evaluation drops
     nothing;
 11. parity: the parity arm at full width (800x800, 24 views, 8 times,
     ``mesh_res`` 24, noise 0) through ``parity_bench``'s in-memory form for
     300 iterations: finite numbers, the held-out PSNR above the initial
     state's, K1, K2 and K3 launched as often as the run asks; its JSON line.

Prints a {"serving": ...} line, a {"train": ...} line, a {"span_ab": ...}
line, a {"fit": ...} line, an {"eval": ...} line, the bench line, a
{"dense": ...} line, the parity line, a {"parity": ...} line, a
{"kernels": [...]} line and, last,
{"ok": true, "device": ...}. Exits non-zero and prints no
result when CUDA is unavailable, when the port package is missing, or when
any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# the field of view, background and training camera times of the benchmark
# entry, whose serving scene and training configuration this script drives
from cloth_splatting_tpu_torch.bench import BG, FOV, TRAIN_TIMES

SEED = 0
WIDTH = HEIGHT = 800
MESH_RES = 128           # grid_cloth_mesh(128, 128): 65,024 Gaussians
TRAIN_CAPACITY = 65536
N_FRAMES = 8
TRAIN_STEPS = 5
# the span options: 625 tiles of 32 px are 5^4, so tiles_per_program must be
# 5 there (4 or 8 would silently turn the span off); 2,500 tiles of 16 px
# take 4. The three span kernels run a program as a cluster of
# tiles_per_program CTAs, each holding ceil(span_cap / 5) chunks of the
# window at 32 px; span_cap 41 is the window every A/B of the span kernels
# has used (resolve_span clamps at 195 chunks, 160 for K4, at tpp 5).
SPAN_32 = (5, 41)
SPAN_16 = (4, 41)
SPAN_DEEP = (2, 41)
# each span kernel must give the same bits at these windows (tpp 5)
SPAN_CAPS = (34, 41, 96)
# 121 tiles of 32 px (352x352) in programs of 11: clusters of one CTA,
# which holds the whole window; span_cap 96 resolves to what one CTA holds
WIDE_SIZE, WIDE_SPAN = 352, (11, 96)
FIT_ITERATIONS = 300
FIT_TIMES = 5
FIT_PROGRESS_EVERY = 50
FIT_VIEWS = 4
FIT_SCHEDULE = dict(iterations=FIT_ITERATIONS, densify_from_iter=100,
                    densification_interval=50, pruning_from_iter=100,
                    pruning_interval=50, opacity_reset_interval=120,
                    bary_cleanup=100)
# The last opacity reset (iteration 240) leaves 60 iterations before the
# held-out evaluation at FIT_ITERATIONS: evaluated right after a reset, every
# opacity is at its floor and the reading says nothing about the fit.
# the eval phase: the video split's spherical orbit (the JAX package's
# default video cameras) and the limit on the held-out PSNR against the fit's
# own evaluation of the same frames (same backend, float images: only the
# mean's float rounding differs)
VIDEO_POSES = 80
TOL_EVAL_PSNR_DB = 1e-3
# the bench phase: a warm-up frame and 40 timed views; a warm-up step and 20
# timed steps of 3 cameras at each of the three training scales
BENCH_K1 = 1 + 40
BENCH_K2_K3 = 3 * 3 * (1 + 20)
# the dense phase: the dense tier (plain PyTorch, the JAX package's XLA tier)
# on the card against the same function on the CPU at 128x128 with 2,116
# Gaussians and a k_cap that drops instances: the two differ only in the
# order of float32 sums; the 65k serving scene's frames at the tier's default
# k_cap; a short fit through the tier from a k_cap that overflows
DENSE_SIZE, DENSE_RES, DENSE_SMALL_CAP = 128, 24, (16, 8)
TOL_DENSE = 1e-5
DENSE_K_CAP = 512
DENSE_FRAMES = 3
DENSE_FIT_ITERATIONS = 12
DENSE_FIT_K_CAP = 64
# the parity phase: the arm parity_iso_zeronoise_ema (scripts/hwq_r05d.json)
# at full width through parity_bench --in_memory, its depth cut 25x: 300 of
# 7,500 iterations. The train command line runs a config's coarse stage as
# the static stage (coarse_iterations, 3,000 of the arm's 7,500: --static sets
# static_reconst_iteration, which that mapping replaces), so the cut scales
# it to 120.
PARITY_ITERATIONS, PARITY_STATIC, PARITY_COARSE = 300, 60, 120
PARITY_ARGV = ["--in_memory", "--wave", "isometric", "--n_views", "24",
               "--prediction_noise", "0", "--iterations", str(PARITY_ITERATIONS),
               "--static", str(PARITY_STATIC), "--train_args",
               "--time_sample balanced --lr_tail_start 0.75 --param_ema 0.995 "
               f"--coarse_iterations {PARITY_COARSE}", "--device", "cuda"]
# K1 and K2 against their plain versions: both walk the same chunks in the
# same order and stop at the same chunk, so they differ only by rounding
# (sequential products in the kernels, cumprod in the plain versions); sound
# K1 runs read at most 2.4e-6 in any channel. 1e-5 catches a splat that
# crosses its power cut or a chunk walked by one side only, each of which
# moves pixels by ~1e-4. K2's saved boundaries are held to the same limit.
TOL_PLAIN = 1e-5
CHANNELS = ("r", "g", "b", "depth", "alpha")
# K3 against its plain version, per gradient field, relative to the field's
# largest magnitude. Both use K2's boundaries and the same classification;
# they differ in rounding (sequential T and prefix in K3, cumprod/cumsum in
# the plain version; per-thread, warp-shuffle and cross-warp sums against
# torch's sums over pixels), and the occlusion term (K - S_i) / (1 - alpha)
# divides a difference of sums by 1 - alpha >= 0.01. Sound runs read at
# most 1.0e-6 (colour, deep 256 px pack of 32 px tiles); the limit is 3x
# that. A pair classified differently, or a clamp gate missed, moves a field
# by 1e-4 of its largest magnitude or more.
TOL_K3 = 3e-6
# K4 against K3 on the same inputs. They differ in where the occlusion
# suffix S_i comes from: K3 subtracts a running prefix from the closed-form
# U_tot, K4 adds the chunk's remainder to a carry of the later chunks, each a
# float32 sum of up to thousands of terms taken in another order, and the
# difference is divided by 1 - alpha >= 0.01. The JAX package's own tests hold
# its two sweeps to each other at this limit.
TOL_K4_K3 = 1e-4
GRAD_FIELDS = {"xy": slice(0, 2), "conic": slice(2, 5), "color": slice(5, 8),
               "opacity": slice(8, 9), "depth": slice(9, 10)}
# A render, and its gradients, against the O(N*P) oracle, which composites
# each pixel on its own and has no tile-wide exit: the tolerances of
# tests/test_pallas_raster.py (images 3e-4 / 3e-3, gradients 2e-4 times the
# field's largest magnitude).
TOL_ORACLE = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}
TOL_ORACLE_GRAD = 2e-4
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# fp32 operations of the function per contributing instance-pixel pair (one
# the classification finds alive). Its classification is dx, dy and the
# quadratic form (11) and alpha (exp, scale, min: 3). It then does, in K1
# and K2, w = alpha T, five multiply-adds and the T update (13); in K3,
# w, u = g . c (7), the prefix (2), four colour and depth sums (8),
# dL/dalpha (7), dpow (1), six moment sums (14) and the T update (2): 42.
# A pair the function finds dead adds nothing to any output: classifying it
# is a kernel's way of finding its live pairs and shows in its time, not in
# its bound (K3 now skips most of them).
OPS_PER_WALKED_PAIR = 14
# K4 computes K3's function on the same pairs; only the occlusion suffix
# differs, S_i = (chunk_total - cum_i) + carry against K3's U_tot - prefix,
# one addition more per contributing pair (43). That K4 walks each chunk
# twice to know chunk_total first is this kernel's way, not the function's:
# the second walk shows in its time, not in its bound.
OPS_PER_CONTRIBUTING_PAIR = {"K1": 13, "K2": 13, "K3": 42, "K4": 43}

def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# each kernel's entry function at 32 px tiles (PPT = 4), the main path's
KERNEL_ENTRIES = {"K1": "tiled_fwd_kernel<4>", "K1-span": "tiled_fwd_span_kernel<4>",
                  "K2": "tiled_fwd_train_kernel<4>",
                  "K2-span": "tiled_fwd_train_span_kernel<4>",
                  "K3": "tiled_bwd_kernel<4>", "K4": "tiled_bwd_reverse_kernel<4>"}


def ptxas_usage(build_log: str) -> dict:
    """Registers, static shared memory and spills of each entry function,
    from an ``nvcc -Xptxas -v`` log, keyed as ``name<PPT>``."""
    import re

    usage, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*?([a-z_]+_kernel)ILi(\d+)E", line)
        if m:
            entry = usage.setdefault(f"{m.group(1)}<{m.group(2)}>", {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            entry["smem_bytes"] = int(m.group(1))
    return usage


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


def kernel_alone_ms(fn, kernel: str, iters: int = 20,
                    per_call: int = 1) -> tuple[float, int]:
    """(mean device time of one launch of ``kernel``, a KERNEL_ENTRIES key,
    over ``iters`` calls of ``fn``, each launching it ``per_call`` times;
    the launch records it is the mean of), from torch.profiler's kernel
    records: the kernel alone, without its wrapper's small kernels and host
    time. The profiler can drop records in a process that profiles many
    times: it profiles again, up to three times, until it keeps a record of
    every launch, takes the session that kept the most, and raises when that
    is fewer than half."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    entry = KERNEL_ENTRIES[kernel]
    launches = iters * per_call
    fn()
    torch.cuda.synchronize()
    count, total_us = 0, 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and entry in e.key]
        seen = sum(e.count for e in hits)
        if seen > launches:
            raise RuntimeError(f"profiler saw {seen} launches of {entry} in "
                               f"{iters} calls of {per_call}")
        if seen > count:
            count, total_us = seen, sum(e.self_device_time_total for e in hits)
        if count == launches:
            break
    if count < launches // 2:
        raise RuntimeError(f"profiler saw {count} launches of {entry} in {iters} "
                           f"calls of {per_call}")
    return total_us / 1e3 / count, count


def function_bytes(kernel: str, stats: dict, n_tiles: int, p: int) -> int:
    """The bytes ``kernel``'s function moves on a pack, each input read once
    and each output written once, from the plain walk's statistics: the 11
    rows of every instance walked (the live slots of the chunks the walk
    entered; for K3 and K4, the chunks K2 started), the tiles' ints (starts,
    counts and, but for K1, the boundary offsets) and the per-pixel data.
    K1 and K2 write r, g, b, depth and alpha (the output's three padding
    rows are its layout's), K2 also one boundary row of p floats per laid
    chunk. K3 and K4 read the started chunks' boundaries and the channels of
    the grad image they use (K3 seven, g_r g_g g_b g_dep g_acc acc U_tot; K4
    six, without U_tot) and write ten gradient rows per instance walked: the
    other slots of grads [16, B_pad] are zeros that the wrapper allocates."""
    walked = stats["instances_walked"] * 11 + n_tiles * (2 if kernel == "K1" else 3)
    if kernel in ("K1", "K2"):
        pixels = n_tiles * p * 5
        if kernel == "K2":
            pixels += stats["chunks_laid"] * p
        return 4 * (walked + pixels)
    grad_channels = {"K3": 7, "K4": 6}[kernel]
    return 4 * (walked + stats["instances_walked"] * 10
                + n_tiles * p * grad_channels + stats["chunks_started"] * p)


def bound(stats: dict, kernel: str, n_tiles: int, p: int) -> dict:
    """The least time the card could take for ``kernel``'s function on a
    pack: the larger of its fp32 operations (on the pairs this pack's data
    finds alive) at the fp32 peak and its bytes (``function_bytes``) at the
    memory rate."""
    ops = stats["pairs_contributing"] * (OPS_PER_WALKED_PAIR
                                         + OPS_PER_CONTRIBUTING_PAIR[kernel])
    n_bytes = function_bytes(kernel, stats, n_tiles, p)
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_HBM_BYTES * 1e3
    return {"ops": ops, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def span_label(span) -> str:
    return "" if span is None else f" tpp={span[0]} span_cap={span[1]}"


def span_counts(packed, n_tiles: int, span, kernel: str) -> dict:
    """How many programs of a span kernel take the span branch and how many
    the overflow walk, with the options as ``resolve_span`` resolves them,
    the cluster size and a CTA's window slots."""
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        resolve_span,
        span_cluster_size,
        span_programs,
        window_slots,
    )

    tpp, cap = resolve_span(n_tiles, packed.rows16.shape[1], span[0], span[1],
                            kernel)
    if not cap:
        raise RuntimeError(f"span options {span} resolve to no span "
                           f"({n_tiles} tiles)")
    fits = span_programs(packed, tpp, cap)[1]
    c = span_cluster_size(tpp)
    return {"tpp": tpp, "span_cap": cap, "span": int(fits.sum()),
            "overflow": int((~fits).sum()), "cluster_size": c,
            "window_slots_per_cta": window_slots(cap, c)}


def compare_k1(packed, width, height, tile_size, label: str, span=None):
    """(max abs difference of K1 and its plain version, walk statistics) on
    one pack; raises above TOL_PLAIN, on non-finite output, or on nonzero
    padding rows. With ``span`` = (tiles_per_program, span_cap) it is
    K1-span against its plain version, the statistics carry the programs'
    branch counts and whether the output is bit-identical to K1's."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        raster_forward_tiles,
        raster_forward_tiles_plain,
        walk_stats,
    )

    name = "K1" if span is None else "K1-span"
    label += span_label(span)
    opts = () if span is None else tuple(span)
    n_before = raster_forward_tiles.span_launches
    out_k = raster_forward_tiles(packed, width, height, tile_size, BG, *opts)
    torch.cuda.synchronize()
    out_p, walk = raster_forward_tiles_plain(packed, width, height, tile_size,
                                             BG, *opts)
    if not bool(torch.isfinite(out_k).all()):
        raise RuntimeError(f"{name} {label}: non-finite output")
    if float(out_k[:, 5:8].abs().max()) != 0.0:
        raise RuntimeError(f"{name} {label}: padding rows 5..7 not zero")
    errs = {ch: float((out_k[:, i] - out_p[:, i]).abs().max())
            for i, ch in enumerate(CHANNELS)}
    stats = walk_stats(packed, walk, tile_size)
    if span is not None:
        if raster_forward_tiles.span_launches != n_before + 1:
            raise RuntimeError(f"{name} {label}: the span kernel was not launched")
        stats["programs"] = span_counts(packed, out_k.shape[0], span, "fwd")
        stats["bit_identical_to_k1"] = bool(torch.equal(
            out_k, raster_forward_tiles(packed, width, height, tile_size, BG)))
    log(f"{name} vs plain [{label}] max|diff| {json.dumps(errs)} walk "
        f"{json.dumps(stats)}")
    bad = {ch: e for ch, e in errs.items() if not e <= TOL_PLAIN}
    if bad:
        raise RuntimeError(f"{name} {label}: disagrees with its plain version {bad}")
    return max(errs.values()), stats


def compare_k2(packed, width, height, tile_size, label: str, span=None):
    """(max abs difference of K2 and its plain version over the output and
    the saved boundaries, walk statistics, K2's out and tbounds); raises
    above TOL_PLAIN, on non-finite output, or when the two started
    different chunks. With ``span`` it is K2-span, and its boundaries must
    also equal K2's bit for bit."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        chunk_span,
        walk_stats,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        raster_forward_train_plain,
    )

    name = "K2" if span is None else "K2-span"
    label += span_label(span)
    opts = () if span is None else tuple(span)
    n_before = raster_forward_train.span_launches
    out_k, tb_k = raster_forward_train(packed, width, height, tile_size, BG, *opts)
    torch.cuda.synchronize()
    out_p, tb_p, walk = raster_forward_train_plain(packed, width, height,
                                                   tile_size, BG, *opts)
    # rows past the tiles' chunk counts are laid out by chunk_layout's bound
    # but never written by K2 and never read by K3
    n_laid = int(chunk_span(packed)[3].sum())
    if not bool(torch.isfinite(out_k).all()) \
            or not bool(torch.isfinite(tb_k[:n_laid]).all()):
        raise RuntimeError(f"{name} {label}: non-finite output")
    started_k = tb_k[:n_laid].amax(dim=1) > 0.0
    started_p = tb_p[:n_laid].amax(dim=1) > 0.0
    if not torch.equal(started_k, started_p):
        raise RuntimeError(
            f"{name} {label}: started {int(started_k.sum())} chunks, the plain "
            f"version {int(started_p.sum())}, not the same set")
    errs = {ch: float((out_k[:, i] - out_p[:, i]).abs().max())
            for i, ch in enumerate(CHANNELS)}
    errs["tbounds"] = float((tb_k[:n_laid] - tb_p[:n_laid]).abs().max())
    stats = walk_stats(packed, walk, tile_size)
    stats["chunks_laid"] = n_laid
    stats["chunks_started"] = int(started_k.sum())
    if span is not None:
        if raster_forward_train.span_launches != n_before + 1:
            raise RuntimeError(f"{name} {label}: the span kernel was not launched")
        stats["programs"] = span_counts(packed, out_k.shape[0], span, "fwd_train")
        out_d, tb_d = raster_forward_train(packed, width, height, tile_size, BG)
        stats["bit_identical_to_k2"] = bool(
            torch.equal(out_k, out_d) and torch.equal(tb_k[:n_laid], tb_d[:n_laid]))
    log(f"{name} vs plain [{label}] max|diff| {json.dumps(errs)} walk "
        f"{json.dumps(stats)}")
    bad = {ch: e for ch, e in errs.items() if not e <= TOL_PLAIN}
    if bad:
        raise RuntimeError(f"{name} {label}: disagrees with its plain version {bad}")
    return max(errs.values()), stats, out_k, tb_k


def cotangent_tiles(out_t, width, height, tile_size, gen):
    """K3's input gimg [T, p, 8] for the loss sum of squared differences
    between the forward's (rgb, depth, alpha) and a seeded random target."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import tiles_to_images
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        grad_image,
        images_to_tiles,
    )

    rgb, dep, acc = tiles_to_images(out_t, width, height, tile_size)
    dev = out_t.device

    def target(c, lo, hi):
        return lo + (hi - lo) * torch.rand(c, height, width, generator=gen,
                                           device=dev)

    g_rgb = 2.0 * (rgb - target(3, 0.0, 1.0)) / rgb.numel()
    g_dep = 2.0 * (dep - target(1, 2.0, 4.0)) / dep.numel()
    g_acc = 2.0 * (acc - target(1, 0.0, 1.0)) / acc.numel()
    return images_to_tiles(grad_image(rgb, dep, acc, g_rgb, g_dep, g_acc, BG),
                           width, height, tile_size)


def field_errors(g, ref, name: str, label: str):
    """(largest abs difference, per-field difference relative to the
    reference field's largest magnitude) of two [16, B_pad] gradients."""
    rel, abs_err = {}, 0.0
    for field, rows in GRAD_FIELDS.items():
        diff = float((g[rows] - ref[rows]).abs().max())
        scale = float(ref[rows].abs().max())
        if scale == 0.0:
            raise RuntimeError(f"{name} {label}: reference {field} gradient is "
                               f"all zero")
        rel[field] = diff / scale
        abs_err = max(abs_err, diff)
    return abs_err, rel


def compare_k3(packed, gimg_t, tb, width, height, tile_size, label: str,
               span=None):
    """(max abs difference of K3 and its plain version, per-field readings
    relative to the field's largest magnitude) on one pack, both fed K2's
    boundaries; raises above TOL_K3, on non-finite grads, on nonzero rows
    10..15, or when a second launch on the same inputs does not give the
    same bits (no atomics, sums in a fixed order). With ``span`` it is K4
    against its plain version, and K4 is also held to K3 at TOL_K4_K3 (a
    third value: those readings)."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        run_backward,
        run_backward_plain,
    )

    name = "K3" if span is None else "K4"
    label += span_label(span)
    opts = () if span is None else tuple(span)
    n_before = run_backward.reverse_launches
    g_k = run_backward(packed, gimg_t, tb, width, height, tile_size, BG, *opts)
    g_again = run_backward(packed, gimg_t, tb, width, height, tile_size, BG, *opts)
    torch.cuda.synchronize()
    if not torch.equal(g_k, g_again):
        raise RuntimeError(f"{name} {label}: two launches on the same inputs "
                           f"differ (largest {float((g_k - g_again).abs().max()):.3g})")
    g_p = run_backward_plain(packed, gimg_t, tb, width, height, tile_size, BG,
                             *opts)
    if not bool(torch.isfinite(g_k).all()):
        raise RuntimeError(f"{name} {label}: non-finite gradients")
    if float(g_k[10:].abs().max()) != 0.0:
        raise RuntimeError(f"{name} {label}: rows 10..15 not zero")
    abs_err, rel = field_errors(g_k, g_p, name, label)
    log(f"{name} vs plain [{label}] max|diff|/max|plain| {json.dumps(rel)} "
        f"max|diff| {abs_err:.4g}; a second launch bit-identical")
    bad = {k: e for k, e in rel.items() if not e <= TOL_K3}
    if bad:
        raise RuntimeError(f"{name} {label}: disagrees with its plain version {bad}")
    if span is None:
        return abs_err, rel
    if run_backward.reverse_launches != n_before + 2:
        raise RuntimeError(f"K4 {label}: the reverse kernel was not launched")
    n_tiles = (width // tile_size) * (height // tile_size)
    g_3 = run_backward(packed, gimg_t, tb, width, height, tile_size, BG)
    _, rel_k3 = field_errors(g_k, g_3, "K4 vs K3", label)
    log(f"K4 vs K3 [{label}] max|diff|/max|K3| {json.dumps(rel_k3)} programs "
        f"{json.dumps(span_counts(packed, n_tiles, span, 'bwd'))}")
    bad = {k: e for k, e in rel_k3.items() if not e <= TOL_K4_K3}
    if bad:
        raise RuntimeError(f"K4 {label}: disagrees with K3 {bad}")
    return abs_err, rel, rel_k3


def cull_phase(cases) -> dict:
    """The footprint cull of all six kernels on the card, from the plain box
    and the plain classification (``tiled_fwd.cull_audit``), for each
    (label, kernels, pack, width, height, tile size, K2's boundaries or
    None) of ``cases``: over the chunks K2 started (which K1, K2, K3, the
    span forms and K4 walk, each pass of K4 the same pairs) or, with None,
    over every chunk (a superset of K1's and K1-span's). Raises if a pair the cull
    skips is alive. Returns the counts, with the share of the walked pairs
    the warps classify, by label."""
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import cull_audit

    out = {}
    for label, kernels, packed, width, height, ts, tb in cases:
        a = cull_audit(packed, width, height, ts, tb)
        a["share_classified"] = a["pairs_classified"] / a["pairs_walked"]
        a["chunks"] = "every chunk" if tb is None else "the chunks K2 started"
        log(f"{kernels} cull audit [{label}, {a['chunks']}]: pairs classified "
            f"{a['pairs_classified']} of {a['pairs_walked']} walked "
            f"({a['share_classified']:.4f}); instances the busiest warp of "
            f"each chunk walks {a['slowest_warp_hits']} (the warps' mean "
            f"{a['pairs_classified'] / (ts * ts):.0f}), heaviest tile "
            f"{a['heaviest_tile_hits']}; K3's and K4's (warp, instance) reductions "
            f"{a['reductions']}; culled pairs alive {a['culled_pairs_alive']}")
        if a["culled_pairs_alive"]:
            raise RuntimeError(f"{kernels} cull audit [{label}]: "
                               f"{a['culled_pairs_alive']} culled pairs are alive")
        out[label] = a
    return out


def blocks_per_sm() -> dict:
    """Blocks of K1 and K2 (32 px tiles) that one SM holds at once, from the
    CUDA runtime's occupancy calculator."""
    import ctypes

    from cloth_splatting_tpu_torch import kernels

    out = {}
    for key, lib, fn in (("K1", "tiled_fwd", "tiled_fwd_blocks_per_sm"),
                         ("K2", "tiled_train", "tiled_fwd_train_blocks_per_sm")):
        query = getattr(kernels.load(lib), fn)
        query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
        out[key] = query(32)
        if out[key] < 1:
            raise RuntimeError(f"{fn}(32) returned {out[key]}")
    return out


# K1-span, K2-span and K4 are cluster launches: at 32 px tiles, tpp 5 and
# span_cap 41, K1-span and K2-span must hold 3 blocks an SM and K4 2
CLUSTER_BLOCKS_MIN = {"K1-span": 3, "K2-span": 3, "K4": 2}
# (resolve_span's name, library, occupancy query and its leading arguments)
# of each span kernel
SPAN_KERNELS = {
    "K1-span": ("fwd", "tiled_fwd", "tiled_fwd_span_occupancy", ()),
    "K2-span": ("fwd_train", "tiled_train", "tiled_train_span_occupancy", (0,)),
    "K4": ("bwd", "tiled_train", "tiled_train_span_occupancy", (1,)),
}


def span_occupancy(key: str, tile_size: int, n_tiles: int, span) -> list:
    """[blocks an SM, clusters resident, cluster size, static shared memory]
    of span kernel ``key`` launched on ``n_tiles`` tiles with ``span``, from
    the kernel's occupancy query."""
    import ctypes

    from cloth_splatting_tpu_torch import kernels

    _, lib, fn, lead = SPAN_KERNELS[key]
    query = getattr(kernels.load(lib), fn)
    query.argtypes = [ctypes.c_int] * (len(lead) + 4) + [ctypes.c_void_p]
    query.restype = ctypes.c_int
    res = (ctypes.c_int * 4)()
    err = query(*lead, tile_size, n_tiles, span[0], span[1], res)
    if err != 0:
        raise RuntimeError(f"{fn}({key}, {tile_size} px, {span}): CUDA error {err}")
    return list(res)


def cluster_occupancy(n_tiles: int, n_sms: int) -> dict:
    """What the occupancy calculator says of the cluster launches of
    K1-span, K2-span and K4 at 32 px tiles with SPAN_32: blocks an SM,
    clusters resident on the card at once
    (cudaOccupancyMaxActiveClusters), the cluster size, the CTAs those
    clusters hold an SM, the window's chunk slots a CTA and the kernel's
    static shared memory. Raises below CLUSTER_BLOCKS_MIN, and when a
    kernel's static shared memory at either tile size is not the
    ``tiled_fwd.SPAN_STATIC_BYTES`` that resolve_span clamps by."""
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        SPAN_STATIC_BYTES,
        window_slots,
    )

    out = {}
    for key, (kernel, *_) in SPAN_KERNELS.items():
        blocks, clusters, size, static = span_occupancy(key, 32, n_tiles, SPAN_32)
        out[key] = {"span_cap": SPAN_32[1], "blocks_per_sm": blocks,
                    "max_active_clusters": clusters, "cluster_size": size,
                    "cluster_ctas_per_sm": clusters * size / n_sms,
                    "window_slots_per_cta": window_slots(SPAN_32[1], size),
                    "static_smem_bytes": static}
        need = CLUSTER_BLOCKS_MIN[key]
        if blocks < need or clusters < 1:
            raise RuntimeError(f"{key}: {out[key]}, fewer than {need} blocks an SM")
        statics = {ts: span_occupancy(key, ts, n_tiles, SPAN_32)[3] for ts in (32, 16)}
        if set(statics.values()) != {SPAN_STATIC_BYTES[kernel]}:
            raise RuntimeError(f"{key}: static shared memory {statics}, "
                               f"SPAN_STATIC_BYTES[{kernel!r}] is "
                               f"{SPAN_STATIC_BYTES[kernel]}")
    return out


def profile_calls(fn, args) -> dict:
    """Device kernels of ``fn(a)`` for each ``a`` under torch.profiler:
    launches per call, device busy share of the wall time, and the kernels
    that take most device time. Busy share is None when the profiler saw
    no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in args:
            fn(a)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    n = len(args)
    return {
        "kernels_per_call": sum(e.count for e in kernels) / n,
        "device_busy_share": busy_us / wall_us if busy_us > 0 else None,
        "device_ms_per_call": busy_us / 1e3 / n,
        "wall_ms_per_call_profiled": wall_us / 1e3 / n,
        "top_kernels_ms_per_call": {
            e.key[:60]: e.self_device_time_total / 1e3 / n for e in top},
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


def oracle_grads(proj, width, height, gen, span=None):
    """Gradients of one loss through ``rasterize_tiled_train`` (K2, K3; with
    ``span`` = (tiles_per_program, span_cap): K2-span, K4) and through the
    oracle under autograd, with respect to the projected fields; raises
    above TOL_ORACLE_GRAD times each field's largest magnitude. Returns the
    readings."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        rasterize_tiled_train,
        run_backward,
    )

    names = ("xy", "conic", "color", "opacity", "depth")
    tgt = torch.rand(3, height, width, generator=gen, device=proj.xy.device)
    tpp, cap = span if span is not None else (None, None)
    k4_before = run_backward.reverse_launches

    def grads(raster):
        leaves = [getattr(proj, k).detach().clone().requires_grad_() for k in names]
        rgb, dep, acc = raster(proj._replace(**dict(zip(names, leaves))))
        loss = ((rgb - tgt) ** 2).mean() + 0.1 * dep.mean() + 0.05 * acc.mean()
        return loss, torch.autograd.grad(loss, leaves)

    loss_k, g_k = grads(lambda q: rasterize_tiled_train(
        q, width, height, BG, tiles_per_program=tpp, span_cap=cap))
    if span is not None and run_backward.reverse_launches != k4_before + 1:
        raise RuntimeError(f"autograd path with span {span}: K4 was not launched")
    loss_o, g_o = grads(lambda q: rasterize_reference(
        q, width, height, torch.tensor(BG, device=proj.xy.device)))
    rel = {}
    for name, a, o in zip(names, g_k, g_o):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"autograd path: non-finite {name} gradient")
        scale = float(o.abs().max())
        if scale == 0.0:
            raise RuntimeError(f"autograd path: oracle {name} gradient is zero")
        rel[name] = float((a - o).abs().max()) / scale
    rel["loss"] = abs(float(loss_k.detach()) - float(loss_o.detach())) / abs(float(loss_o.detach()))
    log(f"{width}x{height} autograd grads{span_label(span)} vs oracle "
        f"max|diff|/max|oracle| {json.dumps(rel)}")
    bad = {k: e for k, e in rel.items() if not e <= TOL_ORACLE_GRAD}
    if bad:
        raise RuntimeError(f"autograd path disagrees with the oracle: {bad}")
    return rel


def span_phase(cases, gen):
    """K1-span, K2-span and K4 against their plain versions (and K4 against
    K3) on every (label, pack, width, height, tile size, spans) of
    ``cases``; on the training packs also K2's output against K1-span's
    (both run K1's walk). Returns the largest errors and the programs'
    branch counts summed over the cases; raises if either branch was never
    taken, if K1-span or K2-span is not bit-identical to K1 or K2 on any
    case, or if K2's output is not K1-span's on a training pack."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import raster_forward_tiles
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
    )

    err = {"K1-span": 0.0, "K2-span": 0.0, "K4": 0.0, "K4_rel": 0.0,
           "K4_vs_K3_rel": 0.0}
    programs = {k: {"span": 0, "overflow": 0} for k in ("K1-span", "K2-span", "K4")}
    identical = {"K1-span": True, "K2-span": True, "K2 vs K1-span": True}

    def count(kernel, c):
        programs[kernel]["span"] += c["span"]
        programs[kernel]["overflow"] += c["overflow"]

    for label, packed, width, height, ts, spans in cases:
        n_tiles = (width // ts) * (height // ts)
        # K2 and K1-span run the same walk on every tile
        out_k2 = (raster_forward_train(packed, width, height, ts, BG)[0]
                  if label.startswith("65k train") else None)
        for span in spans:
            e, stats = compare_k1(packed, width, height, ts, label, span)
            err["K1-span"] = max(err["K1-span"], e)
            count("K1-span", stats["programs"])
            identical["K1-span"] &= stats["bit_identical_to_k1"]
            if out_k2 is not None:
                same = bool(torch.equal(out_k2, raster_forward_tiles(
                    packed, width, height, ts, BG, *span)))
                log(f"K2 vs K1-span [{label}{span_label(span)}]: out "
                    f"bit-identical {same}")
                identical["K2 vs K1-span"] &= same
            e, stats, out_k, tb_k = compare_k2(packed, width, height, ts, label, span)
            err["K2-span"] = max(err["K2-span"], e)
            count("K2-span", stats["programs"])
            identical["K2-span"] &= stats["bit_identical_to_k2"]
            gimg = cotangent_tiles(out_k, width, height, ts, gen)
            e, rel, rel_k3 = compare_k3(packed, gimg, tb_k, width, height, ts,
                                        label, span)
            err["K4"] = max(err["K4"], e)
            err["K4_rel"] = max(err["K4_rel"], *rel.values())
            err["K4_vs_K3_rel"] = max(err["K4_vs_K3_rel"], *rel_k3.values())
            count("K4", span_counts(packed, n_tiles, span, "bwd"))
    log(f"span: programs on the span branch / on the overflow walk "
        f"{json.dumps(programs)}; bit-identical to the default kernels "
        f"{json.dumps(identical)}; largest K4 vs K3 reading "
        f"{err['K4_vs_K3_rel']:.4g} (limit {TOL_K4_K3})")
    for kernel, c in programs.items():
        if c["span"] == 0 or c["overflow"] == 0:
            raise RuntimeError(f"span: {kernel} never took one of its branches {c}")
    # the span forms and K2 run the same walk through the same float
    # operations, each pixel's in the same order, so they owe the same bits
    if not all(identical.values()):
        raise RuntimeError(f"span: a span form is not bit-identical to its "
                           f"default kernel, or K2 to K1-span {identical}")
    return err, programs, identical


def span_cap_phase(serve, train, gimg, tb, tile: int) -> dict:
    """Each span kernel at tpp 5 with every window of SPAN_CAPS on the 65k
    packs (K1-span on the serving pack of view 0, K2-span and K4 on the
    training pack of camera 0 with its cotangent and K2's boundaries):
    bit-identical across the windows, which decide only where a chunk is
    read from, and held to its plain version at the largest (K1-span and
    K2-span also bit-identical to K1 and K2 there). Raises on any
    difference; returns the readings."""
    import torch

    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        chunk_span,
        raster_forward_tiles,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        run_backward,
    )

    n_tiles = (WIDTH // tile) * (HEIGHT // tile)
    n_laid = int(chunk_span(train)[3].sum())
    outs, programs = {}, {}
    for cap in SPAN_CAPS:
        span = (SPAN_32[0], cap)
        out, tb_s = raster_forward_train(train, WIDTH, HEIGHT, tile, BG, *span)
        outs[cap] = {
            "K1-span": (raster_forward_tiles(serve, WIDTH, HEIGHT, tile, BG, *span),),
            "K2-span": (out, tb_s[:n_laid]),
            "K4": (run_backward(train, gimg, tb, WIDTH, HEIGHT, tile, BG, *span),)}
        programs[cap] = {
            key: span_counts(serve if key == "K1-span" else train, n_tiles, span,
                             SPAN_KERNELS[key][0])
            for key in SPAN_KERNELS}
    first = SPAN_CAPS[0]
    same = {key: all(torch.equal(a, b) for cap in SPAN_CAPS[1:]
                     for a, b in zip(outs[first][key], outs[cap][key]))
            for key in SPAN_KERNELS}
    big = (SPAN_32[0], SPAN_CAPS[-1])
    e1, s1 = compare_k1(serve, WIDTH, HEIGHT, tile, "65k view 0", big)
    e2, s2, _, _ = compare_k2(train, WIDTH, HEIGHT, tile, "65k train cam 0", big)
    e4, rel4, rel43 = compare_k3(train, gimg, tb, WIDTH, HEIGHT, tile,
                                 "65k train cam 0", big)
    record = {"span_caps": SPAN_CAPS, "bit_identical_across_span_caps": same,
              "programs": programs,
              "at_largest": {"K1-span": e1, "K2-span": e2, "K4": e4,
                             "K4_rel": max(rel4.values()),
                             "K4_vs_K3_rel": max(rel43.values()),
                             "K1-span_bit_identical_to_k1": s1["bit_identical_to_k1"],
                             "K2-span_bit_identical_to_k2": s2["bit_identical_to_k2"]}}
    log(f"span caps at tpp={SPAN_32[0]}: {json.dumps(record)}")
    if not all(same.values()) or not s1["bit_identical_to_k1"] \
            or not s2["bit_identical_to_k2"]:
        raise RuntimeError(f"span caps: a span kernel's bits depend on its window "
                           f"or differ from its default kernel {record}")
    return record


def wide_phase(gen, dev) -> dict:
    """The three span kernels at WIDE_SPAN over the 121 tiles of a deep
    WIDE_SIZE px pack at 32 px tiles: programs of 11 tiles, clusters of one
    CTA holding the whole window, span_cap 96 resolved to what one CTA
    holds. Each held to its plain version, K1-span and K2-span bit-identical
    to K1 and K2, K4 also against K3 (compare_k1, compare_k2, compare_k3);
    raises unless some program with chunks takes the window."""
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        chunk_span,
        resolve_span,
        sorted_pack,
        span_programs,
    )

    size, ts = WIDE_SIZE, 32
    packed = sorted_pack(deep_proj(20000, size, size, gen, dev), size // ts,
                         size // ts, ts, 3, order="exact")
    label = f"deep {size}px/{ts}px tiles"
    e1, s1 = compare_k1(packed, size, size, ts, label, WIDE_SPAN)
    e2, s2, out_k, tb_k = compare_k2(packed, size, size, ts, label, WIDE_SPAN)
    e4, rel4, rel43 = compare_k3(packed, cotangent_tiles(out_k, size, size, ts, gen),
                                 tb_k, size, size, ts, label, WIDE_SPAN)
    n_tiles = (size // ts) ** 2
    tpp, cap = resolve_span(n_tiles, packed.rows16.shape[1], *WIDE_SPAN, "fwd")
    fits = span_programs(packed, tpp, cap)[1]
    chunks = chunk_span(packed)[3].reshape(-1, tpp).sum(1)
    record = {"tiles": n_tiles, "programs": {
                  key: span_counts(packed, n_tiles, WIDE_SPAN, SPAN_KERNELS[key][0])
                  for key in SPAN_KERNELS},
              "fitting_programs_with_chunks": int((fits & (chunks > 0)).sum()),
              "max_abs_err": {"K1-span": e1, "K2-span": e2, "K4": e4},
              "K4_rel": max(rel4.values()), "K4_vs_K3_rel": max(rel43.values()),
              "K1-span_bit_identical_to_k1": s1["bit_identical_to_k1"],
              "K2-span_bit_identical_to_k2": s2["bit_identical_to_k2"]}
    log(f"span kernels at tpp={WIDE_SPAN[0]} span_cap={WIDE_SPAN[1]} over "
        f"{n_tiles} tiles: {json.dumps(record)}")
    if not s1["bit_identical_to_k1"] or not s2["bit_identical_to_k2"] \
            or record["fitting_programs_with_chunks"] == 0:
        raise RuntimeError(f"span kernels at {WIDE_SPAN}: {record}")
    return record


class span_options:
    """Within the block, ``render`` rasterizes with the span options: its
    two rasterizer entry points are re-bound with ``tiles_per_program`` and
    ``span_cap`` set, which is how scripts/bench_span_ab.py of the JAX
    package drives them (no config field sets them)."""

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        import functools

        from cloth_splatting_tpu_torch import render as R

        self.module = R
        self.saved = (R.rasterize_tiled_fwd, R.rasterize_tiled_train)
        tpp, cap = self.span
        R.rasterize_tiled_fwd = functools.partial(
            self.saved[0], tiles_per_program=tpp, span_cap=cap)
        R.rasterize_tiled_train = functools.partial(
            self.saved[1], tiles_per_program=tpp, span_cap=cap)

    def __exit__(self, *exc):
        self.module.rasterize_tiled_fwd, self.module.rasterize_tiled_train = self.saved


def launch_counts() -> dict:
    """The six kernels' launch counters."""
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import raster_forward_tiles
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        run_backward,
    )

    return {"K1": raster_forward_tiles.launches,
            "K1-span": raster_forward_tiles.span_launches,
            "K2": raster_forward_train.launches,
            "K2-span": raster_forward_train.span_launches,
            "K3": run_backward.launches, "K4": run_backward.reverse_launches}


def reset_launch_counts() -> None:
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import raster_forward_tiles
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        run_backward,
    )

    raster_forward_tiles.launches = raster_forward_tiles.span_launches = 0
    raster_forward_train.launches = raster_forward_train.span_launches = 0
    run_backward.launches = run_backward.reverse_launches = 0


def timed_calls(fn, args):
    """(device ms per call from CUDA events, host ms per call, results) of
    ``fn(a)`` for each ``a``, one after another."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    results = [fn(a) for a in args]
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / len(args)
    return start.elapsed_time(end) / len(args), host_ms, results


def span_ab(run_default, run_span, span, what: str, n: int, expected: dict):
    """The default path and the span path in turns (default, span, span,
    default), ``n`` calls each; the launch counters are set to 0 just before
    the first span turn and read just after the second. Returns (ms per call
    of the four turns, the launches counted in one span turn: half of what
    the two turns counted); raises if the span turns launched anything but
    ``expected`` per turn."""
    ms = {"default": [], "span": []}
    ms["default"].append(run_default())
    reset_launch_counts()
    with span_options(span):
        ms["span"].append(run_span())
        ms["span"].append(run_span())
    counts = launch_counts()
    ms["default"].append(run_default())
    want = {k: 2 * v for k, v in expected.items()}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise RuntimeError(f"span A/B {what}: launches {got}, expected {want}")
    per_turn = {k: v // 2 for k, v in got.items()}
    log(f"span A/B {what} tpp={span[0]} span_cap={span[1]}: default "
        f"{ms['default'][0]:.4f} / {ms['default'][1]:.4f}, span "
        f"{ms['span'][0]:.4f} / {ms['span'][1]:.4f} ms per {what} over {n} "
        f"(device; order default, span, span, default); launches per span "
        f"turn {json.dumps(per_turn)}")
    return ms, per_turn


def state_tensors(state) -> dict:
    """Every tensor of a SplatTrainState by a flat name."""
    out = {"step": state.step, "g_opt.count": state.g_opt.count,
           "sim_opt.count": state.sim_opt.count}
    for name, tree in (("params", state.params._asdict()),
                       ("gstate", state.gstate._asdict()),
                       ("g_opt.mu", state.g_opt.mu._asdict()),
                       ("g_opt.nu", state.g_opt.nu._asdict()),
                       ("sim_params", state.sim_params),
                       ("sim_opt.mu", state.sim_opt.mu),
                       ("sim_opt.nu", state.sim_opt.nu)):
        out.update({f"{name}.{k}": v for k, v in tree.items()})
    return out


def fit_scene(mesh):
    """The fit's scene built in memory: the 65k mesh on the inextensible
    wave over FIT_TIMES times, FIT_VIEWS orbit views rendered at 800x800 by
    the serving path into uint8 banks, and the held-out frames (the views
    half way between the training views, at every time); checks the bank.
    Returns (traj, cam_bank, gt_bank, the held-out ground truth [T, 3, H, W],
    the held-out EvalFrames, the NeRF++ radius, seconds)."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.scene import nerfpp_radius
    from cloth_splatting_tpu_torch.data.synthetic import (
        cloth_wave_isometric,
        orbit_camera,
        render_scene_banks,
    )
    from cloth_splatting_tpu_torch.train.loop import EvalFrame

    dev = mesh.pos.device
    t0 = time.time()
    rest = mesh.pos.cpu().numpy()
    traj = np.stack([cloth_wave_isometric(rest, t)
                     for t in np.linspace(0.0, 1.0, FIT_TIMES)]).astype(np.float32)
    cam_bank, gt_bank = render_scene_banks(mesh, traj, range(FIT_VIEWS), FIT_VIEWS,
                                           WIDTH, fov=FOV, seed=SEED, device=dev)
    test_cams, test_gts = render_scene_banks(mesh, traj, [1], 2 * FIT_VIEWS, WIDTH,
                                             fov=FOV, seed=SEED, device=dev)
    test_frames = [EvalFrame(type(test_cams)(*(f[0, t] for f in test_cams)),
                             test_gts[0, t], f"r_1_{t}") for t in range(FIT_TIMES)]
    coverage = float((gt_bank.float().mean(dim=2) < 250).float().mean())
    if tuple(gt_bank.shape) != (FIT_VIEWS, FIT_TIMES, 3, HEIGHT, WIDTH) \
            or gt_bank.dtype != torch.uint8 or not 0.02 < coverage < 0.9:
        raise RuntimeError(f"fit: ground-truth bank {tuple(gt_bank.shape)} "
                           f"{gt_bank.dtype} coverage {coverage}")
    radius = nerfpp_radius([orbit_camera(v, FIT_VIEWS, FOV, WIDTH, HEIGHT, 0.0)
                            for v in range(FIT_VIEWS)])
    return (traj, cam_bank, gt_bank, test_gts[0], test_frames, radius,
            time.time() - t0)


def fit_phase(mesh, tan, gpu):
    """Fit the scene of ``fit_scene`` for FIT_ITERATIONS iterations of
    ``fit_banks`` on FIT_SCHEDULE with one held-out evaluation and one
    checkpoint at the end, the true trajectory as the mesh predictions.
    Returns (the {"fit": ...} record, the launch counts of the fit, the
    fitted scene for the eval phase: the trainer, the state the fit hands
    ``save_scene_checkpoint`` at its end (its parameter average when
    ``param_ema`` is on; the PLY and HDF5 writing is left out, so that no
    h5py is needed), the active SH degree, the true vertex trajectory, the
    held-out ground truth and the fit's held-out PSNR)."""
    import tempfile
    import types

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.models import gaussians as G
    from cloth_splatting_tpu_torch.train import loop
    from cloth_splatting_tpu_torch.train.config import Config
    from cloth_splatting_tpu_torch.train.loop import (
        evaluate_split,
        fit_banks,
        load_train_checkpoint,
    )
    from cloth_splatting_tpu_torch.train.step import Trainer

    dev = mesh.pos.device
    traj, cam_bank, gt_bank, test_gts, test_frames, radius, scene_s = fit_scene(mesh)

    cfg = Config()
    for key, value in FIT_SCHEDULE.items():
        setattr(cfg.opt, key, value)
    trainer = Trainer(cfg, mesh, torch.from_numpy(traj).to(dev), WIDTH, HEIGHT,
                      tan, tan, radius)
    rng = np.random.default_rng(SEED)
    params, gstate = G.init_from_mesh(rng, mesh, cfg.model.sh_degree, 2,
                                      capacity=TRAIN_CAPACITY, device=dev)
    state = trainer.init_state(rng, params, gstate)
    alive0, cap0 = int(state.gstate.alive.sum()), int(state.gstate.alive.numel())
    held_out_start = evaluate_split(trainer, state, test_frames,
                                    cfg.model.white_background,
                                    cfg.model.sh_degree)

    # count the host events where they run
    events = {"densify": 0, "prune": 0, "opacity_reset": 0, "cleanup": 0,
              "grow_capacity": 0, "densify_overflow": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            events[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def counted_densify(fn):
        def wrapper(*args, **kwargs):
            events["densify"] += 1
            new_state, overflow = fn(*args, **kwargs)
            events["densify_overflow"] += int(overflow)
            return new_state, overflow
        return wrapper

    trainer._densify = counted_densify(trainer._densify)
    trainer._prune = counted("prune", trainer._prune)
    trainer._reset_opacity = counted("opacity_reset", trainer._reset_opacity)
    trainer.cleanup_barycentric = counted("cleanup", trainer.cleanup_barycentric)
    trainer.grow_capacity = counted("grow_capacity", trainer.grow_capacity)

    saved = {}

    def capture_scene_checkpoint(out_dir, iteration, trainer_, state_):
        saved[iteration] = state_

    save_scene_checkpoint = loop.save_scene_checkpoint
    loop.save_scene_checkpoint = capture_scene_checkpoint
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        try:
            (device_ms, host_ms, (final,)) = timed_calls(
                lambda _: fit_banks(
                    trainer, state, cam_bank, gt_bank, None, out_dir=out_dir,
                    test_frames=test_frames, test_iterations=[FIT_ITERATIONS],
                    save_iterations=[FIT_ITERATIONS],
                    checkpoint_iterations=[FIT_ITERATIONS], seed=SEED,
                    progress_every=FIT_PROGRESS_EVERY), [0])
        finally:
            loop.save_scene_checkpoint = save_scene_checkpoint
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            ticks = [json.loads(line) for line in f]
        reloaded = load_train_checkpoint(
            os.path.join(out_dir, f"chkpnt{FIT_ITERATIONS}.npz"), final)

    expected = 3 * FIT_ITERATIONS
    if counts["K2"] != expected or counts["K3"] != expected \
            or counts["K1-span"] or counts["K2-span"] or counts["K4"]:
        raise RuntimeError(f"fit: launches {counts}, expected K2 = K3 = {expected} "
                           f"and no span kernel")
    if counts["K1"] != FIT_TIMES:
        raise RuntimeError(f"fit: the held-out evaluation launched K1 "
                           f"{counts['K1']} times for {FIT_TIMES} frames")
    for name, t in state_tensors(final).items():
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"fit: non-finite {name}")
    for name in ("densify", "prune", "opacity_reset", "cleanup"):
        if events[name] == 0:
            raise RuntimeError(f"fit: {name} never ran {events}")
    alive1, cap1 = int(final.gstate.alive.sum()), int(final.gstate.alive.numel())
    if alive1 == alive0:
        raise RuntimeError(f"fit: the alive count stayed at {alive0}")
    if int(final.step) != FIT_ITERATIONS:
        raise RuntimeError(f"fit: step counter {int(final.step)}")
    if list(saved) != [FIT_ITERATIONS]:
        raise RuntimeError(f"fit: scene checkpoints at {list(saved)}")
    train_ticks = {t["step"]: t for t in ticks if "ema_psnr" in t}
    test_tick = [t for t in ticks if "test_psnr" in t]
    if sorted(train_ticks) != list(range(FIT_PROGRESS_EVERY, FIT_ITERATIONS + 1,
                                         FIT_PROGRESS_EVERY)) or not test_tick:
        raise RuntimeError(f"fit: progress ticks {sorted(train_ticks)}, "
                           f"{len(test_tick)} evaluations")
    values = [v for t in ticks for k, v in t.items() if k not in ("step", "ts")]
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"fit: non-finite metrics {ticks}")
    psnr_50 = train_ticks[FIT_PROGRESS_EVERY]["ema_psnr"]
    psnr_end = train_ticks[FIT_ITERATIONS]["ema_psnr"]
    if not psnr_end > psnr_50:
        raise RuntimeError(f"fit: EMA PSNR {psnr_50:.3f} at iteration "
                           f"{FIT_PROGRESS_EVERY}, {psnr_end:.3f} at {FIT_ITERATIONS}")
    if not test_tick[-1]["test_psnr"] > held_out_start["psnr"]:
        raise RuntimeError(f"fit: held-out PSNR {held_out_start['psnr']:.3f} before "
                           f"the fit, {test_tick[-1]['test_psnr']:.3f} after")
    a, b = state_tensors(final), state_tensors(reloaded)
    unequal = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if unequal:
        raise RuntimeError(f"fit: the checkpoint reloads unequal in {unequal}")

    record = {
        "iterations": FIT_ITERATIONS, "views": FIT_VIEWS, "times": FIT_TIMES,
        "width": WIDTH, "height": HEIGHT,
        "iterations_per_second": 1e3 / host_ms * FIT_ITERATIONS,
        "device_ms_per_iteration": device_ms / FIT_ITERATIONS,
        "host_ms_per_iteration": host_ms / FIT_ITERATIONS,
        "scene_build_s": scene_s, "gt_bank_mb": gt_bank.numel() / 1e6,
        "events": events, "alive_start": alive0, "alive_end": alive1,
        "capacity_start": cap0, "capacity_end": cap1,
        "grow_capacity_fired": events["grow_capacity"] > 0,
        "ema_psnr": {str(k): v["ema_psnr"] for k, v in sorted(train_ticks.items())},
        "test_psnr_before_fit": held_out_start["psnr"],
        "test_psnr": test_tick[-1]["test_psnr"], "test_l1": test_tick[-1]["test_l1"],
        "launches": counts, "peak_memory_gb": peak_gb,
        "checkpoint_reloads_equal": True, "gpu": gpu}
    log(f"fit: {FIT_ITERATIONS} iterations, {record['iterations_per_second']:.3f} "
        f"it/s, {record['device_ms_per_iteration']:.3f} ms/iteration (device), "
        f"{record['host_ms_per_iteration']:.3f} (host), events {json.dumps(events)}, "
        f"alive {alive0} -> {alive1}, capacity {cap0} -> {cap1}, EMA PSNR "
        f"{psnr_50:.3f} at {FIT_PROGRESS_EVERY} -> {psnr_end:.3f} at "
        f"{FIT_ITERATIONS}, held-out PSNR {held_out_start['psnr']:.3f} before the "
        f"fit -> {record['test_psnr']:.3f} [{gpu}]")
    fitted = types.SimpleNamespace(
        trainer=trainer, state=saved[FIT_ITERATIONS],
        sh_degree=min(FIT_ITERATIONS // 1000, cfg.model.sh_degree), traj=traj,
        test_gts=test_gts, test_psnr=record["test_psnr"])
    return record, counts, fitted


def train_phase(gpu):
    """The 65k training configuration of the port's ``bench.train_setup``
    (the root bench.py's) through the port's Trainer:
    a warm-up step, then TRAIN_STEPS timed steps with the launch counters
    set to 0 just before; then the span A/B over TRAIN_STEPS steps. Returns
    (the {"train": ...} record, K2 launches, K3 launches, the A/B's ms per
    step, the span kernels' launches in one span turn)."""
    import torch

    from cloth_splatting_tpu_torch.bench import train_setup
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        raster_forward_tiles,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        run_backward,
    )

    trainer, state, cams, gts = train_setup(WIDTH, HEIGHT, MESH_RES, TRAIN_CAPACITY,
                                            torch.device("cuda"))
    n_alive = int(state.gstate.alive.sum())

    def step(s):
        return trainer.step(s, cams, gts, None, sh_degree=1, static=False)

    state0 = state
    state, _ = step(state)                      # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raster_forward_tiles.launches = 0
    raster_forward_train.launches = 0
    run_backward.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state)
        losses.append(metrics.loss)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / TRAIN_STEPS
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    k2, k3 = raster_forward_train.launches, run_backward.launches
    k1 = raster_forward_tiles.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = len(TRAIN_TIMES) * TRAIN_STEPS
    if k2 != expected or k3 != expected:
        raise RuntimeError(f"train: K2 launched {k2} and K3 {k3} times in "
                           f"{TRAIN_STEPS} steps of {len(TRAIN_TIMES)} cameras")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train: non-finite loss {losses}")
    moved = {k: float((a - b).abs().max())
             for k, a, b in zip(state.params._fields, state.params, state0.params)}
    sim_moved = {k: float((state.sim_params[k] - v).abs().max())
                 for k, v in state0.sim_params.items()}
    if max(moved.values()) <= 0.0 or max(sim_moved.values()) <= 0.0:
        raise RuntimeError(f"train: parameters did not move {moved} {sim_moved}")
    if int(state.step) != TRAIN_STEPS + 1:
        raise RuntimeError(f"train: step counter {int(state.step)}")

    # the step's three stages, timed separately over two more steps
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stages = {"forward_renders_and_losses": 0.0, "backward": 0.0, "adam_and_stats": 0.0}
    for _ in range(2):
        ev[0].record()
        fwd = trainer.forward(state, cams, gts, None, 1, False)
        ev[1].record()
        grads = trainer.backward(fwd)
        ev[2].record()
        state, _ = trainer.update(state, fwd, grads)
        ev[3].record()
        ev[3].synchronize()
        for i, k in enumerate(stages):
            stages[k] += ev[i].elapsed_time(ev[i + 1]) / 2
    # the span A/B: the same steps with the rasterizer's span options on
    def run_steps():
        return timed_calls(lambda _: step(state), range(TRAIN_STEPS))[0]

    n_cams = len(TRAIN_TIMES)
    ab_ms, ab_launches = span_ab(
        run_steps, run_steps, SPAN_32, "step", TRAIN_STEPS,
        {"K2-span": n_cams * TRAIN_STEPS, "K4": n_cams * TRAIN_STEPS})

    trace = profile_calls(lambda _: step(state), [0])
    record = {
        "steps": TRAIN_STEPS, "cameras": len(TRAIN_TIMES), "gaussians": n_alive,
        "width": WIDTH, "height": HEIGHT, "ms_per_step": step_ms,
        "host_ms_per_step": host_ms, "stage_ms": stages,
        "loss_first": losses[0], "loss_last": losses[-1],
        "k1_launches": k1, "k2_launches": k2, "k3_launches": k3,
        "peak_memory_gb": peak_gb,
        "device_busy_share": trace["device_busy_share"],
        "kernels_per_step": trace["kernels_per_call"],
        "gpu": gpu}
    log(f"train: {TRAIN_STEPS} steps, {step_ms:.4f} ms/step (device), "
        f"{host_ms:.4f} ms/step (host), stages {json.dumps(stages)}, K2 {k2} "
        f"K3 {k3} launches, loss {losses[0]:.6f} -> {losses[-1]:.6f}, largest "
        f"parameter moves {json.dumps(moved)} simulator {json.dumps(sim_moved)} "
        f"[{gpu}]")
    log(f"profile of 1 train step: {json.dumps(trace)}")
    return record, k2, k3, ab_ms, ab_launches


def eval_phase(fitted, gpu: str):
    """The fitted scene through the port's evaluation, on the card: the 5
    held-out frames (the fit's held-out cameras, rebuilt) and the video
    orbit through ``render_frames``, each split with the launch counters set
    to 0 just before; the held-out frames scored in memory; the tracked
    trajectories written and scored. K1's share of a frame is K1 alone
    (torch.profiler over one more pass of the split, its 2 n + 1 launches)
    over the split's frame time. Returns (the {"eval": ...} record, K1's
    launches over both splits)."""
    import tempfile

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.scene import spherical_video_cameras
    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera
    from cloth_splatting_tpu_torch.eval import lpips as L
    from cloth_splatting_tpu_torch.eval.metrics import score_images
    from cloth_splatting_tpu_torch.eval.render_sets import (
        render_frames,
        write_trajectories,
    )
    from cloth_splatting_tpu_torch.eval.tracking import evaluate_tracking
    from cloth_splatting_tpu_torch.models.deform import simulator_from_params

    trainer, state = fitted.trainer, fitted.state
    dev = trainer.device
    simulator = simulator_from_params(state.sim_params)
    splits = {
        "test": [orbit_camera(1, 2 * FIT_VIEWS, FOV, WIDTH, HEIGHT, float(t))
                 for t in np.linspace(0.0, 1.0, FIT_TIMES)],
        "video": spherical_video_cameras(VIDEO_POSES, FOV, WIDTH, HEIGHT, 1.0)}
    rendered, record = {}, {"gaussians": int(state.gstate.alive.sum()),
                            "width": WIDTH, "height": HEIGHT,
                            "sh_degree": fitted.sh_degree, "splits": {}}
    k1 = 0
    for split, cams in splits.items():
        def run(keep_logs=False):
            return render_frames(cams, state.params, state.gstate, trainer.mesh,
                                 simulator, trainer.mesh_predictions, True,
                                 fitted.sh_degree, keep_logs=keep_logs, device=dev)

        reset_launch_counts()
        rs = run(keep_logs=split == "test")
        counts = {k: v for k, v in launch_counts().items() if v}
        if counts != {"K1": 2 * len(cams) + 1}:
            raise RuntimeError(f"eval {split}: launches {counts} for {len(cams)} "
                               f"cameras, expected K1 = {2 * len(cams) + 1}")
        k1 += counts["K1"]
        # K1 alone on this split's own frames: the same pass again under the
        # profiler, after the counts were read
        k1_ms, k1_records = kernel_alone_ms(run, "K1", 1, counts["K1"])
        covered = []
        for i, frame in enumerate(rs.frames):
            if frame.shape != (3, HEIGHT, WIDTH) or not np.isfinite(frame).all():
                raise RuntimeError(f"eval {split} frame {i}: {frame.shape}, finite "
                                   f"{bool(np.isfinite(frame).all())}")
            covered.append(float((frame.min(axis=0) < 0.99).mean()))
        if max(covered) <= 0.01:
            raise RuntimeError(f"eval {split}: nothing rendered {covered}")
        rendered[split] = rs
        record["splits"][split] = {
            "frames": len(cams), "fps": rs.fps, "elapsed_s": rs.elapsed,
            "ms_per_frame": 1e3 / rs.fps, "k1_launches": counts["K1"],
            "k1_ms": k1_ms, "k1_records": k1_records,
            "k1_share_of_frame": k1_ms * rs.fps / 1e3,
            "coverage_min": min(covered), "coverage_max": max(covered)}
        log(f"eval {split}: {len(cams)} frames at {WIDTH}x{HEIGHT}, FPS "
            f"{rs.fps:.3f} ({1e3 / rs.fps:.4f} ms a frame; K1 alone on these "
            f"frames {k1_ms:.4f} ms of it, mean of {k1_records} launches), K1 "
            f"launches {counts['K1']} [{gpu}]")

    # the held-out frames scored in memory, against the fit's own reading
    frames = [torch.from_numpy(f).to(dev) for f in rendered["test"].frames]
    gts = fitted.test_gts.to(torch.float32) / 255.0
    weights = L.to_torch(L.fixture_weights(), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = score_images(zip(frames, gts), weights)
    score_s = time.perf_counter() - t0
    means = {k: float(np.mean(v)) for k, v in scores.items()}
    self_lpips = score_images([(frames[0], frames[0])], weights)["LPIPS"][0]
    if not all(math.isfinite(v) for vs in scores.values() for v in vs) \
            or len(scores["LPIPS"]) != FIT_TIMES:
        raise RuntimeError(f"eval: scores {scores}")
    if abs(means["PSNR"] - fitted.test_psnr) > TOL_EVAL_PSNR_DB:
        raise RuntimeError(f"eval: held-out PSNR {means['PSNR']:.6f} dB, the fit's "
                           f"evaluation {fitted.test_psnr:.6f}")
    if self_lpips != 0.0:
        raise RuntimeError(f"eval: LPIPS of a frame against itself {self_lpips}")

    # tracking: the held-out split's logs against the true vertex trajectory
    alive = state.gstate.alive.cpu().numpy()
    mte = {}
    with tempfile.TemporaryDirectory() as d:
        gt_path = os.path.join(d, "gt.npz")
        np.savez(gt_path, traj=fitted.traj)
        for name, vertices in (("gaussians", False), ("vertices", True)):
            path = os.path.join(d, f"all_trajs_{name}.npz")
            write_trajectories(path, splits["test"], rendered["test"].deform_logs,
                               alive, track_vertices=vertices)
            mte[name] = evaluate_tracking(path, gt_path)
            if not math.isfinite(mte[name]["mte_mean"]) \
                    or mte[name]["n_times"] != FIT_TIMES:
                raise RuntimeError(f"eval: tracking {name} {mte[name]}")
    record.update(psnr=means["PSNR"], ssim=means["SSIM"], lpips=means["LPIPS"],
                  lpips_weights=L.FIXTURE_VERSION, fit_test_psnr=fitted.test_psnr,
                  lpips_self=self_lpips, score_s=score_s, per_view=scores,
                  tracking=mte, gpu=gpu)
    log(f"eval scores of {FIT_TIMES} held-out frames: PSNR {means['PSNR']:.4f} dB "
        f"(the fit's evaluation {fitted.test_psnr:.4f}), SSIM {means['SSIM']:.4f}, "
        f"LPIPS ({L.FIXTURE_VERSION}) {means['LPIPS']:.4f}, in {score_s:.3f} s; "
        f"MTE {mte['gaussians']['mte_mean']:.6f} (Gaussians), "
        f"{mte['vertices']['mte_mean']:.6f} (vertices) scene units [{gpu}]")
    return record, k1


def bench_phase(scene, gpu: str) -> dict:
    """The port's benchmark entry at the root bench.py's default scales, the
    65k render scale on ``scene`` (the serving scene, built once), with the
    launch counters set to 0 just before; prints its JSON line. Returns the
    launches it counted."""
    import torch

    from cloth_splatting_tpu_torch import bench

    reset_launch_counts()
    t0 = time.time()
    result = bench.run(torch.device("cuda"), scene=scene)
    seconds = time.time() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    expected = {"K1": BENCH_K1, "K2": BENCH_K2_K3, "K3": BENCH_K2_K3}
    if counts != expected:
        raise RuntimeError(f"bench: launches {counts}, expected {expected}")
    rates = [v for k, v in result.items() if k not in ("metric", "unit")]
    if not all(math.isfinite(v) and v > 0 for v in rates):
        raise RuntimeError(f"bench: {result}")
    print(json.dumps(result))
    log(f"bench: {seconds:.1f} s, launches {json.dumps(counts)} [{gpu}]")
    return counts


def dense_phase(sc, gpu: str) -> dict:
    """The dense tier on the card: (1) against the same function on the
    CPU at DENSE_SIZE with a k_cap that drops (values, the binning's
    counts, gradients); (2) the 65k serving scene's frames through
    ``render(backend="tiled")`` at DENSE_K_CAP, timed, with the launch
    counters set to 0 just before (the tier launches none of the port's
    kernels), the dropped count, the deepest tile, the k_cap at which
    nothing drops and the frame's PSNR against K1's; (3) the fit's scene
    fitted through the tier for DENSE_FIT_ITERATIONS iterations from
    DENSE_FIT_K_CAP, every iteration a tick: ``grow_k_cap`` must run and the
    final evaluation must drop nothing. Returns the {"dense": ...} record."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera, target_gaussians
    from cloth_splatting_tpu_torch.models import gaussians as G
    from cloth_splatting_tpu_torch.ops.image import psnr
    from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled
    from cloth_splatting_tpu_torch.render import camera_arrays, project_view, render
    from cloth_splatting_tpu_torch.train.config import Config
    from cloth_splatting_tpu_torch.train.loop import evaluate_split, fit_banks
    from cloth_splatting_tpu_torch.train.step import Trainer

    dev = sc.mesh.pos.device
    tan = sc.tan
    record = {"gpu": gpu}

    # 1. the card against the CPU, the same projected inputs
    size = DENSE_SIZE
    mesh = grid_cloth_mesh(DENSE_RES, DENSE_RES, size=1.4, device=dev)
    params, state = target_gaussians(mesh, 3, seed=SEED, device=dev)
    cam = camera_arrays(orbit_camera(1, 8, FOV, size, size, 0.0), device=dev)
    with torch.no_grad():
        proj = project_view(cam, size, size, tan, tan, params, state, mesh, None,
                            None, 3)[0]
    gen = torch.Generator().manual_seed(SEED)
    cot = [torch.randn(shape, generator=gen)
           for shape in ((3, size, size), (1, size, size), (1, size, size))]
    fields = ("xy", "conic", "color", "opacity", "depth")
    runs = []
    for where in (dev, torch.device("cpu")):
        p = proj._replace(**{k: getattr(proj, k).to(where) for k in proj._fields})
        leaves = {f: getattr(p, f).clone().requires_grad_() for f in fields}
        out = rasterize_tiled(p._replace(**leaves), size, size, BG,
                              k_cap=DENSE_SMALL_CAP[0], k_chunk=DENSE_SMALL_CAP[1])
        loss = sum((o * c.to(where)).sum() for o, c in zip(out[:3], cot))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        runs.append(([o.detach().cpu() for o in out[:3]],
                     (int(out[3].n_dropped), int(out[3].max_tile_count)),
                     [g.cpu() for g in grads]))
    (vg, ag, gg), (vc, ac, gc) = runs
    value_err = max(float((a - b).abs().max()) for a, b in zip(vg, vc))
    grad_rel = {f: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for f, a, b in zip(fields, gg, gc)}
    log(f"dense {size}x{size}, {int(state.alive.sum())} Gaussians, k_cap "
        f"{DENSE_SMALL_CAP[0]}: card vs CPU max|diff| {value_err:.3e}, gradients "
        f"(of each field's max) {json.dumps(grad_rel)}, dropped / deepest tile "
        f"{ag} (card) {ac} (CPU)")
    if not value_err <= TOL_DENSE or not max(grad_rel.values()) <= TOL_DENSE \
            or ag != ac or ag[0] == 0:
        raise RuntimeError(f"dense: card against CPU {value_err}, {grad_rel}, "
                           f"binning {ag} against {ac}")
    record["card_vs_cpu"] = {"size": size, "gaussians": int(state.alive.sum()),
                             "k_cap": DENSE_SMALL_CAP[0], "max_abs_err": value_err,
                             "grad_rel_err": grad_rel, "n_dropped": ag[0],
                             "max_tile_count": ag[1]}

    # 2. the 65k serving frames through render(backend="tiled")
    def frame(c, k_cap=DENSE_K_CAP):
        return render(c, WIDTH, HEIGHT, tan, tan, sc.params, sc.state, sc.mesh,
                      sc.simulator, sc.preds, BG, 3, k_cap=k_cap, backend="tiled",
                      device=dev)

    with torch.no_grad():
        frame(sc.cams[0])
        reset_launch_counts()
        device_ms, host_ms, outs = timed_calls(frame, sc.cams[:DENSE_FRAMES])
        counts = {k: v for k, v in launch_counts().items() if v}
        proj0 = sc.project(sc.cams[0])

        def raster(k_cap):
            return rasterize_tiled(proj0, WIDTH, HEIGHT, BG, k_cap=k_cap,
                                   k_chunk=min(32, k_cap))

        raster_ms = timed_calls(lambda _: raster(DENSE_K_CAP), range(3))[0]
        caps = {}
        cap = DENSE_K_CAP
        while True:
            aux = raster(cap)[3]
            caps[cap] = int(aux.n_dropped)
            if caps[cap] == 0 or cap >= 8192:
                break
            cap *= 2
        exact = frame(sc.cams[0], cap).rgb
        k1_rgb = render(sc.cams[0], WIDTH, HEIGHT, tan, tan, sc.params, sc.state,
                        sc.mesh, sc.simulator, sc.preds, BG, 3, device=dev).rgb
    if counts:
        raise RuntimeError(f"dense: the dense frames launched {counts}")
    for i, out in enumerate(outs):
        for name in ("rgb", "depth", "alpha"):
            if not bool(torch.isfinite(getattr(out, name)).all()):
                raise RuntimeError(f"dense frame {i}: non-finite {name}")
    if caps[cap] != 0:
        raise RuntimeError(f"dense: instances still drop at k_cap {cap}: {caps}")
    with torch.no_grad():
        aux512 = raster(DENSE_K_CAP)[3]
    record["serving"] = {
        "frames": DENSE_FRAMES, "width": WIDTH, "height": HEIGHT,
        "gaussians": int(sc.state.alive.sum()), "k_cap": DENSE_K_CAP,
        "ms_per_frame": device_ms, "host_ms_per_frame": host_ms,
        "rasterize_ms": raster_ms, "n_dropped": int(outs[0].n_dropped),
        "max_tile_count": int(aux512.max_tile_count), "n_dropped_by_k_cap": caps,
        "k_cap_nothing_dropped": cap,
        "psnr_vs_k1_db": float(psnr(torch.clamp(outs[0].rgb, 0, 1),
                                    torch.clamp(k1_rgb, 0, 1))),
        "psnr_vs_k1_db_nothing_dropped": float(psnr(torch.clamp(exact, 0, 1),
                                                    torch.clamp(k1_rgb, 0, 1)))}
    log(f"dense 65k {WIDTH}x{HEIGHT} k_cap {DENSE_K_CAP}: {device_ms:.3f} ms/frame "
        f"(device), {host_ms:.3f} (host), rasterize_tiled {raster_ms:.3f} ms, "
        f"dropped {record['serving']['n_dropped']}, deepest tile "
        f"{record['serving']['max_tile_count']}, nothing drops at k_cap {cap} "
        f"({json.dumps(caps)}), PSNR vs K1 "
        f"{record['serving']['psnr_vs_k1_db']:.3f} dB "
        f"({record['serving']['psnr_vs_k1_db_nothing_dropped']:.3f} at k_cap "
        f"{cap}) [{gpu}]")

    # 3. a short fit through the tier from an overflowing k_cap
    traj, cam_bank, gt_bank, _, test_frames, radius, _ = fit_scene(sc.mesh)
    cfg = Config()
    for key, value in dict(iterations=DENSE_FIT_ITERATIONS, raster_backend="tiled",
                           raster_k_cap=DENSE_FIT_K_CAP, densify_from_iter=10**6,
                           opacity_reset_interval=10**6, bary_cleanup=10**6).items():
        setattr(cfg.opt, key, value)
    trainer = Trainer(cfg, sc.mesh, torch.from_numpy(traj).to(dev), WIDTH, HEIGHT,
                      tan, tan, radius)
    rng = np.random.default_rng(SEED)
    fparams, fstate = G.init_from_mesh(rng, sc.mesh, cfg.model.sh_degree, 2,
                                       capacity=TRAIN_CAPACITY, device=dev)
    state0 = trainer.init_state(rng, fparams, fstate)
    grown = []
    grow = trainer.grow_k_cap

    def counted_grow(*args, **kwargs):
        grown.append(grow(*args, **kwargs))
        return grown[-1]

    trainer.grow_k_cap = counted_grow
    ticks = []
    reset_launch_counts()
    t0 = time.time()
    final = fit_banks(trainer, state0, cam_bank, gt_bank, None, seed=SEED,
                      on_iteration=lambda i, m: ticks.append(m["psnr"]))
    ev = evaluate_split(trainer, final, test_frames, cfg.model.white_background, 0)
    fit_s = time.time() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts:
        raise RuntimeError(f"dense fit: launched {counts}")
    if not grown or ev["n_dropped"] != 0 or not all(map(math.isfinite, ticks)) \
            or not math.isfinite(ev["psnr"]):
        raise RuntimeError(f"dense fit: k_cap grew to {grown}, evaluation {ev}, "
                           f"PSNR ticks {ticks}")
    record["fit"] = {"iterations": DENSE_FIT_ITERATIONS, "k_cap_start": DENSE_FIT_K_CAP,
                     "k_cap_grown_to": grown, "seconds": fit_s,
                     "eval_k_cap": ev["k_cap"], "eval_n_dropped": ev["n_dropped"],
                     "test_psnr": ev["psnr"], "train_psnr": ticks}
    log(f"dense fit: {DENSE_FIT_ITERATIONS} iterations from k_cap {DENSE_FIT_K_CAP}, "
        f"grown to {grown}, evaluation at k_cap {ev['k_cap']} dropped "
        f"{ev['n_dropped']}, test PSNR {ev['psnr']:.3f}, {fit_s:.1f} s [{gpu}]")
    return record


def parity_phase(gpu: str) -> tuple[dict, dict]:
    """The parity arm at full width through ``parity_bench``'s in-memory
    form (PARITY_ARGV), with the launch counters set to 0 just before: every
    number finite, the held-out PSNR above the initial state's, and K1, K2
    and K3 launched as often as the run asks and nothing else. Prints the
    run's JSON line. Returns (the {"parity": ...} record, its launches)."""
    from cloth_splatting_tpu_torch import parity_bench

    args = parity_bench.build_parser().parse_args(PARITY_ARGV)
    reset_launch_counts()
    run = parity_bench.run_in_memory(args)
    counts = {k: v for k, v in launch_counts().items() if v}
    line = run["line"]
    n_test = len(parity_bench.TEST_VIEWS) * args.n_times
    # K1: the ground truth of every view and time, the test split scored
    # before and after the fit (a warm-up, a timed and an export pass each)
    # and the fit's own evaluation; K2 and K3: one camera a static step,
    # three a dynamic one
    static = PARITY_COARSE - 1
    expected = {"K1": args.n_views * args.n_times + 2 * (2 * n_test + 1) + n_test,
                "K2": static + 3 * (PARITY_ITERATIONS - static)}
    expected["K3"] = expected["K2"]
    numbers = [line[k] for k in ("value", "ssim", "lpips", "mte_mm")] + [
        v for k, v in run.items() if k != "line"]
    if counts != expected:
        raise RuntimeError(f"parity: launches {counts}, expected {expected}")
    if not all(isinstance(v, (int, float)) and math.isfinite(v) for v in numbers):
        raise RuntimeError(f"parity: {run}")
    if not line["value"] > run["test_psnr_before"]:
        raise RuntimeError(f"parity: test PSNR {run['test_psnr_before']:.3f} before "
                           f"the fit, {line['value']} after")
    print(json.dumps(line))
    log(f"parity: {PARITY_ITERATIONS} iterations (the arm's 7,500 cut 25x; static "
        f"{static} of them), {run['iterations_per_second']:.3f} it/s, "
        f"{run['n_gaussians']} Gaussians, test PSNR {run['test_psnr_before']:.3f} "
        f"-> {line['value']} dB, launches {json.dumps(counts)} [{gpu}]")
    record = {"argv": PARITY_ARGV, "line": line, "launches": counts, "gpu": gpu,
              **{k: v for k, v in run.items() if k != "line"}}
    return record, counts


def build_scenes(dev):
    """The main paths' scenes at full width: the 65k serving scene of the
    port's ``bench.serving_scene`` (mesh, Gaussians) with a seeded residual
    simulator, N_FRAMES orbit cameras at times 0..1 and ``project(cam)``;
    and the 65k training configuration's pack
    for the first camera (``t_proj``, ``train_pack``; the step renders with
    the fused pack order), at the tiling render's rasterizer picks."""
    import types

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.bench import serving_scene
    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera
    from cloth_splatting_tpu_torch.models import gaussians as G
    from cloth_splatting_tpu_torch.models.deform import init_residual_simulator
    from cloth_splatting_tpu_torch.ops.camera import Camera
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import sorted_pack, tile_and_win
    from cloth_splatting_tpu_torch.render import camera_arrays, project_view

    tan = math.tan(FOV / 2.0)
    serving = serving_scene(MESH_RES, dev)
    mesh, params, state = serving
    rng = np.random.default_rng(SEED)
    simulator = init_residual_simulator(rng, int(mesh.pos.shape[0]), device=dev)
    preds = mesh.pos[None].repeat(3, 1, 1)
    times = np.linspace(0.0, 1.0, N_FRAMES)
    cams = [camera_arrays(orbit_camera(v, N_FRAMES, FOV, WIDTH, HEIGHT,
                                       float(times[v])), device=dev)
            for v in range(N_FRAMES)]
    tile, win = tile_and_win(WIDTH, HEIGHT)

    def project(cam):
        with torch.no_grad():
            return project_view(cam, WIDTH, HEIGHT, tan, tan, params, state, mesh,
                                simulator, preds, 3)[0]

    t_params, t_state = G.init_from_mesh(np.random.default_rng(SEED), mesh, 3, 2,
                                         capacity=TRAIN_CAPACITY, device=dev)
    t_cam = camera_arrays(Camera.create(
        R=np.eye(3), t=np.asarray([0.0, 0.0, 3.0]), fovx=FOV, fovy=FOV,
        width=WIDTH, height=HEIGHT, time=TRAIN_TIMES[0]), device=dev)
    with torch.no_grad():
        t_proj = project_view(t_cam, WIDTH, HEIGHT, tan, tan, t_params, t_state,
                              mesh, simulator, preds, 1)[0]
    train_pack = sorted_pack(t_proj, WIDTH // tile, HEIGHT // tile, tile, win,
                             order="fused")
    return types.SimpleNamespace(
        serving=serving, tan=tan, mesh=mesh, params=params, state=state,
        simulator=simulator,
        preds=preds, cams=cams, project=project, tile=tile, win=win,
        t_proj=t_proj, train_pack=train_pack)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera, target_gaussians
    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        raster_forward_tiles,
        raster_forward_tiles_plain,
        sorted_pack,
        tiles_to_images,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        raster_forward_train_plain,
        run_backward,
        run_backward_plain,
    )
    from cloth_splatting_tpu_torch.render import camera_arrays, project_view, render

    t_start = time.time()
    dev = torch.device("cuda")

    # 1. build ---------------------------------------------------------------
    t0 = time.time()
    usage = {}
    for name, text in kernels.build_all().items():
        if text is not None:
            log(f"nvcc {name}:\n{text.strip()}")
            usage.update(ptxas_usage(text))
    log(f"build: {time.time() - t0:.1f} s; ptxas {json.dumps(usage)}")
    occupancy = blocks_per_sm()
    log(f"blocks an SM (occupancy calculator): {json.dumps(occupancy)}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = cluster_occupancy((WIDTH // 32) * (HEIGHT // 32), n_sms)
    log(f"cluster launches at 32 px, tpp={SPAN_32[0]} ({n_sms} SMs): "
        f"{json.dumps(clusters)}")
    for key in SPAN_KERNELS:
        spills = usage.get(KERNEL_ENTRIES[key], {})
        if spills.get("spill_stores") or spills.get("spill_loads"):
            raise RuntimeError(f"{key} spills: {spills}")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    sc = build_scenes(dev)
    tan, mesh, params, state = sc.tan, sc.mesh, sc.params, sc.state
    simulator, preds, cams, project = sc.simulator, sc.preds, sc.cams, sc.project
    tile, win, t_proj, train_pack = sc.tile, sc.win, sc.t_proj, sc.train_pack
    tw, th = WIDTH // tile, HEIGHT // tile
    n_tiles = tw * th
    p = tile * tile
    n_alive = int(state.alive.sum())
    log(f"scene: {n_alive} Gaussians (capacity {state.alive.numel()}), "
        f"{mesh.pos.shape[0]} vertices, {WIDTH}x{HEIGHT}")

    # 2. kernels against their plain versions ----------------------------------
    k1_err = k2_err = k3_err = k3_rel = 0.0
    packs = []
    for v in (0, 3):
        packed = sorted_pack(project(cams[v]), tw, th, tile, win, order="fused")
        err, stats = compare_k1(packed, WIDTH, HEIGHT, tile, f"65k view {v}")
        k1_err = max(k1_err, err)
        packs.append((packed, stats))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err, train_stats, train_out, train_tb = compare_k2(
        train_pack, WIDTH, HEIGHT, tile, "65k train cam 0")
    k2_err = max(k2_err, err)
    train_gimg = cotangent_tiles(train_out, WIDTH, HEIGHT, tile, gen)
    err, rel = compare_k3(train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile,
                          "65k train cam 0")
    k3_err, k3_rel = max(k3_err, err), max(k3_rel, *rel.values())
    serve16 = sorted_pack(project(cams[0]), WIDTH // 16, HEIGHT // 16, 16, 5,
                          order="fused")
    train16 = sorted_pack(t_proj, WIDTH // 16, HEIGHT // 16, 16, 5, order="fused")
    cull_cases = [("65k view 0", "K1 and K1-span", packs[0][0], WIDTH, HEIGHT,
                   tile, None),
                  ("65k view 0 at 16 px", "K1 and K1-span", serve16, WIDTH,
                   HEIGHT, 16, None),
                  ("65k train cam 0", "K2, K3, K2-span and K4", train_pack,
                   WIDTH, HEIGHT, tile, train_tb),
                  ("65k train cam 0 at 16 px", "K2-span and K4", train16, WIDTH,
                   HEIGHT, 16, raster_forward_train(train16, WIDTH, HEIGHT, 16,
                                                    BG, *SPAN_16)[1])]
    deep_cases = []
    for ts, size, n in ((32, 256, 20000), (16, 128, 6000)):
        proj = deep_proj(n, size, size, gen, dev)
        packed = sorted_pack(proj, size // ts, size // ts, ts,
                             3 if ts == 32 else 5, order="exact")
        label = f"deep {size}px/{ts}px tiles"
        err, stats = compare_k1(packed, size, size, ts, label)
        if stats["tiles_exited_early"] == 0:
            raise RuntimeError("deep pack: the transmittance exit never fired")
        k1_err = max(k1_err, err)
        err, stats, out_k, tb_k = compare_k2(packed, size, size, ts, label)
        if stats["chunks_started"] == stats["chunks_laid"]:
            raise RuntimeError("deep pack: K2 started every chunk")
        k2_err = max(k2_err, err)
        err, rel = compare_k3(packed, cotangent_tiles(out_k, size, size, ts, gen),
                              tb_k, size, size, ts, label)
        k3_err, k3_rel = max(k3_err, err), max(k3_rel, *rel.values())
        cull_cases.append((label, "K1, K2, K3, K2-span and K4", packed, size,
                           size, ts, tb_k))
        deep_cases.append((label, packed, size, size, ts,
                           (SPAN_DEEP, (SPAN_DEEP[0], 1))))
    cull = cull_phase(cull_cases)

    # the span forms: the same packs at 32 px tiles, the same scenes packed
    # at 16 px tiles, and the deep packs; a window most programs fit and a
    # window of one chunk (mostly the overflow walk)
    def both_spans(span):
        return (span, (span[0], 1))

    span_cases = [
        ("65k view 0", packs[0][0], WIDTH, HEIGHT, tile, both_spans(SPAN_32)),
        ("65k train cam 0", train_pack, WIDTH, HEIGHT, tile, both_spans(SPAN_32)),
        ("65k view 0 at 16 px", serve16, WIDTH, HEIGHT, 16, both_spans(SPAN_16)),
        ("65k train cam 0 at 16 px", train16, WIDTH, HEIGHT, 16,
         both_spans(SPAN_16)),
        *deep_cases]
    span_err, span_programs_taken, span_identical = span_phase(span_cases, gen)
    span_caps = span_cap_phase(packs[0][0], train_pack, train_gimg, train_tb, tile)
    wide = wide_phase(gen, dev)

    # 3. times at the main paths' shapes ---------------------------------------
    packed, stats = packs[0]
    k1_ms = time_ms(lambda: raster_forward_tiles(packed, WIDTH, HEIGHT, tile, BG), 50)
    alone = {"K1": kernel_alone_ms(
        lambda: raster_forward_tiles(packed, WIDTH, HEIGHT, tile, BG), "K1")}
    k1_plain_ms = time_ms(
        lambda: raster_forward_tiles_plain(packed, WIDTH, HEIGHT, tile, BG), 3, 1)
    k1_bound = bound(stats, "K1", n_tiles, p)
    log(f"K1 65k view 0: {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, bound "
        f"{json.dumps(k1_bound)} [{gpu}]")

    k2_ms = time_ms(lambda: raster_forward_train(train_pack, WIDTH, HEIGHT, tile,
                                                 BG), 50)
    alone["K2"] = kernel_alone_ms(
        lambda: raster_forward_train(train_pack, WIDTH, HEIGHT, tile, BG), "K2")
    k2_plain_ms = time_ms(lambda: raster_forward_train_plain(
        train_pack, WIDTH, HEIGHT, tile, BG), 3, 1)
    k2_bound = bound(train_stats, "K2", n_tiles, p)
    log(f"K2 65k train cam 0: {k2_ms:.4f} ms, plain {k2_plain_ms:.3f} ms, bound "
        f"{json.dumps(k2_bound)} [{gpu}]")

    k3_ms = time_ms(lambda: run_backward(train_pack, train_gimg, train_tb, WIDTH,
                                         HEIGHT, tile, BG), 50)
    alone["K3"] = kernel_alone_ms(lambda: run_backward(
        train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile, BG), "K3")
    k3_plain_ms = time_ms(lambda: run_backward_plain(
        train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile, BG), 3, 1)
    k3_bound = bound(train_stats, "K3", n_tiles, p)
    log(f"K3 65k train cam 0: {k3_ms:.4f} ms, plain {k3_plain_ms:.3f} ms, bound "
        f"{json.dumps(k3_bound)} [{gpu}]")

    # the span kernels at the same shapes: the same function, so K1-span's
    # and K2-span's bounds are K1's and K2's; K4's is K3's with one more
    # addition per contributing pair and without U_tot's channel
    k1s_ms = time_ms(lambda: raster_forward_tiles(packed, WIDTH, HEIGHT, tile, BG,
                                                  *SPAN_32), 50)
    k1s_plain_ms = time_ms(lambda: raster_forward_tiles_plain(
        packed, WIDTH, HEIGHT, tile, BG, *SPAN_32), 3, 1)
    k2s_ms = time_ms(lambda: raster_forward_train(train_pack, WIDTH, HEIGHT, tile,
                                                  BG, *SPAN_32), 50)
    k2s_plain_ms = time_ms(lambda: raster_forward_train_plain(
        train_pack, WIDTH, HEIGHT, tile, BG, *SPAN_32), 3, 1)
    k4_ms = time_ms(lambda: run_backward(train_pack, train_gimg, train_tb, WIDTH,
                                         HEIGHT, tile, BG, *SPAN_32), 50)
    alone["K1-span"] = kernel_alone_ms(lambda: raster_forward_tiles(
        packed, WIDTH, HEIGHT, tile, BG, *SPAN_32), "K1-span")
    alone["K2-span"] = kernel_alone_ms(lambda: raster_forward_train(
        train_pack, WIDTH, HEIGHT, tile, BG, *SPAN_32), "K2-span")
    alone["K4"] = kernel_alone_ms(lambda: run_backward(
        train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile, BG, *SPAN_32), "K4")
    log("kernels alone (torch.profiler; ms, launch records of 20): "
        f"{json.dumps(alone)} [{gpu}]")
    # the span kernels alone at the largest window of SPAN_CAPS
    big = (SPAN_32[0], SPAN_CAPS[-1])
    alone_big = {
        "K1-span": kernel_alone_ms(lambda: raster_forward_tiles(
            packed, WIDTH, HEIGHT, tile, BG, *big), "K1-span"),
        "K2-span": kernel_alone_ms(lambda: raster_forward_train(
            train_pack, WIDTH, HEIGHT, tile, BG, *big), "K2-span"),
        "K4": kernel_alone_ms(lambda: run_backward(
            train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile, BG, *big), "K4")}
    log(f"span kernels alone at tpp={big[0]} span_cap={big[1]} (torch.profiler; "
        f"ms, launch records of 20): {json.dumps(alone_big)} [{gpu}]")
    k4_plain_ms = time_ms(lambda: run_backward_plain(
        train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile, BG, *SPAN_32), 3, 1)
    k4_bound = bound(train_stats, "K4", n_tiles, p)
    log(f"span kernels at tpp={SPAN_32[0]} span_cap={SPAN_32[1]}: K1-span "
        f"{k1s_ms:.4f} ms (K1 {k1_ms:.4f}), plain {k1s_plain_ms:.3f}; K2-span "
        f"{k2s_ms:.4f} ms (K2 {k2_ms:.4f}), plain {k2s_plain_ms:.3f}; K4 "
        f"{k4_ms:.4f} ms (K3 {k3_ms:.4f}), plain {k4_plain_ms:.3f}, bound "
        f"{json.dumps(k4_bound)} [{gpu}]")

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

    # 4. the serving path: frames through render ------------------------------
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
    trace = profile_calls(frame, cams[:2])
    log(f"profile of 2 frames: {json.dumps(trace)}")
    print(json.dumps({"serving": {
        "frames": N_FRAMES, "gaussians": n_alive, "width": WIDTH,
        "height": HEIGHT, "ms_per_frame": frame_ms,
        "host_ms_per_frame": host_ms, "stage_ms": stage_ms,
        "device_busy_share": trace["device_busy_share"],
        "kernels_per_frame": trace["kernels_per_call"], "gpu": gpu}}))

    # the span A/B of the serving path: the same frames with K1-span
    def run_frames():
        return timed_calls(frame, cams)[0]

    serve_ab_ms, serve_ab_launches = span_ab(
        run_frames, run_frames, SPAN_32, "frame", N_FRAMES, {"K1-span": N_FRAMES})

    # 5. a small render and its gradients against the oracle -------------------
    small_mesh = grid_cloth_mesh(8, 8, size=1.2, device=dev)
    s_params, s_state = target_gaussians(small_mesh, 3, seed=SEED, device=dev)
    s_cam = camera_arrays(orbit_camera(1, 8, FOV, 64, 64, 0.0), device=dev)
    out = render(s_cam, 64, 64, tan, tan, s_params, s_state, small_mesh, None,
                 None, BG, 3, device=dev)
    with torch.no_grad():
        proj = project_view(s_cam, 64, 64, tan, tan, s_params, s_state,
                            small_mesh, None, None, 3)[0]
    ref = rasterize_reference(proj, 64, 64, torch.tensor(BG, device=dev))
    ref_err = {name: float((getattr(out, name) - r).abs().max())
               for name, r in zip(("rgb", "depth", "alpha"), ref)}
    log(f"64x64 render vs oracle max|diff| {json.dumps(ref_err)}")
    if any(not ref_err[k] <= TOL_ORACLE[k] for k in TOL_ORACLE):
        raise RuntimeError(f"render disagrees with the oracle: {ref_err}")
    if float(out.alpha.mean()) <= 0.0:
        raise RuntimeError("small render has no coverage")
    oracle_grads(proj, 64, 64, gen)
    oracle_grads(proj, 64, 64, gen, span=(4, 8))

    # 6. the training path: steps of the Trainer -------------------------------
    train, k2_launches, k3_launches, train_ab_ms, train_ab_launches = \
        train_phase(gpu)
    print(json.dumps({"train": train}))
    print(json.dumps({"span_ab": {
        "tiles_per_program": SPAN_32[0], "span_cap": SPAN_32[1],
        "order": "default, span, span, default",
        "serving_ms_per_frame": serve_ab_ms, "frames": N_FRAMES,
        "train_ms_per_step": train_ab_ms, "steps": TRAIN_STEPS,
        "programs": span_programs_taken,
        "bit_identical_to_default": span_identical, "span_caps": span_caps,
        "wide": wide, "gpu": gpu}}))

    # 7. the full fit ----------------------------------------------------------
    fit, fit_launches, fitted = fit_phase(mesh, tan, gpu)
    print(json.dumps({"fit": fit}))

    # 8. evaluation of the fitted scene ----------------------------------------
    ev, eval_launches = eval_phase(fitted, gpu)
    del fitted
    print(json.dumps({"eval": ev}))

    # 9. the port's benchmark entry --------------------------------------------
    bench_launches = bench_phase(sc.serving, gpu)

    # 10. the dense tier -------------------------------------------------------
    print(json.dumps({"dense": dense_phase(sc, gpu)}))

    # 11. the parity run --------------------------------------------------------
    parity, parity_launches = parity_phase(gpu)
    print(json.dumps({"parity": parity}))

    log(f"total: {time.time() - t_start:.1f} s")
    print(gpu)

    def entry(name, source, replaces, by_path, err, ms, plain_ms, b):
        # launches_by_path: each main path's own count, read just after the
        # path was driven from counters set to 0 just before; launches: their
        # sum; ms: the wrapper call, kernel_ms: the kernel alone, the mean of
        # kernel_ms_records launch records of 20; share_of_bound: bound /
        # kernel alone; ptxas: the entry function's registers, shared memory
        # and spills from this run's build log (None when it was built before)
        key = name.split()[0]
        kernel_ms, records = alone[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None,
                "kernel_ms": kernel_ms, "kernel_ms_records": records,
                "share_of_bound": b["bound_ms"] / kernel_ms,
                "ptxas": usage.get(KERNEL_ENTRIES[key])}

    # K3's cotangent is scaled by 1 / numel, so its absolute error is small
    # whatever the agreement; its entry also carries the relative reading
    # that TOL_K3 holds
    k3_entry = entry("K3 tiled_bwd forward-order gradient sweep",
                     "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                     "cloth_splatting_tpu/ops/rasterize/pallas_train.py:353",
                     {"train": k3_launches, "fit": fit_launches["K3"],
                      "bench": bench_launches["K3"], "parity": parity_launches["K3"]},
                     k3_err, k3_ms, k3_plain_ms,
                     k3_bound)
    k3_entry["max_rel_err"] = k3_rel
    k3_entry["cull_audit"] = cull["65k train cam 0"]
    k4_entry = entry("K4 tiled_bwd_reverse reverse gradient sweep",
                     "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                     "cloth_splatting_tpu/ops/rasterize/pallas_train.py:655",
                     {"span_train": train_ab_launches["K4"]}, span_err["K4"],
                     k4_ms, k4_plain_ms,
                     k4_bound)
    k4_entry["max_rel_err"] = span_err["K4_rel"]
    k4_entry["max_rel_err_vs_k3"] = span_err["K4_vs_K3_rel"]

    # the span kernels run the cluster program: registers (ptxas), the
    # occupancy calculator's blocks an SM and resident clusters at tpp 5,
    # span_cap 41, the kernel alone at the largest of SPAN_CAPS, and the
    # cull audit of the pack they are timed on (K1-span: every chunk of the
    # serving pack; K2-span, K4: the chunks K2 started on the training pack)
    def clustered(e, key, walk, audit):
        e.update(redesigned="one CTA per tile in a cluster per program, the "
                            f"window spread over the cluster; {walk}",
                 registers=(e["ptxas"] or {}).get("registers"),
                 blocks_per_sm=clusters[key]["blocks_per_sm"],
                 cluster_occupancy=clusters[key], cull_audit=audit)
        e[f"kernel_ms_span_cap_{big[1]}"] = alone_big[key][0]
        return e

    clustered(k4_entry, "K4", "K3's patched, culled walk, two passes a chunk",
              cull["65k train cam 0"])
    # K1 and K2 run the patched walk: registers (ptxas), blocks an SM and
    # their cull audits (K1 over every chunk of the serving pack of view 0,
    # K2 over the chunks it started on the training pack)
    def patched(e, key, audit):
        e.update(redesigned="warp patches and footprint cull "
                            "(composite.cuh::composite_tile_patched)",
                 registers=(e["ptxas"] or {}).get("registers"),
                 blocks_per_sm=occupancy[key], cull_audit=audit)
        return e

    k1_entry = patched(entry("K1 tiled_fwd compositor",
                             "cloth_splatting_tpu_torch/csrc/tiled_fwd.cu",
                             "cloth_splatting_tpu/ops/rasterize/pallas_tiled.py:305",
                             {"serving": k1_launches, "fit": fit_launches["K1"],
                              "eval": eval_launches, "bench": bench_launches["K1"],
                              "parity": parity_launches["K1"]},
                             k1_err, k1_ms, k1_plain_ms, k1_bound),
                       "K1", cull["65k view 0"])
    k2_entry = patched(entry("K2 tiled_fwd_train compositor + boundaries",
                             "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                             "cloth_splatting_tpu/ops/rasterize/pallas_train.py:104",
                             {"train": k2_launches, "fit": fit_launches["K2"],
                              "bench": bench_launches["K2"],
                              "parity": parity_launches["K2"]},
                             k2_err, k2_ms, k2_plain_ms, k2_bound),
                       "K2", cull["65k train cam 0"])
    # K1, K2, K3 over the serving frames, the Trainer steps, the fit, the
    # eval splits (K1) and the bench; the span kernels over one span turn of
    # the A/B's frames and steps
    print(json.dumps({"kernels": [
        k1_entry,
        clustered(entry("K1-span tiled_fwd_span compositor, one window per program",
                        "cloth_splatting_tpu_torch/csrc/tiled_fwd.cu",
                        "cloth_splatting_tpu/ops/rasterize/pallas_tiled.py:376",
                        {"span_serving": serve_ab_launches["K1-span"]},
                        span_err["K1-span"], k1s_ms, k1s_plain_ms, k1_bound),
                  "K1-span", "K1's patched, culled walk", cull["65k view 0"]),
        k2_entry,
        clustered(entry("K2-span tiled_fwd_train_span, one window per program",
                        "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                        "cloth_splatting_tpu/ops/rasterize/pallas_train.py:169",
                        {"span_train": train_ab_launches["K2-span"]},
                        span_err["K2-span"], k2s_ms, k2s_plain_ms, k2_bound),
                  "K2-span", "K2's patched, culled walk", cull["65k train cam 0"]),
        k3_entry, k4_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
