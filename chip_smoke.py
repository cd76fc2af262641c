#!/usr/bin/env python3
"""Gate the PyTorch + CUDA port (``cloth_splatting_tpu_torch``) on one card.

    python3 chip_smoke.py

The port's correctness gate on the card: each kernel against its plain
PyTorch version, and each main path of the port driven on the card with
its kernel launches counted (``kernels.LAUNCHES``), its outputs checked
and, where the port promises it, the same bits twice. Speed is the
benchmark's (``python3 -m benchmark.run``) and, for a kernel edit,
``scripts/kernel_ab.py``'s: the only times taken here are each kernel
alone (the ``kernels`` line) and each phase's seconds. Phases, each of
which raises on failure:
  1. build: every kernel of the port from ``cloth_splatting_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together; a library built before
     is compiled again into a temporary directory for its log), read each
     kernel's registers, shared memory and spills from the build log, fail
     when the span kernels or any of the five SH degrees of the point or
     the cloth front end spill or are missing from it, and print the card's
     name and power limit;
  2. kernels: each kernel against its plain PyTorch version on the card: K1
     on the packs of the 65k-Gaussian 800x800 serving scene for two orbit
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
  3. alone: each of the six kernels alone (torch.profiler) on the packs of
     phase 2, the span forms also at ``span_cap`` 96, and its bound from the
     benchmark's counts (``benchmark/counts/``);
  4. serving: frames of the scene at different views and times through the
     port's ``render`` with the launch counts cleared just before: K1 and
     the cloth front end's kernel (``csrc/point_front.cu``'s cloth pass)
     launched once per frame and nothing else, the frames finite with
     nonzero coverage; then the same frames with the span options on, which
     launch K1-span and the cloth front end once a frame and nothing else;
     then one more frame: the cloth front end and K1 once and nothing else,
     the front end run by the kernel and not by the PyTorch ops, its outputs
     (``project_view``'s four) bit-identical to ``project_view_eager``'s,
     and the kernel alone with its bound, registers and blocks an SM;
  5. oracle: a small render, and the gradients of the differentiable
     rasterizer (K2 forward, K3 backward, under autograd; once more with
     the span options: K2-span, K4), against the O(N*P) oracle;
  6. train: a warm-up step and 5 steps of the port's ``Trainer`` on
     bench.py's 65k training configuration (3 cameras, 800x800) with the
     launch counts cleared just before, checking that K2 and K3 ran 3
     times per step and nothing else, that the loss is finite and that the
     Gaussians and the simulator moved; then 5 steps with the span options
     on, which launch K2-span and K4 3 times a step and nothing else;
  7. fit: a scene built in memory (the 65k mesh on an inextensible wave over
     5 times, 4 orbit views rendered at 800x800 by the port's serving path
     into uint8 banks) fitted for 300 iterations of ``fit_banks`` with
     density control, barycentric cleanup, one held-out evaluation and one
     checkpoint, checking the launch counts (K2 and K3 three times an
     iteration, K1 and the cloth front end once a held-out frame), that
     every event ran, finite
     values, a rising PSNR and that the checkpoint reloads equal;
  8. eval: the fit's final state, as the fit hands it to
     ``save_scene_checkpoint``, through ``eval.render_sets.render_frames``
     over the fit's 5 held-out frames and the 80-pose spherical video orbit
     at 800x800 (K1 and the cloth front end launched 2 n + 1 times a split
     and no other kernel),
     the held-out frames scored in memory by ``eval.metrics.score_images``
     (PSNR, SSIM, LPIPS on the ``fixture-v1`` weights; the mean PSNR equal
     to the fit's own held-out evaluation within 1e-3 dB, a frame's LPIPS
     against itself 0), and the tracked trajectories (Gaussians, then
     vertices) written as ``all_trajs.npz`` and scored against the fit's
     true vertex trajectory by ``eval.tracking.evaluate_tracking`` (finite
     MTE);
  9. bench: ``cloth_splatting_tpu_torch.bench.run`` at the root bench.py's
     default scales (the 65k serving scene; training at 4k, 24k and 65k):
     its launch counts, and finite, positive rates;
 10. dense: the dense tier (``ops/rasterize/tiled.py``, plain PyTorch) on
     the card against the same function on the CPU at 128x128 with a k_cap
     that drops (values and gradients within 1e-5, the same dropped count
     and deepest tile); the 65k serving frames through
     ``render(backend="tiled")`` at k_cap 512 (launching no compositor
     kernel of the port and the cloth front end once a frame; dropped
     instances, the k_cap at which nothing drops, PSNR against K1's frame);
     the fit's scene fitted through the tier from k_cap 64: ``grow_k_cap``
     runs, the final evaluation drops nothing, and the fit and its
     evaluation launch the cloth front end once an evaluated frame and
     nothing else;
 11. parity: the parity arm at full width (800x800, 24 views, 8 times,
     ``mesh_res`` 24, noise 0) through ``parity_bench``'s in-memory form for
     300 iterations: finite numbers, the held-out PSNR above the initial
     state's, K1, K2, K3 and the cloth front end (once a K1 frame) launched
     as often as the run asks; then the same
     fit again in the same process: every tensor of the final state, the
     alive count and the line bit-identical to the first fit's;
 12. gnn: the GNN dynamics at the full width of the root
     ``train_meshnet_sim.py`` (latent 128, 15 message-passing layers, batch
     32, 200 nodes) on the root ``datacollection.py``'s data (20 trajectories
     of a 20x20 cloth, 25 steps) made on the card in memory (trajectory 0
     against the CPU's), ``train_meshnet`` over 6 curriculum epochs of 10
     steps (the loss must fall within each unroll length) and once more,
     bit for bit; one training step at unroll lengths 1 and 3 against the
     same step on the CPU; a validation rollout (finite MSE); a real-world
     rollout from a start with 3 mm tracking noise whose refinement must
     lower the edge-length deviation (and from the clean start, reported);
     no tile kernel launched;
 13. planning: the closed manipulation loop at the root ``planning.py``'s
     defaults (16 candidates, horizon 4, plans of 12 steps, the 64-sample
     estimation mesh of a 12x12 cloth, 5 views of 96x96, 150 static and
     200 refine steps), planning with the GNN the gnn phase trained:
     ``MPC.model_rollout`` on the card against the CPU (positions within
     1e-5: the eager first call, the call that captures the CUDA graph and
     a replay; one eager call, one capture, one replay); one ``mpc-cs``
     episode of 3 steps (max_steps cut from 20) through the in-memory path,
     with K2 and K3 launched once per camera of every refiner step, the
     cloth front end once per view of every observed state and no other
     kernel, finite costs and a finite refined history [4, 64, 3];
     the same episode again, bit for bit (costs, history, every tensor of
     the refiner's state); K2 and K3 against their plain versions on the
     final refiner state's pack at 96x96 (16 px tiles); and 3-step episodes
     of ``fixed``, ``random``, ``mpc-oracle`` and ``mpc-ol`` (finite costs,
     no kernel);
 14. legacy: ``models.point_gaussians.fit_static_scene_capped`` (the
     free-xyz model through the dense tier, the JAX package's fit) at the
     root ``fit_legacy.py``'s defaults
     (sh 3, 500 iterations, k_cap 256, 50 training cameras, white
     background) on a scene of NeRF-synthetic size built in memory (800x800
     cameras on a sphere of radius 4.03 with the lego scene's field of
     view, ``load_dnerf_scene``'s init cloud of 2,000 random points, ground
     truth rendered through ``render_points`` from the bench mesh's 16,384
     vertices on a wave): the loss falls, the held-out PSNR over 10 cameras
     beats the initial model's, the point front end's forward and backward
     kernels launched once each an iteration and no other kernel; the
     first 20 iterations twice, bit for bit; 3 iterations at 128x128 on the
     card against the CPU;
 15. sweep: ``parallel.sweep.train_scenes_parallel`` over two scenes of the
     fit's shape from two texture seeds (one signature), both on the one
     card as one group, 120 iterations with a static stage, density events,
     two barycentric cleanups and an evaluation at the end: K2 and K3
     launched once per camera of every step of both scenes, K1 and the
     cloth front end only by the evaluation; then scene 1 alone through
     ``train_scene``: every state
     tensor bit-identical to the sweep's;
 16. mesh: the multi-device layer (``parallel/{launch,mesh,trainer}.py``)
     through ``parallel.launch`` on the one card: a world of one NCCL rank
     takes 5 sharded steps of the 65k train cell (mesh 1x1) bit-identical
     to 5 ``Trainer.step_banked`` steps from the same state (K2 and K3 3
     times a step), then ``train_scene(device_mesh=1x1)`` on the sweep's
     scene 1 (K1 and the cloth front end by its evaluation), every state
     tensor bit-identical to its lone run, then the
     GNN cut (3 curriculum epochs of one step at the gnn phase's width)
     data-parallel, against the single process (loss 1e-6 relative a step,
     parameters 1e-5); two gloo ranks sharing the card take 3 steps on
     meshes 2x1 and 1x2, then 3 more, each held to the Trainer's step from
     the same state (metrics 1e-4, face_bary 5e-5, grad_accum 1e-3 / 1e-7;
     the free-running steps' drift from the Trainer's run reported) and the
     GNN cut (16 samples a rank; loss 1e-5);
 17. points: ``models.point_gaussians.render_points`` without a gradient on
     the benchmark's gs-360-3m field (3.0M free-xyz Gaussians, SH 3,
     uncapped splats) at 1237x822, whose last column and row of 32 px tiles
     are partial: K1 and the point front end's kernel
     (``csrc/point_front.cu``) launched once a frame and nothing else, the
     PyTorch ops never run; the frame bit-identical to K1's output of its
     pack, which holds every instance the frame's binning emitted and
     agrees with K1's plain walk within 1e-5 (depth: 1e-5 of the deepest
     Gaussian's); the front end's ``ProjectedGaussians`` of the frame
     bit-identical to the PyTorch ops'; K1 and the front end alone, each
     with its bound, registers and blocks an SM;
 18. train_points: the training compositors on the same field's partial
     tiles: K2 and K3 on the whole 1237x822 frame (launched once each,
     finite, every pixel off the frame with zero boundaries and
     cotangents, the pack holding what the binning emitted), each against
     its plain version on a crop that keeps the partial tiles, and on that
     corner cut to whole tiles; then the point front end's backward kernel
     (``csrc/point_front_bwd.cu``) on the frame's K3 gradients, reduced to
     the [C, 16] per-Gaussian rows as the training rasterizer reduces them,
     at the benchmark's 3.5M slots (0.5M dead): one launch, each leaf within
     1e-5 of its plain version's norm, exact zeros on every slot without a
     cotangent, and the kernel alone, its bound, registers and blocks an
     SM.

Prints a {"train": ...} line, a {"span": ...} line, a {"fit": ...} line, an
{"eval": ...} line, a {"dense": ...} line, a {"parity": ...} line, a
{"gnn": ...} line, a {"planning": ...} line, a {"legacy": ...} line, a
{"sweep": ...} line, a {"mesh": ...} line, a {"points": ...} line, a
{"train_points": ...} line, a {"kernels": [...]} line, a {"phases": {phase:
seconds}} line and, last, {"ok": true, "device": ...}. Exits non-zero and
prints no result when CUDA is unavailable, when the port package is
missing, or when any phase fails. Imports nothing of JAX.
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
# the bench phase: a warm-up frame and 40 views; a warm-up step and 20
# steps of 3 cameras at each of the three training scales
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
# the gnn phase: the root train_meshnet_sim.py's defaults at full width
# (latent 128, 15 message-passing layers, MLPs of 2 hidden layers, history 2,
# batch 32, 200 nodes, Delaunay graphs, normalizers, lr 3e-4 decaying 0.1 per
# 300 epochs) on the root datacollection.py's defaults (20 trajectories of a
# 20x20 cloth of 0.3 m, 25 steps, seed 0; 4 held-out ones of seed 1), made
# on the card in memory. Depth cut: 6 epochs of 10 steps instead of 300 of
# len(ds) / 32 = 15, with the curriculum on, so that unroll lengths 1, 2 and
# 3 run 2 epochs each (at 5 steps an epoch, batch noise outweighs an
# epoch's progress and the loss of a later epoch of one unroll length can
# exceed the earlier one's).
GNN_DATA = dict(nx=20, ny=20, cloth_size=0.3, n_steps=25)
GNN_TRAIN_TRAJS, GNN_VAL_TRAJS = 20, 4
GNN_MODEL = dict(input_sequence_length=2, n_message_passing=15, latent=128)
GNN_TRAINER = dict(lr_init=3e-4, lr_decay_rate=0.1, lr_decay_steps=300.0,
                   noise_std=0.0, normalize=True, input_seq_len=2)
GNN_NODES, GNN_BATCH, GNN_EPOCHS, GNN_STEPS_PER_EPOCH = 200, 32, 6, 10
GNN_REAL_WORLD_STEPS = 5
# the real-world rollout starts from the held-out mesh as a tracker sees it:
# each point off by this much (m, per coordinate; the CPU tests' synthetic
# captures use the same tracking noise)
GNN_TRACKING_NOISE = 3e-3
# the card's trajectory 0 against the CPU's, positions: the CPU tests hold
# the port's settles and 14-step pick-and-place runs to JAX's at 1e-5
# (TOL_RUN of tests/test_torch_pbd.py), where the two packages sum the
# constraint corrections in different orders; the card sums them in yet
# another order
TOL_GNN_DATA = 1e-5
# one MeshnetTrainer step on the card against the same step on the CPU, from
# the trained state, on one batch with velocity noise of GNN_STEP_NOISE
# passed in: the loss within TOL_GNN_STEP relative (TOL_STEP of
# tests/test_torch_gnn.py), the normalizers' statistics within TOL_GNN_NORM
# relative (that file's limit), all gradients together within
# TOL_GNN_GRAD_ALL of their norm and each parameter's within
# TOL_GNN_GRAD_LEAF of its norm: the limits of that file's
# test_meshnet_trainer_step_matches_jax_at_full_depth, where at 15 layers
# of latent 128 rounding flips ReLU units near their kink and the port's
# step read 8.9e-5 / 2.0e-5 (all) and 5.2e-4 / 7.9e-5 (worst leaf) against
# JAX's at unroll lengths 1 / 3; a wrong edge, offset or sum moves them by
# O(1). The largest element error of a leaf (relative to that leaf's
# largest) is reported, not held: a flipped unit moved single elements by
# 1.6e-3 of it there.
TOL_GNN_STEP = 1e-5
TOL_GNN_NORM = 1e-6
TOL_GNN_GRAD_ALL = 5e-4
TOL_GNN_GRAD_LEAF = 2e-3
GNN_STEP_NOISE = 1e-3
# The closed manipulation loop (phase 13) at the root planning.py's
# defaults, planning with the GNN the gnn phase trained at full width: 16
# candidates over a horizon of 4, bezier plans of 12 steps, the 64-sample
# estimation mesh of a 12x12 cloth, history 2; mpc-cs renders 5 views of
# 96x96 through the dense tier and refines 150 static and 200 refine steps
# on K2/K3. Depth cut: 3 planning steps instead of max_steps 20.
PLAN_CFG = dict(n_candidates=16, horizon=4, traj_len=12, action_repetition=1,
                input_sequence_length=2, num_samples=64, refine_steps=200,
                static_steps=150, n_views=5, image_size=96, seed=0)
PLAN_STEPS, PLAN_STEPS_FULL = 3, 20
PLAN_OTHER_MODALITIES = ("fixed", "random", "mpc-oracle", "mpc-ol")
# the card's candidate rollouts (positions, m) against the CPU's from the
# same state and inputs: the CPU tests hold the port's batched rollout to
# JAX's vmap and to single rollouts at 1e-5 (TOL_ROLLOUT of
# tests/test_torch_manipulation.py and tests/test_torch_gnn.py; they read 0
# at latent 32, 2 layers)
TOL_PLAN_ROLLOUT = 1e-5
# the legacy phase: the root fit_legacy.py's defaults (sh 3, 500
# iterations, k_cap 256, up to 50 training cameras, white background) on a
# scene of NeRF-synthetic size: 800x800 cameras on a sphere of radius 4.03
# with camera_angle_x 0.6911 (the lego scene's), load_dnerf_scene's init
# cloud of 2,000 random points, ground truth rendered through render_points
# from a free-xyz reference (the bench mesh's 16,384 vertices on a wave,
# coloured by position); 10 held-out cameras. Then the first LEGACY_REPEAT
# iterations twice, and at LEGACY_SMALL px the card against the CPU: the
# front end (SH, EWA) within TOL_LEGACY_FRONT of each field's largest (the
# conics within TOL_LEGACY_CONIC: their entries scale like 1 / det, and
# tests/test_torch_ops.py holds them so against JAX) and the same radii; the dense tier on the same projected inputs with its L1 +
# SSIM gradients within TOL_DENSE (the dense phase's limit);
# LEGACY_SMALL_ITERATIONS iterations of the fit on each, the losses within
# TOL_LEGACY_LOSS relative and the fitted models' renders at least
# TOL_LEGACY_RENDER_DB apart in PSNR. Each device sorts by its own depths,
# and a depth within rounding of a bucket edge composites two splats in the
# other order (the first card call read 6.1e-4 at most in a pixel), so the
# renders are not held pixel by pixel; nor are the parameters, which Adam
# moves by +-lr where a gradient is rounding (ROADMAP queue 3)
LEGACY_SIZE, LEGACY_ITERATIONS, LEGACY_K_CAP, LEGACY_SH = 800, 500, 256, 3
LEGACY_TRAIN_CAMS, LEGACY_TEST_CAMS = 50, 10
LEGACY_RADIUS, LEGACY_FOV, LEGACY_POINTS = 4.03, 0.6911, 2000
# the reference's 800x800 frames drop nothing from 2,048 on (the first
# chip run doubled from 512)
LEGACY_REFERENCE_RES, LEGACY_GT_K_CAP = 128, 2048
LEGACY_REPEAT = 20
LEGACY_SMALL, LEGACY_SMALL_ITERATIONS = 128, 3
TOL_LEGACY_FRONT, TOL_LEGACY_CONIC = 1e-5, 1e-4
TOL_LEGACY_LOSS = 1e-5
TOL_LEGACY_RENDER_DB = 50.0
# the sweep phase: two scenes of the fit phase's shape (the 65k mesh on the
# inextensible wave, FIT_VIEWS views x FIT_TIMES times at 800x800, textures
# from two seeds; one signature) swept together, both on the one card,
# SWEEP_ITERATIONS iterations with a static stage, a densify and prune
# round, an opacity reset, two barycentric cleanups and an evaluation at
# the end; then scene 1 alone through train_scene: the same bits
SWEEP_ITERATIONS = 120
SWEEP_SCHEDULE = dict(iterations=SWEEP_ITERATIONS, static_reconst=True,
                      static_reconst_iteration=30, densify_from_iter=40,
                      densification_interval=40, pruning_from_iter=40,
                      pruning_interval=40, densify_until_iter=SWEEP_ITERATIONS,
                      bary_cleanup=60)
SWEEP_SCENE_SEEDS = (SEED, SEED + 1)
# the mesh phase: sharded steps of the train cell on a world of one NCCL rank
# (held bit for bit to the Trainer's) and on two gloo ranks sharing the card
# (2x1 and 1x2, each step held to the Trainer's step from the same state:
# the metrics, face_bary and grad_accum at the CPU tests' limits for the
# port's step against the JAX package's, tests/test_torch_mesh.py TOL_JAX;
# the moments and the parameters at clear gradients (``float_state_errors``)
# at 1e-5: a card run of both meshes read at most 5.0e-7 and 7.3e-7, a 64 px
# cut of this phase on the CPU 2.8e-6, and a wrong sum or scale over the
# ranks moves them by a factor.
# Free-running steps are reported only: at 1x2 the simulator's parameters
# and moments are the only float state a held step changes (its gradient is
# summed over the ranks in another order), and that alone parts the free
# runs by ~4e-6 in face_bary in 3 steps); the GNN cut data-parallel: 3
# epochs of one step (unroll 1, 2, 3 by the curriculum)
MESH_STEPS = 5
MESH_GLOO_STEPS = 3
MESH_GLOO_SHAPES = ((2, 1), (1, 2))
TOL_MESH = dict(metrics=1e-4, bary=5e-5, accum=(1e-3, 1e-7), moments=1e-5, params=1e-5)
# a gradient element is clearly nonzero where its first moment is at least
# this share of its optimizer's largest (tests/test_torch_mesh.py CLEAR)
CLEAR_GRAD = 1e-3
MESH_GNN_EPOCHS = 3
TOL_MESH_GNN_LOSS = 1e-6          # world of one against the single process
TOL_MESH_GNN_PARAMS = 1e-5
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
# K3 against its plain version on the gs-360-3m field's lists (thousands of
# instances a tile, ~65 live pairs a pixel; phase 18): an instance's sums
# over 1,024 pixels cancel more, and the opacity field read 5.0e-6 of its
# largest magnitude on the partial-tile crop (an H100 at 700 W); a pair
# classified differently moves a field by 1e-4 or more
TOL_K3_DEEP = 2e-5
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
# tensor cores, and HBM3 bandwidth; benchmark/run.py's PEAK_FLOPS["fp32"]
# and PEAK_BYTES
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the point front end's bytes a Gaussian (59 floats and a byte read, 12
# floats and a byte written), which benchmark/counts/point_front_end.py
# does not count
FRONT_BYTES_PER_GAUSSIAN = (59 * 4 + 1) + (12 * 4 + 1)
# the cloth front end's bytes a Gaussian: the point row (59 floats and a
# byte), face_bary, the face id, the face's three indices and its six
# vertices read; the point front end's 12 floats and a byte, means3d and
# rotations written. Its FLOPs: benchmark/counts/front_end.py's 430 a
# Gaussian (the simulator MLP, which runs in PyTorch, left out)
CLOTH_FRONT_BYTES_PER_GAUSSIAN = ((59 * 4 + 1 + 3 * 4 + 8 + 3 * 8 + 6 * 3 * 4)
                                  + (12 * 4 + 1 + 3 * 4 + 4 * 4))
# the point front end's backward: every slot reads its cotangents (floats
# 0-9 of a [C, 16] row of the training rasterizer: two 32-byte sectors) and
# its valid byte and writes its 59-float gradient row; a slot with a
# cotangent also reads its 59-float parameter row. Its FLOPs:
# benchmark/counts/point_front_backward.py's a Gaussian
FRONT_BWD_BYTES_PER_SLOT = 16 * 4 + 1 + 59 * 4
FRONT_BWD_BYTES_PER_REACHED = 59 * 4
# the benchmark's fit-gs360 slots: gs-360-3m's 3.0M Gaussians and 0.5M free
FRONT_BWD_SLOTS = 3_500_000
TOL_FRONT_BWD = 1e-5


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
                  "K3": "tiled_bwd_kernel<4>", "K4": "tiled_bwd_reverse_kernel<4>",
                  "front": "point_front_kernel<3>",
                  "cloth_front": "cloth_front_kernel<3>",
                  "front_bwd": "point_front_bwd_kernel<3>"}


def build_logs() -> dict:
    """Each kernel's ``nvcc`` log: ``kernels.build_all``'s where it built the
    library, else (a library built before leaves no log) a compile of the
    same source and flags into a temporary directory."""
    import tempfile
    from pathlib import Path

    from cloth_splatting_tpu_torch import kernels

    logs = kernels.build_all()
    built = [name for name, text in logs.items() if text is None]
    if built:
        saved = kernels.BUILD_DIR
        with tempfile.TemporaryDirectory() as tmp:
            kernels.BUILD_DIR = Path(tmp)
            try:
                logs.update(kernels.build_all(built))
            finally:
                kernels.BUILD_DIR = saved
    return logs


def check_spills(usage: dict) -> None:
    """Raises unless ``usage`` (``ptxas_usage`` of the build's logs) holds
    the three span kernels and the point front end, its backward and the
    cloth front end at each of their five SH degrees, none of them
    spilling."""
    entries = [KERNEL_ENTRIES[key] for key in SPAN_KERNELS]
    entries += [f"{front}_kernel<{deg}>" for front in
                ("point_front", "cloth_front", "point_front_bwd") for deg in range(5)]
    for entry in entries:
        if entry not in usage:
            raise RuntimeError(f"the build log has no ptxas line of {entry}")
        spills = usage[entry]
        if spills.get("spill_stores") or spills.get("spill_loads"):
            raise RuntimeError(f"{entry} spills: {spills}")


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


def kernel_alone_ms(fn, kernel: str, iters: int = 20) -> tuple[float, int]:
    """(mean device time of one launch of ``kernel``, a KERNEL_ENTRIES key,
    over ``iters`` calls of ``fn``, each launching it once; the launch
    records it is the mean of), from torch.profiler's kernel records: the
    kernel alone, without its wrapper's small kernels and host time. The
    profiler can drop records in a process that profiles many times: it
    profiles again, up to three times, until it keeps a record of every
    launch, takes the session that kept the most, and raises when that is
    fewer than half."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    entry = KERNEL_ENTRIES[kernel]
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
        if seen > iters:
            raise RuntimeError(f"profiler saw {seen} launches of {entry} in "
                               f"{iters} calls")
        if seen > count:
            count, total_us = seen, sum(e.self_device_time_total for e in hits)
        if count == iters:
            break
    if count < iters // 2:
        raise RuntimeError(f"profiler saw {count} launches of {entry} in {iters} "
                           f"calls")
    return total_us / 1e3 / count, count


def roofline(kernel: str, item: dict) -> dict:
    """The least time the card could take for ``kernel``'s function on
    ``item`` ({"gaussians": valid Gaussians, "pixels": the frame's, "pairs":
    live pairs; the front ends': {"gaussians": all}; the point front end's
    backward's: {"gaussians": slots, "reached": slots with a cotangent}), by
    the benchmark's counts (``benchmark/counts/``: the compositor's forward
    for K1, K1-span, K2 and K2-span, its backward for K3 and K4,
    ``point_front_end`` and FRONT_BYTES_PER_GAUSSIAN for the point front
    end, ``point_front_backward`` and FRONT_BWD_BYTES_PER_* for its
    backward, ``front_end``'s FLOPs a Gaussian and
    CLOTH_FRONT_BYTES_PER_GAUSSIAN for the cloth front end): the larger of
    its FLOPs at the fp32 peak and its bytes at the memory rate."""
    from benchmark.counts import (
        compositor_backward,
        compositor_forward,
        front_end,
        point_front_backward,
        point_front_end,
    )

    if kernel == "front_bwd":
        flops = point_front_backward.flops(item["reached"])
        n_bytes = (FRONT_BWD_BYTES_PER_SLOT * item["gaussians"]
                   + FRONT_BWD_BYTES_PER_REACHED * item["reached"])
    elif kernel == "front":
        flops = point_front_end.flops(item["gaussians"])
        n_bytes = FRONT_BYTES_PER_GAUSSIAN * item["gaussians"]
    elif kernel == "cloth_front":
        flops = float(front_end.OPS_PER_GAUSSIAN * item["gaussians"])
        n_bytes = CLOTH_FRONT_BYTES_PER_GAUSSIAN * item["gaussians"]
    else:
        count = compositor_backward if kernel in ("K3", "K4") else compositor_forward
        flops, n_bytes = count.flops(item), count.bytes_moved(item)
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
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


def compare_k1(packed, width, height, tile_size, label: str, span=None,
               depth_scale: float = 1.0):
    """(max abs difference of K1 and its plain version, walk statistics) on
    one pack; raises above TOL_PLAIN, on non-finite output, or on nonzero
    padding rows. With ``span`` = (tiles_per_program, span_cap) it is
    K1-span against its plain version, the statistics carry the programs'
    branch counts and whether the output is bit-identical to K1's. The
    pixels of partial tiles outside the frame, which the kernels leave
    unwritten, are zeroed on both sides first. The depth channel is held to
    TOL_PLAIN x ``depth_scale``: its rounding grows with the depths
    composited (1 for the cloth scenes, whose depths are ~4)."""
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        pixel_coords,
        raster_forward_tiles,
        raster_forward_tiles_plain,
        walk_stats,
    )

    name = "K1" if span is None else "K1-span"
    label += span_label(span)
    opts = () if span is None else tuple(span)
    px, py = pixel_coords(width, tile_size, packed.starts.numel(),
                          packed.rows16.device)
    off_frame = ((px >= width) | (py >= height)).permute(0, 2, 1)    # [T, 1, p]

    def composite(*args):
        return raster_forward_tiles(packed, width, height, tile_size, BG,
                                    *args).masked_fill(off_frame, 0.0)

    n_before = kernels.LAUNCHES["K1-span"]
    out_k = composite(*opts)
    torch.cuda.synchronize()
    out_p, walk = raster_forward_tiles_plain(packed, width, height, tile_size,
                                             BG, *opts)
    out_p = out_p.masked_fill(off_frame, 0.0)
    if not bool(torch.isfinite(out_k).all()):
        raise RuntimeError(f"{name} {label}: non-finite output")
    if float(out_k[:, 5:8].abs().max()) != 0.0:
        raise RuntimeError(f"{name} {label}: padding rows 5..7 not zero")
    errs = {ch: float((out_k[:, i] - out_p[:, i]).abs().max())
            for i, ch in enumerate(CHANNELS)}
    stats = walk_stats(packed, walk, tile_size)
    if span is not None:
        if kernels.LAUNCHES["K1-span"] != n_before + 1:
            raise RuntimeError(f"{name} {label}: the span kernel was not launched")
        stats["programs"] = span_counts(packed, out_k.shape[0], span, "fwd")
        stats["bit_identical_to_k1"] = bool(torch.equal(out_k, composite()))
    log(f"{name} vs plain [{label}] max|diff| {json.dumps(errs)} walk "
        f"{json.dumps(stats)}")
    bad = {ch: e for ch, e in errs.items()
           if not e <= TOL_PLAIN * (depth_scale if ch == "depth" else 1.0)}
    if bad:
        raise RuntimeError(f"{name} {label}: disagrees with its plain version {bad}")
    return max(errs.values()), stats


def compare_k2(packed, width, height, tile_size, label: str, span=None,
               depth_scale: float = 1.0):
    """(max abs difference of K2 and its plain version over the output and
    the saved boundaries, walk statistics, K2's out and tbounds); raises
    above TOL_PLAIN, on non-finite output, or when the two started
    different chunks. With ``span`` it is K2-span, and its boundaries must
    also equal K2's bit for bit. As in ``compare_k1``, the pixels of partial
    tiles outside the frame, which K2 leaves unwritten, are zeroed on both
    sides first, and the depth channel is held to TOL_PLAIN x
    ``depth_scale``."""
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        chunk_span,
        pixel_coords,
        walk_stats,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        raster_forward_train_plain,
    )

    name = "K2" if span is None else "K2-span"
    label += span_label(span)
    opts = () if span is None else tuple(span)
    px, py = pixel_coords(width, tile_size, packed.starts.numel(),
                          packed.rows16.device)
    off_frame = ((px >= width) | (py >= height)).permute(0, 2, 1)    # [T, 1, p]
    n_before = kernels.LAUNCHES["K2-span"]
    out_k, tb_k = raster_forward_train(packed, width, height, tile_size, BG, *opts)
    out_k = out_k.masked_fill(off_frame, 0.0)
    torch.cuda.synchronize()
    out_p, tb_p, walk = raster_forward_train_plain(packed, width, height,
                                                   tile_size, BG, *opts)
    out_p = out_p.masked_fill(off_frame, 0.0)
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
        if kernels.LAUNCHES["K2-span"] != n_before + 1:
            raise RuntimeError(f"{name} {label}: the span kernel was not launched")
        stats["programs"] = span_counts(packed, out_k.shape[0], span, "fwd_train")
        out_d, tb_d = raster_forward_train(packed, width, height, tile_size, BG)
        stats["bit_identical_to_k2"] = bool(
            torch.equal(out_k, out_d.masked_fill(off_frame, 0.0))
            and torch.equal(tb_k[:n_laid], tb_d[:n_laid]))
    log(f"{name} vs plain [{label}] max|diff| {json.dumps(errs)} walk "
        f"{json.dumps(stats)}")
    bad = {ch: e for ch, e in errs.items()
           if not e <= TOL_PLAIN * (depth_scale if ch == "depth" else 1.0)}
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
               span=None, tol: float = TOL_K3):
    """(max abs difference of K3 and its plain version, per-field readings
    relative to the field's largest magnitude) on one pack, both fed K2's
    boundaries; raises above ``tol`` (TOL_K3), on non-finite grads, on
    nonzero rows 10..15, or when a second launch on the same inputs does not
    give the same bits (no atomics, sums in a fixed order). With ``span`` it is K4
    against its plain version, and K4 is also held to K3 at TOL_K4_K3 (a
    third value: those readings)."""
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        run_backward,
        run_backward_plain,
    )

    name = "K3" if span is None else "K4"
    label += span_label(span)
    opts = () if span is None else tuple(span)
    n_before = kernels.LAUNCHES["K4"]
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
    bad = {k: e for k, e in rel.items() if not e <= tol}
    if bad:
        raise RuntimeError(f"{name} {label}: disagrees with its plain version {bad}")
    if span is None:
        return abs_err, rel
    if kernels.LAUNCHES["K4"] != n_before + 2:
        raise RuntimeError(f"K4 {label}: the reverse kernel was not launched")
    n_tiles = -(-width // tile_size) * -(-height // tile_size)
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

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import rasterize_tiled_train

    names = ("xy", "conic", "color", "opacity", "depth")
    tgt = torch.rand(3, height, width, generator=gen, device=proj.xy.device)
    tpp, cap = span if span is not None else (None, None)
    k4_before = kernels.LAUNCHES["K4"]

    def grads(raster):
        leaves = [getattr(proj, k).detach().clone().requires_grad_() for k in names]
        rgb, dep, acc = raster(proj._replace(**dict(zip(names, leaves))))
        loss = ((rgb - tgt) ** 2).mean() + 0.1 * dep.mean() + 0.05 * acc.mean()
        return loss, torch.autograd.grad(loss, leaves)

    loss_k, g_k = grads(lambda q: rasterize_tiled_train(
        q, width, height, BG, tiles_per_program=tpp, span_cap=cap))
    if span is not None and kernels.LAUNCHES["K4"] != k4_before + 1:
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
                         size // ts, ts, order="exact")
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


def span_turn(run, span, what: str, expected: dict) -> dict:
    """``run()`` with the span options ``span``, the launch counts cleared
    just before; raises unless it launched exactly ``expected``. Returns
    the launches."""
    from cloth_splatting_tpu_torch import kernels

    kernels.LAUNCHES.clear()
    with span_options(span):
        run()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if got != expected:
        raise RuntimeError(f"span {what}: launches {got}, expected {expected}")
    log(f"span {what} tpp={span[0]} span_cap={span[1]}: launches {json.dumps(got)}")
    return got


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
    the held-out EvalFrames, the NeRF++ radius)."""
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
    return traj, cam_bank, gt_bank, test_gts[0], test_frames, radius


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

    from cloth_splatting_tpu_torch import kernels
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
    traj, cam_bank, gt_bank, test_gts, test_frames, radius = fit_scene(mesh)

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
        kernels.LAUNCHES.clear()
        try:
            final = fit_banks(trainer, state, cam_bank, gt_bank, None, out_dir=out_dir,
                              test_frames=test_frames, test_iterations=[FIT_ITERATIONS],
                              save_iterations=[FIT_ITERATIONS],
                              checkpoint_iterations=[FIT_ITERATIONS], seed=SEED,
                              progress_every=FIT_PROGRESS_EVERY)
        finally:
            loop.save_scene_checkpoint = save_scene_checkpoint
        counts = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            ticks = [json.loads(line) for line in f]
        reloaded = load_train_checkpoint(
            os.path.join(out_dir, f"chkpnt{FIT_ITERATIONS}.npz"), final)

    expected = 3 * FIT_ITERATIONS
    if counts.get("K2") != expected or counts.get("K3") != expected \
            or set(counts) - {"K1", "K2", "K3", "cloth_front"}:
        raise RuntimeError(f"fit: launches {counts}, expected K2 = K3 = {expected} "
                           f"and no other kernel but K1 and the cloth front end")
    if counts.get("K1") != FIT_TIMES or counts.get("cloth_front") != FIT_TIMES:
        raise RuntimeError(f"fit: the held-out evaluation launched K1 "
                           f"{counts.get('K1')} times and the cloth front end "
                           f"{counts.get('cloth_front')} times for {FIT_TIMES} "
                           f"frames")
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
        "width": WIDTH, "height": HEIGHT, "gt_bank_mb": gt_bank.numel() / 1e6,
        "events": events, "alive_start": alive0, "alive_end": alive1,
        "capacity_start": cap0, "capacity_end": cap1,
        "grow_capacity_fired": events["grow_capacity"] > 0,
        "ema_psnr": {str(k): v["ema_psnr"] for k, v in sorted(train_ticks.items())},
        "test_psnr_before_fit": held_out_start["psnr"],
        "test_psnr": test_tick[-1]["test_psnr"], "test_l1": test_tick[-1]["test_l1"],
        "launches": counts, "peak_memory_gb": peak_gb,
        "checkpoint_reloads_equal": True, "gpu": gpu}
    log(f"fit: {FIT_ITERATIONS} iterations, events {json.dumps(events)}, alive "
        f"{alive0} -> {alive1}, capacity {cap0} -> {cap1}, EMA PSNR "
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
    (the root bench.py's) through the port's Trainer: a warm-up step, then
    TRAIN_STEPS steps with the launch counts cleared just before; then
    TRAIN_STEPS steps with the span options on (``span_turn``). Returns
    (the {"train": ...} record, K2 launches, K3 launches, the span kernels'
    launches)."""
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.bench import train_setup

    trainer, state, cams, gts = train_setup(WIDTH, HEIGHT, MESH_RES, TRAIN_CAPACITY,
                                            torch.device("cuda"))
    n_alive = int(state.gstate.alive.sum())

    def step(s):
        return trainer.step(s, cams, gts, None, sh_degree=1, static=False)

    state0 = state
    state, _ = step(state)                      # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state)
        losses.append(metrics.loss)
    counts = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_cams = len(TRAIN_TIMES)
    expected = n_cams * TRAIN_STEPS
    if counts != {"K2": expected, "K3": expected}:
        raise RuntimeError(f"train: launches {counts} in {TRAIN_STEPS} steps of "
                           f"{n_cams} cameras, expected K2 = K3 = {expected}")
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

    def steps():
        for _ in range(TRAIN_STEPS):
            step(state)

    span_launches = span_turn(steps, SPAN_32, "step",
                              {"K2-span": expected, "K4": expected})
    record = {
        "steps": TRAIN_STEPS, "cameras": n_cams, "gaussians": n_alive,
        "width": WIDTH, "height": HEIGHT,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": counts,
        "peak_memory_gb": peak_gb, "gpu": gpu}
    log(f"train: {TRAIN_STEPS} steps, launches {json.dumps(counts)}, loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, largest parameter moves "
        f"{json.dumps(moved)} simulator {json.dumps(sim_moved)} [{gpu}]")
    return record, counts["K2"], counts["K3"], span_launches


def eval_phase(fitted, gpu: str):
    """The fitted scene through the port's evaluation, on the card: the 5
    held-out frames (the fit's held-out cameras, rebuilt) and the video
    orbit through ``render_frames``, each split with the launch counts
    cleared just before; the held-out frames scored in memory; the tracked
    trajectories written and scored. Returns (the {"eval": ...} record, K1's
    launches over both splits)."""
    import tempfile

    import numpy as np
    import torch

    from cloth_splatting_tpu_torch import kernels
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

        kernels.LAUNCHES.clear()
        rs = run(keep_logs=split == "test")
        counts = dict(kernels.LAUNCHES)
        if counts != {"K1": 2 * len(cams) + 1, "cloth_front": 2 * len(cams) + 1}:
            raise RuntimeError(f"eval {split}: launches {counts} for {len(cams)} "
                               f"cameras, expected K1 = cloth_front = "
                               f"{2 * len(cams) + 1}")
        k1 += counts["K1"]
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
            "frames": len(cams), "k1_launches": counts["K1"],
            "coverage_min": min(covered), "coverage_max": max(covered)}
        log(f"eval {split}: {len(cams)} frames at {WIDTH}x{HEIGHT}, K1 launches "
            f"{counts['K1']}, coverage {min(covered):.4f}..{max(covered):.4f} [{gpu}]")

    # the held-out frames scored in memory, against the fit's own reading
    frames = [torch.from_numpy(f).to(dev) for f in rendered["test"].frames]
    gts = fitted.test_gts.to(torch.float32) / 255.0
    weights = L.to_torch(L.fixture_weights(), dev)
    scores = score_images(zip(frames, gts), weights)
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
                  lpips_self=self_lpips, per_view=scores,
                  tracking=mte, gpu=gpu)
    log(f"eval scores of {FIT_TIMES} held-out frames: PSNR {means['PSNR']:.4f} dB "
        f"(the fit's evaluation {fitted.test_psnr:.4f}), SSIM {means['SSIM']:.4f}, "
        f"LPIPS ({L.FIXTURE_VERSION}) {means['LPIPS']:.4f}; "
        f"MTE {mte['gaussians']['mte_mean']:.6f} (Gaussians), "
        f"{mte['vertices']['mte_mean']:.6f} (vertices) scene units [{gpu}]")
    return record, k1


def bench_phase(scene, gpu: str) -> dict:
    """The port's benchmark entry at the root bench.py's default scales, the
    65k render scale on ``scene`` (the serving scene, built once), with the
    launch counts cleared just before: its launches, and finite, positive
    rates. Returns the launches it counted."""
    import torch

    from cloth_splatting_tpu_torch import bench, kernels

    kernels.LAUNCHES.clear()
    result = bench.run(torch.device("cuda"), scene=scene)
    counts = dict(kernels.LAUNCHES)
    expected = {"K1": BENCH_K1, "K2": BENCH_K2_K3, "K3": BENCH_K2_K3}
    if counts != expected:
        raise RuntimeError(f"bench: launches {counts}, expected {expected}")
    rates = [v for k, v in result.items() if k not in ("metric", "unit")]
    if not all(math.isfinite(v) and v > 0 for v in rates):
        raise RuntimeError(f"bench: {result}")
    log(f"bench: launches {json.dumps(counts)}, every rate finite and positive [{gpu}]")
    return counts


def dense_phase(sc, gpu: str) -> dict:
    """The dense tier on the card: (1) against the same function on the
    CPU at DENSE_SIZE with a k_cap that drops (values, the binning's
    counts, gradients); (2) the 65k serving scene's frames through
    ``render(backend="tiled")`` at DENSE_K_CAP, with the launch counts
    cleared just before (the tier launches no compositor kernel of the
    port; the front end, without a gradient, is the cloth front end's
    kernel once a frame), the dropped count, the deepest tile, the k_cap at
    which nothing drops and the frame's PSNR against K1's; (3) the fit's
    scene fitted through the tier for DENSE_FIT_ITERATIONS iterations from
    DENSE_FIT_K_CAP, every iteration a tick: ``grow_k_cap`` must run, the
    final evaluation must drop nothing, and the cloth front end must run
    once for each frame of each of the evaluation's k_cap rounds and no
    other kernel. Returns the {"dense": ...} record."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch import kernels
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
        kernels.LAUNCHES.clear()
        outs = [frame(c) for c in sc.cams[:DENSE_FRAMES]]
        counts = dict(kernels.LAUNCHES)
        proj0 = sc.project(sc.cams[0])

        def raster(k_cap):
            return rasterize_tiled(proj0, WIDTH, HEIGHT, BG, k_cap=k_cap,
                                   k_chunk=min(32, k_cap))

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
    if counts != {"cloth_front": DENSE_FRAMES}:
        raise RuntimeError(f"dense: the dense frames launched {counts}, expected the "
                           f"cloth front end once a frame and no compositor kernel")
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
        "n_dropped": int(outs[0].n_dropped),
        "max_tile_count": int(aux512.max_tile_count), "n_dropped_by_k_cap": caps,
        "k_cap_nothing_dropped": cap,
        "psnr_vs_k1_db": float(psnr(torch.clamp(outs[0].rgb, 0, 1),
                                    torch.clamp(k1_rgb, 0, 1))),
        "psnr_vs_k1_db_nothing_dropped": float(psnr(torch.clamp(exact, 0, 1),
                                                    torch.clamp(k1_rgb, 0, 1)))}
    log(f"dense 65k {WIDTH}x{HEIGHT} k_cap {DENSE_K_CAP}: no compositor kernel "
        f"launched, the cloth front end once a frame, "
        f"dropped {record['serving']['n_dropped']}, deepest tile "
        f"{record['serving']['max_tile_count']}, nothing drops at k_cap {cap} "
        f"({json.dumps(caps)}), PSNR vs K1 "
        f"{record['serving']['psnr_vs_k1_db']:.3f} dB "
        f"({record['serving']['psnr_vs_k1_db_nothing_dropped']:.3f} at k_cap "
        f"{cap}) [{gpu}]")

    # 3. a short fit through the tier from an overflowing k_cap
    traj, cam_bank, gt_bank, _, test_frames, radius = fit_scene(sc.mesh)
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
    kernels.LAUNCHES.clear()
    final = fit_banks(trainer, state0, cam_bank, gt_bank, None, seed=SEED,
                      on_iteration=lambda i, m: ticks.append(m["psnr"]))
    eval_k_cap = trainer.cfg.opt.raster_k_cap
    ev = evaluate_split(trainer, final, test_frames, cfg.model.white_background, 0)
    counts = dict(kernels.LAUNCHES)
    # the evaluation renders every frame at each k_cap from the trainer's,
    # doubled until nothing drops: the cloth front end once a frame a round
    rounds = round(math.log2(ev["k_cap"] / eval_k_cap)) + 1
    if counts != {"cloth_front": rounds * len(test_frames)}:
        raise RuntimeError(f"dense fit: launched {counts}, expected the cloth front "
                           f"end {rounds} x {len(test_frames)} times (the "
                           f"evaluation) and no compositor kernel")
    if not grown or ev["n_dropped"] != 0 or not all(map(math.isfinite, ticks)) \
            or not math.isfinite(ev["psnr"]):
        raise RuntimeError(f"dense fit: k_cap grew to {grown}, evaluation {ev}, "
                           f"PSNR ticks {ticks}")
    record["fit"] = {"iterations": DENSE_FIT_ITERATIONS, "k_cap_start": DENSE_FIT_K_CAP,
                     "k_cap_grown_to": grown,
                     "eval_k_cap": ev["k_cap"], "eval_n_dropped": ev["n_dropped"],
                     "test_psnr": ev["psnr"], "train_psnr": ticks}
    log(f"dense fit: {DENSE_FIT_ITERATIONS} iterations from k_cap {DENSE_FIT_K_CAP}, "
        f"grown to {grown}, evaluation at k_cap {ev['k_cap']} dropped "
        f"{ev['n_dropped']}, test PSNR {ev['psnr']:.3f} [{gpu}]")
    return record


def parity_phase(gpu: str) -> tuple[dict, dict]:
    """The parity arm at full width through ``parity_bench``'s in-memory
    form (PARITY_ARGV), with the launch counts cleared just before: every
    number finite, the held-out PSNR above the initial state's, and K1, K2
    and K3 launched as often as the run asks and nothing else. Then the same
    fit again in this process: every tensor of its final state, the alive
    count and the line must be the same bits. Returns (the {"parity": ...}
    record, its launches)."""
    import torch

    from cloth_splatting_tpu_torch import kernels, parity_bench

    args = parity_bench.build_parser().parse_args(PARITY_ARGV)
    kernels.LAUNCHES.clear()
    run = parity_bench.run_in_memory(args)
    counts = dict(kernels.LAUNCHES)
    line = run["line"]
    n_test = len(parity_bench.TEST_VIEWS) * args.n_times
    # K1: the ground truth of every view and time, the test split scored
    # before and after the fit (a warm-up, a timed and an export pass each)
    # and the fit's own evaluation; K2 and K3: one camera a static step,
    # three a dynamic one
    # the cloth front end: every K1 frame (the training renders need a
    # gradient)
    static = PARITY_COARSE - 1
    expected = {"K1": args.n_views * args.n_times + 2 * (2 * n_test + 1) + n_test,
                "K2": static + 3 * (PARITY_ITERATIONS - static)}
    expected["K3"] = expected["K2"]
    expected["cloth_front"] = expected["K1"]
    numbers = [line[k] for k in ("value", "ssim", "lpips", "mte_mm")] + [
        v for k, v in run.items() if k not in ("line", "state")]
    if counts != expected:
        raise RuntimeError(f"parity: launches {counts}, expected {expected}")
    if not all(isinstance(v, (int, float)) and math.isfinite(v) for v in numbers):
        raise RuntimeError(f"parity: {run}")
    if not line["value"] > run["test_psnr_before"]:
        raise RuntimeError(f"parity: test PSNR {run['test_psnr_before']:.3f} before "
                           f"the fit, {line['value']} after")
    log(f"parity: {PARITY_ITERATIONS} iterations (the arm's 7,500 cut 25x; static "
        f"{static} of them), {run['n_gaussians']} Gaussians, test PSNR "
        f"{run['test_psnr_before']:.3f} "
        f"-> {line['value']} dB, launches {json.dumps(counts)} [{gpu}]")
    # the same fit again, same seed, same process: every tensor of the final
    # state, the alive count and the held-out PSNR must be the same bits
    again = parity_bench.run_in_memory(args)
    a, b = state_tensors(run["state"]), state_tensors(again["state"])
    differ = [k for k in a if not (a[k].shape == b[k].shape and torch.equal(a[k], b[k]))]
    repeat = {"state_tensors": len(a), "differ": differ,
              "n_gaussians": [run["n_gaussians"], again["n_gaussians"]],
              "test_psnr": [line["value"], again["line"]["value"]],
              "bit_identical": not differ
              and run["n_gaussians"] == again["n_gaussians"]
              and line == again["line"]}
    if not repeat["bit_identical"]:
        raise RuntimeError(f"parity: the fit run twice from one seed differs: {repeat}")
    log(f"parity: the second fit gave the same bits in all {len(a)} state tensors, "
        f"{again['n_gaussians']} Gaussians, test PSNR {again['line']['value']} dB")
    record = {"argv": PARITY_ARGV, "line": line, "launches": counts, "gpu": gpu,
              "repeat": repeat, "test_psnr_before": run["test_psnr_before"],
              "n_gaussians": run["n_gaussians"]}
    return record, counts


def gnn_tensors(state: dict) -> dict:
    """Every tensor of a GNN simulator state by its checkpoint path."""
    from cloth_splatting_tpu_torch.models.meshnet import flat_params

    return flat_params({k: v if isinstance(v, dict) else v._asdict()
                        for k, v in state.items()})


def edge_length_deviation(traj, edge_index, grasped: int, rest) -> float:
    """Mean |edge length - rest length| over the steps after the first and
    the edges not incident to the grasped node (those the real-world
    refinement holds)."""
    free = (edge_index[0] != grasped) & (edge_index[1] != grasped)
    e = edge_index[:, free]
    lengths = (traj[1:, e[0]] - traj[1:, e[1]]).norm(dim=-1)
    return float((lengths - rest[free]).abs().mean())


def gnn_step_vs_cpu(trainer, state: dict, ds, gpu: str) -> dict:
    """One ``trainer.train_step`` at unroll lengths 1 and 3 from ``state``
    against the same step of a CPU trainer from a copy of it, on one batch of
    ``ds`` and the same velocity noise (the limits at TOL_GNN_STEP). The
    gradients are read back from the first moments: one step from zero
    moments leaves mu = 0.1 g. Raises on a miss; returns the readings."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer

    host = MeshnetTrainer(device="cpu", **GNN_TRAINER)
    host_state = gnn_state_on(state, "cpu")
    out = {}
    for future in (1, 3):
        ds.set_future_seq_len(future)
        batch = ds.batch(np.random.default_rng(10 + future), GNN_BATCH)
        noise = torch.from_numpy(np.random.default_rng(20 + future).normal(
            0, GNN_STEP_NOISE, batch["velocity"].shape).astype(np.float32))
        (c_state, c_opt, c_loss), (h_state, h_opt, h_loss) = (
            t.train_step(s, t.init_opt(s), batch, 0, future, noise=noise)
            for t, s in ((trainer, state), (host, host_state)))
        card = {k: v.cpu().double() for k, v in c_opt.mu.items()}
        cpu = {k: v.double() for k, v in h_opt.mu.items()}
        diff = {k: (card[k] - v).norm() for k, v in cpu.items()}
        leaf = {k: float(diff[k] / cpu[k].norm().clamp_min(1e-30)) for k in cpu}
        elem = {k: float((card[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                for k, v in cpu.items()}
        norm = {f"{k}.{f}": float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for k in ("node_norm", "out_norm")
                for f, a, b in zip(h_state[k]._fields, c_state[k], h_state[k])}
        reading = {
            "loss_rel": abs(float(c_loss) - float(h_loss)) / abs(float(h_loss)),
            "grad_rel_all": float(torch.stack(list(diff.values())).norm()
                                  / torch.stack([v.norm() for v in cpu.values()]).norm()),
            "grad_rel_worst_leaf": max(leaf.values()), "worst_leaf": max(leaf, key=leaf.get),
            "grad_elem_rel_of_leaf_max": max(elem.values()),
            "normalizer_max_rel": max(norm.values())}
        out[f"unroll_{future}"] = reading
        if not (reading["loss_rel"] <= TOL_GNN_STEP
                and reading["normalizer_max_rel"] <= TOL_GNN_NORM
                and reading["grad_rel_all"] <= TOL_GNN_GRAD_ALL
                and reading["grad_rel_worst_leaf"] <= TOL_GNN_GRAD_LEAF):
            raise RuntimeError(f"gnn: the card's training step at unroll {future} is "
                               f"not the CPU's: {out}")
    log(f"gnn step, card vs CPU: {json.dumps(out)} [{gpu}]")
    return {**out, "limits": {"loss_rel": TOL_GNN_STEP, "normalizer": TOL_GNN_NORM,
                              "grad_rel_all": TOL_GNN_GRAD_ALL,
                              "grad_rel_worst_leaf": TOL_GNN_GRAD_LEAF},
            "noise_std": GNN_STEP_NOISE}


def gnn_phase(gpu: str, dev=None) -> tuple[dict, dict]:
    """The GNN dynamics at full width (GNN_*): data made on the card by
    ``collect_trajectories`` (trajectory 0 also on the CPU: within
    TOL_GNN_DATA), ``train_meshnet`` over GNN_EPOCHS curriculum epochs with
    a held-out validation rollout each epoch (the loss must fall within each
    unroll length), then the same training again, bit for bit; one training
    step at unroll lengths 1 and 3 against the CPU's (``gnn_step_vs_cpu``);
    a validation rollout (finite per-step MSE), and a real-world rollout of
    GNN_REAL_WORLD_STEPS steps from the held-out start with tracking noise,
    with and without the edge-length refinement
    (refining must lower the mean edge-length deviation from the noise-free
    rest lengths). No kernel of the port may launch. Returns (the
    {"gnn": ...} record, the trained state)."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.data.trajectories import (
        ClothSampleDataset,
        process_trajectory,
    )
    from cloth_splatting_tpu_torch.manipulation.collect import collect_trajectories
    from cloth_splatting_tpu_torch.models.cloth_simulator import (
        init_cloth_simulator,
        rollout,
    )
    from cloth_splatting_tpu_torch.train.meshnet_train import (
        MeshnetTrainer,
        curriculum_future,
        train_meshnet,
    )

    dev = dev or torch.device("cuda")
    kernels.LAUNCHES.clear()
    train_raw = collect_trajectories(GNN_TRAIN_TRAJS, seed=0, device=dev, **GNN_DATA)
    val_raw = collect_trajectories(GNN_VAL_TRAJS, seed=1, device=dev, **GNN_DATA)
    cpu0 = collect_trajectories(1, seed=0, device="cpu", **GNN_DATA)[0]
    data_err = float(np.abs(train_raw[0]["pos"] - cpu0["pos"]).max())
    if not data_err <= TOL_GNN_DATA:
        raise RuntimeError(f"gnn: trajectory 0 on the card is {data_err} from the "
                           f"CPU's (limit {TOL_GNN_DATA})")

    def dataset(raws):
        return ClothSampleDataset(None, GNN_MODEL["input_sequence_length"], 1,
                                  num_samples=GNN_NODES, trajectories=[
                                      process_trajectory(r, num_samples=GNN_NODES)
                                      for r in raws])

    train_ds, val_ds = dataset(train_raw), dataset(val_raw)
    trainer = MeshnetTrainer(device=dev, **GNN_TRAINER)

    def train():
        state = init_cloth_simulator(np.random.default_rng(0), device=dev, **GNN_MODEL)
        return train_meshnet(trainer, state, train_ds, val_ds, n_epochs=GNN_EPOCHS,
                             batch_size=GNN_BATCH, curriculum=True,
                             steps_per_epoch=GNN_STEPS_PER_EPOCH, seed=0)

    state, losses = train()
    counts = dict(kernels.LAUNCHES)
    if counts:
        raise RuntimeError(f"gnn: tile kernels launched on the GNN path: {counts}")
    # the loss falls within each unroll length of the curriculum: an epoch's
    # loss sums its unroll steps' losses, so the last epochs' 3-step loss and
    # the first epochs' 1-step loss are not comparable (both are reported)
    unroll = [curriculum_future(e, GNN_EPOCHS) for e in range(GNN_EPOCHS)]
    stages = {f: [x for x, u in zip(losses, unroll) if u == f] for f in sorted(set(unroll))}
    falls = {"within_each_unroll_length": all(v[-1] < v[0] for v in stages.values()),
             "last_epoch_below_first": losses[-1] < losses[0]}
    if not (all(math.isfinite(x) for x in losses) and falls["within_each_unroll_length"]):
        raise RuntimeError(f"gnn: the loss did not fall within an unroll length: "
                           f"per epoch {losses} (unroll {unroll})")
    again, losses2 = train()
    a, b = gnn_tensors(state), gnn_tensors(again)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    identical = not differ and losses == losses2
    if not identical:
        raise RuntimeError(f"gnn: two trainings from one seed differ: losses {losses} "
                           f"and {losses2}; tensors {differ[:8]}")

    step_vs_cpu = gnn_step_vs_cpu(trainer, state, train_ds, gpu)

    # a validation rollout over the held-out trajectory 0
    item = val_ds.rollout_item(0)
    val = trainer.validate_rollout(state, item)
    n_roll = val["per_step_mse"].shape[0]
    if not np.isfinite(val["per_step_mse"]).all():
        raise RuntimeError(f"gnn: rollout MSE {val['per_step_mse']}")

    # a real-world rollout: the held-out start as a tracker sees it (each
    # point off by GNN_TRACKING_NOISE), the rest lengths of the noise-free
    # mesh, the same steps with and without the refinement (the root
    # generate_rw_predictions.py's 10 Adam steps at lr 1e-3); the clean start
    # too, for the record: the simulated cloth barely stretches, and there
    # the refinement's steps of about lr are larger than what they correct
    def tensor(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype)).to(dev)

    p0, edge_index = item["pos"][0], tensor(item["edge_index"], np.int64)
    grasped = int(item["grasped"])
    d0 = p0[item["edge_index"][0]] - p0[item["edge_index"][1]]
    rest = tensor(np.sqrt((d0 * d0).sum(-1) + 1e-20), np.float32)
    noisy = p0 + np.random.default_rng(SEED).normal(0, GNN_TRACKING_NOISE, p0.shape)
    deviation = {}
    for start, pos0 in (("tracked", noisy), ("clean", p0)):
        for refine in (False, True):
            traj, _ = rollout(state, tensor(pos0, np.float32),
                              tensor(item["init_velocity"], np.float32),
                              tensor(item["node_type"], np.int64), edge_index,
                              tensor(item["actions"], np.float32), grasped,
                              n_steps=GNN_REAL_WORLD_STEPS, real_world=refine,
                              rest_lengths=rest)
            deviation[f"{start}_{'refined' if refine else 'plain'}"] = {
                "mean_edge_length_deviation": edge_length_deviation(
                    traj, edge_index, grasped, rest),
                "finite": bool(torch.isfinite(traj).all())}
    refined, plain = deviation["tracked_refined"], deviation["tracked_plain"]
    if not (refined["finite"] and refined["mean_edge_length_deviation"]
            < plain["mean_edge_length_deviation"]):
        raise RuntimeError(f"gnn: the refinement did not hold edge lengths: {deviation}")

    record = {
        "data": {"trajectories": GNN_TRAIN_TRAJS, "held_out": GNN_VAL_TRAJS,
                 **GNN_DATA, "card_vs_cpu_pos_max_abs_traj0": data_err,
                 "limit": TOL_GNN_DATA},
        "model": {**GNN_MODEL, "mlp_hidden_layers": 2, "nodes": train_ds.n_nodes,
                  "edges_max": train_ds.e_max, "batch": GNN_BATCH},
        "epochs": GNN_EPOCHS, "steps_per_epoch": GNN_STEPS_PER_EPOCH,
        "unroll_by_epoch": unroll,
        "epoch_loss": losses, "loss_falls": falls,
        "second_training_bit_identical": identical,
        "step_card_vs_cpu": step_vs_cpu,
        "validate_rollout": {"steps": n_roll, "mean_mse": val["mean_mse"],
                             "per_step_mse": val["per_step_mse"].tolist()},
        "real_world_rollout": {"steps": GNN_REAL_WORLD_STEPS,
                               "tracking_noise_m": GNN_TRACKING_NOISE, **deviation},
        "tile_kernel_launches": counts, "gpu": gpu}
    log(f"gnn: data card vs CPU {data_err:.3g}, losses {json.dumps(losses)}, the "
        f"second training bit-identical, rollout mean MSE {val['mean_mse']:.4g}, "
        f"tracked start's "
        f"edge-length deviation {plain['mean_edge_length_deviation']:.4g} -> "
        f"{refined['mean_edge_length_deviation']:.4g} refined [{gpu}]")
    return record, state


def gnn_state_on(state: dict, device) -> dict:
    """A copy of a GNN simulator state on ``device``."""
    from cloth_splatting_tpu_torch.models.meshnet import (
        NormalizerState,
        flat_params,
        unflat_params,
    )

    return {"gnn": unflat_params(state["gnn"], {k: v.to(device) for k, v in
                                               flat_params(state["gnn"]).items()}),
            **{k: NormalizerState(*(x.to(device) for x in state[k]))
               for k in ("node_norm", "out_norm")}}


def planning_rollout_vs_cpu(sim_state: dict, gpu: str, dev) -> dict:
    """``MPC.model_rollout`` of PLAN_CFG's candidates on the card and on the
    CPU from one state of the planning episode's estimation mesh (after one
    step of the fixed plan, so the velocity history is not zero): positions
    within TOL_PLAN_ROLLOUT; on the card one eager call, one capture, one
    replay."""
    import numpy as np

    from cloth_splatting_tpu_torch.data.trajectories import process_trajectory
    from cloth_splatting_tpu_torch.manipulation.env import ClothEnv
    from cloth_splatting_tpu_torch.manipulation.mpc import MPC
    from cloth_splatting_tpu_torch.manipulation.planning import _estimator_features
    from cloth_splatting_tpu_torch.manipulation.trajectory_gen import bezier_actions

    c = PLAN_CFG
    env = ClothEnv(seed=c["seed"], device=dev)
    full0 = env.reset()
    pick_idx, pick, place = env.sample_pick_place()
    proc = process_trajectory({"pos": np.stack([full0, full0]),
                               "actions": np.zeros((1, 3), np.float32),
                               "pick": pick, "place": place},
                              num_samples=c["num_samples"], norm_threshold=0.2,
                              seed=c["seed"])
    env.grasp_particle(pick_idx)
    env.step(bezier_actions(pick, place, 0.05, c["traj_len"])[0])
    ids = proc["fps_ids"] if "fps_ids" in proc else None
    from cloth_splatting_tpu_torch.data.meshing import farthest_point_sampling

    ids = farthest_point_sampling(full0[:, [0, 2, 1]], c["num_samples"], seed=c["seed"])
    hist = np.stack([full0[ids], env.positions[ids]])[:, :, [0, 2, 1]].astype(np.float32)
    feats = _estimator_features(proc, hist, c["input_sequence_length"])
    mpcs = {name: MPC(s, c["n_candidates"], c["horizon"], c["input_sequence_length"],
                      seed=c["seed"])
            for name, s in (("card", sim_state), ("cpu", gnn_state_on(sim_state, "cpu")))}
    for m in mpcs.values():
        m.init_sampler(1.0, 1, pick[[0, 2, 1]], place[[0, 2, 1]], c["traj_len"])
    # the card's first call runs eagerly, the second captures its CUDA graph
    # and replays it, the third replays it
    cpu = mpcs["cpu"].model_rollout(feats)
    cards = [mpcs["card"].model_rollout(feats) for _ in range(3)]
    errs = [float(np.abs(card - cpu).max()) for card in cards]
    err = max(errs)
    shape = list(cards[1].shape)
    if shape != [c["n_candidates"], c["horizon"] + 1, c["num_samples"], 3] \
            or not all(np.isfinite(card).all() for card in cards) \
            or not err <= TOL_PLAN_ROLLOUT:
        raise RuntimeError(f"planning: the card's candidate rollouts {shape} (eager, "
                           f"captured call, replay) are {errs} from the CPU's (limit "
                           f"{TOL_PLAN_ROLLOUT})")
    graphs = mpcs["card"].rollouts
    counts = {"captures": graphs.captures, "replays": graphs.replays,
              "eager": graphs.eager}
    if counts != ({"captures": 1, "replays": 1, "eager": 1} if dev.type == "cuda"
                  else {"captures": 0, "replays": 0, "eager": 3}):
        raise RuntimeError(f"planning: model_rollout on the card counted {counts}")
    log(f"planning: model_rollout [{shape}] card vs CPU {errs[0]:.3g} (eager), "
        f"{errs[1]:.3g} (captured call), {errs[2]:.3g} (replay), {counts} [{gpu}]")
    return {"shape": shape, "card_vs_cpu_pos_max_abs": err,
            "eager_captured_and_replay_vs_cpu": errs, "limit": TOL_PLAN_ROLLOUT,
            "graph_calls": counts}


def planning_phase(gpu: str, sim_state: dict, dev=None) -> tuple[dict, dict]:
    """Phase 13: the closed manipulation loop on the card, planning with the
    GNN state the gnn phase trained. Candidate rollouts against the CPU's
    (``planning_rollout_vs_cpu``); one ``mpc-cs`` episode through the
    in-memory path at PLAN_CFG with PLAN_STEPS steps, from launch counts
    cleared just before: finite costs, K2 and K3 launched once per camera
    of every refiner step and no other kernel, a finite refined history of
    [PLAN_STEPS + 1, 64, 3]; the same episode again, bit for bit (costs,
    history, every tensor of the refiner's state); K2 and K3 against their
    plain versions on the pack of the final refiner state's newest camera at
    96x96; then PLAN_STEPS-step episodes of the other four modalities
    (finite costs, no kernel). Returns (the {"planning": ...} record, K2/K3's launches and
    readings at this shape)."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.manipulation.planning import (
        PlanningConfig,
        closed_loop_planning,
    )
    from cloth_splatting_tpu_torch.models.deform import simulator_from_params
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import sorted_pack, tile_size_for
    from cloth_splatting_tpu_torch.render import CameraArrays, project_view

    dev = dev or torch.device("cuda")
    rollout = planning_rollout_vs_cpu(sim_state, gpu, dev)

    cfg = PlanningConfig(modality="mpc-cs", max_steps=PLAN_STEPS, in_memory=True,
                         **PLAN_CFG)
    # one camera a static step; a refine step takes a mid time and its two
    # neighbours once 3 times are observed (step s observes s + 2)
    cams_per_refine = [min(s + 2, 3) for s in range(PLAN_STEPS)]
    expected = cfg.static_steps + cfg.refine_steps * sum(cams_per_refine)
    # the observations (the dense tier, no gradient): every view of the
    # first state and of each step's, the cloth front end once a view
    observed = (PLAN_STEPS + 1) * cfg.n_views

    def episode():
        ep = {}
        kernels.LAUNCHES.clear()
        res = closed_loop_planning(sim_state, cfg, None, device=dev, episode=ep)
        return res, ep, dict(kernels.LAUNCHES)

    res, ep, counts = episode()
    history = ep["history"]
    if counts != {"K2": expected, "K3": expected, "cloth_front": observed}:
        raise RuntimeError(f"planning: mpc-cs launched {counts}, expected K2 and K3 "
                           f"{expected} times each, the cloth front end {observed} "
                           f"times and nothing else")
    if len(res["costs"]) != PLAN_STEPS or not all(map(math.isfinite, res["costs"])):
        raise RuntimeError(f"planning: mpc-cs costs {res['costs']}")
    if history.shape != (PLAN_STEPS + 1, cfg.num_samples, 3) \
            or not np.isfinite(history).all():
        raise RuntimeError(f"planning: refined history {history.shape}, finite "
                           f"{bool(np.isfinite(history).all())}")
    log(f"planning: mpc-cs {PLAN_STEPS} steps, costs "
        f"{json.dumps(res['costs'])}, launches {json.dumps(counts)} [{gpu}]")
    res2, ep2, counts2 = episode()
    a, b = (state_tensors(e["refiner"].state) for e in (ep, ep2))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or res2 != res or counts2 != counts \
            or not np.array_equal(ep2["history"], history):
        raise RuntimeError(f"planning: a second mpc-cs episode differs: costs "
                           f"{res['costs']} and {res2['costs']}, tensors {differ[:8]}")
    del ep2

    # K2 and K3 on one refiner step's pack: the final state's newest camera
    refiner = ep["refiner"]
    trainer, state, scene = refiner.trainer, refiner.state, refiner.scene
    size = cfg.image_size
    cam = CameraArrays(*(f[0, scene.n_times - 1] for f in scene.cam_bank))
    with torch.no_grad():
        proj = project_view(cam, size, size, trainer.tanfovx, trainer.tanfovy,
                            state.params, state.gstate, trainer.mesh,
                            simulator_from_params(state.sim_params),
                            trainer.mesh_predictions, 0)[0]
    tile = tile_size_for(size, size)
    pack = sorted_pack(proj, size // tile, size // tile, tile,
                       order=trainer.cfg.opt.raster_pack_order)
    label = f"planning refiner {size}px"
    k2_err, stats, out_k, tb_k = compare_k2(pack, size, size, tile, label)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    gimg = cotangent_tiles(out_k, size, size, tile, gen)
    k3_err, k3_rel = compare_k3(pack, gimg, tb_k, size, size, tile, label)
    shape = {"width": size, "height": size, "tile": tile, "tiles": (size // tile) ** 2,
             "gaussians_alive": int(state.gstate.alive.sum()),
             "capacity": int(state.gstate.alive.numel()), "walk": stats}
    k_at = {"K2": {**shape, "max_abs_err": k2_err, "launches": counts["K2"]},
            "K3": {**shape, "max_abs_err": k3_err, "max_rel_err": max(k3_rel.values()),
                   "launches": counts["K3"]}}
    log(f"planning: K2/K3 at {size}px: {json.dumps(k_at)} [{gpu}]")
    del ep, refiner

    others = {}
    for modality in PLAN_OTHER_MODALITIES:
        kernels.LAUNCHES.clear()
        r = closed_loop_planning(sim_state if modality.startswith("mpc") else None,
                                 PlanningConfig(modality=modality, max_steps=PLAN_STEPS,
                                                **PLAN_CFG), None, device=dev)
        launched = dict(kernels.LAUNCHES)
        if launched or not all(map(math.isfinite, r["costs"])) \
                or len(r["costs"]) != PLAN_STEPS:
            raise RuntimeError(f"planning: {modality} costs {r['costs']}, kernels "
                               f"launched {launched}")
        others[modality] = r
    log(f"planning: other modalities "
        f"{json.dumps({k: v['costs'] for k, v in others.items()})} [{gpu}]")
    record = {
        "config": {**PLAN_CFG, "max_steps": PLAN_STEPS, "in_memory": True,
                   "gnn": {k: GNN_MODEL[k] for k in ("n_message_passing", "latent")}},
        "reduced": {"max_steps": [PLAN_STEPS_FULL, PLAN_STEPS]},
        "model_rollout": rollout,
        "mpc_cs": {**res, "launches": counts,
                   "launches_expected": {"K2": expected, "K3": expected,
                                         "cloth_front": observed},
                   "cameras_per_refine_step": cams_per_refine,
                   "history_shape": list(history.shape),
                   "second_episode_bit_identical": True},
        "kernels_at_refiner_shape": k_at,
        "other_modalities": others, "gpu": gpu}
    return record, k_at


def legacy_cameras(n: int, size: int, seed: int):
    """``n`` cameras of ``size`` px looking at the origin from the upper
    half of the sphere of radius LEGACY_RADIUS (azimuth uniform, elevation
    in [0.15, 1.2] rad), with LEGACY_FOV: the NeRF-synthetic layout."""
    import numpy as np

    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera

    rng = np.random.default_rng(seed)
    return [orbit_camera(float(az), 1, LEGACY_FOV, size, size, 0.0,
                         radius=LEGACY_RADIUS, elevation=float(el))
            for az, el in zip(rng.random(n), rng.uniform(0.15, 1.2, n))]


def legacy_reference(dev):
    """The free-xyz reference the legacy phase's ground truth is rendered
    from: the bench mesh's vertices (grid_cloth_mesh(128, 128, size=1.4))
    on the wave at t = 0.5, coloured by position, opaque (0.95)."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
    from cloth_splatting_tpu_torch.data.synthetic import cloth_wave
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.image import inverse_sigmoid

    rest = grid_cloth_mesh(LEGACY_REFERENCE_RES, LEGACY_REFERENCE_RES, size=1.4,
                           device="cpu").pos.numpy()
    pts = cloth_wave(rest, 0.5).astype(np.float32)
    colors = (pts - pts.min(0)) / (pts.max(0) - pts.min(0))
    params, state = PG.init_from_point_cloud(np.random.default_rng(SEED), pts,
                                             colors, 0, device=dev)
    params = params._replace(opacity=torch.full_like(
        params.opacity, float(inverse_sigmoid(torch.tensor(0.95)))))
    return params, state


def legacy_render_set(params, state, cams, size: int, sh_degree: int, k_cap: int):
    """Renders of ``cams`` [n, 3, H, W] in [0, 1] (white background) and
    the most instances any of them dropped."""
    import torch

    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS
    from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled

    tan = math.tan(LEGACY_FOV / 2)
    images, dropped = [], 0
    with torch.no_grad():
        for cam in cams:
            proj = PG.project_points_view(params, state, cam, size, size, tan, tan,
                                          sh_degree, max_radius=MAX_SPLAT_RADIUS)
            rgb, _, _, aux = rasterize_tiled(proj, size, size, (1.0, 1.0, 1.0),
                                             k_cap=k_cap, k_chunk=32)
            images.append(torch.clamp(rgb, 0.0, 1.0))
            dropped = max(dropped, int(aux.n_dropped))
    return torch.stack(images), dropped


def legacy_ground_truth(ref, cams, size: int):
    """The reference's renders as the loader hands images to the fit:
    8-bit, truncated (``decode_image``), over [0, 1]; ``k_cap`` doubles
    from LEGACY_GT_K_CAP until no frame drops. Returns (the images, that
    k_cap)."""
    import torch

    k_cap = LEGACY_GT_K_CAP
    while True:
        images, dropped = legacy_render_set(*ref, cams, size, 0, k_cap)
        if dropped == 0:
            break
        k_cap *= 2
    return [(img * 255.0).to(torch.uint8).to(torch.float32) / 255.0
            for img in images], k_cap


def legacy_phase(gpu: str, dev=None) -> dict:
    """Phase 14: ``fit_static_scene_capped`` (the free-xyz model through the
    dense tier, as the root fit_legacy.py runs it) at that script's defaults on a
    scene of NeRF-synthetic size built in memory (``legacy_cameras``,
    ``legacy_reference``, ``load_dnerf_scene``'s init cloud), with the
    launch counts cleared just before: the loss falls, the held-out
    PSNR over LEGACY_TEST_CAMS cameras beats the initial model's, no kernel
    of the port runs; the first LEGACY_REPEAT iterations twice give the same
    bits; LEGACY_SMALL_ITERATIONS iterations at LEGACY_SMALL px on the card
    against the CPU (``legacy_vs_cpu``). The fit's only kernels are the
    point front end's forward and backward, once each an iteration (its
    leaves need a gradient; the dense tier has no kernel). ``dev`` defaults
    to the card. Returns the {"legacy": ...} record."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.data.legacy import dnerf_init_cloud
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.image import psnr
    from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS
    from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled
    from cloth_splatting_tpu_torch.render import camera_arrays
    from cloth_splatting_tpu_torch.train.losses import image_losses

    dev = dev or torch.device("cuda")
    size, tan = LEGACY_SIZE, math.tan(LEGACY_FOV / 2)
    ref = legacy_reference(dev)
    cams = [camera_arrays(c, dev) for c in
            legacy_cameras(LEGACY_TRAIN_CAMS + LEGACY_TEST_CAMS, size, SEED)]
    gts, gt_k_cap = legacy_ground_truth(ref, cams, size)
    train_cams, test_cams = cams[:LEGACY_TRAIN_CAMS], cams[LEGACY_TRAIN_CAMS:]
    train_gts, test_gts = gts[:LEGACY_TRAIN_CAMS], torch.stack(gts[LEGACY_TRAIN_CAMS:])
    cloud = dnerf_init_cloud(LEGACY_POINTS, SEED)
    kw = dict(sh_degree=LEGACY_SH, seed=SEED, k_cap=LEGACY_K_CAP,
              white_background=True, device=dev)

    # the initial model: its held-out PSNR and the loss of the camera that
    # the fit's last iteration renders
    p0, s0 = PG.init_from_point_cloud(np.random.default_rng(SEED), cloud.points,
                                      cloud.colors, LEGACY_SH, device=dev)
    last = (LEGACY_ITERATIONS - 1) % LEGACY_TRAIN_CAMS
    with torch.no_grad():
        # the fit's own renderer: the dense tier at its k_cap, splats capped
        proj0 = PG.project_points_view(p0, s0, train_cams[last], size, size, tan, tan,
                                       LEGACY_SH, max_radius=MAX_SPLAT_RADIUS)
        rgb0 = rasterize_tiled(proj0, size, size, (1.0, 1.0, 1.0), k_cap=LEGACY_K_CAP,
                               k_chunk=32)[0]
        loss0 = float(image_losses(rgb0[None], train_gts[last][None], 0.2)[0])
    img0, drop0 = legacy_render_set(p0, s0, test_cams, size, LEGACY_SH, LEGACY_K_CAP)
    psnr0 = float(psnr(img0, test_gts).mean())

    kernels.LAUNCHES.clear()
    params, state, loss = PG.fit_static_scene_capped(train_cams, train_gts, cloud, size,
                                                     size, tan, tan,
                                                     iterations=LEGACY_ITERATIONS, **kw)
    counts = dict(kernels.LAUNCHES)
    img1, drop_test = legacy_render_set(params, state, test_cams, size, LEGACY_SH,
                                        LEGACY_K_CAP)
    psnr1 = float(psnr(img1, test_gts).mean())
    _, drop_train = legacy_render_set(params, state, train_cams, size, LEGACY_SH,
                                      LEGACY_K_CAP)
    if counts != {"front": LEGACY_ITERATIONS, "front_bwd": LEGACY_ITERATIONS}:
        raise RuntimeError(f"legacy: the dense-tier fit launched {counts}")
    for name, t in params._asdict().items():
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"legacy: non-finite {name}")
    if not (math.isfinite(loss) and loss < loss0):
        raise RuntimeError(f"legacy: loss {loss0:.5f} at the start, {loss:.5f} at "
                           f"iteration {LEGACY_ITERATIONS} (camera {last})")
    if not psnr1 > psnr0:
        raise RuntimeError(f"legacy: held-out PSNR {psnr0:.3f} before the fit, "
                           f"{psnr1:.3f} after")

    # the first LEGACY_REPEAT iterations twice: the same bits
    a, b = (PG.fit_static_scene_capped(train_cams, train_gts, cloud, size, size, tan,
                                       tan, iterations=LEGACY_REPEAT, **kw)
            for _ in range(2))
    differ = [k for k in PG.PointGaussianParams._fields
              if not torch.equal(getattr(a[0], k), getattr(b[0], k))]
    if differ or a[2] != b[2]:
        raise RuntimeError(f"legacy: {LEGACY_REPEAT} iterations twice differ in "
                           f"{differ}, loss {a[2]} / {b[2]}")

    vs_cpu = legacy_vs_cpu(ref, cloud, dev)
    record = {
        "iterations": LEGACY_ITERATIONS, "width": size, "height": size,
        "train_cameras": LEGACY_TRAIN_CAMS, "test_cameras": LEGACY_TEST_CAMS,
        "sh_degree": LEGACY_SH, "k_cap": LEGACY_K_CAP,
        "init_points": LEGACY_POINTS, "reference_points": int(ref[1].alive.sum()),
        "ground_truth_k_cap": gt_k_cap, "loss_start": loss0, "loss_end": loss,
        "test_psnr_before_fit": psnr0,
        "test_psnr": psnr1,
        "dropped_most_a_frame": {"test_start": drop0, "test_end": drop_test,
                                 "train_end": drop_train},
        "launches": counts, "repeat_bit_identical": True, "vs_cpu": vs_cpu,
        "gpu": gpu}
    log(f"legacy: {LEGACY_ITERATIONS} iterations at {size}x{size}; loss {loss0:.5f} -> "
        f"{loss:.5f}; held-out PSNR {psnr0:.3f} -> {psnr1:.3f} dB over "
        f"{LEGACY_TEST_CAMS} cameras; dropped (most a frame) "
        f"{json.dumps(record['dropped_most_a_frame'])} at k_cap {LEGACY_K_CAP}; "
        f"launches {json.dumps(counts)}; {LEGACY_REPEAT} iterations twice bit-identical; "
        f"card vs CPU {json.dumps(vs_cpu)} [{gpu}]")
    return record


def legacy_vs_cpu(ref, cloud, dev) -> dict:
    """At LEGACY_SMALL px on 3 of the sphere's cameras, ``dev`` against the
    CPU: the initial model's front end (``project_points_view``) within
    TOL_LEGACY_FRONT of each field's largest (TOL_LEGACY_CONIC the
    conics), radii equal, and how many
    Gaussians fall in another depth bucket; the dense tier on the card's
    projected inputs, rgb, depth and the L1 + SSIM gradients within
    TOL_DENSE of each one's largest; LEGACY_SMALL_ITERATIONS iterations of
    ``fit_static_scene_capped`` on each device, the losses within
    TOL_LEGACY_LOSS relative and the fitted models' renders at least TOL_LEGACY_RENDER_DB
    apart in PSNR."""
    import numpy as np
    import torch

    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.image import psnr
    from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS
    from cloth_splatting_tpu_torch.ops.rasterize.tiled import DEPTH_BUCKETS, rasterize_tiled
    from cloth_splatting_tpu_torch.ops.sort import quantize_depth
    from cloth_splatting_tpu_torch.render import camera_arrays
    from cloth_splatting_tpu_torch.train.losses import image_losses

    size, tan = LEGACY_SMALL, math.tan(LEGACY_FOV / 2)
    cpu = torch.device("cpu")
    cams = legacy_cameras(3, size, SEED + 1)
    gts, _ = legacy_ground_truth(ref, [camera_arrays(c, dev) for c in cams], size)
    projs, fits = {}, {}
    for where in (dev, cpu):
        wc = [camera_arrays(c, where) for c in cams]
        wg = [g.to(where) for g in gts]
        p0, s0 = PG.init_from_point_cloud(np.random.default_rng(SEED), cloud.points,
                                          cloud.colors, LEGACY_SH, device=where)
        with torch.no_grad():
            projs[where.type] = PG.project_points_view(p0, s0, wc[0], size, size,
                                                       tan, tan, LEGACY_SH,
                                                       max_radius=MAX_SPLAT_RADIUS)
        params, state, loss = PG.fit_static_scene_capped(
            wc, wg, cloud, size, size, tan, tan, sh_degree=LEGACY_SH,
            iterations=LEGACY_SMALL_ITERATIONS, seed=SEED, k_cap=LEGACY_K_CAP,
            white_background=True, device=where)
        fitted, _ = legacy_render_set(params, state, wc, size, LEGACY_SH, LEGACY_K_CAP)
        fits[where.type] = (loss, fitted.cpu())

    def rel(a, b):
        a, b = a.detach().cpu().float(), b.detach().cpu().float()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    card_p, cpu_p = projs[dev.type], projs["cpu"]
    valid = cpu_p.valid
    front = {f: rel(getattr(card_p, f)[valid], getattr(cpu_p, f)[valid])
             for f in ("xy", "depth", "conic", "color", "opacity")}
    buckets = [quantize_depth(p.depth, p.valid, DEPTH_BUCKETS).cpu()
               for p in (card_p, cpu_p)]

    # the dense tier on one set of inputs: the card's projection
    fields = ("xy", "conic", "color", "opacity", "depth")
    raster = {}
    for where in (dev, cpu):
        p = card_p._replace(**{k: getattr(card_p, k).to(where) for k in card_p._fields})
        leaves = {f: getattr(p, f).clone().requires_grad_() for f in fields}
        rgb, depth, _, _ = rasterize_tiled(p._replace(**leaves), size, size,
                                           (1.0, 1.0, 1.0), k_cap=LEGACY_K_CAP)
        loss = image_losses(rgb[None], gts[0].to(where)[None], 0.2)[0]
        raster[where.type] = (rgb, depth, torch.autograd.grad(loss, list(leaves.values())))
    card_r, cpu_r = raster[dev.type], raster["cpu"]
    res = {"front": front,
           "radii_equal": bool(torch.equal(card_p.radius.cpu(), cpu_p.radius)),
           "depth_buckets_differ": int((buckets[0] != buckets[1]).sum()),
           "rgb": rel(card_r[0], cpu_r[0]), "depth": rel(card_r[1], cpu_r[1]),
           "grads": {f: rel(a, b) for f, a, b in zip(fields, card_r[2], cpu_r[2])},
           "loss": abs(fits[dev.type][0] - fits["cpu"][0]) / abs(fits["cpu"][0]),
           "fitted_render_max_abs": float((fits[dev.type][1] - fits["cpu"][1])
                                          .abs().max()),
           "fitted_render_psnr_db": float(psnr(fits[dev.type][1], fits["cpu"][1])
                                          .min())}
    bad = [f for f, v in front.items()
           if not v <= (TOL_LEGACY_CONIC if f == "conic" else TOL_LEGACY_FRONT)]
    bad += [k for k in ("rgb", "depth") if not res[k] <= TOL_DENSE]
    bad += [f for f, v in res["grads"].items() if not v <= TOL_DENSE]
    if not res["radii_equal"]:
        bad.append("radii")
    if not res["loss"] <= TOL_LEGACY_LOSS:
        bad.append("loss")
    if not res["fitted_render_psnr_db"] >= TOL_LEGACY_RENDER_DB:
        bad.append("fitted_render")
    if bad:
        raise RuntimeError(f"legacy: the card disagrees with the CPU in {bad}: {res}")
    return res


def sweep_scene(mesh, scene_seed: int):
    """A ``ClothScene`` of the fit phase's shape held in memory: the mesh on
    the inextensible wave over FIT_TIMES times, FIT_VIEWS orbit views
    rendered at 800x800 by the serving path (target texture from
    ``scene_seed``) into records that carry their uint8 images, and the
    held-out view half way between views 0 and 1, as ``fit_scene``."""
    import dataclasses

    import numpy as np

    from cloth_splatting_tpu_torch.data.scene import (
        CameraGrid,
        ClothScene,
        FrameRecord,
        nerfpp_radius,
    )
    from cloth_splatting_tpu_torch.data.synthetic import (
        cloth_wave_isometric,
        orbit_camera,
        render_scene_banks,
    )

    rest = mesh.pos.cpu().numpy()
    times = np.linspace(0.0, 1.0, FIT_TIMES)
    traj = np.stack([cloth_wave_isometric(rest, t) for t in times]).astype(np.float32)

    def grid(views, n_views):
        _, gt = render_scene_banks(mesh, traj, views, n_views, WIDTH, fov=FOV,
                                   seed=scene_seed, device=mesh.pos.device)
        gt = gt.cpu().numpy()
        return CameraGrid([
            FrameRecord(dataclasses.replace(
                orbit_camera(v, n_views, FOV, WIDTH, HEIGHT, float(times[t])),
                view_id=i, time_id=t), None, f"r_{v}_{t}", image=gt[i, t])
            for i, v in enumerate(views) for t in range(FIT_TIMES)])

    radius = nerfpp_radius([orbit_camera(v, FIT_VIEWS, FOV, WIDTH, HEIGHT, 0.0)
                            for v in range(FIT_VIEWS)])
    return ClothScene(train=grid(list(range(FIT_VIEWS)), FIT_VIEWS),
                      test=grid([1], 2 * FIT_VIEWS), video_cameras=[],
                      initial_mesh=mesh, mesh_predictions=traj, radius=radius,
                      maxtime=1.0, white_background=True)


def sweep_phase(mesh, gpu: str) -> tuple[dict, dict, object, object]:
    """Phase 15: ``train_scenes_parallel`` on the card over two scenes of
    one signature (``sweep_scene`` from SWEEP_SCENE_SEEDS), both placed on
    the one card so that they form one group, on SWEEP_SCHEDULE, with the
    launch counts cleared just before: K2 and K3 launched once per
    camera of every step of both scenes, K1 only by the final evaluation
    (its held-out frames); then scene 1 alone through ``train_scene``:
    every tensor of its state equal to the sweep's, bit for bit. Returns
    (the {"sweep": ...} record, the sweep's launches, scene 1, its lone
    run's final state)."""
    import copy
    import tempfile

    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.parallel.sweep import (
        group_scenes,
        train_scenes_parallel,
    )
    from cloth_splatting_tpu_torch.train.config import Config
    from cloth_splatting_tpu_torch.train.loop import train_scene

    scenes = [sweep_scene(mesh, s) for s in SWEEP_SCENE_SEEDS]
    cfg = Config()
    for key, value in SWEEP_SCHEDULE.items():
        setattr(cfg.opt, key, value)
    devices = [mesh.pos.device] * 2
    groups = group_scenes(scenes, len(devices))
    if groups != [[0, 1]]:
        raise RuntimeError(f"sweep: groups {groups}, expected one of both scenes")
    with tempfile.TemporaryDirectory() as out:
        kernels.LAUNCHES.clear()
        swept = train_scenes_parallel(copy.deepcopy(cfg), scenes,
                                      [f"{out}/s0", f"{out}/s1"], devices=devices,
                                      test_iterations=[SWEEP_ITERATIONS], seed=SEED)
        got = dict(kernels.LAUNCHES)
        lone = train_scene(copy.deepcopy(cfg), scenes[1], f"{out}/lone",
                           test_iterations=[SWEEP_ITERATIONS], seed=SEED,
                           device=mesh.pos.device)
    static = SWEEP_SCHEDULE["static_reconst_iteration"] - 1
    per_scene = static + 3 * (SWEEP_ITERATIONS - static)
    expected = {"K1": 2 * FIT_TIMES, "K2": 2 * per_scene, "K3": 2 * per_scene,
                "cloth_front": 2 * FIT_TIMES}
    if got != expected:
        raise RuntimeError(f"sweep: launches {got}, expected {expected}")
    a, b = state_tensors(swept[1]), state_tensors(lone)
    differ = [k for k in a if not (a[k].shape == b[k].shape and torch.equal(a[k], b[k]))]
    if differ:
        raise RuntimeError(f"sweep: scene 1 differs from its lone train_scene in {differ}")
    for i, st in enumerate(swept):
        for name, t in state_tensors(st).items():
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"sweep: scene {i} non-finite {name}")
        if int(st.step) != SWEEP_ITERATIONS:
            raise RuntimeError(f"sweep: scene {i} step {int(st.step)}")
    if torch.equal(swept[0].params.features_dc, swept[1].params.features_dc):
        raise RuntimeError("sweep: the two scenes ended equal")
    record = {
        "scenes": len(scenes), "devices": [str(d) for d in devices],
        "groups": groups,
        "iterations": SWEEP_ITERATIONS, "schedule": SWEEP_SCHEDULE,
        "views": FIT_VIEWS, "times": FIT_TIMES, "width": WIDTH, "height": HEIGHT,
        "alive_end": [int(st.gstate.alive.sum()) for st in swept],
        "launches": got, "state_tensors": len(a), "lone_bit_identical": True,
        "gpu": gpu}
    log(f"sweep: {len(scenes)} scenes x {SWEEP_ITERATIONS} iterations in one group on "
        f"one card; scene 1 alone: all {len(a)} state tensors bit-identical to the "
        f"sweep's; launches {json.dumps(got)} [{gpu}]")
    return record, got, scenes[1], lone


def held_step_errors(got, got_m, ref, ref_m) -> dict:
    """A sharded step's full state and metrics against the Trainer's step
    from the same state: the metrics' relative differences, face_bary's
    largest, grad_accum's elements beyond TOL_MESH, the integer and boolean
    tensors that differ, and the rest of the float state
    (``float_state_errors``)."""
    import torch

    g, r = state_tensors(got), state_tensors(ref)
    accum = (g["gstate.grad_accum"] - r["gstate.grad_accum"]).abs()
    return {"metrics_rel": {k: abs(float(getattr(got_m, k)) - float(getattr(ref_m, k)))
                            / abs(float(getattr(ref_m, k))) for k in ("loss", "psnr", "l1")},
            "face_bary_abs": float((g["params.face_bary"] - r["params.face_bary"]).abs().max()),
            "grad_accum_abs": float(accum.max()),
            "grad_accum_over_limit": int((accum > TOL_MESH["accum"][1] + TOL_MESH["accum"][0]
                                          * r["gstate.grad_accum"].abs()).sum()),
            "ints_differ": [k for k, v in r.items()
                            if not v.is_floating_point() and not torch.equal(g[k], v)],
            **float_state_errors(g, r)}


def float_state_errors(g: dict, r: dict) -> dict:
    """tests/test_torch_mesh.py's ``state_errors`` over ``state_tensors``
    names ``g`` against ``r``: each optimizer's moments (the largest
    difference over the optimizer's largest moment of that kind, so a leaf
    whose gradient is at rounding level does not set the scale), the
    Gaussian and simulator parameters (over the leaf's largest, at the
    elements whose first moment is at least CLEAR_GRAD of the optimizer's
    largest: Adam turns a rounding-level gradient into a step of the
    learning rate's size), the other float bookkeeping (max_radii2d, denom;
    over each leaf's largest) and, reported only, each simulator leaf's
    largest difference over every element."""
    def big(keys):
        return max(max(float(r[k].abs().max()) for k in keys), 1e-30)

    out = {}
    for opt, params in (("g_opt", "params"), ("sim_opt", "sim_params")):
        for m in ("mu", "nu"):
            keys = [k for k in r if k.startswith(f"{opt}.{m}.")]
            out[f"{opt}.{m}"] = max(float((g[k] - r[k]).abs().max()) for k in keys) / big(keys)
        mu_big = big([k for k in r if k.startswith(f"{opt}.mu.")])
        worst = 0.0
        for k in [k for k in r if k.startswith(f"{params}.")]:
            clear = r[f"{opt}.mu.{k[len(params) + 1:]}"].abs() >= CLEAR_GRAD * mu_big
            if bool(clear.any()):
                worst = max(worst, float((g[k] - r[k]).abs()[clear].max()) / big([k]))
        out[params] = worst
    keys = [k for k in r if k.startswith("gstate.") and r[k].is_floating_point()
            and k != "gstate.grad_accum"]
    out["gstate"] = max(float((g[k] - r[k]).abs().max()) / big([k]) for k in keys)
    out["sim_params_abs"] = {k[len("sim_params."):]: float((g[k] - r[k]).abs().max())
                             for k in r if k.startswith("sim_params.")}
    return out


def mesh_train_cell(device, shapes, steps: int, held: bool = False) -> dict:
    """One rank's share of the mesh phase's train steps: ``bench.train_setup``'s
    65k cell at full width in (view x time) banks; on rank 0 first ``steps``
    unsharded ``Trainer.step_banked`` steps, then, on every rank, a warm-up
    step and ``steps`` sharded steps (``ShardedTrainer.step_banked``) on a
    mesh of each of ``shapes``, all from the same state, the launch counts
    cleared just before and read just after. With ``held``, each mesh's
    ``steps`` again, each held to the Trainer's step from the same (gathered)
    state (``held_step_errors``). Returns rank 0's record (per mesh and for
    the Trainer: state tensors on the CPU, losses, launches, the held steps'
    errors), None on the other ranks."""
    import torch
    import torch.distributed as dist

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.bench import train_setup
    from cloth_splatting_tpu_torch.parallel.mesh import make_mesh
    from cloth_splatting_tpu_torch.parallel.trainer import ShardedTrainer
    from cloth_splatting_tpu_torch.render import CameraArrays
    from cloth_splatting_tpu_torch.train.step import StepCarry

    trainer, state0, cams, _ = train_setup(WIDTH, HEIGHT, MESH_RES, TRAIN_CAPACITY, device)
    cam_bank = CameraArrays(*(f[None] for f in cams))
    gt_bank = torch.full((1, len(TRAIN_TIMES), 3, HEIGHT, WIDTH), 128,
                         dtype=torch.uint8, device=device)
    t_ids = list(range(len(TRAIN_TIMES)))
    lead = dist.get_rank() == 0

    def run(runner, state):
        def one(st, carry):
            return runner.step_banked(st, cam_bank, gt_bank, None, 0, t_ids,
                                      sh_degree=1, static=False, carry=carry)

        one(state, StepCarry.zeros(device))          # warm-up, discarded
        kernels.LAUNCHES.clear()
        carry, metrics = StepCarry.zeros(device), []
        for _ in range(steps):
            state, m, carry = one(state, carry)
            metrics.append(m)
        return state, {
            "launches": dict(kernels.LAUNCHES),
            "metrics": [{k: float(v) for k, v in x._asdict().items()} for x in metrics],
            "carry": {k: float(v) for k, v in carry._asdict().items()}}

    out = {}
    if lead:
        state, rec = run(trainer, state0)
        rec["state"] = {k: v.cpu() for k, v in state_tensors(state).items()}
        out["trainer"] = rec
    for shape in shapes:
        runner = ShardedTrainer(trainer, make_mesh(data=shape[0]))
        state, rec = run(runner, runner.place_state(state0))
        full = runner.host_state(state)
        rec["state"] = {k: v.cpu() for k, v in state_tensors(full).items()}
        if held:
            rec["held"], state = [], runner.place_state(state0)
            for _ in range(steps):
                before = runner.host_state(state)
                state, m, _ = runner.step_banked(state, cam_bank, gt_bank, None, 0, t_ids,
                                                 sh_degree=1, static=False)
                after = runner.host_state(state)
                if lead:
                    ref, ref_m = trainer.step_banked(before, cam_bank, gt_bank, None, 0,
                                                     t_ids, sh_degree=1, static=False)
                    rec["held"].append(held_step_errors(after, m, ref, ref_m))
        out[f"{shape[0]}x{shape[1]}"] = rec
    return out if lead else None


def mesh_gnn(device, train_raw: list, data_parallel: bool) -> dict:
    """The GNN cut (MESH_GNN_EPOCHS epochs of one step at the gnn phase's
    width) from the gnn phase's data: per-step losses and the trained
    tensors on the CPU; data-parallel over the initialized world when asked."""
    import numpy as np

    from cloth_splatting_tpu_torch.data.trajectories import (
        ClothSampleDataset,
        process_trajectory,
    )
    from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer, train_meshnet

    ds = ClothSampleDataset(None, GNN_MODEL["input_sequence_length"], 1,
                            num_samples=GNN_NODES, trajectories=[
                                process_trajectory(r, num_samples=GNN_NODES)
                                for r in train_raw])
    trainer = MeshnetTrainer(device=device, **GNN_TRAINER)
    state = init_cloth_simulator(np.random.default_rng(0), device=device, **GNN_MODEL)
    state, losses = train_meshnet(trainer, state, ds, None, n_epochs=MESH_GNN_EPOCHS,
                                  batch_size=GNN_BATCH, curriculum=True,
                                  steps_per_epoch=1, seed=0, data_parallel=data_parallel)
    return {"losses": losses,
            "tensors": {k: v.cpu() for k, v in gnn_tensors(state).items()}}


def mesh_nccl_rank(device, scene, train_raw) -> dict:
    """The mesh phase's world of one NCCL rank: the train cell at 1x1, then
    ``train_scene(device_mesh=1x1)`` on the sweep phase's scene, then the
    train command's rank path on it (``mesh_cli``), each with the launch
    counts cleared just before, then the GNN cut data-parallel."""
    import copy
    import tempfile

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.train.config import Config
    from cloth_splatting_tpu_torch.train.loop import train_scene_rank

    out = {"train": mesh_train_cell(device, [(1, 1)], MESH_STEPS)}
    cfg = Config()
    for key, value in SWEEP_SCHEDULE.items():
        setattr(cfg.opt, key, value)
    with tempfile.TemporaryDirectory() as tmp:
        kernels.LAUNCHES.clear()
        state = train_scene_rank(device, (1, 1), copy.deepcopy(cfg), scene, tmp,
                                 {"test_iterations": [SWEEP_ITERATIONS], "seed": SEED})
        out["scene"] = {"state": state_tensors(state),
                        "launches": dict(kernels.LAUNCHES)}
    out["cli"] = mesh_cli(device, scene, state)
    out["gnn"] = mesh_gnn(device, train_raw, True)
    return out


def mesh_cli(device, scene, template) -> dict:
    """``python -m cloth_splatting_tpu_torch.train --mesh 1x1`` as a rank of
    the running NCCL world runs it (``parallel.launch.main_rank``), on the
    sweep phase's scene (handed to the command's scene loader: it is held
    in memory) with the sweep's schedule and seed, the live viewer
    listening on a free port, so that the viewer's agreement over the world
    (``parallel.mesh.agree``, an NCCL all-reduce) runs before the loop and
    at every iteration; no evaluation and no PLY, one checkpoint at the
    end. Returns the checkpoint's state (restored into ``template``'s
    layout), the agreements counted and the launches."""
    import tempfile
    from unittest import mock

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.data import scene as scene_module
    from cloth_splatting_tpu_torch.parallel import mesh as PM
    from cloth_splatting_tpu_torch.parallel.launch import main_rank
    from cloth_splatting_tpu_torch.train.loop import load_train_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-s", "sweep-scene-1", "-m", tmp, "--mesh", "1x1", "--seed", str(SEED),
                "--port", "0", "--quiet", "--test_iterations", "0",
                "--save_iterations", "0", "--checkpoint_iterations", str(SWEEP_ITERATIONS)]
        for key, value in SWEEP_SCHEDULE.items():
            argv += [f"--{key}", str(value)]
        PM.COUNTS.clear()
        kernels.LAUNCHES.clear()
        with mock.patch.object(scene_module, "load_cloth_scene", lambda *a, **k: scene):
            main_rank(device, "cloth_splatting_tpu_torch.train.__main__", argv)
        launches = dict(kernels.LAUNCHES)
        state = load_train_checkpoint(f"{tmp}/chkpnt{SWEEP_ITERATIONS}.npz", template)
    return {"state": state_tensors(state), "agreed": PM.COUNTS["all_reduce_max/world"],
            "launches": launches}


def mesh_gloo_rank(device, train_raw) -> dict | None:
    """The mesh phase's two gloo ranks sharing the card: the train cell on
    MESH_GLOO_SHAPES, then the GNN cut data-parallel (16 samples a rank)."""
    import torch.distributed as dist

    out = {"train": mesh_train_cell(device, MESH_GLOO_SHAPES, MESH_GLOO_STEPS, held=True),
           "gnn": mesh_gnn(device, train_raw, True)}
    return out if dist.get_rank() == 0 else None


def mesh_phase(gpu: str, scene, lone, dev=None) -> tuple[dict, dict]:
    """Phase 16, the multi-device layer (``parallel/{launch,mesh,trainer}.py``),
    which one card can run two ways: a world of one NCCL rank
    (``parallel.launch``, the production backend) and two gloo ranks sharing
    the card (NCCL refuses two ranks on one GPU). Real multi-card speed is
    not measured. (1) NCCL, 1x1: MESH_STEPS sharded steps of the 65k train
    cell bit-identical to as many ``Trainer.step_banked`` steps from the same
    state, K2 and K3 launched 3 times a step; (2) NCCL, 1x1:
    ``train_scene(device_mesh=...)`` on the sweep phase's scene 1 with its
    schedule: every state tensor bit-identical to the sweep phase's lone
    run (``lone``), K2/K3 once per camera of every step, K1 only by the
    evaluation; then ``train --mesh 1x1`` (``mesh_cli``) on the same scene:
    its checkpoint bit-identical to the lone run, the viewer agreed over
    NCCL once before the loop and once an iteration, K2/K3 as before;
    (3) gloo, 2x1 and 1x2: MESH_GLOO_STEPS steps each (K2/K3
    once per camera a rank renders: 2x1, the batch padded to 4, 2 a rank;
    1x2, all 3) and as many more, each within TOL_MESH of the Trainer's
    step from the same state, every float tensor of the state held
    (``float_state_errors``); (4) the GNN cut
    data-parallel, on the NCCL rank against the single process (loss within
    TOL_MESH_GNN_LOSS at every step, parameters TOL_MESH_GNN_PARAMS) and on
    the two gloo ranks (loss TOL_GNN_STEP). Returns (the {"mesh": ...}
    record, K1/K2/K3 launches of the mesh paths)."""
    import dataclasses

    import torch

    from cloth_splatting_tpu_torch.manipulation.collect import collect_trajectories
    from cloth_splatting_tpu_torch.models.gaussians import Mesh
    from cloth_splatting_tpu_torch.parallel.launch import launch

    dev = dev or torch.device("cuda")
    train_raw = collect_trajectories(GNN_TRAIN_TRAJS, seed=0, device=dev, **GNN_DATA)
    cpu_scene = dataclasses.replace(
        scene, initial_mesh=Mesh(*(t.cpu() for t in scene.initial_mesh)))
    nccl = launch(mesh_nccl_rank, 1, dev, args=(cpu_scene, train_raw))[0]
    gloo = launch(mesh_gloo_rank, 2, dev, args=(train_raw,), backend="gloo",
                  devices=[dev] * 2)[0]
    single = mesh_gnn(dev, train_raw, False)

    failures = []
    n_cams = len(TRAIN_TIMES)
    # (1) the train cell on the world of one
    tr = nccl["train"]
    a, b = tr["1x1"]["state"], tr["trainer"]["state"]
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    same_metrics = tr["1x1"]["metrics"] == tr["trainer"]["metrics"]
    if differ or not same_metrics:
        failures.append(f"1x1 NCCL steps differ from the Trainer's: tensors {differ[:8]}, "
                        f"metrics equal {same_metrics}")
    for name in ("1x1", "trainer"):
        want = {"K2": n_cams * MESH_STEPS, "K3": n_cams * MESH_STEPS}
        if tr[name]["launches"] != want:
            failures.append(f"{name} launches {tr[name]['launches']}, expected {want}")
    # (2) train_scene on the world of one against the sweep's lone run
    sc = nccl["scene"]
    lone_t = {k: v.cpu() for k, v in state_tensors(lone).items()}
    scene_differ = [k for k in lone_t if not torch.equal(sc["state"][k], lone_t[k])]
    if scene_differ:
        failures.append(f"train_scene on 1x1 differs from the lone run: {scene_differ[:8]}")
    static = SWEEP_SCHEDULE["static_reconst_iteration"] - 1
    per_scene = static + 3 * (SWEEP_ITERATIONS - static)
    want = {"K1": FIT_TIMES, "K2": per_scene, "K3": per_scene,
            "cloth_front": FIT_TIMES}
    if sc["launches"] != want:
        failures.append(f"train_scene on 1x1 launches {sc['launches']}, expected {want}")
    # (2b) the train command's rank path on the world of one
    cli = nccl["cli"]
    cli_differ = [k for k in lone_t if not torch.equal(cli["state"][k], lone_t[k])]
    if cli_differ:
        failures.append(f"train --mesh 1x1 differs from the lone run: {cli_differ[:8]}")
    if cli["agreed"] != SWEEP_ITERATIONS + 1:
        failures.append(f"train --mesh 1x1 agreed {cli['agreed']} times over NCCL, "
                        f"expected {SWEEP_ITERATIONS + 1}")
    want = {"K2": per_scene, "K3": per_scene}
    if cli["launches"] != want:
        failures.append(f"train --mesh 1x1 launches {cli['launches']}, expected {want}")
    # (3) two gloo ranks sharing the card
    errors = {}
    for shape in MESH_GLOO_SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        got, ref = gloo["train"][name], gloo["train"]["trainer"]
        # the free run's drift from the Trainer's run (not gated: over free
        # steps the rounding of the ranks' sums moves every vertex)
        drift = float((got["state"]["params.face_bary"]
                       - ref["state"]["params.face_bary"]).abs().max())
        errors[name] = {"held": got["held"], "free_running_face_bary_abs": drift}
        per_rank = -(-n_cams // shape[0]) * MESH_GLOO_STEPS
        if got["launches"] != {"K2": per_rank, "K3": per_rank}:
            failures.append(f"gloo {name} rank 0 launches {got['launches']}, expected "
                            f"{per_rank} each")
        for k, e in enumerate(got["held"]):
            if (max(e["metrics_rel"].values()) > TOL_MESH["metrics"]
                    or e["face_bary_abs"] > TOL_MESH["bary"] or e["grad_accum_over_limit"]
                    or e["ints_differ"]
                    or max(e[k] for k in ("g_opt.mu", "g_opt.nu", "sim_opt.mu",
                                          "sim_opt.nu")) > TOL_MESH["moments"]
                    or max(e["params"], e["sim_params"], e["gstate"]) > TOL_MESH["params"]):
                failures.append(f"gloo {name} step {k} against the Trainer's step from "
                                f"the same state: {json.dumps(e)}")
    # (4) the GNN cut
    gnn = {}
    for name, run, tol in (("nccl_1", nccl["gnn"], TOL_MESH_GNN_LOSS),
                           ("gloo_2", gloo["gnn"], TOL_GNN_STEP)):
        rel = [abs(x - y) / abs(y) for x, y in zip(run["losses"], single["losses"])]
        params = max(float((run["tensors"][k] - single["tensors"][k]).abs().max())
                     for k in single["tensors"])
        bits = (run["losses"] == single["losses"]
                and all(torch.equal(run["tensors"][k], single["tensors"][k])
                        for k in single["tensors"]))
        gnn[name] = {"loss_rel": rel, "params_abs": params, "bit_identical": bits,
                     "losses": run["losses"]}
        if not max(rel) <= tol or (name == "nccl_1" and not params <= TOL_MESH_GNN_PARAMS):
            failures.append(f"gnn {name} against the single process: {json.dumps(gnn[name])}")
    if failures:
        raise RuntimeError("mesh: " + "; ".join(failures))

    launches = {k: sum(r["launches"].get(k, 0) for r in
                       (tr["1x1"], sc, cli, gloo["train"]["2x1"], gloo["train"]["1x2"]))
                for k in ("K1", "K2", "K3", "cloth_front")}
    record = {
        "nccl_1x1": {"steps": MESH_STEPS, "bit_identical": True,
                     "launches": tr["1x1"]["launches"]},
        "train_scene_1x1": {"iterations": SWEEP_ITERATIONS,
                            "bit_identical_to_lone": True, "launches": sc["launches"]},
        "train_cli_1x1": {"iterations": SWEEP_ITERATIONS,
                          "bit_identical_to_lone": True, "nccl_agreements": cli["agreed"],
                          "launches": cli["launches"]},
        "gloo_shared_card": {"steps": MESH_GLOO_STEPS,
                             **{n: {"errors": errors[n],
                                    "rank0_launches": gloo["train"][n]["launches"]}
                                for n in errors},
                             "note": "two ranks on one card over gloo: a check, not a "
                                     "multi-card speed"},
        "gnn": {**gnn, "single_losses": single["losses"], "epochs": MESH_GNN_EPOCHS,
                "batch": GNN_BATCH},
        "launches": launches, "gpu": gpu}
    log(f"mesh: NCCL 1x1 {MESH_STEPS} steps bit-identical to the Trainer's; "
        f"train_scene 1x1 and train --mesh 1x1 ({cli['agreed']} viewer agreements "
        f"over NCCL) bit-identical to the lone run; gloo shared card "
        f"{', '.join(errors)}, each step against the Trainer's from the same state: "
        f"largest face_bary "
        f"{max(e['face_bary_abs'] for n in errors for e in errors[n]['held']):.3g}, "
        f"metrics {max(max(e['metrics_rel'].values()) for n in errors for e in errors[n]['held']):.3g}; "
        f"gnn {json.dumps({n: (max(g['loss_rel']), g['params_abs'], g['bit_identical']) for n, g in gnn.items()})} "
        f"[{gpu}]")
    return record, launches


# the plain 3DGS serving path at the benchmark's gs-360-3m configuration: a
# fixed camera of its orbit-360 ranges (azimuth, elevation rad, radius)
POINTS_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "benchmark", "configs", "gs-360-3m.json")
POINTS_CAMERA = (0.7, 0.25, 3.6)


def bits_differ(got, want) -> dict:
    """Elements of each field of two ``ProjectedGaussians`` whose bits
    differ."""
    import torch

    return {f: int((a != b).sum()) if a.dtype == torch.bool
            else int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for f, a, b in zip(got._fields, got, want)}


def points_phase(gpu: str, usage: dict, occupancy: dict, dev=None) -> dict:
    """``models.point_gaussians.render_points`` without a gradient on the
    gs-360-3m field (3.0M free-xyz Gaussians drawn from SEED as the
    benchmark's ``render-gs360`` cell draws them, SH 3, uncapped splats) at
    1237x822, 39 x 26 tiles of 32 px whose last column and row are partial:
    one frame with the launch counts cleared just before and read just
    after (K1 and the point front end's kernel once each, nothing else), the
    pack of that frame made again and holding as many instances as the
    frame's binning emitted, K1 on it bit-identical to the frame and within
    TOL_PLAIN of its plain walk (the depth channel relative to the deepest
    Gaussian); then K1 alone on that pack (torch.profiler), its bound
    (``roofline``) on the frame's pixels, its registers and blocks an SM
    (the one K1 instance the 65k entry also reads). The point front end:
    ``models.point_gaussians.COUNTS`` adds one kernel call and no PyTorch
    call in the counted frame; on the frame's camera its eight outputs equal
    the PyTorch ops' (``project_points_eager``) bit for bit; the kernel
    alone (torch.profiler), its bound, registers and blocks an SM."""
    import ctypes

    import torch

    from benchmark.drivers.render_points import camera, make_field
    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops import point_front as PF
    from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as TF
    from cloth_splatting_tpu_torch.render import CameraArrays

    dev = dev or torch.device("cuda")
    with open(POINTS_CONFIG) as f:
        cfg = json.load(f)
    img = cfg["image"]
    w, h, sh = img["width"], img["height"], cfg["sh_degree"]
    tan_x = img["tan_half_fov_x"]
    tan_y = tan_x * h / w
    bg = tuple(float(c) for c in img["background"])
    n = cfg["gaussians"]
    params = PG.PointGaussianParams(**make_field(cfg, SEED, dev))
    state = PG.PointGaussianState(
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        max_radii2d=torch.zeros(n, device=dev), grad_accum=torch.zeros(n, device=dev),
        denom=torch.zeros(n, device=dev))
    cam_m = camera(POINTS_CAMERA, tan_x, tan_y, dev)
    cam = CameraArrays(world_view=cam_m["world_view"], full_proj=cam_m["full_proj"],
                       camera_center=cam_m["center"],
                       time=torch.zeros((), device=dev))

    def frame():
        return PG.render_points(params, state, cam, w, h, tan_x, tan_y, bg, sh)[0]

    frame()                                  # warm-up (allocator, the build)
    kernels.LAUNCHES.clear()
    emitted = TF.COUNTS["instances"]
    fronts = dict(PG.COUNTS)
    rgb = frame()
    launches = dict(kernels.LAUNCHES)
    emitted = TF.COUNTS["instances"] - emitted
    fronts = {k: PG.COUNTS[k] - fronts.get(k, 0) for k in ("front_fused", "front_eager")}
    if launches != {"K1": 1, "front": 1}:
        raise RuntimeError(f"points frame launched {launches}")
    if fronts != {"front_fused": 1, "front_eager": 0}:
        raise RuntimeError(f"points frame's front end ran {fronts}")

    tile = TF.tile_size_for(w, h)
    tw, th = TF.tile_grid(w, h, tile)
    with torch.no_grad():
        proj = PG.project_points_view(params, state, cam, w, h, tan_x, tan_y, sh)
        eager = PG.project_points_eager(params, state.alive, cam, w, h, tan_x, tan_y, sh)
    front_differ = bits_differ(proj, eager)
    del eager
    if any(front_differ.values()):
        raise RuntimeError(f"points front end: the kernel's outputs differ from the "
                           f"PyTorch ops' in {front_differ} elements")

    def fused_front():
        return PF.project_points_fused(params, state.alive, cam, w, h, tan_x, tan_y, sh)

    front_kernel_ms, front_records = kernel_alone_ms(fused_front, "front")
    front_bound = roofline("front", {"gaussians": n})
    query = kernels.load("point_front").point_front_blocks_per_sm
    query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
    front_occupancy = query(sh)
    packed = TF.sorted_pack(proj, tw, th, tile, order="exact")
    instances = int(packed.counts.to(torch.int64).sum())
    if instances != emitted:
        raise RuntimeError(f"points pack holds {instances} instances, the frame's "
                           f"binning emitted {emitted}")
    label = f"gs-360-3m {w}x{h}"
    # the field's depths reach ~55 (the background shell): its depth channel
    # is held to TOL_PLAIN relative to the deepest valid Gaussian
    depth_scale = max(1.0, float(proj.depth[proj.valid].max()))
    err, stats = compare_k1(packed, w, h, tile, label, depth_scale=depth_scale)
    out_k = TF.raster_forward_tiles(packed, w, h, tile, bg)
    if not torch.equal(rgb, TF.tiles_to_images(out_k, w, h, tile)[0]):
        raise RuntimeError(f"{label}: render_points' frame is not K1's output")
    del out_k
    kernel_ms, records = kernel_alone_ms(
        lambda: TF.raster_forward_tiles(packed, w, h, tile, bg), "K1")
    valid = int(proj.valid.sum())
    b = roofline("K1", {"gaussians": valid, "pixels": w * h,
                        "pairs": stats["pairs_contributing"]})
    record = {"gaussians": n, "valid": valid, "width": w,
              "height": h, "tile": tile, "tiles": tw * th, "instances": instances,
              "launches": launches["K1"], "max_abs_err": err,
              "depth_scale": depth_scale, "walk": stats, "kernel_ms": kernel_ms,
              "kernel_ms_records": records, **b,
              "share_of_bound": b["bound_ms"] / kernel_ms,
              "registers": (usage.get(KERNEL_ENTRIES["K1"]) or {}).get("registers"),
              "blocks_per_sm": occupancy["K1"],
              "front": {"counts": fronts, "launches": launches["front"],
                        "bits_differ": front_differ,
                        "kernel_ms": front_kernel_ms,
                        "kernel_ms_records": front_records, **front_bound,
                        "share_of_bound": front_bound["bound_ms"] / front_kernel_ms,
                        "usage": usage.get(KERNEL_ENTRIES["front"]),
                        "blocks_per_sm": front_occupancy},
              "gpu": gpu}
    log(f"points serving path [{label}]: {json.dumps(record)}")
    del params, state, proj, packed, rgb
    torch.cuda.empty_cache()
    return record


# the training compositors on partial tiles: a crop of the gs-360-3m frame
# from this corner keeps its partial last column (21 px) and row (22 px) of
# 32 px tiles
TRAIN_POINTS_CROP = (960, 576)


def crop_proj(proj, x0: int, y0: int, width: int, height: int):
    """The projected Gaussians seen by the window [x0, x0 + width) x [y0,
    y0 + height) of the frame, in the window's pixel coordinates: the valid
    ones whose rect meets it."""
    import torch

    xy = proj.xy - torch.tensor([float(x0), float(y0)], device=proj.xy.device)
    r = proj.radius
    valid = (proj.valid & (xy[:, 0] + r > 0) & (xy[:, 0] - r < width)
             & (xy[:, 1] + r > 0) & (xy[:, 1] - r < height))
    return proj._replace(xy=xy, valid=valid, radius=torch.where(valid, r,
                                                                torch.zeros_like(r)))


def train_points_phase(gpu: str, usage: dict, dev=None) -> dict:
    """K2 and K3 on the gs-360-3m field (3.0M Gaussians drawn from SEED,
    uncapped splats, in FRONT_BWD_SLOTS slots) seen from POINTS_CAMERA at
    1237x822, whose last column and row of 32 px tiles are partial: on the
    whole frame K2 and K3 launched once each, finite, every boundary of a
    pixel off the frame 0, and the instances the frame's binning emitted;
    then the point front end's backward on the frame's K3 gradients
    (``front_bwd_gate``); on the crop from TRAIN_POINTS_CROP, the same
    partial tiles, each against its plain version (``compare_k2``,
    ``compare_k3`` at TOL_K3_DEEP), and again on that corner cut to whole
    tiles."""
    import torch

    from benchmark.drivers.render_points import camera, make_field
    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as TF
    from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as TT
    from cloth_splatting_tpu_torch.render import CameraArrays

    dev = dev or torch.device("cuda")
    with open(POINTS_CONFIG) as f:
        cfg = json.load(f)
    img = cfg["image"]
    w, h, sh = img["width"], img["height"], cfg["sh_degree"]
    tan_x = img["tan_half_fov_x"]
    tan_y = tan_x * h / w
    n, slots = cfg["gaussians"], FRONT_BWD_SLOTS
    field = make_field(cfg, SEED, dev)
    free = {k: torch.zeros((slots - n,) + tuple(v.shape[1:]), device=dev)
            for k, v in field.items()}
    free["rotation"][:, 0] = 1.0
    params = PG.PointGaussianParams(**{k: torch.cat([v, free[k]]).contiguous()
                                       for k, v in field.items()})
    del field, free
    alive = torch.zeros(slots, dtype=torch.bool, device=dev)
    alive[:n] = True
    state = PG.PointGaussianState(
        alive=alive, max_radii2d=torch.zeros(slots, device=dev),
        grad_accum=torch.zeros(slots, device=dev), denom=torch.zeros(slots, device=dev))
    cam_m = camera(POINTS_CAMERA, tan_x, tan_y, dev)
    cam = CameraArrays(world_view=cam_m["world_view"], full_proj=cam_m["full_proj"],
                       camera_center=cam_m["center"], time=torch.zeros((), device=dev))
    with torch.no_grad():
        proj = PG.project_points_view(params, state, cam, w, h, tan_x, tan_y, sh)
    del state
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tile = TF.tile_size_for(w, h)
    tw, th = TF.tile_grid(w, h, tile)
    emitted = TF.COUNTS["instances"]
    packed = TF.sorted_pack(proj, tw, th, tile, order="exact")
    emitted = TF.COUNTS["instances"] - emitted
    instances = int(packed.counts.to(torch.int64).sum())
    kernels.LAUNCHES.clear()
    out_t, tb = TT.raster_forward_train(packed, w, h, tile, BG)
    gimg = cotangent_tiles(out_t, w, h, tile, gen)
    grads = TT.run_backward(packed, gimg, tb, w, h, tile, BG)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches != {"K2": 1, "K3": 1}:
        raise RuntimeError(f"train points: the frame launched {launches}")
    if instances != emitted:
        raise RuntimeError(f"train points: the pack holds {instances} instances, the "
                           f"binning emitted {emitted}")
    rgb = TF.tiles_to_images(out_t, w, h, tile)[0]
    n_laid = int(TF.chunk_span(packed)[3].sum())
    px, py = TF.pixel_coords(w, tile, tw * th, dev)
    off = ((px >= w) | (py >= h))[..., 0]                    # [T, p]
    tile_of_row = torch.repeat_interleave(torch.arange(tw * th, device=dev),
                                          TF.chunk_span(packed)[3])
    off_bounds = float((tb[:n_laid] * off[tile_of_row]).abs().max())
    if not (bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(grads).all())):
        raise RuntimeError("train points: non-finite image or gradients")
    if off_bounds != 0.0 or float(gimg[off].abs().max()) != 0.0:
        raise RuntimeError(f"train points: pixels off the frame hold a boundary "
                           f"({off_bounds}) or a cotangent")
    del out_t, tb, gimg
    front_bwd = front_bwd_gate(params, proj, cam, packed, grads, (w, h, tan_x, tan_y, sh),
                               usage)
    del grads, packed, params
    x0, y0 = TRAIN_POINTS_CROP
    cw, ch = w - x0, h - y0
    cpack = TF.sorted_pack(crop_proj(proj, x0, y0, cw, ch), *TF.tile_grid(cw, ch, tile),
                           tile, order="exact")
    label = f"gs-360-3m crop {cw}x{ch} of {w}x{h}"
    # the shell's depths reach ~55: the depth channel is held relative to
    # the deepest valid Gaussian, as phase 17 holds K1's
    depth_scale = max(1.0, float(proj.depth[proj.valid].max()))
    k2_err, k2_stats, c_out, c_tb = compare_k2(cpack, cw, ch, tile, label,
                                               depth_scale=depth_scale)
    k3_err, k3_rel = compare_k3(cpack, cotangent_tiles(c_out, cw, ch, tile, gen), c_tb,
                                cw, ch, tile, label, tol=TOL_K3_DEEP)
    # the same corner cut to whole tiles: what the field's lists alone give
    ww, wh = cw // tile * tile, ch // tile * tile
    wpack = TF.sorted_pack(crop_proj(proj, x0, y0, ww, wh), ww // tile, wh // tile,
                           tile, order="exact")
    wlabel = f"gs-360-3m crop {ww}x{wh} (whole tiles)"
    _, _, w_out, w_tb = compare_k2(wpack, ww, wh, tile, wlabel, depth_scale=depth_scale)
    _, k3_rel_whole = compare_k3(wpack, cotangent_tiles(w_out, ww, wh, tile, gen), w_tb,
                                 ww, wh, tile, wlabel, tol=TOL_K3_DEEP)
    del wpack, w_out, w_tb
    record = {"width": w, "height": h, "tile": tile, "tiles": tw * th,
              "instances": instances, "launches": launches, "front_bwd": front_bwd,
              "crop": {"width": cw, "height": ch, "k2_max_abs_err": k2_err,
                       "k3_rel": k3_rel, "k3_max_abs_err": k3_err,
                       "chunks_started": k2_stats["chunks_started"],
                       "k3_rel_whole_tiles": k3_rel_whole},
              "gpu": gpu}
    log(f"training compositors on partial tiles [gs-360-3m {w}x{h}]: {json.dumps(record)}")
    del proj, cpack
    torch.cuda.empty_cache()
    return record


def front_bwd_gate(params, proj, cam, packed, grads16, view: tuple, usage: dict) -> dict:
    """The point front end's backward (``csrc/point_front_bwd.cu``) on one
    frame's K3 gradients ``grads16`` [16, B_pad] of the training pack
    ``packed`` of ``proj`` (the front end of ``params`` from ``cam`` at
    ``view`` = (width, height, tan_x, tan_y, sh_degree)), reduced to [C, 16]
    per-Gaussian rows as the training rasterizer's backward reduces them
    and handed over as its views: one ``front_bwd`` launch; each leaf
    within TOL_FRONT_BWD of the norm of ``project_points_backward_plain``'s
    on the same cotangents, and exact zeros on every slot without a
    cotangent; the kernel alone (torch.profiler), its bound (``roofline``) on the
    slots and the slots with a cotangent, its registers and blocks an SM.
    Returns the record."""
    import ctypes

    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops import point_front as PF
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import PACK16

    slots = params.xyz.shape[0]
    rows = grads16.new_zeros((slots + 1, PACK16)).index_add_(
        0, packed.gauss_idx, grads16.T)[:slots]
    cots = (rows[:, 0:2], rows[:, 9], rows[:, 2:5], rows[:, 5:8], rows[:, 8])
    args = (params, proj.valid, cam, *view, *cots)
    kernels.LAUNCHES.clear()
    got = PF.project_points_backward_fused(*args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches != {"front_bwd": 1}:
        raise RuntimeError(f"front_bwd: one backward launched {launches}")
    want = PF.project_points_backward_plain(*args)
    gaps = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
            for name, a, b in zip(params._fields, got, want)}
    unreached = ~((rows[:, :9] != 0).any(1) | ((rows[:, 9] != 0) & proj.valid))
    zeros = all(bool((g.reshape(slots, -1)[unreached] == 0).all()) for g in got)
    del got, want
    bad = [k for k, v in gaps.items() if not v <= TOL_FRONT_BWD]
    if bad or not zeros:
        raise RuntimeError(f"front_bwd: the kernel disagrees with its plain version in "
                           f"{bad} {gaps}, or a slot without a cotangent has a "
                           f"gradient ({not zeros})")
    kernel_ms, records = kernel_alone_ms(lambda: PF.project_points_backward_fused(*args),
                                         "front_bwd")
    reached = slots - int(unreached.sum())
    bound = roofline("front_bwd", {"gaussians": slots, "reached": reached})
    query = kernels.load("point_front_bwd").point_front_bwd_blocks_per_sm
    query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
    return {"slots": slots, "reached": reached, "launches": launches, "vs_plain": gaps,
            "unreached_zero": zeros,
            "kernel_ms": kernel_ms, "kernel_ms_records": records, **bound,
            "share_of_bound": bound["bound_ms"] / kernel_ms,
            "usage": usage.get(KERNEL_ENTRIES["front_bwd"]),
            "usage_by_degree": {d: usage.get(f"point_front_bwd_kernel<{d}>")
                                for d in range(5)},
            "blocks_per_sm": query(view[4])}


def cloth_front_frame(sc, usage: dict, gpu: str) -> dict:
    """One frame of the 65k serving scene (``build_scenes``) through
    ``render``, the launch counts cleared just before: the cloth front end's
    kernel (``csrc/point_front.cu``'s cloth pass) and K1 launched once each
    and no other counted kernel, ``render.COUNTS`` one call of the kernel
    and none of the PyTorch ops; that frame's front end through
    ``project_view`` (the ``ProjectedGaussians``, vertices, means and
    rotations) bit-identical to ``project_view_eager``'s; the kernel alone
    (torch.profiler), its bound (``roofline``), registers and blocks an SM.
    Returns the record for the kernels line."""
    import ctypes

    import torch

    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch import render as R
    from cloth_splatting_tpu_torch.ops.cloth_front import project_cloth_fused

    cam = sc.cams[1]
    args = (cam, WIDTH, HEIGHT, sc.tan, sc.tan, sc.params, sc.state, sc.mesh,
            sc.simulator, sc.preds, 3)
    kernels.LAUNCHES.clear()
    fronts = dict(R.COUNTS)
    R.render(*args[:10], BG, 3, device=cam.world_view.device)
    launches = dict(kernels.LAUNCHES)
    fronts = {k: R.COUNTS[k] - fronts.get(k, 0) for k in ("front_fused", "front_eager")}
    if launches != {"cloth_front": 1, "K1": 1}:
        raise RuntimeError(f"cloth front: a serving frame launched {launches}, "
                           f"expected cloth_front and K1 once each")
    if fronts != {"front_fused": 1, "front_eager": 0}:
        raise RuntimeError(f"cloth front: a serving frame's front end ran {fronts}")
    with torch.no_grad():
        got = R.project_view(*args)
        want = R.project_view_eager(*args)
    differ = bits_differ(got[0], want[0])
    differ.update({name: int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   for name, a, b in zip(("vertices", "means3d", "rotations"),
                                         got[1:], want[1:])})
    if any(differ.values()):
        raise RuntimeError(f"cloth front: the kernel's outputs differ from the "
                           f"PyTorch ops' in {differ} elements")
    vertices = got[1]

    def fused():
        return project_cloth_fused(sc.params, sc.state, sc.mesh, vertices, cam, WIDTH,
                                   HEIGHT, sc.tan, sc.tan, 3, True)

    kernel_ms, records = kernel_alone_ms(fused, "cloth_front")
    n = int(sc.params.face_bary.shape[0])
    bound = roofline("cloth_front", {"gaussians": n})
    query = kernels.load("point_front").cloth_front_blocks_per_sm
    query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
    record = {"gaussians": n, "valid": int(want[0].valid.sum()), "launches": launches,
              "counts": fronts, "bits_differ": differ, "kernel_ms": kernel_ms,
              "kernel_ms_records": records, **bound,
              "share_of_bound": bound["bound_ms"] / kernel_ms,
              "usage": usage.get(KERNEL_ENTRIES["cloth_front"]),
              "blocks_per_sm": query(3), "gpu": gpu}
    log(f"cloth front end on a 65k serving frame: {json.dumps(record)}")
    return record


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
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import sorted_pack, tile_size_for
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
    tile = tile_size_for(WIDTH, HEIGHT)

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
    train_pack = sorted_pack(t_proj, WIDTH // tile, HEIGHT // tile, tile,
                             order="fused")
    return types.SimpleNamespace(
        serving=serving, tan=tan, mesh=mesh, params=params, state=state,
        simulator=simulator,
        preds=preds, cams=cams, project=project, tile=tile,
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
        sorted_pack,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        run_backward,
    )
    from cloth_splatting_tpu_torch.render import camera_arrays, project_view, render

    dev = torch.device("cuda")
    # each phase's seconds, on the host clock, from the end of the one before
    phases, clock = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        phases[phase] = now - clock[0]
        clock[0] = now

    # 1. build ---------------------------------------------------------------
    usage = {}
    for name, text in build_logs().items():
        log(f"nvcc {name}:\n{text.strip()}")
        usage.update(ptxas_usage(text))
    log(f"ptxas {json.dumps(usage)}")
    check_spills(usage)
    occupancy = blocks_per_sm()
    log(f"blocks an SM (occupancy calculator): {json.dumps(occupancy)}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = cluster_occupancy((WIDTH // 32) * (HEIGHT // 32), n_sms)
    log(f"cluster launches at 32 px, tpp={SPAN_32[0]} ({n_sms} SMs): "
        f"{json.dumps(clusters)}")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    lap("build")

    sc = build_scenes(dev)
    tan, mesh, params, state = sc.tan, sc.mesh, sc.params, sc.state
    simulator, preds, cams, project = sc.simulator, sc.preds, sc.cams, sc.project
    tile, t_proj, train_pack = sc.tile, sc.t_proj, sc.train_pack
    tw, th = WIDTH // tile, HEIGHT // tile
    n_alive = int(state.alive.sum())
    log(f"scene: {n_alive} Gaussians (capacity {state.alive.numel()}), "
        f"{mesh.pos.shape[0]} vertices, {WIDTH}x{HEIGHT}")

    # 2. kernels against their plain versions ----------------------------------
    k1_err = k2_err = k3_err = k3_rel = 0.0
    packs = []
    for v in (0, 3):
        proj = project(cams[v])
        packed = sorted_pack(proj, tw, th, tile, order="fused")
        err, stats = compare_k1(packed, WIDTH, HEIGHT, tile, f"65k view {v}")
        k1_err = max(k1_err, err)
        packs.append((packed, stats, int(proj.valid.sum())))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err, train_stats, train_out, train_tb = compare_k2(
        train_pack, WIDTH, HEIGHT, tile, "65k train cam 0")
    k2_err = max(k2_err, err)
    train_gimg = cotangent_tiles(train_out, WIDTH, HEIGHT, tile, gen)
    err, rel = compare_k3(train_pack, train_gimg, train_tb, WIDTH, HEIGHT, tile,
                          "65k train cam 0")
    k3_err, k3_rel = max(k3_err, err), max(k3_rel, *rel.values())
    serve16 = sorted_pack(project(cams[0]), WIDTH // 16, HEIGHT // 16, 16,
                          order="fused")
    train16 = sorted_pack(t_proj, WIDTH // 16, HEIGHT // 16, 16, order="fused")
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
        packed = sorted_pack(proj, size // ts, size // ts, ts, order="exact")
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
    lap("kernels")

    # 3. each kernel alone at the main paths' shapes ---------------------------
    # K1 and K1-span on the serving pack of view 0, the others on the training
    # pack of camera 0; the span forms at SPAN_32 and at the largest window of
    # SPAN_CAPS
    packed, stats, serve_valid = packs[0]
    big = (SPAN_32[0], SPAN_CAPS[-1])

    def calls(span):
        return {
            "K1": lambda: raster_forward_tiles(packed, WIDTH, HEIGHT, tile, BG, *span),
            "K2": lambda: raster_forward_train(train_pack, WIDTH, HEIGHT, tile, BG,
                                               *span),
            "K3": lambda: run_backward(train_pack, train_gimg, train_tb, WIDTH, HEIGHT,
                                       tile, BG, *span)}

    spanned = {"K1": "K1-span", "K2": "K2-span", "K3": "K4"}
    alone = {key: kernel_alone_ms(fn, key) for key, fn in calls(()).items()}
    alone.update({spanned[key]: kernel_alone_ms(fn, spanned[key])
                  for key, fn in calls(SPAN_32).items()})
    alone_big = {spanned[key]: kernel_alone_ms(fn, spanned[key])
                 for key, fn in calls(big).items()}
    log("kernels alone (torch.profiler; ms, launch records of 20): "
        f"{json.dumps(alone)}; span forms at tpp={big[0]} span_cap={big[1]}: "
        f"{json.dumps(alone_big)} [{gpu}]")
    # the functions the kernels compute, on these packs
    serve_item = {"gaussians": serve_valid, "pixels": WIDTH * HEIGHT,
                  "pairs": stats["pairs_contributing"]}
    train_item = {"gaussians": int(t_proj.valid.sum()), "pixels": WIDTH * HEIGHT,
                  "pairs": train_stats["pairs_contributing"]}
    lap("alone")

    # 4. the serving path: frames through render ------------------------------
    def frame(cam):
        return render(cam, WIDTH, HEIGHT, tan, tan, params, state, mesh,
                      simulator, preds, BG, 3, device=dev)

    kernels.LAUNCHES.clear()
    outs = [frame(c) for c in cams]
    serving_launches = dict(kernels.LAUNCHES)
    if serving_launches != {"K1": N_FRAMES, "cloth_front": N_FRAMES}:
        raise RuntimeError(f"serving: launches {serving_launches} for {N_FRAMES} "
                           f"frames, expected K1 = cloth_front = {N_FRAMES}")
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
    log(f"serving: {N_FRAMES} frames of {n_alive} Gaussians, launches "
        f"{json.dumps(serving_launches)}, alpha coverage "
        f"{min(coverages):.4f}..{max(coverages):.4f} [{gpu}]")
    del outs
    serve_span = span_turn(lambda: [frame(c) for c in cams], SPAN_32, "frame",
                           {"K1-span": N_FRAMES, "cloth_front": N_FRAMES})
    cloth_front = cloth_front_frame(sc, usage, gpu)
    lap("serving")

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
    lap("oracle")

    # 6. the training path: steps of the Trainer -------------------------------
    train, k2_launches, k3_launches, train_span = train_phase(gpu)
    print(json.dumps({"train": train}))
    print(json.dumps({"span": {
        "tiles_per_program": SPAN_32[0], "span_cap": SPAN_32[1],
        "launches": {"serving": serve_span, "train": train_span},
        "programs": span_programs_taken,
        "bit_identical_to_default": span_identical, "span_caps": span_caps,
        "wide": wide, "gpu": gpu}}))
    lap("train")

    # 7. the full fit ----------------------------------------------------------
    fit, fit_launches, fitted = fit_phase(mesh, tan, gpu)
    print(json.dumps({"fit": fit}))
    lap("fit")

    # 8. evaluation of the fitted scene ----------------------------------------
    ev, eval_launches = eval_phase(fitted, gpu)
    del fitted
    print(json.dumps({"eval": ev}))
    lap("eval")

    # 9. the port's benchmark entry --------------------------------------------
    bench_launches = bench_phase(sc.serving, gpu)
    lap("bench")

    # 10. the dense tier -------------------------------------------------------
    print(json.dumps({"dense": dense_phase(sc, gpu)}))
    lap("dense")

    # 11. the parity run --------------------------------------------------------
    parity, parity_launches = parity_phase(gpu)
    print(json.dumps({"parity": parity}))
    lap("parity")

    # 12. the GNN dynamics -----------------------------------------------------
    gnn, gnn_state = gnn_phase(gpu)
    print(json.dumps({"gnn": gnn}))
    lap("gnn")

    # 13. the closed manipulation loop -----------------------------------------
    planning, planning_k = planning_phase(gpu, gnn_state)
    del gnn_state
    print(json.dumps({"planning": planning}))
    lap("planning")

    # 14. the legacy free-xyz fit (the dense tier) -----------------------------
    print(json.dumps({"legacy": legacy_phase(gpu)}))
    lap("legacy")

    # 15. the scene-parallel sweep ---------------------------------------------
    sweep, sweep_launches, sweep_scene1, sweep_lone = sweep_phase(mesh, gpu)
    print(json.dumps({"sweep": sweep}))
    lap("sweep")

    # 16. the multi-device layer: a world of one NCCL rank, two gloo ranks ----
    mesh_rec, mesh_launches = mesh_phase(gpu, sweep_scene1, sweep_lone)
    del sweep_scene1, sweep_lone
    print(json.dumps({"mesh": mesh_rec}))
    lap("mesh")

    # 17. the plain 3DGS serving path at gs-360-3m ----------------------------
    points = points_phase(gpu, usage, occupancy)
    print(json.dumps({"points": points}))
    lap("points")

    # 18. the training compositors on partial tiles --------------------------
    train_points = train_points_phase(gpu, usage)
    print(json.dumps({"train_points": train_points}))
    lap("train_points")

    print(gpu)

    def entry(name, source, replaces, by_path, err, item):
        # launches_by_path: each main path's own count, read just after the
        # path was driven from counts cleared just before; launches: their
        # sum; kernel_ms: the kernel alone, the mean of kernel_ms_records
        # launch records of 20; bound_ms: ``roofline`` of the function on
        # ``item``; share_of_bound: bound / kernel alone; ptxas: the entry
        # function's registers, shared memory and spills from this run's
        # build log
        key = name.split()[0]
        kernel_ms, records = alone[key]
        b = roofline(key, item)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, **b,
                "library_ms": None, "kernel_ms": kernel_ms,
                "kernel_ms_records": records,
                "share_of_bound": b["bound_ms"] / kernel_ms,
                "ptxas": usage.get(KERNEL_ENTRIES[key])}

    # K3's cotangent is scaled by 1 / numel, so its absolute error is small
    # whatever the agreement; its entry also carries the relative reading
    # that TOL_K3 holds
    k3_entry = entry("K3 tiled_bwd forward-order gradient sweep",
                     "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                     "cloth_splatting_tpu/ops/rasterize/pallas_train.py:353",
                     {"train": k3_launches, "fit": fit_launches["K3"],
                      "bench": bench_launches["K3"], "parity": parity_launches["K3"],
                      "planning": planning_k["K3"]["launches"],
                      "sweep": sweep_launches["K3"], "mesh": mesh_launches["K3"]},
                     max(k3_err, planning_k["K3"]["max_abs_err"]), train_item)
    k3_entry["max_rel_err"] = max(k3_rel, planning_k["K3"]["max_rel_err"])
    k3_entry["at_planning_shape"] = planning_k["K3"]
    k3_entry["cull_audit"] = cull["65k train cam 0"]
    k4_entry = entry("K4 tiled_bwd_reverse reverse gradient sweep",
                     "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                     "cloth_splatting_tpu/ops/rasterize/pallas_train.py:655",
                     {"span_train": train_span["K4"]}, span_err["K4"], train_item)
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
                             {"serving": serving_launches["K1"],
                              "fit": fit_launches["K1"],
                              "eval": eval_launches, "bench": bench_launches["K1"],
                              "parity": parity_launches["K1"],
                              "sweep": sweep_launches["K1"],
                              "mesh": mesh_launches["K1"],
                              "points": points["launches"]},
                             k1_err, serve_item),
                       "K1", cull["65k view 0"])
    # K1 on the gs-360-3m frame: partial tiles, uncapped splats, ~10M instances
    k1_entry["at_points_shape"] = {k: points[k] for k in (
        "instances", "max_abs_err", "depth_scale", "kernel_ms", "kernel_ms_records",
        "bound_ms", "bound_by", "share_of_bound", "registers", "blocks_per_sm")}
    k2_entry = patched(entry("K2 tiled_fwd_train compositor + boundaries",
                             "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                             "cloth_splatting_tpu/ops/rasterize/pallas_train.py:104",
                             {"train": k2_launches, "fit": fit_launches["K2"],
                              "bench": bench_launches["K2"],
                              "parity": parity_launches["K2"],
                              "planning": planning_k["K2"]["launches"],
                              "sweep": sweep_launches["K2"],
                              "mesh": mesh_launches["K2"]},
                             max(k2_err, planning_k["K2"]["max_abs_err"]), train_item),
                       "K2", cull["65k train cam 0"])
    k2_entry["at_planning_shape"] = planning_k["K2"]
    # K1, K2, K3 over the serving frames, the Trainer steps, the fit, the
    # eval splits (K1), the bench, the parity run, (K2, K3) the planning
    # episode and the sweep (K1: its final evaluation), K1 over the points
    # frame; the span kernels over the span turn's frames and steps. K2 and
    # K3 also carry their readings at the planning refiner's 96 px shape
    # (at_planning_shape: error, launches), K1 at the gs-360-3m frame's
    # (at_points_shape)
    # the cloth front end: every front end of a render without a gradient on
    # the card, bit-identical to the PyTorch ops (cloth_front_frame)
    cloth_entry = {
        "name": "cloth_front mesh-anchored front end (positions, face rotations, SH, "
                "covariance, EWA)",
        "route": "cuda", "source": "cloth_splatting_tpu_torch/csrc/point_front.cu",
        "replaces": None, "launches_by_path": {
            "serving": serving_launches["cloth_front"] + 1,
            "span_serving": serve_span["cloth_front"],
            "fit": fit_launches["cloth_front"], "eval": eval_launches,
            "parity": parity_launches["cloth_front"],
            "planning": planning["mpc_cs"]["launches"]["cloth_front"],
            "sweep": sweep_launches["cloth_front"],
            "mesh": mesh_launches["cloth_front"]},
        "max_abs_err": 0.0, "library_ms": None,
        **{k: cloth_front[k] for k in (
            "kernel_ms", "kernel_ms_records", "bound_ms", "bound_by", "share_of_bound",
            "blocks_per_sm", "bits_differ")},
        "ptxas": cloth_front["usage"]}
    cloth_entry["launches"] = sum(cloth_entry["launches_by_path"].values())
    print(json.dumps({"kernels": [
        k1_entry,
        clustered(entry("K1-span tiled_fwd_span compositor, one window per program",
                        "cloth_splatting_tpu_torch/csrc/tiled_fwd.cu",
                        "cloth_splatting_tpu/ops/rasterize/pallas_tiled.py:376",
                        {"span_serving": serve_span["K1-span"]},
                        span_err["K1-span"], serve_item),
                  "K1-span", "K1's patched, culled walk", cull["65k view 0"]),
        k2_entry,
        clustered(entry("K2-span tiled_fwd_train_span, one window per program",
                        "cloth_splatting_tpu_torch/csrc/tiled_train.cu",
                        "cloth_splatting_tpu/ops/rasterize/pallas_train.py:169",
                        {"span_train": train_span["K2-span"]},
                        span_err["K2-span"], train_item),
                  "K2-span", "K2's patched, culled walk", cull["65k train cam 0"]),
        k3_entry, k4_entry, cloth_entry,
    ]}))
    log(f"total: {sum(phases.values()):.1f} s")
    print(json.dumps({"phases": phases}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
