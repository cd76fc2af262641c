"""The parity run: the whole per-scene pipeline on a synthetic scene whose
ground truth is known exactly; counterpart of ``scripts/parity_bench.py``:

    python -m cloth_splatting_tpu_torch.parity_bench [--in_memory] \\
        --wave isometric --n_views 24 --prediction_noise 0 \\
        --iterations 7500 --static 1500 \\
        --train_args "--time_sample balanced --lr_tail_start 0.75 --param_ema 0.995"

The file form runs the chain through the port's command lines, as the JAX
script runs the root ones: ``data.synthetic.generate_synthetic_scene``
writes the scene, then ``train`` (with ``--train_args`` appended),
``eval.render --skip_video --skip_train --log_deform``, ``eval.metrics`` and
``eval.align_eval_trajs`` (the MTE against the scene's ``gt.npz``). It needs
``h5py``, ``imageio`` and PIL.

``--in_memory`` runs the same fit and scoring without a file: the same scene
(the mesh, the wave and the mesh predictions of ``generate_synthetic_scene``
at the same seed, its views and times, the test views (1, 4), the cameras as
the loader rebuilds them from ``transforms_*.json``), rendered by
``data.synthetic.render_scene_banks`` into device banks; ``train.loop.
fit_banks`` with the config that ``--train_args`` gives the port's train
parser; the fit's evaluation-facing state through
``eval.render_sets.render_frames`` over the test split, scored by
``eval.metrics.score_images`` on the frames as the file chain's PNGs hold
them (uint8); and ``eval.tracking.score_tracking`` against the true
trajectory, in mm. It needs none of those libraries.

Either form prints one JSON line with the JAX script's keys (``metric``,
``value`` (test PSNR, dB), ``unit``, ``ssim``, ``lpips``, ``mte_mm``,
``image_size``, ``iterations``, ``prediction_noise``, ``noise_mode``,
``wave``); the in-memory form prints the fit's rate on the line before.
LPIPS is scored on the ``fixture-v1`` weights. ``--device`` defaults to
``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_VIEWS = (1, 4)     # generate_synthetic_scene's held-out views
FOV = 2 * np.arctan(0.4)


def select_result_method(results: dict) -> str:
    """The test split's ``ours_<iteration>`` entry of the numerically largest
    iteration (a lexicographic sort would put "ours_7500" after
    "ours_20000"); the lexicographically last key when there is none."""
    test_keys = [k for k in results if "/" not in k and k.startswith("ours_")]
    if not test_keys:
        return sorted(results)[-1]
    return max(test_keys, key=lambda k: int(k.split("_")[-1]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m cloth_splatting_tpu_torch.parity_bench")
    p.add_argument("--workdir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "parity_bench"))
    p.add_argument("--image_size", type=int, default=800)
    p.add_argument("--mesh_res", type=int, default=24,
                   help="24 -> ~2.1k Gaussians at the start, more after densify")
    p.add_argument("--n_views", type=int, default=8)
    p.add_argument("--n_times", type=int, default=8)
    p.add_argument("--prediction_noise", type=float, default=0.01,
                   help="error in the mesh predictions that the residual "
                        "simulator must fix")
    p.add_argument("--noise_mode", type=str, default="iid",
                   choices=("iid", "smooth"),
                   help="iid: per-vertex white noise; smooth: a spatially and "
                        "temporally correlated field at the same RMS")
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--static", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wave", type=str, default="stretchy",
                   choices=("stretchy", "isometric"),
                   help="isometric: an inextensible bend; stretchy: a pure-z "
                        "wave that stretches the sheet")
    p.add_argument("--train_args", type=str, default="",
                   help="extra arguments of the train call, e.g. "
                        "'--densify_until_iter 6000 --sh_degree 2'")
    p.add_argument("--reuse_scene", action="store_true",
                   help="keep the workdir's scene when it exists")
    p.add_argument("--in_memory", action="store_true",
                   help="build, fit and score the scene in memory; no file")
    p.add_argument("--device", type=str, default="cuda")
    return p


def train_argv(args, scene: str, exp: str) -> list[str]:
    """The train call's arguments, the JAX script's."""
    return ["-s", scene, "-m", exp, "--iterations", str(args.iterations),
            "--static_reconst_iteration", str(args.static),
            "--test_iterations", str(args.iterations),
            "--save_iterations", str(args.iterations), "--quiet",
            *args.train_args.split()]


def result_line(args, psnr, ssim, lpips, mte_mm: float) -> dict:
    return {
        "metric": "parity_psnr_db",
        "value": round(psnr, 3) if psnr else None,
        "unit": "dB",
        "ssim": round(ssim, 4) if ssim else None,
        "lpips": round(lpips, 4) if lpips is not None else None,
        "mte_mm": round(mte_mm, 3),
        "image_size": args.image_size,
        "iterations": args.iterations,
        "prediction_noise": args.prediction_noise,
        "noise_mode": args.noise_mode,
        "wave": args.wave,
    }


def _run(module: str, *argv: str) -> str:
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-4000:])
        raise RuntimeError(f"{module} failed rc={r.returncode}")
    return r.stdout


def run_files(args) -> dict:
    """The chain through the port's command lines; returns the JSON line."""
    from cloth_splatting_tpu_torch.data.synthetic import generate_synthetic_scene

    scene = os.path.join(args.workdir, "scene")
    exp = os.path.join(args.workdir, "exp")
    os.makedirs(args.workdir, exist_ok=True)
    if not (args.reuse_scene
            and os.path.exists(os.path.join(scene, "transforms_train.json"))):
        generate_synthetic_scene(
            scene, n_views=args.n_views, n_times=args.n_times,
            image_size=args.image_size, mesh_res=args.mesh_res,
            prediction_noise=args.prediction_noise, noise_mode=args.noise_mode,
            seed=args.seed, wave=args.wave, device=args.device)
    dev = ["--device", args.device]
    _run("cloth_splatting_tpu_torch.train", *train_argv(args, scene, exp), *dev)
    _run("cloth_splatting_tpu_torch.eval.render", "-m", exp, "--skip_video",
         "--skip_train", "--log_deform", *dev)
    _run("cloth_splatting_tpu_torch.eval.metrics", "-m", exp, *dev)
    mte_out = _run("cloth_splatting_tpu_torch.eval.align_eval_trajs",
                   "--trajs", os.path.join(exp, "all_trajs.npz"),
                   "--gt", os.path.join(scene, "gt.npz"))
    with open(os.path.join(exp, "results.json")) as f:
        results = json.load(f)
    res = results[select_result_method(results)]
    mte_mm = float(mte_out.split("MTE mean:")[1].split("mm")[0])
    return result_line(args, res.get("PSNR"), res.get("SSIM"), res.get("LPIPS"),
                       mte_mm)


def loader_cameras(args, views) -> list[list]:
    """[view][time] cameras of ``views`` as the loader rebuilds them from the
    scene's ``transforms_*.json`` (the same float64 round trip)."""
    from cloth_splatting_tpu_torch.data.scene import camera_from_transform
    from cloth_splatting_tpu_torch.data.synthetic import (
        camera_to_transform_matrix,
        orbit_camera,
    )

    size = args.image_size
    times = np.linspace(0.0, 1.0, args.n_times)
    return [[camera_from_transform(
        camera_to_transform_matrix(orbit_camera(v, args.n_views, FOV, size, size,
                                                float(t))),
        float(FOV), float(FOV), size, size, float(t), v, ti)
        for ti, t in enumerate(times)] for v in views]


def run_in_memory(args, on_iteration=None) -> dict:
    """The same run without a file. Returns {"line": the JSON line,
    "test_psnr_before": the test split's PSNR at the initial state, scored
    the same way, "fit_seconds", "iterations_per_second", "n_gaussians" (alive
    at the end), "scene_seconds", "eval_seconds", "state": the fitted state
    that was scored}. ``on_iteration`` goes to ``fit_banks``."""
    import torch

    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
    from cloth_splatting_tpu_torch.data.scene import nerfpp_radius
    from cloth_splatting_tpu_torch.data.synthetic import (
        gaussian_trajectory,
        render_scene_banks,
        scene_motion,
        target_gaussians,
    )
    from cloth_splatting_tpu_torch.device import resolve_device, synchronize
    from cloth_splatting_tpu_torch.eval import lpips as L
    from cloth_splatting_tpu_torch.eval.metrics import score_images
    from cloth_splatting_tpu_torch.eval.render_sets import render_frames, trajectories
    from cloth_splatting_tpu_torch.eval.tracking import score_tracking
    from cloth_splatting_tpu_torch.models.deform import simulator_from_params
    from cloth_splatting_tpu_torch.render import CameraArrays, camera_arrays
    from cloth_splatting_tpu_torch.train.__main__ import build_parser as train_parser
    from cloth_splatting_tpu_torch.train.__main__ import training_config
    from cloth_splatting_tpu_torch.train.loop import EvalFrame, fit_banks
    from cloth_splatting_tpu_torch.train.step import Trainer
    from cloth_splatting_tpu_torch.utils.logging import seed_everything

    dev = resolve_device(args.device)
    t0 = time.time()
    size = args.image_size
    mesh = grid_cloth_mesh(args.mesh_res, args.mesh_res, size=1.4, device=dev)
    traj, preds = scene_motion(mesh.pos.cpu().numpy(), args.n_times, args.wave,
                               args.prediction_noise, args.noise_mode, args.seed)
    target, target_state = target_gaussians(mesh, 3, seed=args.seed, device=dev)
    gt_traj = gaussian_trajectory(target, target_state, mesh, traj)
    del target, target_state

    targs = train_parser().parse_args(train_argv(args, "in_memory", "in_memory"))
    cfg = training_config(targs)
    white = cfg.model.white_background
    train_views = [v for v in range(args.n_views) if v not in TEST_VIEWS]
    test_views = [v for v in range(args.n_views) if v in TEST_VIEWS]
    train_cams = loader_cameras(args, train_views)
    test_cams = loader_cameras(args, test_views)
    _, gt_bank = render_scene_banks(mesh, traj, train_views, args.n_views, size,
                                    fov=FOV, white_background=white,
                                    seed=args.seed, device=dev)
    _, test_bank = render_scene_banks(mesh, traj, test_views, args.n_views, size,
                                      fov=FOV, white_background=white,
                                      seed=args.seed, device=dev)
    rows = [[camera_arrays(c, dev) for c in row] for row in train_cams]
    cam_bank = CameraArrays(*(
        torch.stack([torch.stack([getattr(c, f) for c in row]) for row in rows])
        for f in CameraArrays._fields))
    # the test split in the loader's order: time-major, then view
    test_list = [(test_cams[vi][ti], test_bank[vi, ti])
                 for ti in range(args.n_times) for vi in range(len(test_views))]
    test_frames = [EvalFrame(camera_arrays(c, dev), gt, f"r_{c.view_id}_{c.time_id}")
                   for c, gt in test_list]
    preds_t = torch.from_numpy(preds).to(dev)
    lpips_w = L.to_torch(L.fixture_weights(), dev)
    scene_s = time.time() - t0

    def score(state):
        """The test split as the file chain scores it: render_frames, the
        frames as uint8 PNGs hold them, the metrics and the MTE."""
        rs = render_frames([c for c, _ in test_list], state.params, state.gstate,
                           mesh, simulator_from_params(state.sim_params), preds_t,
                           white, 3, keep_logs=True, device=dev)
        pairs = [(torch.from_numpy(
                     (f.transpose(1, 2, 0) * 255).astype(np.uint8)
                     .transpose(2, 0, 1).astype(np.float32) / 255.0).to(dev),
                  gt.to(torch.float32) / 255.0)
                 for f, (_, gt) in zip(rs.frames, test_list)]
        scores = {k: float(np.mean(v)) for k, v in score_images(pairs, lpips_w).items()}
        pred, rot = trajectories([c for c, _ in test_list], rs.deform_logs,
                                 state.gstate.alive.cpu().numpy())
        scores["mte_mm"] = score_tracking(pred, rot, gt_traj)["mte_mean"] * 1000.0
        return scores

    seed_everything(targs.seed)
    cam0 = train_cams[0][0]
    trainer = Trainer(cfg, mesh, preds_t, size, size, cam0.tanfovx, cam0.tanfovy,
                      nerfpp_radius([c for row in train_cams for c in row]))
    state = trainer.init_state(np.random.default_rng(targs.seed))
    before = score(state)

    saved = {}
    synchronize(dev)
    t_fit = time.time()
    fit_banks(trainer, state, cam_bank, gt_bank, None, test_frames=test_frames,
              test_iterations=targs.test_iterations,
              save_iterations=targs.save_iterations, seed=targs.seed,
              three_steps_batch=targs.three_steps_batch,
              on_iteration=on_iteration,
              on_save=lambda it, st: saved.__setitem__(it, st))
    synchronize(dev)
    fit_s = time.time() - t_fit
    final = saved[max(saved)]
    t_eval = time.time()
    after = score(final)
    return {"line": result_line(args, after["PSNR"], after["SSIM"], after["LPIPS"],
                                after["mte_mm"]),
            "test_psnr_before": before["PSNR"], "fit_seconds": fit_s,
            "iterations_per_second": args.iterations / fit_s,
            "n_gaussians": int(final.gstate.alive.sum()),
            "scene_seconds": scene_s, "eval_seconds": time.time() - t_eval,
            "state": final}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.in_memory:
        run = run_in_memory(args)
        print(f"parity (in memory): {args.iterations} iterations in "
              f"{run['fit_seconds']:.1f} s ({run['iterations_per_second']:.3f} it/s), "
              f"{run['n_gaussians']} Gaussians, test PSNR "
              f"{run['test_psnr_before']:.3f} dB before the fit")
        line = run["line"]
    else:
        line = run_files(args)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
