"""Evaluation rendering: render the train / test / video camera sets of a
trained checkpoint, time them, and export frames and tracking logs;
counterpart of ``cloth_splatting_tpu/eval/render_sets.py``.

``render_frames`` renders, times and returns the frames (and the deformation
logs) and needs no image library: a warm-up frame outside the clock, a timed
pass that keeps nothing, FPS = (n_views - 1) / elapsed, then a re-render of
one frame at a time for export. ``render_set`` calls it and writes what the
reference's ``render.py`` writes: per-frame PNGs under
``<model>/<split>/ours_<iter>/{renders,gt}``, ``video_rgb.mp4`` at 30 fps,
flow overlays under ``flow/``, ``deform_log_*.npz`` and, with
``log_deform``, the tracked trajectories ``<model>/all_trajs.npz``.

A frame that tiles by 16 px goes through the serving backend
``"tiled_fwd"``: K1 on the card, its plain version on the CPU. Any other
frame goes to the dense tier, as in the JAX package, and that tier raises
its ``ValueError``: it tiles by 16 px as well, so such frames render in
neither package. The JAX package's per-split ``k_cap`` doubling serves only
that tier, which no frame the port renders reaches, so it is left out.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.mesh_io import load_mesh_h5
from cloth_splatting_tpu_torch.data.ply_io import read_ply
from cloth_splatting_tpu_torch.device import resolve_device, synchronize
from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.models.deform import (
    RESIDUAL_FIELDS,
    simulator_from_params,
)
from cloth_splatting_tpu_torch.render import (
    DENSE_BACKEND,
    SERVING_BACKEND,
    camera_arrays,
    render,
)
from cloth_splatting_tpu_torch.utils.checkpoints import (
    latest_checkpoint,
    load_flat,
    search_max_iteration,
)

TILE_MULTIPLE = 16


def load_gaussian_checkpoint(point_cloud_dir: str,
                             device: str | torch.device = "cuda"):
    """PLY + mesh.hdf5 -> (params, state, mesh) on ``device``, padded to the
    rounded capacity."""
    dev = resolve_device(device)
    cols = read_ply(os.path.join(point_cloud_dir, "point_cloud.ply"))
    mesh = load_mesh_h5(os.path.join(point_cloud_dir, "mesh.hdf5"), dev)
    n = cols["x"].shape[0]
    cap = G.round_capacity(n)

    n_rest = len([k for k in cols if k.startswith("f_rest_")])
    k_rest = n_rest // 3

    def padded(arr, shape_tail):
        out = np.zeros((cap,) + shape_tail, np.float32)
        out[:n] = arr
        return torch.from_numpy(out).to(dev)

    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None, :]
    # channel-major storage back to [N, K-1, 3]
    f_rest = np.stack([cols[f"f_rest_{i}"] for i in range(n_rest)], axis=1)
    f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)

    params = G.GaussianParams(
        face_bary=padded(np.stack([cols["b1"], cols["b2"], cols["b3"]], 1), (3,)),
        face_offset=padded(cols["o"][:, None], (1,)),
        features_dc=padded(f_dc, (1, 3)),
        features_rest=padded(f_rest, (k_rest, 3)),
        scaling=padded(np.stack([cols[f"scale_{i}"] for i in range(3)], 1), (3,)),
        rotation=padded(np.stack([cols[f"rot_{i}"] for i in range(4)], 1), (4,)),
        opacity=padded(cols["opacity"][:, None], (1,)),
    )
    alive = torch.zeros(cap, dtype=torch.bool, device=dev)
    alive[:n] = True
    face_ids = np.zeros(cap, np.int64)
    face_ids[:n] = cols["id"].astype(np.int64)
    zeros = torch.zeros(cap, dtype=torch.float32, device=dev)
    state = G.GaussianState(face_ids=torch.from_numpy(face_ids).to(dev),
                            alive=alive, max_radii2d=zeros,
                            grad_accum=zeros.clone(), denom=zeros.clone())
    return params, state, mesh


def load_trained_model(model_path: str, iteration: int = -1,
                       device: str | torch.device = "cuda"):
    """(params, state, mesh, simulator, iteration) of a trained model: the
    PLY Gaussians of ``iteration`` (-1: the latest) and the latest simulator
    checkpoint under ``meshnet/``, a ``ResidualSimulator`` or, for a
    checkpoint that holds only an ``embedding`` table, an
    ``EmbeddingSimulator``."""
    dev = resolve_device(device)
    if iteration == -1:
        iteration = search_max_iteration(os.path.join(model_path, "point_cloud"))
        if iteration is None:
            raise FileNotFoundError(f"no point_cloud checkpoints in {model_path}")
    pc_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    params, state, mesh = load_gaussian_checkpoint(pc_dir, dev)

    ckpt = latest_checkpoint(os.path.join(model_path, "meshnet"))
    if ckpt is None:
        raise FileNotFoundError(f"no meshnet checkpoint in {model_path}/meshnet")
    flat = load_flat(ckpt)
    keys = ("embedding",) if set(flat) == {"embedding"} else RESIDUAL_FIELDS
    simulator = simulator_from_params(
        {k: torch.from_numpy(np.asarray(flat[k], np.float32)).to(dev) for k in keys})
    return params, state, mesh, simulator, iteration


class RenderedSet(NamedTuple):
    frames: list[np.ndarray]   # [3, H, W] float32 in [0, 1], one per camera
    deform_logs: list[dict]    # per camera, when asked for; else empty
    fps: float                 # (n_views - 1) / elapsed
    elapsed: float             # seconds of the timed pass


@torch.no_grad()
def render_frames(cameras, params, state, mesh, simulator, preds,
                  white_background: bool, sh_degree: int = 3,
                  keep_logs: bool = False,
                  device: str | torch.device = "cuda") -> RenderedSet:
    """Render ``cameras`` (``ops.camera.Camera``s of one size) through the
    serving backend (the dense tier for a frame that does not tile by 16 px,
    which raises there): one warm-up frame outside the clock, a timed pass over
    every camera that keeps nothing (on CUDA the clock starts and stops at a
    synchronize), then every camera once more for the returned frames and,
    with ``keep_logs``, each frame's deformation log (deformed means and
    vertices, rotations, pixel projections, depth). K1 runs 2 n + 1 times."""
    dev = resolve_device(device)
    cam0 = cameras[0]
    w, h = cam0.width, cam0.height
    backend = (SERVING_BACKEND if w % TILE_MULTIPLE == 0 and h % TILE_MULTIPLE == 0
               else DENSE_BACKEND)
    bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)

    def render_one(cam_arr):
        return render(cam_arr, w, h, cam0.tanfovx, cam0.tanfovy, params, state,
                      mesh, simulator, preds, bg, sh_degree,
                      backend=backend, device=dev)

    cam_arrs = [camera_arrays(cam, dev) for cam in cameras]
    render_one(cam_arrs[0])
    synchronize(dev)
    t0 = time.perf_counter()
    for ca in cam_arrs:
        render_one(ca)
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    fps = (len(cameras) - 1) / max(elapsed, 1e-9)

    frames, logs = [], []
    for ca in cam_arrs:
        out = render_one(ca)
        frames.append(torch.clamp(out.rgb, 0.0, 1.0).cpu().numpy())
        if keep_logs:
            logs.append({
                "means3D_deform": out.means3d.cpu().numpy(),
                "vertice_deform": out.vertices.cpu().numpy(),
                "rotations": out.rotations.cpu().numpy(),
                "projections": out.projections.cpu().numpy(),
                "depth": out.depth.cpu().numpy(),
            })
    return RenderedSet(frames, logs, fps, elapsed)


def trajectories(cameras, deform_logs, alive: np.ndarray,
                 track_vertices: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(traj [T, M, 3], rotations [T, M, 4]): ONE entry per unique time, in
    time order (views that share a time share its deformation; stacking the
    camera order of an interleaved grid would corrupt the time axis), of the
    alive Gaussians' means or of the mesh vertices."""
    traj_key = "vertice_deform" if track_vertices else "means3D_deform"
    by_time: dict = {}
    for cam, d in zip(cameras, deform_logs):
        tid = getattr(cam, "time_id", -1)
        key = tid if tid is not None and tid >= 0 else float(cam.time)
        if key not in by_time:
            by_time[key] = d
    time_logs = [by_time[k] for k in sorted(by_time)]
    trajs = np.stack([d[traj_key] if track_vertices else d[traj_key][alive]
                      for d in time_logs])
    rots = np.stack([d["rotations"] for d in time_logs])
    if not track_vertices:
        rots = rots[:, alive]
    return trajs, rots


def write_trajectories(path: str, cameras, deform_logs, alive: np.ndarray,
                       track_vertices: bool = False) -> None:
    """``all_trajs.npz`` {'traj', 'rotations'} of ``trajectories``."""
    trajs, rots = trajectories(cameras, deform_logs, alive, track_vertices)
    np.savez(path, traj=trajs, rotations=rots)


def render_set(
    model_path: str,
    split: str,
    iteration: int,
    cameras,
    gt_paths,
    params, state, mesh, simulator, preds,
    white_background: bool,
    sh_degree: int = 3,
    log_deform: bool = False,
    track_vertices: bool = False,
    show_flow: bool = False,
    flow_skip: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Render one camera list and export it; returns {'fps', 'out_dir'}.
    Needs ``imageio`` (and PIL for ground truth, ``cv2`` for flow)."""
    import imageio.v2 as imageio

    out_dir = os.path.join(model_path, split, f"ours_{iteration}")
    renders_dir = os.path.join(out_dir, "renders")
    gts_dir = os.path.join(out_dir, "gt")
    os.makedirs(renders_dir, exist_ok=True)
    os.makedirs(gts_dir, exist_ok=True)

    rs = render_frames(cameras, params, state, mesh, simulator, preds,
                       white_background, sh_degree,
                       keep_logs=log_deform or show_flow, device=device)
    frames, deform_logs = rs.frames, rs.deform_logs
    print(f"{split}: rendered {len(cameras)} views in {rs.elapsed:.3f}s "
          f"-> FPS {rs.fps:.2f}")

    def to_uint8(img):
        return (img.transpose(1, 2, 0) * 255).astype(np.uint8)

    for i, img in enumerate(frames):
        imageio.imwrite(os.path.join(renders_dir, f"{i:05d}.png"), to_uint8(img))
        if gt_paths and i < len(gt_paths) and gt_paths[i]:
            from cloth_splatting_tpu_torch.data.scene import decode_image

            gt = decode_image(gt_paths[i], white_background)
            imageio.imwrite(os.path.join(gts_dir, f"{i:05d}.png"),
                            gt.transpose(1, 2, 0))

    if len(frames) > 1:
        try:
            imageio.mimwrite(os.path.join(out_dir, "video_rgb.mp4"),
                             [to_uint8(f) for f in frames], fps=30)
        except Exception as exc:  # codec availability varies
            print(f"video export skipped: {exc}")

    alive = state.alive.cpu().numpy()
    if show_flow:
        # occlusion-masked tracked points and their trajectory tails
        from cloth_splatting_tpu_torch.eval.flow_viz import draw_tracks, occlusion_mask

        flow_dir = os.path.join(out_dir, "flow")
        os.makedirs(flow_dir, exist_ok=True)
        alive_idx = np.flatnonzero(alive)
        if flow_skip:
            sel = alive_idx[::flow_skip]
        else:
            m = min(128, len(alive_idx))
            sel = alive_idx[np.linspace(0, len(alive_idx) - 1, m).astype(int)]
        track = [d["projections"][sel] for d in deform_logs]
        for t, (img, cam, d) in enumerate(zip(frames, cameras, deform_logs)):
            wv = np.asarray(cam.world_view, np.float32)      # row-vector W2C
            pts = d["means3D_deform"][sel]
            z = pts @ wv[:3, 2] + wv[3, 2]                   # camera depth
            vis = occlusion_mask(track[t], z, d["depth"][0])
            overlay = draw_tracks(to_uint8(img), track[:t + 1], vis)
            imageio.imwrite(os.path.join(flow_dir, f"{t:05d}.png"), overlay)

    if log_deform:
        write_trajectories(os.path.join(model_path, "all_trajs.npz"), cameras,
                           deform_logs, alive, track_vertices)
        for t, d in enumerate(deform_logs):
            np.savez(os.path.join(out_dir, f"deform_log_{t:03d}.npz"), **d)

    return {"fps": rs.fps, "out_dir": out_dir}
