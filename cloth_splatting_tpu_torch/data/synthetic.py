"""Synthetic cloth scenes; counterpart of
``cloth_splatting_tpu/data/synthetic.py``.

``generate_synthetic_scene`` writes a dataset in the on-disk format the
loader reads (``transforms_{train,test}.json`` with ``r_<view>_<time>``
frames, ``init_mesh.hdf5``, ``mesh_predictions/mesh_%03d.hdf5`` and the
ground-truth trajectory ``gt.npz``), rendered by the port's own serving
path (K1 on the card, its plain version on the CPU).
``render_scene_banks`` renders the same frames straight into the (view x
time) device banks the train loop addresses, without touching PNG or HDF5.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.ops.camera import Camera
from cloth_splatting_tpu_torch.ops.image import inverse_sigmoid
from cloth_splatting_tpu_torch.ops.sh import rgb_to_sh
from cloth_splatting_tpu_torch.render import CameraArrays, camera_arrays, render


def cloth_wave(pos: np.ndarray, t: float, amp: float = 0.15) -> np.ndarray:
    """Analytic cloth deformation: a travelling wave plus drift in z. Pure-z
    displacement stretches the sheet (up to ~17% edge elongation at t=1);
    ``cloth_wave_isometric`` is the physically honest one."""
    x, y = pos[:, 0], pos[:, 1]
    z = pos[:, 2] + amp * np.sin(4.0 * x + 6.0 * t) * np.cos(3.0 * y) * t
    out = pos.copy()
    out[:, 2] = z
    out[:, 1] = y + 0.1 * t
    return out


def cloth_wave_isometric(pos: np.ndarray, t: float,
                         amp: float = 0.6) -> np.ndarray:
    """Inextensible travelling wave: a developable (cylindrical) bend.

    The sheet's x-lines follow a planar curve given by its tangent angle
    theta(s) = amp * t * sin(4 s + 6 t), integrated as X' = cos(theta),
    Z' = sin(theta) over the material coordinate s, so arc length is kept
    exactly and every edge keeps its rest length; y-lines ride rigidly, with
    the same 0.1 t drift in y. ``amp`` is the peak bend angle in radians."""
    x, y = pos[:, 0], pos[:, 1]
    # fine material grid covering the sheet, one tangent-angle integral per t
    s = np.linspace(x.min() - 1e-6, x.max() + 1e-6, 4097)
    theta = amp * t * np.sin(4.0 * s + 6.0 * t)
    ds = s[1] - s[0]
    # trapezoid cumulative integrals of (cos, sin) theta
    cx = np.concatenate([[0.0], np.cumsum(
        0.5 * (np.cos(theta[1:]) + np.cos(theta[:-1])) * ds)])
    cz = np.concatenate([[0.0], np.cumsum(
        0.5 * (np.sin(theta[1:]) + np.sin(theta[:-1])) * ds)])
    big_x = s[0] + cx
    # keep the sheet centred: remove the mean in-plane shrink drift
    big_x = big_x - (big_x.mean() - s.mean())
    out = pos.copy()
    out[:, 0] = np.interp(x, s, big_x)
    out[:, 2] = pos[:, 2] + np.interp(x, s, cz)
    out[:, 1] = y + 0.1 * t
    return out


WAVES = {"stretchy": cloth_wave, "isometric": cloth_wave_isometric}


def orbit_camera(view: int, n_views: int, fov: float, width: int, height: int,
                 time: float, radius: float = 3.0, elevation: float = 0.6
                 ) -> Camera:
    """Camera ``view`` of ``n_views`` on an orbit around the origin."""
    ang = 2.0 * np.pi * view / n_views
    cam_pos = np.asarray([
        radius * np.cos(elevation) * np.sin(ang),
        radius * np.sin(elevation),
        -radius * np.cos(elevation) * np.cos(ang),
    ])
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    r_w2c = np.stack([right, up2, fwd], axis=0)
    t = -r_w2c @ cam_pos
    return Camera.create(R=r_w2c.T, t=t, fovx=fov, fovy=fov, width=width,
                         height=height, time=time)


def target_gaussians(mesh: G.Mesh, sh_degree: int, seed: int = 0,
                     device: str | torch.device = "cuda"):
    """A textured 'ground truth' Gaussian field anchored on the mesh."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params, state = G.init_from_mesh(
        rng, mesh, sh_degree, 2,
        capacity=G.round_capacity(2 * int(mesh.faces.shape[0])), device=dev)
    xyz = G.gaussian_positions(params, state, mesh)
    colors = torch.stack([
        0.55 + 0.4 * torch.sin(6.0 * xyz[:, 0]) * torch.cos(4.0 * xyz[:, 1]),
        0.5 + 0.35 * torch.cos(8.0 * xyz[:, 0]),
        0.45 + 0.3 * torch.sin(5.0 * xyz[:, 1]),
    ], dim=1)
    params = params._replace(
        features_dc=rgb_to_sh(torch.clamp(colors, 0.05, 0.95))[:, None, :],
        opacity=torch.full_like(params.opacity,
                                float(inverse_sigmoid(torch.tensor(0.95)))),
        scaling=params.scaling + 0.2,
    )
    return params, state


def camera_to_transform_matrix(cam: Camera) -> np.ndarray:
    """Invert the loader's convention back to an OpenGL c2w for the json."""
    w2c = np.asarray(cam.world_view).T.copy()   # column-vector W2C
    c2w = np.linalg.inv(w2c)
    c2w[:3, 1:3] *= -1
    return c2w


def smooth_prediction_error(rest: np.ndarray, n_times: int, rms: float,
                            rng: np.random.Generator, n_centers: int = 4,
                            length_scale: float = 0.5) -> np.ndarray:
    """Spatially and temporally smooth error field [T, V, 3], normalized to
    ``rms``: a sum of RBF bumps with temporally smoothed coefficients, the
    way a trained GNN's rollout errs (a drifting bias, not white noise)."""
    centers = rest[rng.choice(rest.shape[0], size=n_centers, replace=False)]
    d2 = ((rest[:, None, :] - centers[None, :, :]) ** 2).sum(-1)   # [V, M]
    basis = np.exp(-d2 / (2.0 * length_scale**2))                  # [V, M]
    coef = rng.normal(size=(n_times, n_centers, 3))                # [T, M, 3]
    if n_times > 2:   # temporal smoothing: 1-2-1 passes along time
        for _ in range(2):
            pad = np.concatenate([coef[:1], coef, coef[-1:]])
            coef = 0.25 * pad[:-2] + 0.5 * pad[1:-1] + 0.25 * pad[2:]
    field = np.einsum("vm,tmc->tvc", basis, coef)                  # [T, V, 3]
    scale = rms / max(np.sqrt(np.mean(field**2)), 1e-12)
    return field * scale


@torch.no_grad()
def render_rgba(cam: Camera, params: G.GaussianParams, state: G.GaussianState,
                mesh: G.Mesh, vertices: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """One ground-truth frame as straight (non-premultiplied) RGBA uint8
    [4, H, W], the NeRF-synthetic convention the loader expects: rendered on
    black to get the premultiplied foreground P, stored as P / alpha and
    alpha, so that the loader's composite (P / alpha) alpha + (1 - alpha) bg
    gives the true composite on either background (up to uint8)."""
    out = render(camera_arrays(cam, device), cam.width, cam.height, cam.tanfovx,
                 cam.tanfovy, params, state, mesh, None, None, (0.0, 0.0, 0.0),
                 3, override_vertices=vertices, device=device)
    prem = torch.clamp(out.rgb, 0, 1)
    alpha = torch.clamp(out.alpha[0], 0, 1)
    straight = torch.clamp(prem / torch.clamp_min(alpha, 1e-4)[None], 0, 1)
    rgba = torch.cat([straight, alpha[None]])
    return torch.round(rgba * 255).to(torch.uint8)


def composite_rgba(rgba: torch.Tensor, white_background: bool) -> torch.Tensor:
    """uint8 RGBA [..., 4, H, W] -> uint8 RGB [..., 3, H, W] on a white or
    black background; what ``data.scene.decode_image`` does to a PNG."""
    data = rgba.to(torch.float32) / 255.0
    bg = 1.0 if white_background else 0.0
    rgb = data[..., :3, :, :] * data[..., 3:4, :, :] \
        + bg * (1.0 - data[..., 3:4, :, :])
    return (rgb * 255.0).to(torch.uint8)


def render_scene_banks(mesh: G.Mesh, traj: np.ndarray, views, n_views: int,
                       image_size: int, fov: float = 2 * np.arctan(0.4),
                       white_background: bool = True, seed: int = 0,
                       device: str | torch.device = "cuda"):
    """The ground truth of a synthetic scene as device banks: (cam_bank with
    fields [V, T, ...], gt_bank uint8 [V, T, 3, H, W]) for the orbit views
    ``views`` of ``n_views`` and the vertex trajectory ``traj`` [T, V, 3] at
    times linspace(0, 1, T); the frames ``generate_synthetic_scene`` would
    write, composited as the loader would."""
    dev = resolve_device(device)
    params, state = target_gaussians(mesh, 3, seed=seed, device=dev)
    n_times = traj.shape[0]
    times = np.linspace(0.0, 1.0, n_times)
    cams, gts = [], []
    for vi in views:
        row_c, row_g = [], []
        for ti in range(n_times):
            cam = orbit_camera(vi, n_views, fov, image_size, image_size,
                               float(times[ti]))
            verts = torch.as_tensor(traj[ti], dtype=torch.float32, device=dev)
            row_c.append(camera_arrays(cam, dev))
            row_g.append(composite_rgba(
                render_rgba(cam, params, state, mesh, verts, dev),
                white_background))
        cams.append(row_c)
        gts.append(torch.stack(row_g))
    cam_bank = CameraArrays(*(
        torch.stack([torch.stack([getattr(c, f) for c in row]) for row in cams])
        for f in CameraArrays._fields))
    return cam_bank, torch.stack(gts)


def generate_synthetic_scene(
    out_dir: str,
    n_views: int = 6,
    n_times: int = 5,
    image_size: int = 128,
    mesh_res: int = 10,
    fov: float = 2 * np.arctan(0.4),
    test_views: tuple[int, ...] = (1, 4),
    prediction_noise: float = 0.0,
    noise_mode: str = "iid",
    seed: int = 0,
    wave: str = "stretchy",
    device: str | torch.device = "cuda",
) -> str:
    """Render a full synthetic dataset into ``out_dir`` and return it.

    ``prediction_noise`` perturbs the saved mesh predictions relative to the
    true trajectory, emulating imperfect GNN rollouts: ``noise_mode='iid'``
    is per-vertex white noise, ``'smooth'`` a spatially and temporally
    correlated field at the same RMS. ``wave`` selects the deformation
    ('stretchy' or 'isometric'). Needs ``h5py`` and ``imageio``."""
    import imageio.v2 as imageio

    from cloth_splatting_tpu_torch.data.mesh_io import (
        save_mesh_h5,
        save_positions_h5,
    )

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rest_mesh = grid_cloth_mesh(mesh_res, mesh_res, size=1.4, device=dev)
    params, state = target_gaussians(rest_mesh, sh_degree=3, seed=seed, device=dev)
    rng = np.random.default_rng(seed + 1)

    rest = rest_mesh.pos.cpu().numpy()
    times = np.linspace(0.0, 1.0, n_times)
    wave_fn = WAVES[wave]
    traj = np.stack([wave_fn(rest, t) for t in times])              # [T, V, 3]

    save_mesh_h5(os.path.join(out_dir, "init_mesh.hdf5"), rest_mesh)
    if prediction_noise > 0 and noise_mode == "smooth":
        err = smooth_prediction_error(rest, n_times, prediction_noise, rng)
    elif prediction_noise > 0:
        err = rng.normal(0, prediction_noise, (n_times,) + rest.shape)
    else:
        err = np.zeros((n_times,) + rest.shape)
    for i in range(n_times):
        save_positions_h5(
            os.path.join(out_dir, "mesh_predictions", f"mesh_{i:03d}.hdf5"),
            rest_mesh, (traj[i] + err[i]).astype(np.float32))

    # Gaussian ground-truth trajectory for tracking evaluation
    alive = state.alive.cpu().numpy()
    xyz_t = np.stack([
        G.gaussian_positions(params, state, rest_mesh,
                             torch.as_tensor(traj[i], dtype=torch.float32,
                                             device=dev)).cpu().numpy()[alive]
        for i in range(n_times)])
    np.savez(os.path.join(out_dir, "gt.npz"), traj=xyz_t)

    frames = {"train": [], "test": []}
    for ti, t in enumerate(times):
        verts = torch.as_tensor(traj[ti], dtype=torch.float32, device=dev)
        for vi in range(n_views):
            cam = orbit_camera(vi, n_views, fov, image_size, image_size, float(t))
            rgba = render_rgba(cam, params, state, rest_mesh, verts, dev)
            split = "test" if vi in test_views else "train"
            os.makedirs(os.path.join(out_dir, split), exist_ok=True)
            name = f"r_{vi}_{ti}"
            imageio.imwrite(os.path.join(out_dir, split, name + ".png"),
                            rgba.permute(1, 2, 0).cpu().numpy())
            frames[split].append({
                "file_path": f"{split}/{name}",
                "time": float(t),
                "transform_matrix": camera_to_transform_matrix(cam).tolist()})

    for split, split_frames in frames.items():
        meta = {"camera_angle_x": float(fov), "camera_angle_y": float(fov),
                "frames": split_frames}
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return out_dir
