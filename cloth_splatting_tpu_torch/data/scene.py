"""Scene loading: NeRF-synthetic ``transforms_*.json`` datasets and cloth
meshes; counterpart of ``cloth_splatting_tpu/data/scene.py``.

  * ``transforms_{train,test}.json`` with ``camera_angle_x/y`` and per-frame
    ``file_path``, ``time``, ``transform_matrix`` (OpenGL camera-to-world).
  * camera-axis conversion: negate the Y and Z columns, invert, store R
    transposed.
  * (view_id, time_id) parsed from ``r_<view>_<time>`` file names, else
    derived from the unique transforms and times.
  * alpha compositing onto a white or black background; optional gripper
    masks from ``masks_gripper/<name>.png`` (mask = 1 - image).
  * NeRF++ normalization radius from the train camera centres.
  * ``init_mesh.hdf5`` and ``mesh_predictions/mesh_*.hdf5`` (GNN rollouts).
  * the video cameras: ``video.json`` when the scene has one, else the
    80-pose spherical orbit (``spherical_video_cameras``).

Everything here is host-side numpy; ``train.loop.build_banks`` decodes the
images once into a uint8 bank on the device. PIL and ``h5py`` are imported
inside the functions that need them.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

import numpy as np
import torch

from cloth_splatting_tpu_torch.data.mesh_io import load_mesh_h5
from cloth_splatting_tpu_torch.models.gaussians import Mesh
from cloth_splatting_tpu_torch.ops.camera import Camera, focal2fov, fov2focal


@dataclasses.dataclass
class FrameRecord:
    camera: Camera
    image_path: Optional[str]
    image_name: str
    mask_path: Optional[str] = None


def _ids_from_name(name: str, transform, time, unique_transforms, unique_times):
    parts = name.split("_")
    if len(parts) > 2:
        try:
            return int(parts[-2]), int(parts[-1])
        except ValueError:
            pass
    view_id = int(np.argmin([np.abs(u - transform).sum() for u in unique_transforms]))
    time_id = int(np.searchsorted(unique_times, time))
    return view_id, time_id


def camera_from_transform(transform_matrix, fovx: float, fovy: float, width: int,
                          height: int, time: float, view_id: int,
                          time_id: int) -> Camera:
    """The camera of a frame's OpenGL/Blender camera-to-world
    ``transform_matrix``: COLMAP-convention W2C with R stored transposed."""
    c2w = np.asarray(transform_matrix, dtype=np.float64).copy()
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return Camera.create(R=w2c[:3, :3].T, t=w2c[:3, 3], fovx=fovx, fovy=fovy,
                         width=width, height=height, time=time,
                         view_id=view_id, time_id=time_id)


def load_transforms(path: str, transformsfile: str, extension: str = ".png",
                    time_skip: int | None = None, view_skip: int | None = None
                    ) -> list[FrameRecord]:
    """Parse one transforms json into FrameRecords (images not decoded yet)."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    fovy = contents.get("camera_angle_y", None)
    frames = contents["frames"]

    unique_times = np.unique([fr["time"] for fr in frames])
    unique_transforms = np.unique(
        np.stack([np.asarray(fr["transform_matrix"]) for fr in frames]), axis=0
    )
    kept_times = unique_times[::time_skip] if time_skip else None

    mask_dir = os.path.join(path, "masks_gripper")
    has_masks = os.path.isdir(mask_dir)

    records = []
    for fr in frames:
        time = fr["time"]
        if kept_times is not None and time not in kept_times:
            continue
        file_path = fr["file_path"]
        if not any(file_path.endswith(e) for e in (".png", ".jpg", ".jpeg")):
            file_path += extension
        name = os.path.splitext(os.path.basename(file_path))[0]
        view_id, time_id = _ids_from_name(
            name, np.asarray(fr["transform_matrix"]), time, unique_transforms, unique_times
        )
        if view_skip and view_id % view_skip != 0:
            continue

        img_path = os.path.join(path, file_path)
        with open(img_path, "rb") as imf:
            # decode lazily later; read size from the PNG header via PIL
            from PIL import Image

            with Image.open(imf) as im:
                width, height = im.size

        fovy_eff = fovy if fovy is not None else focal2fov(fov2focal(fovx, width), height)
        cam = camera_from_transform(fr["transform_matrix"], fovx, fovy_eff, width,
                                    height, float(time), view_id, time_id)
        mask_path = os.path.join(mask_dir, name + ".png") if has_masks else None
        records.append(FrameRecord(camera=cam, image_path=img_path,
                                   image_name=name, mask_path=mask_path))
    return records


def decode_image(path: str, white_background: bool) -> np.ndarray:
    """Decode + alpha-composite to uint8 [3, H, W]."""
    from PIL import Image

    with Image.open(path) as im:
        data = np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0
    bg = 1.0 if white_background else 0.0
    rgb = data[:, :, :3] * data[:, :, 3:4] + bg * (1.0 - data[:, :, 3:4])
    return (rgb * 255.0).astype(np.uint8).transpose(2, 0, 1)


def decode_mask(path: str) -> np.ndarray:
    """Gripper mask as float [1, H, W]: 1 - image."""
    from PIL import Image

    with Image.open(path) as im:
        data = np.asarray(im, dtype=np.float32) / 255.0
    if data.ndim == 3:
        data = data[..., 0]
    return (1.0 - data)[None]


def nerfpp_radius(cameras: list[Camera]) -> float:
    """NeRF++ scene radius: 1.1 x the largest distance from the mean camera
    centre."""
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    center = centers.mean(axis=0, keepdims=True)
    return float(np.linalg.norm(centers - center, axis=1).max() * 1.1)


def spherical_video_cameras(n_poses: int, fovx: float, width: int, height: int,
                            maxtime: float, radius: float = 4.0,
                            phi_deg: float = -30.0,
                            single_cam: bool = False) -> list[Camera]:
    """The spherical orbit of ``n_poses`` cameras that video rendering uses,
    times spread over [0, 1]; ``single_cam`` holds the camera at one pose."""

    def pose_spherical(theta_deg: float) -> np.ndarray:
        t = np.eye(4)
        t[2, 3] = radius
        phi = np.deg2rad(phi_deg)
        rp = np.eye(4)
        rp[1, 1], rp[1, 2] = np.cos(phi), -np.sin(phi)
        rp[2, 1], rp[2, 2] = np.sin(phi), np.cos(phi)
        th = np.deg2rad(theta_deg)
        rt = np.eye(4)
        rt[0, 0], rt[0, 2] = np.cos(th), -np.sin(th)
        rt[2, 0], rt[2, 2] = np.sin(th), np.cos(th)
        flip = np.asarray(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
        )
        return flip @ rt @ rp @ t

    thetas = (np.ones(n_poses) * -90.0 if single_cam
              else np.linspace(-180, 180, n_poses + 1)[:-1])
    times = np.linspace(0, maxtime, n_poses) / max(maxtime, 1e-9)
    fovy = focal2fov(fov2focal(fovx, width), height)
    cams = []
    for i, (theta, time) in enumerate(zip(thetas, times)):
        c2w = pose_spherical(theta)
        w2c = np.linalg.inv(c2w)
        R = -w2c[:3, :3].T
        R[:, 0] = -R[:, 0]
        T = -w2c[:3, 3]
        cams.append(Camera.create(R=R, t=T, fovx=fovx, fovy=fovy, width=width,
                                  height=height, time=float(time), view_id=i,
                                  time_id=i))
    return cams


class CameraGrid:
    """(view x time) grid of FrameRecords."""

    def __init__(self, records: list[FrameRecord]):
        self.records = records
        self.view_ids = sorted({r.camera.view_id for r in records})
        self.time_ids = sorted({r.camera.time_id for r in records})
        self.n_views = len(self.view_ids)
        self.n_times = len(self.time_ids)
        self.grid: list[list[Optional[FrameRecord]]] = [
            [None] * self.n_times for _ in range(self.n_views)
        ]
        vmap = {v: i for i, v in enumerate(self.view_ids)}
        tmap = {t: i for i, t in enumerate(self.time_ids)}
        for r in records:
            self.grid[vmap[r.camera.view_id]][tmap[r.camera.time_id]] = r

    def get(self, view_idx: int, time_idx: int) -> FrameRecord:
        rec = self.grid[view_idx % self.n_views][time_idx]
        if rec is None:
            options = [row[time_idx] for row in self.grid if row[time_idx] is not None]
            if not options:
                raise ValueError(f"no camera at time index {time_idx}")
            rec = options[np.random.randint(len(options))]
        return rec

    def __len__(self):
        return self.n_views


@dataclasses.dataclass
class ClothScene:
    train: CameraGrid
    test: CameraGrid
    video_cameras: list[Camera]
    initial_mesh: Mesh
    mesh_predictions: np.ndarray     # [T, V, 3]
    radius: float
    maxtime: float
    white_background: bool

    @property
    def width(self) -> int:
        return self.train.records[0].camera.width

    @property
    def height(self) -> int:
        return self.train.records[0].camera.height


def read_timeline(path: str) -> float:
    times = []
    for split in ("transforms_train.json", "transforms_test.json"):
        with open(os.path.join(path, split)) as f:
            times += [fr["time"] for fr in json.load(f)["frames"]]
    return max(times) if times else 1.0


def load_cloth_scene(path: str, white_background: bool = True, eval_split: bool = True,
                     time_skip: int | None = None, view_skip: int | None = None,
                     single_cam_video: bool = False,
                     device: str | torch.device = "cuda") -> ClothScene:
    """Read a scene directory; the mesh goes to ``device``. The video
    cameras come from ``video.json`` when there is one, else from the
    80-pose orbit at 800x800 (``single_cam_video``: one pose)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    maxtime = read_timeline(path)

    train = load_transforms(path, "transforms_train.json",
                            time_skip=time_skip, view_skip=view_skip)
    test = load_transforms(path, "transforms_test.json",
                           time_skip=time_skip, view_skip=view_skip)
    if not eval_split:
        train = train + test
        test = []

    if os.path.exists(os.path.join(path, "video.json")):
        video_cams = [r.camera for r in load_transforms(path, "video.json")]
    else:
        video_cams = spherical_video_cameras(
            80, train[0].camera.fovx, 800, 800, maxtime, single_cam=single_cam_video)

    radius = nerfpp_radius([r.camera for r in train])

    initial_mesh = load_mesh_h5(os.path.join(path, "init_mesh.hdf5"), device)
    pred_paths = sorted(glob.glob(os.path.join(path, "mesh_predictions", "mesh_*.hdf5")))
    if time_skip:
        pred_paths = pred_paths[::time_skip]
    preds = np.stack([load_mesh_h5(p, "cpu").pos.numpy() for p in pred_paths]) \
        if pred_paths else initial_mesh.pos.cpu().numpy()[None]

    return ClothScene(
        train=CameraGrid(train),
        test=CameraGrid(test) if test else CameraGrid(train),
        video_cameras=video_cams,
        initial_mesh=initial_mesh,
        mesh_predictions=preds,
        radius=radius,
        maxtime=maxtime,
        white_background=white_background,
    )
