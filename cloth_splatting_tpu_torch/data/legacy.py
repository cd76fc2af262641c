"""Legacy dataset loaders: COLMAP, D-NeRF synthetic, DyNeRF (Neural-3D),
HyperNeRF/Nerfies; counterpart of ``cloth_splatting_tpu/data/legacy.py``.

Parity with the reference's loader surface
(scene_reconstruction/dataset_readers.py:151-200 COLMAP, :402-448 D-NeRF,
:526-583 DyNeRF via neural_3D_dataset_NDC.py, :469-499 HyperNeRF via
hyper_loader.py; COLMAP binary parsing scene_reconstruction/colmap_loader.py).
All loaders are host-side preprocessing (numpy + file IO, no device work);
they produce the same ``FrameRecord``/``Camera`` objects as the cloth loader
so downstream tooling is format-agnostic. Reading image sizes (D-NeRF) and
decoding images needs PIL, imported inside the functions that use it.

The camera-convention quirks of the reference are preserved exactly:
  * COLMAP: R stored transposed (``qvec2rotmat(qvec).T``), T = tvec.
  * DyNeRF: R = -c2w_rot with column 0 re-negated, T = -t @ R, time = idx/300.
  * HyperNeRF: R = orientation.T, T = -(scaled position) @ R, time =
    warp_id / max(warp_id).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import struct

import numpy as np

from cloth_splatting_tpu_torch.data.ply_io import read_ply
from cloth_splatting_tpu_torch.data.scene import (
    FrameRecord,
    load_transforms,
    nerfpp_radius,
    read_timeline,
    spherical_video_cameras,
)
from cloth_splatting_tpu_torch.ops.camera import Camera, focal2fov
from cloth_splatting_tpu_torch.ops.sh import sh_to_rgb


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray    # [N, 3]
    colors: np.ndarray    # [N, 3] in [0, 1]
    normals: np.ndarray   # [N, 3]


@dataclasses.dataclass
class LegacyScene:
    train: list[FrameRecord]
    test: list[FrameRecord]
    video: list[Camera]
    point_cloud: PointCloud | None
    radius: float
    maxtime: float


# --------------------------------------------------------------------- COLMAP

# model_id -> (name, n_params); params start with focal length(s) then cx, cy
_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_colmap_cameras_binary(path: str) -> dict[int, dict]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = _COLMAP_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = {"model": name, "width": int(width),
                            "height": int(height), "params": params}
    return cams


def read_colmap_cameras_text(path: str) -> dict[int, dict]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            cams[cam_id] = {"model": model, "width": int(parts[2]),
                            "height": int(parts[3]),
                            "params": np.array([float(x) for x in parts[4:]])}
    return cams


def read_colmap_images_binary(path: str) -> dict[int, dict]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (image_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)   # skip (x, y, point3D_id) tracks
            images[image_id] = {"qvec": qvec, "tvec": tvec,
                                "camera_id": camera_id,
                                "name": name.decode()}
    return images


def read_colmap_images_text(path: str) -> dict[int, dict]:
    # meta/track line pairs; a track line may be BLANK (an image with zero
    # observed 2D points, which COLMAP legitimately writes), so blanks must
    # stay in the stream to keep the pairing parity.
    images = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
    while lines and not lines[0].strip():
        lines.pop(0)
    for meta in lines[::2]:   # every other line is the 2D-point track
        if not meta.strip():
            continue
        parts = meta.split()
        images[int(parts[0])] = {
            "qvec": np.array([float(x) for x in parts[1:5]]),
            "tvec": np.array([float(x) for x in parts[5:8]]),
            "camera_id": int(parts[8]), "name": parts[9]}
    return images


def read_colmap_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        for i in range(n):
            _read(f, "<Q")                       # point id
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            _read(f, "<d")                        # reprojection error
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)                 # skip track
    return xyz, rgb / 255.0


def read_colmap_points3d_text(path: str):
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            xyz.append([float(x) for x in parts[1:4]])
            rgb.append([float(x) / 255.0 for x in parts[4:7]])
    return np.asarray(xyz), np.asarray(rgb)


def _colmap_camera(intr: dict, qvec: np.ndarray, tvec: np.ndarray,
                   time: float = 0.0, view_id: int = 0) -> Camera:
    width, height = intr["width"], intr["height"]
    p = intr["params"]
    if intr["model"] == "PINHOLE":
        fx, fy = p[0], p[1]
    else:                                          # SIMPLE_* / OPENCV share f first
        fx = fy = p[0]
    R = qvec2rotmat(qvec).T                        # reference colmap quirk
    return Camera.create(R=R, t=tvec, fovx=focal2fov(fx, width),
                         fovy=focal2fov(fy, height), width=width,
                         height=height, time=time, view_id=view_id,
                         time_id=0)


def load_colmap_scene(path: str, images: str | None = None,
                      eval_split: bool = False, llffhold: int = 8) -> LegacyScene:
    """readColmapSceneInfo parity (dataset_readers.py:151-200): static scene,
    every llffhold-th camera held out when eval_split."""
    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = read_colmap_images_binary(os.path.join(sparse, "images.bin"))
        intr = read_colmap_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = read_colmap_images_text(os.path.join(sparse, "images.txt"))
        intr = read_colmap_cameras_text(os.path.join(sparse, "cameras.txt"))

    images_dir = os.path.join(path, images if images else "images")
    records = []
    for img in extr.values():
        cam = _colmap_camera(intr[img["camera_id"]], img["qvec"], img["tvec"])
        records.append(FrameRecord(
            camera=cam, image_path=os.path.join(images_dir, img["name"]),
            image_name=os.path.splitext(img["name"])[0]))
    records.sort(key=lambda r: r.image_name)
    for i, r in enumerate(records):   # stable view ids after sorting
        records[i] = FrameRecord(
            camera=dataclasses.replace(r.camera, view_id=i),
            image_path=r.image_path, image_name=r.image_name)

    if eval_split:
        train = [r for i, r in enumerate(records) if i % llffhold != 0]
        test = [r for i, r in enumerate(records) if i % llffhold == 0]
    else:
        train, test = records, []

    pcd = None
    if os.path.exists(os.path.join(sparse, "points3D.bin")):
        xyz, rgb = read_colmap_points3d_binary(os.path.join(sparse, "points3D.bin"))
        pcd = PointCloud(xyz, rgb, np.zeros_like(xyz))
    elif os.path.exists(os.path.join(sparse, "points3D.txt")):
        xyz, rgb = read_colmap_points3d_text(os.path.join(sparse, "points3D.txt"))
        pcd = PointCloud(xyz, rgb, np.zeros_like(xyz))

    return LegacyScene(train=train, test=test,
                       video=[r.camera for r in train], point_cloud=pcd,
                       radius=nerfpp_radius([r.camera for r in train]),
                       maxtime=0.0)


# --------------------------------------------------------------------- D-NeRF


def load_dnerf_scene(path: str, white_background: bool = True,
                     eval_split: bool = True, extension: str = ".png",
                     time_skip: int | None = None, view_skip: int | None = None,
                     n_random_points: int = 2000, seed: int = 0) -> LegacyScene:
    """readNerfSyntheticInfo parity (dataset_readers.py:402-448): NeRF-
    synthetic transforms with per-frame times, random init point cloud in
    [-1.3, 1.3]^3 (no mesh — this is the free-xyz 3DGS path)."""
    maxtime = read_timeline(path)
    train = load_transforms(path, "transforms_train.json", extension,
                            time_skip=time_skip, view_skip=view_skip)
    test = load_transforms(path, "transforms_test.json", extension,
                           time_skip=time_skip, view_skip=view_skip)
    if not eval_split:
        train, test = train + test, []

    video_json = os.path.join(path, "video.json")
    if os.path.exists(video_json):
        video = [r.camera for r in load_transforms(path, "video.json", extension)]
    else:
        cam0 = train[0].camera
        video = spherical_video_cameras(80, cam0.fovx, cam0.width, cam0.height,
                                        maxtime)

    return LegacyScene(train=train, test=test, video=video,
                       point_cloud=dnerf_init_cloud(n_random_points, seed),
                       radius=nerfpp_radius([r.camera for r in train]),
                       maxtime=maxtime)


def dnerf_init_cloud(n_random_points: int = 2000, seed: int = 0) -> PointCloud:
    """D-NeRF's initial cloud: points uniform in [-1.3, 1.3]^3 and colours
    ``SH2RGB(rand / 255)``, the reference's convention
    (dataset_readers.py:424-427): near-mid-grey 0.5 +- 0.002, not uniform
    random colours. Positions, then colours, from one generator."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((n_random_points, 3)) * 2.6 - 1.3
    colors = sh_to_rgb(rng.random((n_random_points, 3)) / 255.0)
    return PointCloud(xyz, colors, np.zeros_like(xyz))


# --------------------------------------------------------------------- DyNeRF


def _center_poses(poses: np.ndarray) -> np.ndarray:
    """Recenter c2w poses about their average pose (neural_3D_dataset_NDC.py
    center_poses/average_poses, :20-85, with blender2opencv = identity as the
    reference constructs it at :244)."""

    def normalize(v):
        return v / np.linalg.norm(v)

    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(z, y_))
    y = np.cross(x, z)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = np.stack([x, y, z, center], 1)
    last_row = np.tile(np.asarray([0.0, 0.0, 0.0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    return (np.linalg.inv(pose_avg_homo) @ poses_homo)[:, :3]


def load_dynerf_scene(path: str, eval_index: int = 0, downsample: float = 1.0,
                      max_frames: int = 300) -> LegacyScene:
    """Neural-3D (DyNeRF) parity (neural_3D_dataset_NDC.py:215-376):
    ``poses_bounds.npy`` [N_cams, 17] + per-camera ``cam*/images/%04d.png``
    frame dirs (pre-extracted; video decoding is out of scope without cv2).
    Camera ``eval_index`` is the test view; time = frame_idx / 300."""
    poses_arr = np.load(os.path.join(path, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape(-1, 3, 5)
    H, W, focal = poses[0, :, -1]
    focal = focal / downsample
    width, height = int(W / downsample), int(H / downsample)
    # LLFF [down right back] -> [right up back] c2w
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]],
                           axis=-1)
    # Recenter about the average pose, then rescale so the nearest plane sits
    # at z = 4/3 (load_meta, neural_3D_dataset_NDC.py:273-282: scale_factor =
    # near_fars.min() * 0.75); without this the world frame and scale differ
    # from the reference and densification thresholds/radii diverge.
    poses = _center_poses(poses)
    near_fars = poses_arr[:, -2:]
    scale_factor = float(near_fars.min()) * 0.75
    poses[..., 3] /= scale_factor

    cam_dirs = sorted(d for d in glob.glob(os.path.join(path, "cam*"))
                      if os.path.isdir(d))
    assert len(cam_dirs) == poses.shape[0], \
        f"{len(cam_dirs)} camera dirs vs {poses.shape[0]} poses"

    fovx = focal2fov(focal, width)
    fovy = focal2fov(focal, height)
    train, test = [], []
    for index, cam_dir in enumerate(cam_dirs):
        pose = poses[index]
        R = -pose[:3, :3]
        R[:, 0] = -R[:, 0]
        T = -pose[:3, 3] @ R
        img_dir = os.path.join(cam_dir, "images")
        frames = sorted(os.listdir(img_dir))[:max_frames] \
            if os.path.isdir(img_dir) else []
        for idx, fname in enumerate(frames):
            cam = Camera.create(R=R, t=T, fovx=fovx, fovy=fovy, width=width,
                                height=height, time=idx / max_frames,
                                view_id=index, time_id=idx)
            rec = FrameRecord(camera=cam,
                              image_path=os.path.join(img_dir, fname),
                              image_name=f"cam{index:02d}_{idx:04d}")
            (test if index == eval_index else train).append(rec)

    pcd = None
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        cols = read_ply(ply_path)
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        rgb = (np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
               if "red" in cols else np.full_like(xyz, 0.5))
        pcd = PointCloud(xyz, rgb, np.zeros_like(xyz))

    return LegacyScene(train=train, test=test,
                       video=[r.camera for r in test] or
                             [r.camera for r in train],
                       point_cloud=pcd,
                       radius=nerfpp_radius([r.camera for r in train]),
                       maxtime=1.0)


# ------------------------------------------------------------------ HyperNeRF


def load_hypernerf_scene(path: str, ratio: float = 0.5) -> LegacyScene:
    """HyperNeRF/Nerfies parity (hyper_loader.py:35-160,
    dataset_readers.py:469-499): dataset.json ids + train/val split (every
    4th frame trains, offset-2 tests when no val_ids), metadata.json warp_id
    times, camera/<id>.json orientation/position/focal, positions scaled by
    scene.json center+scale, images under rgb/<1/ratio>x/."""
    with open(os.path.join(path, "scene.json")) as f:
        scene_json = json.load(f)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "dataset.json")) as f:
        dataset = json.load(f)

    center = np.asarray(scene_json["center"])
    scale = float(scene_json["scale"])
    ids = dataset["ids"]
    val_ids = dataset.get("val_ids", [])
    if len(val_ids) == 0:
        i_train = np.arange(len(ids))[::4]
        i_test = (i_train + 2)[:-1]
    else:
        train_ids = set(dataset["train_ids"])
        val_set = set(val_ids)
        i_train = [i for i, d in enumerate(ids) if d in train_ids]
        i_test = [i for i, d in enumerate(ids) if d in val_set]

    warp_ids = np.asarray([meta[i]["warp_id"] for i in ids], np.float64)
    times = warp_ids / max(warp_ids.max(), 1)

    records = []
    for i, frame_id in enumerate(ids):
        with open(os.path.join(path, "camera", f"{frame_id}.json")) as f:
            cj = json.load(f)
        orientation = np.asarray(cj["orientation"])
        position = (np.asarray(cj["position"]) - center) * scale
        focal = float(cj["focal_length"]) * ratio
        w, h = [int(round(s * ratio)) for s in cj["image_size"]]
        R = orientation.T
        T = -position @ R
        cam = Camera.create(R=R, t=T, fovx=focal2fov(focal, w),
                            fovy=focal2fov(focal, h), width=w, height=h,
                            time=float(times[i]), view_id=int(meta[frame_id]
                            .get("camera_id", 0)), time_id=int(warp_ids[i]))
        img = os.path.join(path, "rgb", f"{int(1 / ratio)}x", f"{frame_id}.png")
        records.append(FrameRecord(camera=cam, image_path=img,
                                   image_name=frame_id))

    train = [records[i] for i in i_train]
    test = [records[i] for i in i_test]

    pcd = None
    pts_path = os.path.join(path, "points.npy")
    if os.path.exists(pts_path):
        xyz = (np.load(pts_path, allow_pickle=True) - center) * scale
        xyz = xyz.astype(np.float32)
        rng = np.random.default_rng(0)
        pcd = PointCloud(xyz, rng.random((xyz.shape[0], 3)),
                         np.zeros_like(xyz))

    return LegacyScene(train=train, test=test,
                       video=[r.camera for r in test] or
                             [r.camera for r in train],
                       point_cloud=pcd,
                       radius=nerfpp_radius([r.camera for r in train]),
                       maxtime=float(times.max()))


# The reference's sceneLoadTypeCallbacks registry (dataset_readers.py:584-589)
scene_load_callbacks = {
    "Colmap": load_colmap_scene,
    "Blender": load_dnerf_scene,
    "dynerf": load_dynerf_scene,
    "nerfies": load_hypernerf_scene,
}
