"""PyTorch port vs the JAX package: the legacy loaders, the free-xyz point
Gaussians and the legacy fit.

Loaders: the four formats on fixtures written here (COLMAP binary and text,
a NeRF-synthetic scene from the JAX generator, DyNeRF, HyperNeRF), read by
both packages; cameras, splits, times, radius and point clouds equal within
1e-12, decoded images equal. Point Gaussians: initialization, clone, split
(JAX's jitter drawn with ``jax.random`` and passed in), prune, opacity
reset and statistics from the same inputs; ``render_points`` through the
dense tier in both (rgb and depth within 1e-5, radii equal; the L1 + SSIM
gradients within 1e-4 of each leaf's largest); 5 iterations of the JAX
package's ``fit_static_scene`` against the port's capped, dense-tier
``fit_static_scene_capped`` (the loss within 1e-5 relative; the parameters
only where every iteration's JAX gradient is sure, the Adam trap of ROADMAP
queue 3); both ``fit_legacy`` command lines on one scene at k_cap 64 and
2048, the port's given that same fit (the port's own fit is the published
one, an intended divergence: ROADMAP queue 1), so that loading, evaluation
and writing are held alike (at 2048 PSNR within 0.1 dB, at 64 the PSNRs
parting by the JAX evaluation's dropped instances alone).
"""

import dataclasses
import importlib
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.data import legacy as jlegacy
from cloth_splatting_tpu.data import scene as jscene
from cloth_splatting_tpu.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu.models import point_gaussians as JPG
from cloth_splatting_tpu.ops.camera import Camera as JCamera
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.train.losses import image_losses as jimage_losses

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data import legacy as tlegacy
from cloth_splatting_tpu_torch.data import ply_io as tply_io
from cloth_splatting_tpu_torch.data import scene as tscene
from cloth_splatting_tpu_torch.fit_legacy import main as fit_legacy_main
from cloth_splatting_tpu_torch.models import point_gaussians as TPG
from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS
from cloth_splatting_tpu_torch.render import camera_arrays as tcamera_arrays
from cloth_splatting_tpu_torch.train.losses import image_losses as timage_losses

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOADER = 1e-12
TOL_RENDER = 1e-5
TOL_GRAD = 1e-4
TOL_FIT_LOSS = 1e-5
TOL_ORACLE_RGB = 1e-4
TOL_FIT_PSNR_DB = 1e-2
CPU = "cpu"


def arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


# ------------------------------------------------------------------ fixtures

def _png(path, rgba):
    from PIL import Image

    Image.fromarray(rgba).save(path)


def write_colmap(root, binary, n_cams=5, seed=0):
    """A PINHOLE camera, ``n_cams`` posed images (real PNGs) and 3 points."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    quats = rng.normal(size=(n_cams, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    tvecs = rng.normal(size=(n_cams, 3)) + [0, 0, 3]
    xyz = rng.normal(size=(3, 3))
    rgb = rng.integers(0, 256, (3, 3))
    for i in range(n_cams):
        _png(os.path.join(root, "images", f"img_{i:03d}.png"),
             rng.integers(0, 256, (48, 64, 4), dtype=np.uint8))
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<iiQQ", 1, 1, 64, 48))
            f.write(struct.pack("<4d", 50.0, 52.0, 32.0, 24.0))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", n_cams))
            for i in range(n_cams):
                f.write(struct.pack("<i", i + 1))
                f.write(struct.pack("<4d", *quats[i]))
                f.write(struct.pack("<3d", *tvecs[i]))
                f.write(struct.pack("<i", 1))
                f.write(f"img_{i:03d}.png\x00".encode())
                f.write(struct.pack("<Q", 2))
                f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", 3))
            for pid in range(3):
                f.write(struct.pack("<Q", pid))
                f.write(struct.pack("<3d", *xyz[pid]))
                f.write(struct.pack("<3B", *rgb[pid]))
                f.write(struct.pack("<d", 0.1))
                f.write(struct.pack("<Q", 1))
                f.write(struct.pack("<ii", 1, 0))
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# cameras\n1 SIMPLE_RADIAL 64 48 50.0 32.0 24.0 0.01\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# images\n")
            for i in range(n_cams):
                f.write(f"{i + 1} {' '.join(map(str, quats[i].tolist()))} "
                        f"{' '.join(map(str, tvecs[i].tolist()))} 1 img_{i:03d}.png\n")
                f.write("\n" if i == 1 else "1.0 2.0 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# points\n")
            for pid in range(3):
                f.write(f"{pid} {' '.join(map(str, xyz[pid].tolist()))} "
                        f"{' '.join(map(str, rgb[pid]))} 0.1 1 0\n")
    return root


def write_dynerf(root, n_cams=3, n_frames=4):
    os.makedirs(root)
    poses = np.zeros((n_cams, 3, 5))
    rng = np.random.default_rng(1)
    for i in range(n_cams):
        q = rng.normal(size=4)
        poses[i, :, :3] = jlegacy.qvec2rotmat(q / np.linalg.norm(q))
        poses[i, :, 3] = [0.2 * i, 0.1, 1.0]
        poses[i, :, 4] = [48, 64, 50.0]
    bounds = np.tile([0.3, 10.0], (n_cams, 1))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n_cams, 15), bounds], axis=1))
    for i in range(n_cams):
        d = os.path.join(root, f"cam{i:02d}", "images")
        os.makedirs(d)
        for t in range(n_frames):
            open(os.path.join(d, f"{t:04d}.png"), "wb").close()
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    cols = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}
    cols.update(red=rng.random(7), green=rng.random(7), blue=rng.random(7))
    tply_io.write_ply(os.path.join(root, "points3d.ply"), cols)
    return root


def write_hypernerf(root, n=8, val=False):
    os.makedirs(os.path.join(root, "camera"))
    os.makedirs(os.path.join(root, "rgb", "2x"))
    ids = [f"{i:06d}" for i in range(n)]
    dataset = {"ids": ids, "val_ids": ids[1::3] if val else [],
               "train_ids": [i for i in ids if not val or i not in ids[1::3]]}
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump(dataset, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({i: {"warp_id": 2 * k, "camera_id": k % 2, "appearance_id": k}
                   for k, i in enumerate(ids)}, f)
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"center": [0.1, -0.2, 0.3], "scale": 0.7, "near": 0.1,
                   "far": 10.0}, f)
    rng = np.random.default_rng(2)
    for k, i in enumerate(ids):
        q = rng.normal(size=4)
        with open(os.path.join(root, "camera", f"{i}.json"), "w") as f:
            json.dump({"orientation": jlegacy.qvec2rotmat(q / np.linalg.norm(q)).tolist(),
                       "position": [0.1 * k, 0.05 * k, -2.0],
                       "focal_length": 100.0, "principal_point": [32.0, 24.0],
                       "image_size": [64, 48]}, f)
        open(os.path.join(root, "rgb", "2x", f"{i}.png"), "wb").close()
    np.save(os.path.join(root, "points.npy"), rng.normal(size=(10, 3)))
    return root


@pytest.fixture(scope="module")
def dnerf_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dnerf"))
    generate_synthetic_scene(path, n_views=4, n_times=2, image_size=48)
    return path


# ------------------------------------------------------------------ loaders

def assert_same_camera(tc, jc, what):
    for f in dataclasses.fields(jc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_LOADER,
                                       err_msg=f"{what}.{f.name}")
        elif isinstance(b, float):
            assert abs(a - b) <= TOL_LOADER, (what, f.name, a, b)
        else:
            assert a == b, (what, f.name, a, b)


def assert_same_scene(ts, js, images: bool, white_background=False):
    for split in ("train", "test"):
        tr, jr = getattr(ts, split), getattr(js, split)
        assert len(tr) == len(jr), split
        for i, (a, b) in enumerate(zip(tr, jr)):
            assert (a.image_path, a.image_name, a.mask_path) == \
                (b.image_path, b.image_name, b.mask_path)
            assert_same_camera(a.camera, b.camera, f"{split}[{i}]")
            if images:
                np.testing.assert_array_equal(
                    tscene.decode_image(a.image_path, white_background),
                    jscene.decode_image(b.image_path, white_background))
    assert len(ts.video) == len(js.video)
    for i, (a, b) in enumerate(zip(ts.video, js.video)):
        assert_same_camera(a, b, f"video[{i}]")
    assert abs(ts.radius - js.radius) <= TOL_LOADER and ts.maxtime == js.maxtime
    assert (ts.point_cloud is None) == (js.point_cloud is None)
    if js.point_cloud is not None:
        for f in ("points", "colors", "normals"):
            np.testing.assert_allclose(getattr(ts.point_cloud, f),
                                       getattr(js.point_cloud, f), rtol=0,
                                       atol=TOL_LOADER, err_msg=f)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_colmap_loader_matches_jax(tmp_path, binary):
    root = write_colmap(str(tmp_path), binary)
    for kw in (dict(eval_split=True, llffhold=2), dict()):
        ts, js = tlegacy.load_colmap_scene(root, **kw), jlegacy.load_colmap_scene(root, **kw)
        assert len(ts.train) > 0 and ts.point_cloud.points.shape == (3, 3)
        assert_same_scene(ts, js, images=True)
    if binary:
        sparse = os.path.join(root, "sparse", "0")
        for name in ("cameras", "images"):
            fn = f"read_colmap_{name}_binary"
            t, j = getattr(tlegacy, fn)(f"{sparse}/{name}.bin"), \
                getattr(jlegacy, fn)(f"{sparse}/{name}.bin")
            assert t.keys() == j.keys()
        for a, b in zip(tlegacy.read_colmap_points3d_binary(f"{sparse}/points3D.bin"),
                        jlegacy.read_colmap_points3d_binary(f"{sparse}/points3D.bin")):
            np.testing.assert_array_equal(a, b)
    q = np.asarray([0.9238795, 0.1, 0.3826834, -0.2])
    np.testing.assert_array_equal(tlegacy.qvec2rotmat(q), jlegacy.qvec2rotmat(q))


def test_dnerf_loader_and_callbacks_match_jax(dnerf_dir):
    assert set(tlegacy.scene_load_callbacks) == set(jlegacy.scene_load_callbacks)
    for kw in (dict(), dict(eval_split=False, seed=3, n_random_points=500),
               dict(white_background=False, time_skip=2)):
        ts = tlegacy.scene_load_callbacks["Blender"](dnerf_dir, **kw)
        js = jlegacy.scene_load_callbacks["Blender"](dnerf_dir, **kw)
        assert_same_scene(ts, js, images=True,
                          white_background=kw.get("white_background", True))
    c = tlegacy.dnerf_init_cloud(2000, 0).colors
    assert np.all(np.abs(c - 0.5) < 0.0012)     # SH2RGB(rand / 255): mid grey


def test_dynerf_and_hypernerf_loaders_match_jax(tmp_path):
    root = write_dynerf(str(tmp_path / "dynerf"))
    for kw in (dict(), dict(eval_index=1, downsample=2.0, max_frames=3)):
        ts = tlegacy.scene_load_callbacks["dynerf"](root, **kw)
        js = jlegacy.scene_load_callbacks["dynerf"](root, **kw)
        assert len(ts.train) > 0 and ts.point_cloud.points.shape == (7, 3)
        assert_same_scene(ts, js, images=False)
    for val in (False, True):
        root = write_hypernerf(str(tmp_path / f"hyper{val}"), val=val)
        ts = tlegacy.scene_load_callbacks["nerfies"](root)
        js = jlegacy.scene_load_callbacks["nerfies"](root)
        assert len(ts.train) > 0 and len(ts.test) > 0
        assert_same_scene(ts, js, images=False)


# ------------------------------------------------------------ point Gaussians

def cloud(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, size=(n, 3)).astype(np.float32),
            rng.random((n, 3)).astype(np.float32))


def init_both(n=64, sh_degree=3, capacity=128, colors=True, seed=0):
    pts, cols = cloud(n, seed)
    cols = cols if colors else None
    jp, js = JPG.init_from_point_cloud(np.random.default_rng(seed), pts, cols,
                                       sh_degree, capacity=capacity)
    tp, ts = TPG.init_from_point_cloud(np.random.default_rng(seed), pts, cols,
                                       sh_degree, capacity=capacity, device=CPU)
    return jp, js, tp, ts


def assert_tree(t_nt, j_nt, atol=1e-6, rel=True, what=""):
    for k, v in arrays(j_nt).items():
        a = getattr(t_nt, k).detach().numpy()
        if v.dtype == np.bool_:
            np.testing.assert_array_equal(a, v, err_msg=f"{what}{k}")
        else:
            scale = (float(np.abs(v).max()) + 1e-12) if rel else 1.0
            np.testing.assert_allclose(a, v, rtol=0, atol=atol * scale,
                                       err_msg=f"{what}{k}")


@pytest.mark.parametrize("colors", [True, False], ids=["colors", "random_sh"])
def test_point_init_matches_jax(colors):
    jp, js, tp, ts = init_both(colors=colors)
    assert_tree(tp, jp, what="params.")
    assert_tree(ts, js, what="state.")
    assert int(ts.alive.sum()) == 64 and tp.xyz.shape == (128, 3)


def test_point_density_control_matches_jax():
    jp, js, _, _ = init_both(n=16, sh_degree=1, capacity=64)
    tp, ts = convert.point_gaussian_params(arrays(jp), CPU), \
        convert.point_gaussian_state(arrays(js), CPU)
    grads = np.where(np.arange(64) < 6, 1.0, 0.0).astype(np.float32)
    grads[2] = 0.2
    jc = JPG.densify_clone(jp, js, jnp.asarray(grads), 0.5, 0.01, 100.0)
    tc = TPG.densify_clone(tp, ts, torch.from_numpy(grads), 0.5, 0.01, 100.0)
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(key, (2, 64, 3)))
    jsplit = JPG.densify_split(jp, js, jnp.asarray(grads), 0.5, 0.0, 1e-6, key)
    tsplit = TPG.densify_split(tp, ts, torch.from_numpy(grads), 0.5, 0.0, 1e-6,
                               torch.from_numpy(eps))
    for name, j, t in (("clone", jc, tc), ("split", jsplit, tsplit)):
        assert_tree(t.params, j.params, what=f"{name}.params.")
        assert_tree(t.state, j.state, what=f"{name}.state.")
        np.testing.assert_array_equal(t.touched.numpy(), np.asarray(j.touched))
        assert int(t.overflow) == int(j.overflow)
    assert int(tsplit.state.alive.sum()) == 21 and int(tc.state.alive.sum()) == 21
    # more sources than free slots: the surplus is the overflow
    full = js._replace(alive=jnp.ones(64, bool))
    jo = JPG.densify_clone(jp, full, jnp.ones(64), 0.5, 0.01, 100.0)
    to = TPG.densify_clone(tp, convert.point_gaussian_state(arrays(full), CPU),
                           torch.ones(64), 0.5, 0.01, 100.0)
    assert int(to.overflow) == int(jo.overflow) == 64

    low = np.asarray(jp.opacity).copy()
    low[:5] = -9.0
    jp2, tp2 = jp._replace(opacity=jnp.asarray(low)), tp._replace(opacity=torch.from_numpy(low))
    jr = js._replace(max_radii2d=jnp.arange(64.0))
    tr = ts._replace(max_radii2d=torch.arange(64.0))
    for size in (None, 30.0):
        np.testing.assert_array_equal(
            TPG.prune(tp2, tr, 0.005, 1.0, size).alive.numpy(),
            np.asarray(JPG.prune(jp2, jr, 0.005, 1.0, size).alive))
    assert_tree(TPG.reset_opacity(tp2), JPG.reset_opacity(jp2), what="reset.")
    rng = np.random.default_rng(5)
    norm, radii = rng.random(64).astype(np.float32), rng.random(64).astype(np.float32) * 9
    vis = rng.random(64) > 0.4
    assert_tree(TPG.add_densification_stats(ts, torch.from_numpy(norm),
                                            torch.from_numpy(radii), torch.from_numpy(vis)),
                JPG.add_densification_stats(js, jnp.asarray(norm), jnp.asarray(radii),
                                            jnp.asarray(vis)), what="stats.")


def camera(width=48, height=48, fov=0.9, z=2.2):
    return JCamera.create(R=np.eye(3), t=np.asarray([0.05, -0.03, z]), fovx=fov,
                          fovy=fov, width=width, height=height)


def test_render_points_and_gradients_match_jax():
    jp, js, _, _ = init_both(n=300, sh_degree=2, capacity=512, seed=6)
    # anisotropic, rotated, partly transparent and view-dependent Gaussians
    rng = np.random.default_rng(8)
    jp = jp._replace(
        scaling=jp.scaling + jnp.asarray(rng.normal(0, 0.4, (512, 3)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(512, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(0, 1.5, (512, 1)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.2, (512, 8, 3)), jnp.float32))
    tp, ts = convert.point_gaussian_params(arrays(jp), CPU), \
        convert.point_gaussian_state(arrays(js), CPU)
    cam = camera()
    tan = float(np.tan(cam.fovx / 2))
    gt = np.random.default_rng(7).random((3, 48, 48)).astype(np.float32)
    bg = (1.0, 1.0, 1.0)

    def jloss(p):
        rgb, depth, radii = JPG.render_points(p, js, jcamera_arrays(cam), 48, 48, tan,
                                              tan, jnp.asarray(bg), 2, k_cap=64)
        return jimage_losses(rgb[None], jnp.asarray(gt)[None], 0.2)[0], (rgb, depth, radii)

    (jl, (jrgb, jdepth, jradii)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = TPG.PointGaussianParams(*(x.clone().requires_grad_() for x in tp))
    # the JAX package's rule: splats capped at 24 px (the port's point model
    # is uncapped unless told)
    rgb, depth, radii = TPG.render_points(leaves, ts, tcamera_arrays(cam, CPU), 48, 48,
                                          tan, tan, bg, 2, k_cap=64,
                                          max_radius=MAX_SPLAT_RADIUS)
    loss = timage_losses(rgb[None], torch.from_numpy(gt)[None], 0.2)[0]
    grads = torch.autograd.grad(loss, list(leaves))
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb), rtol=0,
                               atol=TOL_RENDER)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(jdepth), rtol=0,
                               atol=TOL_RENDER)
    np.testing.assert_array_equal(radii.detach().numpy(), np.asarray(jradii))
    assert float(radii.gt(0).float().mean()) > 0.5
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    for name, g, j in zip(TPG.PointGaussianParams._fields, grads, jg):
        j = np.asarray(j)
        err = float(np.abs(g.numpy() - j).max())
        print(f"render_points d/d{name}: {err:.3e} of {float(np.abs(j).max()):.3e}")
        assert err <= TOL_GRAD * float(np.abs(j).max()), name


def jax_fit_with_grads(cams, gts, pc, w, h, tan, iterations, sh_degree, k_cap):
    """JAX's ``fit_static_scene`` loop, also returning every iteration's
    gradients (for the mask of sure elements); compiled with the gradients
    as an output, so its rounding is not the fit's own."""
    import optax

    params, state = JPG.init_from_point_cloud(np.random.default_rng(0), pc.points,
                                              pc.colors, sh_degree)
    lrs = {"xyz": 1.6e-4, "features_dc": 2.5e-3, "features_rest": 2.5e-3 / 20,
           "scaling": 5e-3, "rotation": 1e-3, "opacity": 0.05}
    labels = JPG.PointGaussianParams(*JPG.PointGaussianParams._fields)
    tx = optax.multi_transform({k: optax.adam(v, eps=1e-15) for k, v in lrs.items()},
                               labels)
    opt = tx.init(params)
    bg = jnp.ones(3)

    def loss_fn(p, cam, gt):
        rgb, _, _ = JPG.render_points(p, state, cam, w, h, tan, tan, bg, sh_degree,
                                      k_cap=k_cap)
        return jimage_losses(rgb[None], gt[None], lambda_dssim=0.2)[0]

    @jax.jit
    def step(p, o, cam, gt):
        loss, g = jax.value_and_grad(loss_fn)(p, cam, gt)
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), o, loss, g

    grads = []
    for it in range(iterations):
        params, opt, loss, g = step(params, opt, cams[it % len(cams)],
                                    gts[it % len(cams)])
        grads.append(g)
    return params, float(loss), grads


def test_fit_static_scene_matches_jax(dnerf_dir):
    scene = jlegacy.load_dnerf_scene(dnerf_dir, n_random_points=400)
    recs = scene.train[:3]
    cam0 = recs[0].camera
    tan = float(np.tan(cam0.fovx / 2))
    gts = [jscene.decode_image(r.image_path, True).astype(np.float32) / 255.0
           for r in recs]
    jcams = [jcamera_arrays(r.camera) for r in recs]
    kw = dict(sh_degree=1, iterations=5, k_cap=64, white_background=True)
    jparams, _, jloss = JPG.fit_static_scene(jcams, [jnp.asarray(g) for g in gts],
                                             scene.point_cloud, 48, 48, tan, tan, **kw)
    replay, rloss, jgrads = jax_fit_with_grads(jcams, [jnp.asarray(g) for g in gts],
                                               scene.point_cloud, 48, 48, tan, 5, 1, 64)
    assert abs(rloss - jloss) <= TOL_FIT_LOSS * abs(jloss)
    tparams, tstate, tloss = TPG.fit_static_scene_capped(
        [tcamera_arrays(r.camera, CPU) for r in recs], [torch.from_numpy(g) for g in gts],
        scene.point_cloud, 48, 48, tan, tan, device=CPU, **kw)
    print(f"fit_static_scene loss: port {tloss:.8f}, JAX {jloss:.8f}")
    assert abs(tloss - jloss) <= TOL_FIT_LOSS * abs(jloss)
    assert int(tstate.alive.sum()) == 400
    for name in TPG.PointGaussianParams._fields:
        j = np.asarray(getattr(jparams, name))
        g = np.stack([np.abs(np.asarray(getattr(gr, name))) for gr in jgrads])
        peak = g.reshape(5, -1).max(axis=1).reshape((5,) + (1,) * (g.ndim - 1))
        sure = ((g > 1e-3 * peak).all(axis=0)) | (g.max(axis=0) == 0)
        t = getattr(tparams, name).numpy()
        err = float(np.abs(t - j)[sure].max())
        print(f"fit_static_scene {name}: {sure.mean():.3f} sure, max|diff| {err:.3e}")
        assert sure.mean() > 0.3, name
        assert err <= 1e-5 * (float(np.abs(j).max()) + 1.0), name


@pytest.mark.parametrize("k_cap", [64, 2048])
def test_both_fit_legacy_command_lines(dnerf_dir, tmp_path, monkeypatch, k_cap):
    """Both command lines on one scene, the port's given the JAX package's
    capped, dense-tier fit at ``k_cap`` (``fit_static_scene_capped``; its
    own is the published fit, which ``tests/test_torch_points_fit.py``
    holds), fit alike (the final loss within TOL_FIT_LOSS). The port
    evaluates the fit through the serving rasterizer, which drops nothing,
    and the JAX package through the dense tier, which keeps ``k_cap``
    instances a tile; the port's command line has no ``--k_cap``. At 2048,
    which holds the scene's 2,000 Gaussians in every tile, the two evaluate
    one image (PSNR within 0.1 dB). At 64 the dense tier drops, and the two
    PSNRs part by the dropped instances alone: the port's held-out images
    are the O(N*P) oracle's of its fitted model, and that model through the
    dense tier at k_cap 64 scores the JAX package's PSNR."""
    from cloth_splatting_tpu_torch.ops import image as timage
    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference
    from cloth_splatting_tpu_torch.ops.rasterize.tiled import rasterize_tiled

    sys.path.insert(0, REPO)
    root_cli = importlib.import_module("fit_legacy")
    argv = ["-s", dnerf_dir, "--type", "Blender", "-w", "--iterations", "30",
            "--sh_degree", "1"]
    root_cli.main(argv + ["--k_cap", str(k_cap), "-m", str(tmp_path / "jax")])
    # what the port's command line fits, renders and scores after its fit
    fitted, held, gts = [], [], []
    fit, render, psnr = TPG.fit_static_scene_capped, TPG.render_points, timage.psnr

    def fit_kept(*a, **k):
        fitted.append(fit(*a, **k, k_cap=k_cap))
        return fitted[-1]

    def render_kept(*a, **k):
        out = render(*a, **k)
        if fitted:
            held.append((a, k, out[0]))
        return out

    def psnr_kept(img, gt):
        gts.append(gt[0])
        return psnr(img, gt)

    monkeypatch.setattr(TPG, "fit_static_scene", fit_kept)
    monkeypatch.setattr(TPG, "render_points", render_kept)
    monkeypatch.setattr(timage, "psnr", psnr_kept)
    fit_legacy_main(argv + ["-m", str(tmp_path / "torch"), "--device", CPU])
    monkeypatch.undo()
    res = {}
    for name in ("jax", "torch"):
        assert (tmp_path / name / "point_cloud.ply").exists()
        with open(tmp_path / name / "results.json") as f:
            res[name] = json.load(f)["ours_static"]
    print(f"fit_legacy k_cap {k_cap} PSNR: port {res['torch']['PSNR']:.4f}, "
          f"JAX {res['jax']['PSNR']:.4f}")
    assert res["torch"]["iterations"] == 30
    assert abs(res["torch"]["final_loss"] - res["jax"]["final_loss"]) \
        <= TOL_FIT_LOSS * res["jax"]["final_loss"], res
    params, state, _ = fitted[0]
    assert len(held) == len(gts) > 0
    dropped, oracle_err, dense_psnrs = 0, 0.0, []
    for (a, k, rgb), gt in zip(held, gts):
        cam, w, h, tanx, tany, bg, sh = a[2:9]
        proj = TPG.project_points_view(params, state, cam, w, h, tanx, tany, sh,
                                       max_radius=k.get("max_radius"))
        ref = rasterize_reference(proj, w, h, torch.tensor(bg))[0]
        oracle_err = max(oracle_err, float((rgb - ref).abs().max()))
        # the JAX package's evaluation: splats capped at 24 px, the dense tier
        proj = TPG.project_points_view(params, state, cam, w, h, tanx, tany, sh,
                                       max_radius=MAX_SPLAT_RADIUS)
        dense, _, _, aux = rasterize_tiled(proj, w, h, bg, k_cap=k_cap, k_chunk=32)
        dropped += int(aux.n_dropped)
        dense_psnrs.append(float(psnr(torch.clamp(dense, 0, 1)[None], gt[None])[0]))
    dense_psnr = float(np.mean(dense_psnrs))
    print(f"  oracle max|diff| {oracle_err:.3g}, dense tier at k_cap {k_cap}: "
          f"{dropped} dropped, PSNR {dense_psnr:.4f}")
    # the serving walk stops a tile once every pixel's T <= 1e-4, the oracle
    # composites every Gaussian: they part by < 1e-4 of a colour
    assert oracle_err <= TOL_ORACLE_RGB
    assert abs(dense_psnr - res["jax"]["PSNR"]) <= TOL_FIT_PSNR_DB, res
    if k_cap == 64:
        assert dropped > 0
    else:
        assert dropped == 0
        assert abs(res["torch"]["PSNR"] - res["jax"]["PSNR"]) < 0.1, res
    ply = tply_io.read_ply(str(tmp_path / "torch" / "point_cloud.ply"))
    assert ply["x"].shape == (2000,) and "f_rest_0" in ply
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_legacy_main(argv + ["-m", str(tmp_path / "x")])
