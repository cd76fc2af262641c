"""PyTorch port vs the JAX package: evaluation (render sets from a trained
checkpoint, tracking export, flow overlays, LPIPS, the metrics) and the
``eval.render`` / ``eval.metrics`` command lines.

One tiny scene (6x6 mesh, 32 px, 3 views x 3 times, view 1 held out) written
by the port's generator is read by both packages; its train split
interleaves the views within each time. A trained model is written into a
model directory by the JAX package's own writers: Gaussians of
``target_gaussians(mesh, 1)`` with every ninth one dead and seeded rotations,
and a residual simulator whose output layer is scaled up so the residual
shows. Tolerances: frames 3e-4 against JAX ``render(...,
backend="pallas_fwd")`` (Pallas in interpret mode; the tolerance of
tests/test_pallas_raster.py); trajectories and deformation logs 1e-5 (they
come from the front end, so the tier JAX picks on the CPU does not matter;
depth is the tier's and is not compared); LPIPS 1e-5 relative; the fixture
weights bit for bit; ``results.json`` 1e-5 relative; numpy-only functions
exactly, the rotation path 1e-6.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics as jmetrics_cli
from cloth_splatting_tpu.data import scene as jscene
from cloth_splatting_tpu.data.synthetic import orbit_camera as jorbit_camera
from cloth_splatting_tpu.data.synthetic import target_gaussians as jtarget_gaussians
from cloth_splatting_tpu.eval import flow_viz as jflow
from cloth_splatting_tpu.eval import lpips_jax
from cloth_splatting_tpu.eval import render_sets as jrs
from cloth_splatting_tpu.eval import tracking as jtracking
from cloth_splatting_tpu.models.deform import init_residual_simulator
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.render import render as jrender
from cloth_splatting_tpu.train import loop as jloop
from cloth_splatting_tpu.utils import checkpoints as jckpt

from cloth_splatting_tpu_torch.data import scene as tscene
from cloth_splatting_tpu_torch.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu_torch.eval import flow_viz as tflow
from cloth_splatting_tpu_torch.eval import lpips as tlpips
from cloth_splatting_tpu_torch.eval import render_sets as trs
from cloth_splatting_tpu_torch.eval import tracking as ttracking
from cloth_splatting_tpu_torch.eval.metrics import main as metrics_main
from cloth_splatting_tpu_torch.eval.render import main as render_main
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.utils import checkpoints as tckpt

torch.set_num_threads(1)

ITERATION = 7
SH_DEGREE = 1
TOL_RGB = 3e-4
TOL_TRAJ = 1e-5
BG = (1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    generate_synthetic_scene(path, n_views=3, n_times=3, image_size=32, mesh_res=6,
                             test_views=(1,), device="cpu")
    return path


def write_model(path, scene_dir, embedding=False):
    """A trained model written by the JAX package's writers."""
    js = jscene.load_cloth_scene(scene_dir)
    mesh = js.initial_mesh
    params, state = jtarget_gaussians(mesh, SH_DEGREE)
    rng = np.random.default_rng(3)
    alive = np.asarray(state.alive).copy()
    alive[::9] = False
    rotation = np.asarray(params.rotation) + rng.normal(
        0, 0.2, params.rotation.shape).astype(np.float32)
    params = params._replace(rotation=jnp.asarray(rotation))
    state = state._replace(alive=jnp.asarray(alive))
    sim = init_residual_simulator(rng, int(mesh.pos.shape[0]))
    sim = sim._replace(w_out=sim.w_out * 300.0)
    jloop.save_scene_checkpoint(path, ITERATION, types.SimpleNamespace(mesh=mesh),
                                types.SimpleNamespace(params=params, gstate=state,
                                                      sim_params=sim))
    if embedding:
        table = rng.normal(0, 1e-2, (3, mesh.pos.shape[0] * 3)).astype(np.float32)
        jckpt.save_pytree(os.path.join(path, "meshnet", f"model-{ITERATION + 1}.npz"),
                          {"embedding": table})
    with open(os.path.join(path, "cfg_args"), "w") as f:
        f.write(f"Namespace(source_path={scene_dir!r})")
    return path


@pytest.fixture(scope="module")
def model(scene_dir, tmp_path_factory):
    path = write_model(str(tmp_path_factory.mktemp("model")), scene_dir)
    js = jscene.load_cloth_scene(scene_dir)
    ts = tscene.load_cloth_scene(scene_dir, device="cpu")
    jax_model = jrs.load_trained_model(path, js)
    return types.SimpleNamespace(
        path=path, js=js, ts=ts, jax=jax_model,
        port=trs.load_trained_model(path, device="cpu"),
        n_alive=int(np.asarray(jax_model[1].alive).sum()),
        jpreds=jnp.asarray(js.mesh_predictions),
        tpreds=torch.from_numpy(ts.mesh_predictions))


def port_tree(model_tuple):
    """(params, state, mesh, simulator params) of the port as numpy dicts."""
    params, state, mesh, simulator, _ = model_tuple
    sim = {k: p.detach().numpy() for k, p in simulator.named_parameters()}
    return ({k: v.numpy() for k, v in params._asdict().items()},
            {k: v.numpy() for k, v in state._asdict().items()},
            {k: v.numpy() for k, v in mesh._asdict().items()}, sim)


def jax_tree(model_tuple):
    params, state, mesh, sim, _ = model_tuple
    return tuple({k: np.asarray(v) for k, v in t._asdict().items()}
                 for t in (params, state, mesh, sim))


def assert_trees_equal(a, b):
    for part_a, part_b in zip(a, b):
        assert set(part_a) == set(part_b)
        for k in part_a:
            np.testing.assert_array_equal(part_a[k], part_b[k], err_msg=k)


# ------------------------------------------------------------- checkpoints

def test_checkpoint_lookups_match_jax(tmp_path):
    d = tmp_path / "ckpt"
    for name in ("model-3.npz", "model-12.npz", "model-x.npz", "amodel-5.npz",
                 "model-40.pt", "other.npz"):
        (d / "meshnet").mkdir(parents=True, exist_ok=True)
        (d / "meshnet" / name).write_bytes(b"")
    for name in ("iteration_5", "iteration_40", "iteration_x", "iter_90", "foo"):
        (d / "point_cloud" / name).mkdir(parents=True)
    (d / "empty").mkdir()
    for sub in ("meshnet", "point_cloud", "empty", "missing"):
        path = str(d / sub)
        assert tckpt.latest_checkpoint(path) == jckpt.latest_checkpoint(path)
        assert tckpt.search_max_iteration(path) == jckpt.search_max_iteration(path)
    assert tckpt.latest_checkpoint(str(d / "meshnet")).endswith("model-12.npz")
    assert tckpt.search_max_iteration(str(d / "point_cloud")) == 40
    pattern = r"model-(\d+)\.pt"
    assert tckpt.latest_checkpoint(str(d / "meshnet"), pattern) == \
        jckpt.latest_checkpoint(str(d / "meshnet"), pattern)


# ------------------------------------------------------------ video cameras

CAMERA_FIELDS = ("world_view", "full_proj", "camera_center")


def assert_cameras_match(tcams, jcams):
    assert len(tcams) == len(jcams)
    for tc, jc in zip(tcams, jcams):
        for f in CAMERA_FIELDS:
            np.testing.assert_allclose(getattr(tc, f), getattr(jc, f), atol=1e-6,
                                       rtol=0, err_msg=f)
        assert abs(tc.time - jc.time) <= 1e-6
        assert (tc.width, tc.height, tc.view_id, tc.time_id) == \
            (jc.width, jc.height, jc.view_id, jc.time_id)
        assert tc.fovx == jc.fovx and tc.fovy == jc.fovy


@pytest.mark.parametrize("single_cam,n,size,maxtime", [
    (False, 80, (800, 800), 1.0), (True, 80, (800, 800), 1.0),
    (False, 7, (48, 32), 2.5)])
def test_spherical_video_cameras_match_jax(single_cam, n, size, maxtime):
    fov = 2 * np.arctan(0.4)
    args = (n, fov, size[0], size[1], maxtime)
    assert_cameras_match(tscene.spherical_video_cameras(*args, single_cam=single_cam),
                         jscene.spherical_video_cameras(*args, single_cam=single_cam))


def test_scene_video_cameras_match_jax(scene_dir, tmp_path):
    for single in (False, True):
        assert_cameras_match(
            tscene.load_cloth_scene(scene_dir, single_cam_video=single,
                                    device="cpu").video_cameras,
            jscene.load_cloth_scene(scene_dir, single_cam_video=single).video_cameras)
    # a scene with its own video.json
    with_video = str(tmp_path / "scene")
    shutil.copytree(scene_dir, with_video)
    shutil.copy(os.path.join(with_video, "transforms_test.json"),
                os.path.join(with_video, "video.json"))
    tcams = tscene.load_cloth_scene(with_video, device="cpu").video_cameras
    assert_cameras_match(tcams, jscene.load_cloth_scene(with_video).video_cameras)
    assert len(tcams) == 3 and tcams[0].width == 32


# ---------------------------------------------------------- trained models

def test_trained_model_loads_as_jax(model):
    assert model.port[-1] == model.jax[-1] == ITERATION
    assert_trees_equal(port_tree(model.port), jax_tree(model.jax))
    params, state = model.port[0], model.port[1]
    assert params.face_bary.shape[0] == 512
    n_alive = int(state.alive.sum())
    assert bool(state.alive[:n_alive].all()) and state.face_ids.dtype == torch.int64
    assert n_alive == model.n_alive


def test_embedding_checkpoint_loads_as_jax(scene_dir, model, tmp_path):
    path = write_model(str(tmp_path / "emb"), scene_dir, embedding=True)
    jm = jrs.load_trained_model(path, model.js)
    tm = trs.load_trained_model(path, device="cpu")
    assert type(tm[3]).__name__ == "EmbeddingSimulator"
    assert_trees_equal(port_tree(tm), jax_tree(jm))


def test_port_checkpoint_reads_in_jax(model, tmp_path):
    params, state, mesh, simulator, _ = model.port
    from cloth_splatting_tpu_torch.models.deform import simulator_params

    tloop.save_scene_checkpoint(
        str(tmp_path), 11, types.SimpleNamespace(mesh=mesh),
        types.SimpleNamespace(params=params, gstate=state,
                              sim_params=simulator_params(simulator)))
    back = jrs.load_trained_model(str(tmp_path), model.js)
    assert back[-1] == 11
    assert_trees_equal(port_tree(model.port), jax_tree(back))


# ---------------------------------------------------------------- frames

def test_render_frames_match_jax_pallas(model):
    jparams, jstate, jmesh, jsim, _ = model.jax
    params, state, mesh, simulator, _ = model.port
    fov = 2 * np.arctan(0.4)
    cams = [jorbit_camera(v, 4, fov, 32, 32, t) for v, t in ((0, 0.2), (3, 0.9))]
    rs = trs.render_frames(cams, params, state, mesh, simulator, model.tpreds,
                           True, SH_DEGREE, keep_logs=True, device="cpu")
    assert len(rs.frames) == 2 and rs.fps > 0 and len(rs.deform_logs) == 2
    for cam, frame, log in zip(cams, rs.frames, rs.deform_logs):
        out = jrender(jcamera_arrays(cam), 32, 32, cam.tanfovx, cam.tanfovy,
                      jparams, jstate, jmesh, jsim, model.jpreds, jnp.ones(3),
                      SH_DEGREE, backend="pallas_fwd", bg_static=BG)
        np.testing.assert_allclose(frame, np.clip(np.asarray(out.rgb), 0, 1),
                                   atol=TOL_RGB, rtol=0)
        for key, field in (("means3D_deform", "means3d"), ("rotations", "rotations"),
                           ("vertice_deform", "vertices"),
                           ("projections", "projections")):
            np.testing.assert_allclose(log[key], np.asarray(getattr(out, field)),
                                       atol=TOL_TRAJ, rtol=0, err_msg=key)
        assert frame.dtype == np.float32 and frame.min() >= 0 and frame.max() <= 1
        assert float((frame < 0.9).mean()) > 0.05


def test_render_set_refuses_untiled_frames_and_missing_card(model, monkeypatch,
                                                            tmp_path):
    """A frame that does not tile by 16 px goes to the dense tier in both
    packages, which raises the same ValueError; without a card the port
    refuses its default device."""
    params, state, mesh, simulator, _ = model.port
    jparams, jstate, jmesh, jsim, _ = model.jax
    cams = [jorbit_camera(0, 4, 0.8, 40, 40, 0.0)]
    with pytest.raises(ValueError, match="multiples of tile_size") as jerr:
        jrs.render_set(str(tmp_path / "jax"), "test", 1, cams, None, jparams,
                       jstate, jmesh, jsim, model.jpreds, True, SH_DEGREE)
    with pytest.raises(ValueError, match="multiples of tile_size") as terr:
        trs.render_set(str(tmp_path), "test", 1, cams, None, params, state, mesh,
                       simulator, model.tpreds, True, SH_DEGREE, device="cpu")
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.render_set(str(tmp_path), "test", 1, [jorbit_camera(0, 4, 0.8, 32, 32, 0.0)],
                       None, params, state, mesh, simulator, model.tpreds, True,
                       SH_DEGREE)


# -------------------------------------------------- render_set as a whole

def run_render_sets(model, root, **kw):
    """JAX's and the port's render_set on the scene's train split (views 0
    and 2 interleaved within each time), each into a model directory of its
    own; returns the two output directories."""
    cams = [r.camera for r in model.js.train.records]
    paths = [r.image_path for r in model.js.train.records]
    assert [(c.view_id, c.time_id) for c in cams[:3]] == [(0, 0), (2, 0), (0, 1)]
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "port")
    jparams, jstate, jmesh, jsim, _ = model.jax
    params, state, mesh, simulator, _ = model.port
    jout = jrs.render_set(jdir, "train", ITERATION, cams, paths, jparams, jstate,
                          jmesh, jsim, model.jpreds, True, SH_DEGREE, **kw)
    tout = trs.render_set(tdir, "train", ITERATION, cams, paths, params, state,
                          mesh, simulator, model.tpreds, True, SH_DEGREE,
                          device="cpu", **kw)
    assert tout["fps"] > 0 and tout["out_dir"] == os.path.join(
        tdir, "train", f"ours_{ITERATION}")
    return jdir, tdir, jout["out_dir"], tout["out_dir"]


@pytest.fixture(scope="module")
def render_sets(model, tmp_path_factory):
    return run_render_sets(model, str(tmp_path_factory.mktemp("sets")),
                           log_deform=True, show_flow=True)


def test_render_set_layout_matches_jax(render_sets):
    jdir, tdir, jout, tout = render_sets
    for sub in ("renders", "gt", "flow"):
        names = sorted(os.listdir(os.path.join(tout, sub)))
        assert names == sorted(os.listdir(os.path.join(jout, sub))), sub
        assert len(names) == 6
    tfiles, jfiles = sorted(os.listdir(tout)), sorted(os.listdir(jout))
    assert tfiles == jfiles
    assert [f for f in tfiles if f.startswith("deform_log_")] == \
        [f"deform_log_{t:03d}.npz" for t in range(6)]
    assert os.path.exists(os.path.join(tdir, "all_trajs.npz"))
    for f in (f for f in tfiles if f.startswith("deform_log_")):
        with np.load(os.path.join(tout, f)) as t, np.load(os.path.join(jout, f)) as j:
            assert t.files == j.files
            for key in ("means3D_deform", "vertice_deform", "rotations",
                        "projections"):
                np.testing.assert_allclose(t[key], j[key], atol=TOL_TRAJ, rtol=0,
                                           err_msg=f"{f} {key}")
            assert t["depth"].shape == j["depth"].shape == (1, 32, 32)


def test_render_set_ground_truth_and_overlays(render_sets):
    jdir, tdir, jout, tout = render_sets
    import imageio.v2 as imageio

    for name in sorted(os.listdir(os.path.join(tout, "gt"))):
        np.testing.assert_array_equal(imageio.imread(os.path.join(tout, "gt", name)),
                                      imageio.imread(os.path.join(jout, "gt", name)))
    overlay = imageio.imread(os.path.join(tout, "flow", "00005.png"))
    base = imageio.imread(os.path.join(tout, "renders", "00005.png"))
    assert overlay.shape == base.shape == (32, 32, 3)
    assert (overlay != base).any()


def test_trajectories_match_jax(model, render_sets):
    jdir, tdir, _, _ = render_sets
    with np.load(os.path.join(tdir, "all_trajs.npz")) as t, \
            np.load(os.path.join(jdir, "all_trajs.npz")) as j:
        assert t.files == j.files == ["traj", "rotations"]
        n = model.n_alive
        assert t["traj"].shape == (3, n, 3) and t["rotations"].shape == (3, n, 4)
        for key in t.files:
            np.testing.assert_allclose(t[key], j[key], atol=TOL_TRAJ, rtol=0,
                                       err_msg=key)


def test_vertex_trajectories_match_jax(model, tmp_path):
    jdir, tdir, _, _ = run_render_sets(model, str(tmp_path), log_deform=True,
                                       track_vertices=True)
    with np.load(os.path.join(tdir, "all_trajs.npz")) as t, \
            np.load(os.path.join(jdir, "all_trajs.npz")) as j:
        assert t["traj"].shape == (3, 36, 3) and t["rotations"].shape == (3, 512, 4)
        for key in ("traj", "rotations"):
            np.testing.assert_allclose(t[key], j[key], atol=TOL_TRAJ, rtol=0,
                                       err_msg=key)


def test_one_entry_per_unique_time(model, tmp_path):
    """Views interleaved within each time ((v0, t0), (v2, t0), (v0, t1), ...)
    share each time's deformation: the exported trajectory has one entry per
    unique time, in time order."""
    import dataclasses

    params, state, mesh, simulator, _ = model.port
    fov = 2 * np.arctan(0.4)
    n_times = 3
    cams = []
    for t in (2, 0, 1):                       # out of time order on purpose
        for v in (0, 2):
            c = jorbit_camera(v, 4, fov, 32, 32, t / (n_times - 1))
            cams.append(dataclasses.replace(c, view_id=v, time_id=t))
    out = trs.render_set(str(tmp_path), "test", 5, cams, None, params, state, mesh,
                         simulator, model.tpreds, True, SH_DEGREE, log_deform=True,
                         device="cpu")
    alive = state.alive.numpy()
    with np.load(os.path.join(str(tmp_path), "all_trajs.npz")) as d:
        assert d["traj"].shape[0] == d["rotations"].shape[0] == n_times
        assert np.all(np.isfinite(d["traj"]))
        for i, t in enumerate((2, 0, 1)):
            with np.load(os.path.join(out["out_dir"],
                                      f"deform_log_{2 * i:03d}.npz")) as log:
                np.testing.assert_array_equal(d["traj"][t],
                                              log["means3D_deform"][alive])
        assert not np.allclose(d["traj"][0], d["traj"][2])


# ------------------------------------------------------- flow and tracking

def test_flow_viz_matches_jax():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(tflow.davis_palette(300), jflow.davis_palette(300))
    np.testing.assert_array_equal(tflow.make_color_wheel(), jflow.make_color_wheel())
    proj = rng.uniform(-4, 36, (60, 2))
    depth = rng.uniform(1, 3, (1, 32, 32)).astype(np.float32)
    pdepth = rng.uniform(1, 3, 60)
    vis = tflow.occlusion_mask(proj, pdepth, depth)
    np.testing.assert_array_equal(vis, jflow.occlusion_mask(proj, pdepth, depth))
    assert 0 < vis.sum() < 60
    img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
    tracks = [proj + rng.normal(0, 1.5, proj.shape) for _ in range(6)]
    drawn = tflow.draw_tracks(img, tracks, vis)
    np.testing.assert_array_equal(drawn, jflow.draw_tracks(img, tracks, vis))
    assert (drawn != img).any()
    flow = rng.normal(0, 3, (24, 20, 2))
    for kw in ({}, {"clip_flow": 2.0}, {"convert_to_bgr": True}):
        np.testing.assert_array_equal(tflow.flow_to_image(flow, **kw),
                                      jflow.flow_to_image(flow, **kw))


def test_tracking_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    t_steps, n, m = 5, 40, 25
    pred = rng.normal(0, 1, (t_steps, n, 3)).astype(np.float32)
    rot = rng.normal(0, 1, (t_steps, n, 4)).astype(np.float32)
    gt = (pred[:, rng.integers(0, n, m)]
          + rng.normal(0, 0.05, (t_steps, m, 3))).astype(np.float32)
    ta, tm = ttracking.align_trajectories(pred, rot, gt)
    ja, jm = jtracking.align_trajectories(pred, rot, gt)
    np.testing.assert_allclose(ta, ja, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm, jm, atol=1e-6, rtol=0)
    ta, tm = ttracking.align_trajectories(pred, None, gt)
    ja, jm = jtracking.align_trajectories(pred, None, gt)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tm, jm)

    np.savez(tmp_path / "all_trajs.npz", traj=pred, rotations=rot)
    np.savez(tmp_path / "gt.npz", traj=gt[:4])
    t = ttracking.evaluate_tracking(str(tmp_path / "all_trajs.npz"),
                                    str(tmp_path / "gt.npz"),
                                    save_aligned=str(tmp_path / "t_aligned.npz"))
    j = jtracking.evaluate_tracking(str(tmp_path / "all_trajs.npz"),
                                    str(tmp_path / "gt.npz"),
                                    save_aligned=str(tmp_path / "j_aligned.npz"))
    assert set(t) == set(j) and (t["n_points"], t["n_times"]) == (m, 4)
    for k in ("mte_mean", "mte_median"):
        assert abs(t[k] - j[k]) <= 1e-6
    with np.load(tmp_path / "t_aligned.npz") as a, np.load(tmp_path / "j_aligned.npz") as b:
        assert a.files == b.files
        np.testing.assert_allclose(a["aligned"], b["aligned"], atol=1e-6, rtol=0)


# ------------------------------------------------------------------- LPIPS

def test_lpips_fixture_weights_bit_identical():
    t, j = tlpips.fixture_weights(), lpips_jax.fixture_weights()
    assert list(t) == list(j)
    for k in t:
        assert t[k].dtype == j[k].dtype == np.float32
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_array_equal(tlpips.fixture_weights(5)["conv_2_1_w"],
                                  lpips_jax.fixture_weights(5)["conv_2_1_w"])
    assert tlpips.FIXTURE_VERSION == lpips_jax.FIXTURE_VERSION
    assert tlpips.VGG_BLOCKS == lpips_jax.VGG_BLOCKS


def seeded_pairs():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_lpips_matches_jax():
    a, b = seeded_pairs()
    w = lpips_jax.fixture_weights()
    j = np.asarray(lpips_jax.lpips({k: jnp.asarray(v) for k, v in w.items()},
                                   jnp.asarray(a), jnp.asarray(b)))
    t = tlpips.lpips(tlpips.to_torch(w, "cpu"), torch.from_numpy(a),
                     torch.from_numpy(b)).numpy()
    assert t.shape == (2,) and np.all(t > 0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


def test_lpips_weights_npz_loads(tmp_path):
    a, b = seeded_pairs()
    rng = np.random.default_rng(4)
    w = {k: (v + rng.normal(0, 0.01, v.shape)).astype(np.float32)
         for k, v in lpips_jax.fixture_weights(1).items()}
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **w)
    assert tlpips.available(path) and not tlpips.available(None)
    loaded = tlpips.load_weights(path, "cpu")
    assert loaded["conv_0_0_w"].shape == (64, 3, 3, 3)
    np.testing.assert_array_equal(loaded["conv_3_2_w"].numpy(),
                                  w["conv_3_2_w"].transpose(3, 2, 0, 1))
    t = tlpips.lpips(loaded, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    j = np.asarray(lpips_jax.lpips(lpips_jax.load_weights(path), jnp.asarray(a),
                                   jnp.asarray(b)))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)
    same = tlpips.lpips(loaded, torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(same, np.zeros(2, np.float32))


# ------------------------------------------------------------ command lines

def test_render_and_metrics_clis_match_jax(scene_dir, model, tmp_path):
    """eval.render then eval.metrics in process on the CPU; results.json and
    per_view.json equal JAX metrics.evaluate's on the same directory."""
    scene = str(tmp_path / "scene")
    shutil.copytree(scene_dir, scene)
    shutil.copy(os.path.join(scene, "transforms_test.json"),
                os.path.join(scene, "video.json"))
    path = write_model(str(tmp_path / "model"), scene)
    results = render_main(["-m", path, "--sh_degree", str(SH_DEGREE), "--log_deform",
                           "--device", "cpu"])
    assert set(results) == {"train", "test", "video"}
    for split, n in (("train", 6), ("test", 3), ("video", 3)):
        renders = os.path.join(path, split, f"ours_{ITERATION}", "renders")
        assert len(os.listdir(renders)) == n, split
    with np.load(os.path.join(path, "all_trajs.npz")) as d:
        # the test split's, written last
        assert d["traj"].shape == (3, model.n_alive, 3)

    def scores(fn):
        fn()
        with open(os.path.join(path, "results.json")) as f:
            res = json.load(f)
        with open(os.path.join(path, "per_view.json")) as f:
            per_view = json.load(f)
        with open(os.path.join(path, "results.txt")) as f:
            return res, per_view, f.read()

    jres, jper, jtxt = scores(lambda: jmetrics_cli.evaluate([path], None,
                                                            splits=("test", "train")))
    tres, tper, ttxt = scores(lambda: metrics_main(
        ["-m", path, "--splits", "test", "train", "--device", "cpu"]))
    assert list(tres) == list(jres) == [f"ours_{ITERATION}", f"train/ours_{ITERATION}"]
    for key in jres:
        assert tres[key]["lpips_weights"] == jres[key]["lpips_weights"] == "fixture-v1"
        for metric in ("SSIM", "PSNR", "LPIPS"):
            a, b = tres[key][metric], jres[key][metric]
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (key, metric, a, b)
            for name, v in jper[key][metric].items():
                w = tper[key][metric][name]
                assert abs(w - v) <= 1e-5 * max(1.0, abs(v)), (key, metric, name)
    assert 5.0 < tres[f"ours_{ITERATION}"]["PSNR"] < 60.0
    assert len(ttxt.splitlines()) == len(jtxt.splitlines()) == 2


def test_clis_default_to_cuda(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_main(["-m", model.path, "--skip_video"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        metrics_main(["-m", model.path])
