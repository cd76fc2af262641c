"""PyTorch port vs the JAX package: the per-scene fit as a whole, and its IO.

One tiny scene (8x8 mesh, 64x64, 2 train views x 3 times) written by the JAX
generator is read by both loaders.

Teacher-forced iterations: with a schedule squeezed so that densify, prune,
opacity reset and barycentric cleanup all fall inside 6 iterations, every
iteration starts both packages from the same JAX state (JAX ``Config`` with
``raster_backend="pallas"``, Pallas in interpret mode), runs the loop's
iteration in each (banked step, density control, cleanup) and compares the
next state at the step's tolerances (tests/test_torch_train.py): ``alive``
and ``face_ids`` exact; Adam's moments and the density statistics at 2e-4
times the leaf's largest magnitude; parameters only where |g| > 1e-3 of the
leaf's largest (Adam moves an element with a round-off gradient by +-lr
whatever its sign), and rows that a density event rewrote within 2.5 lr.

Free-running: 30 iterations of ``train_scene`` in each package from the same
seed (about 35 s here together), with an opacity reset, two densify and
prune rounds and three cleanups on the way; the final train PSNRs (mean of
the last 5 iterations) agree within 0.5 dB. The JAX run uses its CPU
default, the dense tier; the port its K2/K3 plain versions.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.data import mesh_io as jmesh_io
from cloth_splatting_tpu.data import ply_io as jply_io
from cloth_splatting_tpu.data import scene as jscene
from cloth_splatting_tpu.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu.models import gaussians as JG
from cloth_splatting_tpu.train import loop as jloop
from cloth_splatting_tpu.train.config import Config as JConfig
from cloth_splatting_tpu.train.step import StepCarry as JStepCarry
from cloth_splatting_tpu.train.step import Trainer as JTrainer

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data import mesh_io as tmesh_io
from cloth_splatting_tpu_torch.data import ply_io as tply_io
from cloth_splatting_tpu_torch.data import scene as tscene
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.train.__main__ import main as train_main
from cloth_splatting_tpu_torch.train.config import Config as TConfig
from cloth_splatting_tpu_torch.train.step import StepCarry as TStepCarry
from cloth_splatting_tpu_torch.train.step import Trainer as TTrainer

torch.set_num_threads(1)

TOL_GRAD = 2e-4
SCHEDULE = dict(
    iterations=6, densify_from_iter=1, densification_interval=2,
    pruning_from_iter=2, pruning_interval=3, opacity_reset_interval=4,
    bary_cleanup=5, percent_dense=0.012, densify_grad_threshold_fine_init=2e-5,
    densify_grad_threshold_after=2e-5, opacity_threshold_fine_init=0.09,
    opacity_threshold_fine_after=0.09)
FIT_ITERATIONS = 30


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    generate_synthetic_scene(path, n_views=3, n_times=3, image_size=64, mesh_res=8,
                             test_views=(1,), wave="isometric")
    return path


def tree_arrays(x):
    if hasattr(x, "_asdict"):
        return {k: tree_arrays(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def close(a, b, name, rel=TOL_GRAD):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * (float(np.abs(b).max()) + 1e-12),
                               rtol=0, err_msg=name)


# ----------------------------------------------------------------------- IO

def test_loaders_return_the_same_scene(scene_dir):
    js = jscene.load_cloth_scene(scene_dir)
    ts = tscene.load_cloth_scene(scene_dir, device="cpu")
    assert (ts.train.n_views, ts.train.n_times) == (js.train.n_views, js.train.n_times) == (2, 3)
    assert (ts.test.n_views, ts.test.n_times) == (1, 3)
    assert ts.radius == js.radius and ts.maxtime == js.maxtime
    np.testing.assert_array_equal(ts.mesh_predictions, js.mesh_predictions)
    for k, v in js.initial_mesh._asdict().items():
        np.testing.assert_array_equal(getattr(ts.initial_mesh, k).numpy(),
                                      np.asarray(v), err_msg=k)
    for rj, rt in zip(js.train.records + js.test.records,
                      ts.train.records + ts.test.records):
        assert rt.image_name == rj.image_name and rt.image_path == rj.image_path
        for f in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(rt.camera, f),
                                          getattr(rj.camera, f), err_msg=f)
        assert (rt.camera.time, rt.camera.view_id, rt.camera.time_id) == \
            (rj.camera.time, rj.camera.view_id, rj.camera.time_id)
    jb = jloop.build_banks(js.train, True)
    tb = tloop.build_banks(ts.train, True, device="cpu")
    for f, a, b in zip(jb[0]._fields, tb[0], jb[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    assert tb[2] is None and jb[2] is None
    assert tb[1].dtype == torch.uint8 and 0 < float(tb[1].float().mean()) < 255


def test_mesh_and_ply_round_trips(scene_dir, tmp_path):
    mesh = tmesh_io.load_mesh_h5(os.path.join(scene_dir, "init_mesh.hdf5"), "cpu")
    path = str(tmp_path / "m" / "mesh.hdf5")
    tmesh_io.save_mesh_h5(path, mesh)
    back, jback = tmesh_io.load_mesh_h5(path, "cpu"), jmesh_io.load_mesh_h5(path)
    for k in mesh._fields:
        assert torch.equal(getattr(back, k), getattr(mesh, k)), k
        np.testing.assert_array_equal(np.asarray(getattr(jback, k)),
                                      getattr(mesh, k).numpy(), err_msg=k)
    moved = mesh.pos.numpy() + 0.1
    tmesh_io.save_positions_h5(path, mesh, moved)
    np.testing.assert_array_equal(tmesh_io.load_mesh_h5(path, "cpu").pos.numpy(), moved)

    rng = np.random.default_rng(0)
    n, k = 17, 4
    args = [rng.normal(size=s).astype(np.float32) for s in
            ((n, 3), (n, 1, 3), (n, k - 1, 3), (n, 1), (n, 3), (n, 4))]
    kw = dict(face_bary=rng.uniform(size=(n, 3)).astype(np.float32),
              face_offset=np.zeros((n, 1), np.float32),
              face_ids=rng.integers(0, 50, n))
    cols = tply_io.gaussian_ply_columns(*args, **kw)
    assert list(cols) == list(jply_io.gaussian_ply_columns(*args, **kw))
    ply = str(tmp_path / "pc.ply")
    tply_io.write_ply(ply, cols)
    for back in (tply_io.read_ply(ply), jply_io.read_ply(ply)):
        assert list(back) == list(cols)
        for name, col in cols.items():
            np.testing.assert_array_equal(back[name], np.asarray(col, np.float32).reshape(-1),
                                          err_msg=name)


# ----------------------------------------------------------- teacher-forced

def trainers(scene_dir, overrides):
    js = jscene.load_cloth_scene(scene_dir)
    ts = tscene.load_cloth_scene(scene_dir, device="cpu")
    jcfg, tcfg = JConfig(), TConfig()
    jcfg.opt.raster_backend = "pallas"
    for key, value in overrides.items():
        setattr(jcfg.opt, key, value)
        setattr(tcfg.opt, key, value)
    cam0 = js.train.get(0, 0).camera
    jtr = JTrainer(jcfg, js.initial_mesh, jnp.asarray(js.mesh_predictions),
                   cam0.width, cam0.height, cam0.tanfovx, cam0.tanfovy, js.radius)
    ttr = TTrainer(tcfg, ts.initial_mesh, torch.from_numpy(ts.mesh_predictions),
                   cam0.width, cam0.height, cam0.tanfovx, cam0.tanfovy, ts.radius)
    return js, ts, jtr, ttr


def test_teacher_forced_iterations_match_jax(scene_dir):
    js, ts, jtr, ttr = trainers(scene_dir, SCHEDULE)
    o = jtr.cfg.opt
    jbank = jloop.build_banks(js.train, True)
    tbank = tloop.build_banks(ts.train, True, device="cpu")
    rng = np.random.default_rng(0)
    params, gstate = JG.init_from_mesh(rng, js.initial_mesh, 3, 2)
    # the mesh init gives every Gaussian the same scale, neither cloned nor
    # split apart: spread the scales, and the opacities for the prune
    params = params._replace(
        scaling=params.scaling + jnp.asarray(
            rng.normal(0, 0.5, params.scaling.shape), jnp.float32),
        opacity=params.opacity + jnp.asarray(
            rng.normal(0, 1.0, params.opacity.shape), jnp.float32))
    jstate = jtr.init_state(rng, params, gstate)
    sample_rng = np.random.default_rng([6666, 1])
    key = jax.random.PRNGKey(6666)
    # The grid's Delaunay triangulation holds sliver faces of no area along
    # the boundary. A split child's barycentric coordinates divide by the
    # face's squared area, so on those faces they are round-off over
    # round-off in either package (JAX's jitted and eager results differ by
    # thousands): Gaussians on them are left out of the face_bary comparison.
    tri = np.asarray(js.initial_mesh.pos)[np.asarray(js.initial_mesh.faces)]
    well = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                          axis=1) > 1e-6
    assert well.sum() > 0.8 * well.size
    events = {"densify": 0, "prune": 0, "reset": 0, "cleanup": 0, "born": 0,
              "killed": 0, "moved_face": 0}

    for it in range(1, o.iterations + 1):
        tstate = convert.train_state(tree_arrays(jstate), "cpu")
        cap = int(tstate.params.face_bary.shape[0])
        vi = int(sample_rng.integers(js.train.n_views))
        t_ids = jloop.sample_time_ids(sample_rng, js.train.n_times, True)
        key, sub = jax.random.split(key)
        eps = torch.from_numpy(np.array(jax.random.normal(sub, (2, cap, 3))))

        # one loop iteration in each package
        jstep, jm, _ = jtr.step_banked(jstate, *jbank, vi, t_ids, sh_degree=0,
                                       static=False, carry=JStepCarry.zeros())
        jnext, jovf = jtr.density_control(jstep, it, sub)
        cams = type(tbank[0])(*(f[vi, t_ids] for f in tbank[0]))
        gts = tbank[1][vi, t_ids].float() / 255.0
        grads = ttr.backward(ttr.forward(tstate, cams, gts, None, 0, False))[0]
        tstep, tm, _ = ttr.step_banked(tstate, *tbank, vi, t_ids, sh_degree=0,
                                       static=False, carry=TStepCarry.zeros("cpu"))
        tnext, tovf = ttr.density_control(tstep, it, eps=eps)
        if it % o.bary_cleanup == 0:
            jnext, tnext = jtr.cleanup_barycentric(jnext), ttr.cleanup_barycentric(tnext)
            events["cleanup"] += 1
            events["moved_face"] += int((np.asarray(jnext.gstate.face_ids)
                                         != np.asarray(jstep.gstate.face_ids)).sum())

        # the step
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(float(tm.psnr), float(jm.psnr), rtol=1e-5)
        lrs = ttr._lr_tree(tstate.step)
        sure = {}
        for k in params._fields:
            g = getattr(grads, k).numpy()
            sure[k] = np.abs(g) > 1e-3 * (np.abs(g).max() + 1e-30)
            np.testing.assert_allclose(
                getattr(tstep.params, k).numpy()[sure[k]],
                np.asarray(getattr(jstep.params, k))[sure[k]], rtol=1e-5, atol=1e-6,
                err_msg=f"iteration {it} step param {k}")
            close(getattr(tstep.g_opt.mu, k), getattr(jstep.g_opt.mu, k), f"{it} mu.{k}")
            close(getattr(tstep.g_opt.nu, k), getattr(jstep.g_opt.nu, k), f"{it} nu.{k}")
        for k, v in jstep.sim_params._asdict().items():
            close(tstep.sim_opt.mu[k], getattr(jstep.sim_opt.mu, k), f"{it} sim mu.{k}")
        close(tstep.gstate.grad_accum, jstep.gstate.grad_accum, f"{it} grad_accum")
        np.testing.assert_array_equal(tstep.gstate.denom.numpy(), jstep.gstate.denom)

        # the whole iteration
        assert int(tovf) == int(jovf) == 0
        assert int(tnext.step) == int(jnext.step) == it
        for k in ("alive", "face_ids", "denom"):
            np.testing.assert_array_equal(getattr(tnext.gstate, k).numpy(),
                                          np.asarray(getattr(jnext.gstate, k)),
                                          err_msg=f"iteration {it} {k}")
        close(tnext.gstate.grad_accum, jnext.gstate.grad_accum, f"{it} grad_accum")
        close(tnext.gstate.max_radii2d, jnext.gstate.max_radii2d, f"{it} radii")
        for k in params._fields:
            a = getattr(tnext.params, k).numpy()
            b, b_step = (np.asarray(getattr(s.params, k)) for s in (jnext, jstep))
            # rows no event rewrote keep the step's element-wise certainty;
            # rewritten rows are copies and transforms of rows within 2 lr
            kept = (b == b_step).reshape(cap, -1).all(1)
            mask = sure[k] & kept.reshape((-1,) + (1,) * (b.ndim - 1))
            np.testing.assert_allclose(a[mask], b[mask], rtol=1e-5, atol=1e-6,
                                       err_msg=f"iteration {it} param {k}")
            rows = well[np.asarray(jnext.gstate.face_ids)] if k == "face_bary" \
                else np.ones(cap, bool)
            np.testing.assert_allclose(
                a[rows], b[rows], atol=2.5 * float(getattr(lrs, k)) + 1e-4,
                err_msg=f"iteration {it} param {k} (all rows)")
            close(getattr(tnext.g_opt.mu, k), getattr(jnext.g_opt.mu, k), f"{it} mu.{k}")

        due = JTrainer.density_control_due(jtr.cfg, it)
        assert TTrainer.density_control_due(ttr.cfg, it) == due
        born = int((np.asarray(jnext.gstate.alive) & ~np.asarray(jstep.gstate.alive)).sum())
        killed = int((~np.asarray(jnext.gstate.alive) & np.asarray(jstep.gstate.alive)).sum())
        events["born"] += born
        events["killed"] += killed
        events["densify"] += it > o.densify_from_iter and it % o.densification_interval == 0
        events["prune"] += it > o.pruning_from_iter and it % o.pruning_interval == 0
        events["reset"] += it % o.opacity_reset_interval == 0 or it == o.densify_from_iter
        jstate = jnext

    # every event ran, and did something
    assert events["densify"] == 3 and events["prune"] == 2 and events["reset"] == 2
    assert events["cleanup"] == 1
    assert events["born"] > 0 and events["killed"] > 0, events


# ------------------------------------------------------------- free-running

def test_short_fit_matches_jax_psnr(scene_dir, tmp_path):
    # the opacity reset of a white-background scene falls on iteration 8
    # (densify_from_iter); the threshold keeps the densify rounds inside the
    # initial capacity, so the JAX step compiles once
    over = dict(iterations=FIT_ITERATIONS, densify_from_iter=8,
                densification_interval=8, densify_grad_threshold_fine_init=2e-3,
                densify_grad_threshold_after=2e-3, pruning_from_iter=8,
                pruning_interval=8, opacity_reset_interval=1000, bary_cleanup=10)
    js, ts, jtr, ttr = trainers(scene_dir, over)
    jtr.cfg.opt.raster_backend = "auto"
    psnrs = {"jax": [], "torch": []}
    jfinal = jloop.train_scene(
        jtr.cfg, js, str(tmp_path / "jax"), seed=3, progress_every=1000,
        checkpoint_iterations=[FIT_ITERATIONS],
        on_iteration=lambda i, m: psnrs["jax"].append(m["psnr"]))
    tfinal = tloop.train_scene(
        ttr.cfg, ts, str(tmp_path / "torch"), seed=3, progress_every=1000,
        test_iterations=[FIT_ITERATIONS], save_iterations=[FIT_ITERATIONS],
        checkpoint_iterations=[FIT_ITERATIONS],
        on_iteration=lambda i, m: psnrs["torch"].append(m["psnr"]), device="cpu")
    assert len(psnrs["torch"]) == len(psnrs["jax"]) == FIT_ITERATIONS
    last = {k: float(np.mean(v[-5:])) for k, v in psnrs.items()}
    after_reset = {k: float(np.mean(v[8:13])) for k, v in psnrs.items()}
    assert last["torch"] > after_reset["torch"] + 0.5, (after_reset, last)
    assert abs(last["torch"] - last["jax"]) < 0.5, (after_reset, last)
    assert int(tfinal.step) == int(jfinal.step) == FIT_ITERATIONS
    n_t, n_j = int(tfinal.gstate.alive.sum()), int(jfinal.gstate.alive.sum())
    n_0 = 2 * int(ts.initial_mesh.faces.shape[0])
    assert n_t > n_0 and abs(n_t - n_j) <= 0.05 * n_j, (n_0, n_t, n_j)

    # what the port wrote reads back equal, and JAX's checkpoint loads
    out = tmp_path / "torch"
    again = tloop.load_train_checkpoint(str(out / f"chkpnt{FIT_ITERATIONS}.npz"), tfinal)
    for name in ("params", "gstate"):
        for k, v in getattr(tfinal, name)._asdict().items():
            assert torch.equal(getattr(getattr(again, name), k), v), k
    for k, v in tfinal.sim_opt.mu.items():
        assert torch.equal(again.sim_opt.mu[k], v), k
    assert int(again.g_opt.count) == FIT_ITERATIONS and again.step.dtype == torch.int32
    from_jax = convert.train_state_from_checkpoint(
        str(tmp_path / "jax" / f"chkpnt{FIT_ITERATIONS}.npz"), "cpu")
    for k, v in jfinal.params._asdict().items():
        np.testing.assert_array_equal(getattr(from_jax.params, k).numpy(), np.asarray(v))
    np.testing.assert_array_equal(from_jax.gstate.alive.numpy(), np.asarray(jfinal.gstate.alive))
    assert from_jax.gstate.face_ids.dtype == torch.int64
    ply = tply_io.read_ply(str(out / "point_cloud" / f"iteration_{FIT_ITERATIONS}"
                               / "point_cloud.ply"))
    alive = tfinal.gstate.alive.numpy()
    np.testing.assert_array_equal(ply["opacity"], tfinal.params.opacity.numpy()[alive, 0])
    np.testing.assert_array_equal(ply["id"], tfinal.gstate.face_ids.numpy()[alive])
    lines = (out / "metrics.jsonl").read_text().strip().splitlines()
    assert any("test_psnr" in line for line in lines)
    assert (out / "meshnet" / f"model-{FIT_ITERATIONS}.npz").exists()


def test_command_line_runs_a_fit(scene_dir, tmp_path):
    out = tmp_path / "cli"
    train_main(["-s", scene_dir, "-m", str(out), "--iterations", "3",
                "--static_reconst", "--static_reconst_iteration", "2",
                "--test_iterations", "3", "--save_iterations", "3",
                "--checkpoint_iterations", "3", "--device", "cpu"])
    assert (out / "chkpnt3.npz").exists() and (out / "cfg_args").exists()
    state = convert.train_state_from_checkpoint(str(out / "chkpnt3.npz"), "cpu")
    assert int(state.step) == 3
    # the simulator is frozen in the static stage (iteration 1) and moves after
    assert float(state.sim_opt.count) == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["-s", scene_dir, "-m", str(out), "--iterations", "1"])
