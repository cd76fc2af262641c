"""PyTorch port vs the JAX package and vs itself: the (data, model) sharded
splat step, ``ShardedTrainer`` and ``train_scene(device_mesh=...)`` over
``torch.distributed``.

A gloo world of 4 ranks on the CPU is spawned once for the module
(``parallel.launch.launch`` running ``torch_mesh_cases.splat_world``), a
world of 2 once for the comparison with JAX's ``ShardedTrainer``; every case
runs inside them and is asserted here. The inputs are the JAX sharded tests'
(tests/test_sharded_training.py ``_scene``/``_banks``: capacity 512, 32 px,
a 5x5 mesh, ``k_cap`` 64, ``k_chunk`` 16, 2 views x 3 times, the top half
masked out), made with numpy from seeds and carried over as numpy arrays.
The sharded step is held to the port's own unsharded ``Trainer.step_banked``
at least as tightly as JAX's own test holds its sharded step (loss, psnr,
EMA rtol 1e-4; ``face_bary`` atol 5e-5; ``grad_accum`` rtol 1e-3, atol
1e-7; the tighter limits reached are the ``TOL_*`` below), and beyond it
on the rest of the float state: both optimizers' moments and the Gaussian
and simulator parameters (``state_errors``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.data.meshing import grid_cloth_mesh
from cloth_splatting_tpu.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu.models import gaussians as JG
from cloth_splatting_tpu.models.deform import init_residual_simulator
from cloth_splatting_tpu.ops.camera import Camera
from cloth_splatting_tpu.parallel.mesh import make_mesh as jmake_mesh
from cloth_splatting_tpu.parallel.trainer import ShardedTrainer as JShardedTrainer
from cloth_splatting_tpu.render import CameraArrays as JCameraArrays
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.train import step as jstep
from cloth_splatting_tpu.train.config import Config as JConfig

import torch_mesh_cases as cases
from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
from cloth_splatting_tpu_torch.parallel.launch import launch
from cloth_splatting_tpu_torch.parallel.mesh import mesh_shape
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.step import StepCarry
from cloth_splatting_tpu_torch.train_scenes import main as train_scenes_main

torch.set_num_threads(1)

CPU = torch.device("cpu")
# JAX's limits for its sharded step (tests/test_sharded_training.py:96-108),
# which hold the port's 2x1 step against JAX's; JAX's test holds neither
# the moments nor the parameters (``state_errors``): read 1.4e-4 (the
# simulator's first moment) and 1.2e-5 (its parameters)
TOL_JAX = dict(metrics=1e-4, bary=5e-5, accum=(1e-3, 1e-7), moments=1e-3, params=1e-4)
# the port's sharded step against its unsharded one: the sums over the data
# axis run in another order (rounding: grad_accum moved by <= 5e-10, the
# metrics and face_bary by nothing, the moments and parameters by <= 3.5e-7
# (``state_errors``), on every mesh here)
TOL_PORT = dict(metrics=1e-6, bary=1e-7, accum=(1e-5, 1e-9), moments=1e-6, params=1e-6)
# the same regularizer weights as the JAX kNN test, and an anchor
OPT = dict(raster_k_cap=64, raster_k_chunk=16, lambda_anchor=0.5,
           lambda_isometric=0.05, lambda_spring=0.02, lambda_rigidity=0.01)
SCENE_OPT = dict(iterations=30, static_reconst=True, static_reconst_iteration=10,
                 densify_from_iter=5, densification_interval=20, pruning_from_iter=5,
                 pruning_interval=20, densify_until_iter=30,
                 opacity_reset_interval=10_000, bary_cleanup=25, raster_k_cap=128,
                 raster_k_chunk=16, raster_backend="tiled")
CHECKPOINT = 20


def tree_arrays(x):
    if hasattr(x, "_asdict"):
        return {k: tree_arrays(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: tree_arrays(v) for k, v in x.items()}
    return np.asarray(x)


def jax_scene():
    """tests/test_sharded_training.py's ``_scene`` and ``_banks``."""
    rng = np.random.default_rng(0)
    mesh = grid_cloth_mesh(5, 5, size=1.2)
    jcfg = JConfig()
    params, gstate = JG.init_from_mesh(rng, mesh, jcfg.model.sh_degree, 2, capacity=512)
    sim_params = init_residual_simulator(rng, int(mesh.pos.shape[0]))
    preds = jnp.tile(mesh.pos[None], (3, 1, 1))
    fov = 2 * np.arctan(0.4)
    cam = Camera.create(R=np.eye(3), t=np.asarray([0.0, 0.0, 3.0]), fovx=fov, fovy=fov,
                        width=32, height=32, time=0.5)
    rows = []
    for _ in range(2):
        arrs = [jcamera_arrays(dataclasses.replace(cam, time=t))
                for t in np.linspace(0, 1, 3)]
        rows.append(JCameraArrays(*[jnp.stack([getattr(a, f) for a in arrs])
                                    for f in JCameraArrays._fields]))
    cam_bank = JCameraArrays(*[jnp.stack([getattr(r, f) for r in rows])
                               for f in JCameraArrays._fields])
    gt_bank = np.random.default_rng(3).integers(0, 255, (2, 3, 3, 32, 32)).astype(np.uint8)
    mask = np.ones((2, 3, 1, 32, 32), np.float32)
    mask[..., :16, :] = 0.0
    trainer = jstep.Trainer(jcfg, mesh, preds, cam.width, cam.height, cam.tanfovx,
                            cam.tanfovy, spatial_lr_scale=2.0)
    state = trainer.init_state(np.random.default_rng(0), params, gstate, sim_params)
    return trainer, state, mesh, preds, cam, cam_bank, gt_bank, mask


@pytest.fixture(scope="module")
def scene():
    return jax_scene()


@pytest.fixture(scope="module")
def inputs(scene):
    _, state, mesh, preds, cam, cam_bank, gt_bank, mask = scene
    return {"state": tree_arrays(state), "mesh": tree_arrays(mesh),
            "preds": np.array(preds),
            "camera": dict(width=cam.width, height=cam.height,
                           tanfovx=float(cam.tanfovx), tanfovy=float(cam.tanfovy),
                           spatial_lr_scale=2.0),
            "cam_bank": {f: np.array(getattr(cam_bank, f)) for f in JCameraArrays._fields},
            "gt_bank": gt_bank, "mask_bank": mask, "opt": OPT}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_scene"))
    generate_synthetic_scene(path, n_views=3, n_times=3, image_size=32, mesh_res=4,
                             prediction_noise=0.0)
    return path


def run_kwargs():
    return dict(save_iterations=(SCENE_OPT["iterations"],),
                checkpoint_iterations=(CHECKPOINT,),
                test_iterations=(SCENE_OPT["iterations"],), progress_every=5, seed=7)


@pytest.fixture(scope="module")
def world(inputs, scene_dir, tmp_path_factory):
    """Every case of the 4-rank world, run once."""
    out_root = str(tmp_path_factory.mktemp("mesh_runs"))
    run_cfg = {"opt": SCENE_OPT, "kwargs": run_kwargs(), "checkpoint": CHECKPOINT}
    res = launch(cases.splat_world, 4, CPU, args=(inputs, scene_dir, out_root, run_cfg))
    return res[0], out_root


def unsharded(inputs, backend, time_ids, *, static=False, sh_degree=1, masks=True,
              knn=True, **opt):
    """The port's unsharded ``Trainer.step_banked`` on the same inputs."""
    cfg = cases.splat_config(inputs, backend, **opt)
    trainer = cases.splat_trainer(inputs, cfg, CPU)
    state = convert.train_state(inputs["state"], CPU)
    cam_bank, gt_bank, mask_bank = cases.banks(inputs, CPU)
    new, metrics, carry = trainer.step_banked(
        state, cam_bank, gt_bank, mask_bank if masks else None, 1, time_ids,
        sh_degree=sh_degree, static=static,
        knn_state=trainer.compute_knn_state(state) if knn else None,
        carry=StepCarry.zeros(CPU))
    return {"state": cases.arrays(new), "metrics": cases.arrays(metrics),
            "carry": cases.arrays(carry)}


def assert_step_close(got, ref, name, tol):
    """A sharded step's result against a reference step; prints the largest
    differences read."""
    read = {}
    for key in ("loss", "psnr", "l1"):
        a, b = float(got["metrics"][key]), float(ref["metrics"][key])
        np.testing.assert_allclose(a, b, rtol=tol["metrics"], err_msg=f"{name} {key}")
        read[key] = abs(a - b) / abs(b)
    for key in ("ema_loss", "ema_psnr"):
        np.testing.assert_allclose(float(got["carry"][key]), float(ref["carry"][key]),
                                   rtol=tol["metrics"], err_msg=f"{name} {key}")
    for key in ("n_alive", "n_dropped"):
        assert int(got["metrics"][key]) == int(ref["metrics"][key]), key
    gs, rs = got["state"], ref["state"]
    np.testing.assert_allclose(gs["params"]["face_bary"], rs["params"]["face_bary"],
                               atol=tol["bary"], rtol=0, err_msg=f"{name} face_bary")
    np.testing.assert_allclose(gs["gstate"]["grad_accum"], rs["gstate"]["grad_accum"],
                               rtol=tol["accum"][0], atol=tol["accum"][1],
                               err_msg=f"{name} grad_accum")
    for key in ("alive", "face_ids", "denom", "max_radii2d"):
        np.testing.assert_array_equal(gs["gstate"][key], rs["gstate"][key],
                                      err_msg=f"{name} {key}")
    for key in ("face_bary", "grad_accum"):
        tree = "params" if key == "face_bary" else "gstate"
        read[key] = float(np.abs(gs[tree][key] - rs[tree][key]).max())
    read.update(state_errors(gs, rs))
    print(f"{name}: {json.dumps(read)}")
    for key in ("g_opt.mu", "g_opt.nu", "sim_opt.mu", "sim_opt.nu"):
        assert read[key] <= tol["moments"], (name, key, read[key])
    for key in ("params", "sim_params"):
        assert read[key] <= tol["params"], (name, key, read[key])


# a gradient element is clearly nonzero where its first moment is at least
# this share of the optimizer's largest
CLEAR = 1e-3


def state_errors(got: dict, ref: dict) -> dict:
    """The float state the metrics and face_bary do not show: each
    optimizer's moments (the largest difference over the optimizer's
    largest moment of that kind, so a leaf whose gradient is at rounding
    level, as the rotations' here (~4e-12), does not set the scale) and
    the parameters of both (the largest difference over the leaf's largest,
    at the elements whose gradient is clearly nonzero: Adam turns a
    rounding-level gradient into a step of the learning rate's size)."""
    out = {}
    for opt, params in (("g_opt", "params"), ("sim_opt", "sim_params")):
        for m in ("mu", "nu"):
            r, g = ref[opt][m], got[opt][m]
            big = max(max(float(np.abs(v).max()) for v in r.values()), 1e-30)
            out[f"{opt}.{m}"] = max(float(np.abs(g[k] - v).max()) for k, v in r.items()) / big
        mu = ref[opt]["mu"]
        big = max(float(np.abs(v).max()) for v in mu.values())
        worst = 0.0
        for k, p in ref[params].items():
            clear = np.abs(mu[k]) >= CLEAR * big
            if clear.any():
                worst = max(worst, float(np.abs(got[params][k] - p)[clear].max())
                            / max(float(np.abs(p).max()), 1e-30))
        out[params] = worst
    return out


def assert_trees_equal(a, b, name="state"):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), name
        for k in b:
            assert_trees_equal(a[k], b[k], f"{name}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_mesh_shape_matches_jax(n, world):
    """``mesh_shape`` against JAX's ``make_mesh`` on the 8 host devices, and
    the 4-rank world's meshes (names, shape, this rank's coordinate)."""
    assert mesh_shape(n) == tuple(jmake_mesh(n).devices.shape)
    shapes = world[0]["mesh_shapes"]
    assert shapes[1] == ((1, 4), ("data", "model"), (0, 0))
    assert shapes[2] == ((2, 2), ("data", "model"), (0, 0))
    assert shapes[4] == ((4, 1), ("data", "model"), (0, 0))


@pytest.mark.parametrize("backend", ["auto", "tiled"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_sharded_step_matches_unsharded(world, inputs, shape, backend):
    """3 cameras (padded to 4 on a data axis of 2 or 4), masks, the kNN terms
    and the anchor, on K2/K3's plain versions ("auto") and the dense tier."""
    ref = unsharded(inputs, backend, [0, 1, 2])
    got = world[0][f"step {shape} {backend}"]
    assert_step_close(got, ref, f"{shape} {backend}", TOL_PORT)
    if shape[0] == 1:
        # one data row: the gathered bundle is the unsharded one, row for
        # row, and the loss the unsharded bits
        assert float(got["metrics"]["loss"]) == float(ref["metrics"]["loss"])


def test_sharded_splat_step_matches_trainer_step(world, inputs):
    """``make_sharded_splat_step`` (a camera batch on every rank, the JAX
    package's GSPMD front door) on 2x2 against ``Trainer.step``."""
    cfg = cases.splat_config(inputs, "auto")
    trainer = cases.splat_trainer(inputs, cfg, CPU)
    cam_bank, gt_bank, _ = cases.banks(inputs, CPU)
    new, metrics = trainer.step(convert.train_state(inputs["state"], CPU),
                                type(cam_bank)(*(f[1] for f in cam_bank)),
                                gt_bank[1].to(torch.float32) / 255.0, None, 1, False)
    got = world[0]["splat_step"]
    for key in ("loss", "psnr", "l1"):
        np.testing.assert_allclose(float(got["metrics"][key]), float(getattr(metrics, key)),
                                   rtol=TOL_PORT["metrics"], err_msg=key)
    np.testing.assert_allclose(got["state"]["params"]["face_bary"],
                               new.params.face_bary.numpy(), atol=TOL_PORT["bary"], rtol=0)
    np.testing.assert_array_equal(got["state"]["gstate"]["denom"], new.gstate.denom.numpy())


def test_gathered_bundle_renders_the_unsharded_bits(world):
    """The capacity in 4 contiguous blocks, the bundle gathered over the
    model axis in row order: the compositor's stable sort breaks ties as
    on the whole state, and the image is the same, bit for bit."""
    res = world[0]["gathered_render"]
    assert res["bit_equal"], res


def test_static_stage_pad_exceeds_batch(world, inputs):
    """The static stage's one camera on a data axis of 4 (pad 3 > 1)."""
    ref = unsharded(inputs, "auto", [0], static=True, sh_degree=0, masks=False,
                    knn=False)
    assert_step_close(world[0]["static 4x1"], ref, "static 4x1", TOL_PORT)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_n_dropped_matches_unsharded(world, inputs, shape):
    ref = unsharded(inputs, "tiled", [0, 1, 2], masks=False, knn=False,
                    raster_k_cap=8, raster_k_chunk=8)
    assert int(ref["metrics"]["n_dropped"]) > 0
    assert int(world[0][f"dropped {shape}"]) == int(ref["metrics"]["n_dropped"])


def test_density_control_and_cleanup_on_sharded_state(world):
    d = world[0]["density"]
    assert d["overflow"][0] == d["overflow"][1]
    assert int(d["sharded"]["gstate"]["alive"].sum()) > d["n_alive_before"]
    assert_trees_equal(d["sharded"], d["ref"])
    assert d["rounded"] == [1024, 512, 1024]
    assert d["placed_rows"] == 256
    assert d["placed_full"]["params"]["face_bary"].shape[0] == 512
    assert not d["placed_full"]["gstate"]["alive"][130:].any()


def test_collectives_of_one_step(world):
    """One 2x2 step (3 cameras: 2 a data row) with the kNN terms: a bundle
    gather over model per camera and one for the kNN means, one gather of
    the frames over data, their reduce-scatters in the backward, and four
    reductions (the counterpart of tests/test_parallel.py:340-389)."""
    assert world[0]["collectives"] == {
        "all_gather/model": 3, "reduce_scatter/model": 3,
        "all_gather/data": 1, "reduce_scatter/data": 1,
        "all_reduce_sum/data": 1, "all_reduce_sum/world": 1,
        "all_reduce_max/data": 1, "all_reduce_sum/model": 1}


def test_sharded_step_matches_jax_sharded_trainer(scene, inputs):
    """The port's 2x1 step against JAX's ``ShardedTrainer.step_banked`` on
    ``make_mesh(2)``, both on the dense tier, without the anchor (the JAX
    sharded step drops it), with JAX's kNN neighbourhoods in both."""
    jtr, jstate, _, _, _, cam_bank, gt_bank, mask = scene
    jtr.cfg.opt.raster_k_cap, jtr.cfg.opt.raster_k_chunk = 64, 16
    for key in ("lambda_isometric", "lambda_spring", "lambda_rigidity"):
        setattr(jtr.cfg.opt, key, OPT[key])
    knn = jtr.compute_knn_state(jstate)
    runner = JShardedTrainer(jtr, jmake_mesh(2))
    new, metrics, carry = runner.step_banked(
        runner.place_state(jstate), runner.replicate(cam_bank),
        runner.replicate(jnp.asarray(gt_bank)), runner.replicate(jnp.asarray(mask)),
        1, [0, 1, 2], sh_degree=1, static=False, knn_state=runner.replicate(knn),
        carry=jstep.StepCarry.zeros())
    ref = {"state": tree_arrays(jax.device_get(new)), "metrics": tree_arrays(metrics),
           "carry": tree_arrays(carry)}
    got = launch(cases.pair_world, 2, CPU, args=({**inputs, "knn": tree_arrays(knn)},))[0]
    assert_step_close(got, ref, "2x1 vs JAX", TOL_JAX)


def test_train_scene_on_mesh_matches_single_device(world, scene_dir, tmp_path):
    """``train_scene(device_mesh=2x2)`` through a densify and prune event (at
    iteration 20) and a barycentric cleanup (25) against the single-device
    run; rank 0 alone wrote (one metrics line a tick). Up to the densify the
    runs differ by the order of the data axis's gradient sum (rounding); the
    split then gives the children of Gaussians on the mesh's sliver faces
    barycentric coordinates of round-off over round-off (ROADMAP queue 3),
    which the cleanup then moves to other faces, so after it the two runs
    are held as the JAX package's test holds them: the same populations at
    every tick and at the end, and renders of the final states above 30 dB
    apart."""
    from cloth_splatting_tpu_torch.models.deform import simulator_from_params
    from cloth_splatting_tpu_torch.ops.image import psnr
    from cloth_splatting_tpu_torch.render import camera_arrays, render

    res, out_root = world
    cfg = Config()
    cfg.model.white_background = True
    for key, value in SCENE_OPT.items():
        setattr(cfg.opt, key, value)
    scene = load_cloth_scene(scene_dir, device=CPU)
    ref = tloop.train_scene(cfg, scene, str(tmp_path / "single"), device=CPU,
                            **run_kwargs())
    got = convert.train_state(res["scene"]["state"], CPU)
    assert int(got.step) == SCENE_OPT["iterations"]
    assert torch.equal(got.gstate.alive, ref.gstate.alive)

    def lines(path):
        with open(path) as f:
            return [json.loads(x) for x in f]

    a = lines(os.path.join(out_root, "sharded", "metrics.jsonl"))
    b = lines(str(tmp_path / "single" / "metrics.jsonl"))
    assert [x["step"] for x in a] == [x["step"] for x in b]
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for key in ("n_gaussians", "capacity"):
            assert x.get(key) == y.get(key)
        if x["step"] <= 20:
            for key in ("loss", "psnr", "ema_loss", "ema_psnr"):
                np.testing.assert_allclose(x[key], y[key], rtol=TOL_PORT["metrics"],
                                           err_msg=key)
    cam = camera_arrays(scene.train.get(0, 0).camera, CPU)

    def image(st):
        with torch.no_grad():
            return render(cam, 32, 32, scene.train.get(0, 0).camera.tanfovx,
                          scene.train.get(0, 0).camera.tanfovy, st.params, st.gstate,
                          scene.initial_mesh, simulator_from_params(st.sim_params),
                          torch.as_tensor(scene.mesh_predictions), (1.0, 1.0, 1.0), 1,
                          backend="tiled", k_cap=128, k_chunk=16, device=CPU).rgb.clamp(0, 1)

    cross = float(psnr(image(got), image(ref)))
    print(f"sharded vs single final render: {cross:.2f} dB")
    assert cross > 30.0
    for name in (f"chkpnt{CHECKPOINT}.npz", "point_cloud/iteration_30/point_cloud.ply",
                 "meshnet/model-30.npz"):
        assert os.path.exists(os.path.join(out_root, "sharded", name)), name


def test_resume_from_a_sharded_checkpoint(world, scene_dir, tmp_path):
    """A checkpoint the 2x2 run saved holds the single-device layout: it
    resumes on the mesh (to the last iteration) and on one device."""
    res, out_root = world
    assert res["scene"]["resumed_step"] == SCENE_OPT["iterations"]
    ckpt = os.path.join(out_root, "sharded", f"chkpnt{CHECKPOINT}.npz")
    assert convert.train_state_from_checkpoint(ckpt, CPU).params.face_bary.shape[0] == 512
    cfg = Config()
    cfg.model.white_background = True
    for key, value in SCENE_OPT.items():
        setattr(cfg.opt, key, value)
    state = tloop.train_scene(cfg, load_cloth_scene(scene_dir, device=CPU),
                              str(tmp_path / "r"), start_checkpoint=ckpt,
                              progress_every=1000, seed=7, device=CPU)
    assert int(state.step) == SCENE_OPT["iterations"]


def test_train_command_line_on_a_mesh(world):
    """``train --mesh 2x2 --device cpu``'s rank path in the 4-rank world:
    rank 0 wrote the outputs, once."""
    _, out_root = world
    cli = os.path.join(out_root, "cli")
    for name in ("cfg_args", "chkpnt4.npz", "point_cloud/iteration_4/point_cloud.ply"):
        assert os.path.exists(os.path.join(cli, name)), name
    with open(os.path.join(cli, "metrics.jsonl")) as f:
        steps = [json.loads(x)["step"] for x in f]
    assert steps == [4]


def test_mesh_flag_on_the_cpu():
    """With ``--device cpu`` any D x M is a mesh of gloo ranks and 'auto' is
    one device; the refusals are tests/test_torch_hooks.py's."""
    from cloth_splatting_tpu_torch.train.__main__ import build_parser, mesh_from_args

    parser = build_parser()
    assert mesh_from_args(parser, "2x4", CPU) == (2, 4)
    assert mesh_from_args(parser, "auto", CPU) is None
    assert mesh_from_args(parser, "", CPU) is None


def test_train_scenes_mesh_flag_message():
    with pytest.raises(NotImplementedError,
                       match="neither package runs an intra-scene device mesh"):
        train_scenes_main(["--scenes", "x", "--mesh", "2x2", "--device", "cpu"])
