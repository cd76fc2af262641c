"""PyTorch port vs the JAX package: the scene-parallel sweep.

Scenes of the JAX package's sweep test (tests/test_scene_sweep.py: 32 px, a
4x4 mesh, 3 views x 3 times, no prediction noise, seeds 100 and 101; the
same 40-iteration schedule with a static stage, a densify and prune round
and a barycentric cleanup), written by the JAX generator and read by both
loaders. ``scene_signature`` and ``group_scenes`` equal JAX's for the same
scenes and device count. The sweep on ``devices=["cpu", "cpu"]`` gives each
scene the bits of the port's own ``train_scene`` (which
tests/test_torch_fit.py holds to JAX); both refusals raise; the
``train_scenes`` command line writes each scene's ``cfg_args`` and
checkpoint.
"""

import argparse
import os

import pytest
import torch

from cloth_splatting_tpu.data import scene as jscene
from cloth_splatting_tpu.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu.parallel import sweep as jsweep

from cloth_splatting_tpu_torch.data import scene as tscene
from cloth_splatting_tpu_torch.parallel import sweep as tsweep
from cloth_splatting_tpu_torch.parallel.scenes import scene_devices
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train_scenes import main as train_scenes_main

torch.set_num_threads(1)

CPU = "cpu"
ITERATIONS = 40


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    dirs = []
    for s, mesh_res in ((0, 4), (1, 4), (2, 6)):
        d = str(root / f"scene_{s}")
        generate_synthetic_scene(d, n_views=3, n_times=3, image_size=32,
                                 mesh_res=mesh_res, prediction_noise=0.0,
                                 seed=100 + s)
        dirs.append(d)
    return dirs


def sweep_cfg(iterations=ITERATIONS):
    """tests/test_scene_sweep.py's schedule."""
    cfg = Config()
    cfg.model.white_background = True
    o = cfg.opt
    o.iterations = iterations
    o.static_reconst, o.static_reconst_iteration = True, 15
    o.densify_from_iter, o.densification_interval = 5, 20
    o.pruning_from_iter, o.pruning_interval = 5, 20
    o.densify_until_iter, o.opacity_reset_interval = iterations, 10_000
    o.bary_cleanup, o.raster_k_cap, o.raster_k_chunk = 25, 128, 16
    return cfg


def state_tensors(state) -> dict:
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


def test_signature_and_groups_match_jax(scene_dirs):
    jscenes = [jscene.load_cloth_scene(d) for d in scene_dirs]
    tscenes = [tscene.load_cloth_scene(d, device=CPU) for d in scene_dirs]
    for j, t in zip(jscenes, tscenes):
        assert tsweep.scene_signature(t) == jsweep.scene_signature(j)
    assert tsweep.scene_signature(tscenes[0]) == tsweep.scene_signature(tscenes[1])
    # the JAX package groups over its 8 (virtual) devices
    assert tsweep.group_scenes(tscenes, 8) == jsweep.group_scenes(jscenes) == [[0, 1], [2]]
    assert tsweep.group_scenes(tscenes + tscenes[:2], 2) == [[0, 1], [3, 4], [2]]
    assert tsweep.group_scenes(tscenes, 1) == [[0], [1], [2]]
    assert scene_devices(2, [CPU] * 3) == [torch.device(CPU)] * 2
    with pytest.raises(ValueError, match="need 3 devices"):
        scene_devices(3, [CPU, CPU])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsweep.group_scenes(tscenes)


def test_sweep_gives_each_scene_its_train_scene_bits(scene_dirs, tmp_path):
    scenes = [tscene.load_cloth_scene(d, device=CPU) for d in scene_dirs[:2]]
    lone = [tloop.train_scene(sweep_cfg(), sc, str(tmp_path / f"seq_{i}"), seed=7,
                              progress_every=1000, device=CPU)
            for i, sc in enumerate(scenes)]
    out_dirs = [str(tmp_path / f"par_{i}") for i in range(2)]
    swept = tsweep.train_scenes_parallel(
        sweep_cfg(), scenes, out_dirs, devices=[CPU, CPU], seed=7,
        test_iterations=(ITERATIONS,), save_iterations=(ITERATIONS,),
        progress_every=10)
    for i in range(2):
        a, b = state_tensors(swept[i]), state_tensors(lone[i])
        unequal = [k for k in b if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
        assert not unequal, (i, unequal)
        assert int(swept[i].step) == ITERATIONS
        assert os.path.exists(os.path.join(out_dirs[i], "point_cloud",
                                           f"iteration_{ITERATIONS}", "point_cloud.ply"))
    # the two scenes differ, and density control ran
    assert not torch.equal(swept[0].params.features_dc, swept[1].params.features_dc)
    n0 = 2 * int(scenes[0].initial_mesh.faces.shape[0])
    assert int(swept[0].gstate.alive.sum()) != n0


@pytest.mark.parametrize("field, value", [("lambda_isometric", 1.0),
                                          ("lambda_rigidity", 0.5),
                                          ("param_ema", 0.99)])
def test_sweep_refusals(scene_dirs, tmp_path, field, value):
    cfg = sweep_cfg()
    setattr(cfg.opt, field, value)
    scenes = [tscene.load_cloth_scene(scene_dirs[0], device=CPU)]
    with pytest.raises(NotImplementedError,
                       match="param_ema" if field == "param_ema" else "kNN"):
        tsweep.train_scene_group(cfg, scenes, [str(tmp_path / "x")], devices=[CPU])


def test_train_scenes_command_line(scene_dirs, tmp_path):
    out_root = tmp_path / "out"
    train_scenes_main([
        "--scenes", *scene_dirs[:2], "--out_root", str(out_root),
        "--iterations", "8", "--static_reconst", "--static_reconst_iteration", "4",
        "--save_iterations", "8", "--test_iterations", "8",
        "--raster_k_cap", "128", "--quiet", "--device", CPU])
    for d in scene_dirs[:2]:
        out = out_root / os.path.basename(d)
        text = (out / "cfg_args").read_text()
        replay = eval(text, {"Namespace": argparse.Namespace})
        assert replay.source_path == d and replay.model_path == str(out)
        assert not hasattr(replay, "scenes") and replay.iterations == 8
        assert (out / "point_cloud" / "iteration_8" / "point_cloud.ply").exists()
        assert (out / "point_cloud" / "iteration_8" / "mesh.hdf5").exists()
        assert (out / "meshnet" / "model-8.npz").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_scenes_main(["--scenes", scene_dirs[0], "--out_root", str(out_root)])
