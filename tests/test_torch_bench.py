"""The port's benchmark entry (``python -m cloth_splatting_tpu_torch.bench``)
against the root ``bench.py``: the same scenes, the same output keys, finite
positive rates at tiny sizes on the CPU (the timings mean something only on
the card), and CUDA by default."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from cloth_splatting_tpu.data.meshing import grid_cloth_mesh as jgrid_cloth_mesh
from cloth_splatting_tpu.data.synthetic import target_gaussians as jtarget_gaussians
from cloth_splatting_tpu.models import gaussians as JG

from cloth_splatting_tpu_torch import bench

torch.set_num_threads(1)


def test_measure_fps_on_the_cpu():
    fps = bench.measure_fps(4, n_views=3, width=32, height=32, device="cpu")
    assert np.isfinite(fps) and fps > 0
    scene = bench.serving_scene(5, "cpu")
    fps = bench.measure_fps(99, n_views=2, width=48, height=32, device="cpu",
                            scene=scene)
    assert np.isfinite(fps) and fps > 0


def test_measure_train_iters_on_the_cpu():
    ips = bench.measure_train_iters(32, 32, n_iters=2, mesh_res=4, capacity=64,
                                    device="cpu")
    assert np.isfinite(ips) and ips > 0


@pytest.mark.parametrize("res", [4, 7])
def test_serving_scene_matches_jax(res):
    """The render benchmark's scene is the root bench.py's: the same mesh and
    Gaussians from the same seed (the log-scales come from float32 kNN
    distances summed in another order: 1e-5)."""
    scene = bench.serving_scene(res, "cpu")
    jmesh = jgrid_cloth_mesh(res, res, size=1.4)
    jparams, jstate = jtarget_gaussians(jmesh, 3)
    for k, v in jmesh._asdict().items():
        np.testing.assert_array_equal(getattr(scene.mesh, k).numpy(), np.asarray(v),
                                      err_msg=k)
    for k, v in jparams._asdict().items():
        np.testing.assert_allclose(getattr(scene.params, k).numpy(), np.asarray(v),
                                   atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_array_equal(scene.state.alive.numpy(), np.asarray(jstate.alive))
    assert int(scene.state.alive.sum()) == int(JG.num_alive(jstate))


def test_train_setup_matches_the_root_configuration():
    trainer, state, cams, gts = bench.train_setup(32, 32, mesh_res=4, capacity=64,
                                                  device="cpu")
    assert tuple(gts.shape) == (3, 3, 32, 32) and float(gts.mean()) == 0.5
    np.testing.assert_array_equal(cams.time.numpy(), np.asarray([0.0, 0.5, 1.0],
                                                                np.float32))
    assert state.params.face_bary.shape[0] == 64
    assert int(state.gstate.alive.sum()) == 2 * int(trainer.mesh.faces.shape[0])


def printed(fn) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("scales", ["", "all"])
def test_main_prints_the_root_keys(monkeypatch, tmp_path, scales):
    monkeypatch.setenv("BENCH_SCALES", scales)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    import bench as root_bench

    for module in (bench, root_bench):
        monkeypatch.setattr(module, "measure_fps", lambda res, *a, **k: 50.0 + res)
        monkeypatch.setattr(module, "measure_train_iters",
                            lambda *a, mesh_res=32, **k: 1.0 + mesh_res)
    monkeypatch.setattr(root_bench, "_wait_for_device", lambda s: None)
    port = printed(lambda: bench.main(["--device", "cpu"]))
    root = printed(root_bench.main)
    assert list(port) == list(root)
    assert port == root
    assert port["metric"] == "render_fps_800x800_65k_gaussians"
    assert ("fps_4k_gaussians" in port) == (scales == "all")


def test_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.measure_fps(4)
