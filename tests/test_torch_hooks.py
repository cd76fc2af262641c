"""PyTorch port vs the JAX package: the loop's hooks and the rest of
``train.py``'s flags, on the CPU.

  - the viewer's codecs equal to JAX's; a round trip over a local socket
    through the loop's poll, whose answer is the dense tier's render of the
    requested camera, bit for bit; a bad request drops the connection;
  - the train parser accepts every flag of the root ``train.py``;
    ``--mesh`` raises; the command line runs with the viewer, wandb, quiet,
    anomaly and single-camera-video flags;
  - ``utils/logging.py`` and ``utils/profiling.py``: the adapters, timers,
    timestamped stdout, seeding, spans and the NaN checks;
  - ``data/predictions.py``: the files equal to the JAX writers' (positions,
    faces and edges exactly, normals within 1e-6); the GNN rollout's files
    are held in ``tests/test_torch_gnn.py``.
"""

import dataclasses
import importlib.util
import io
import json
import os
import socket
import struct
import sys

import numpy as np
import pytest
import torch

import h5py

from cloth_splatting_tpu.data import predictions as jpred
from cloth_splatting_tpu.utils import viewer as jviewer

from cloth_splatting_tpu_torch.data import predictions as tpred
from cloth_splatting_tpu_torch.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu_torch.render import CameraArrays, render
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.train.__main__ import build_parser
from cloth_splatting_tpu_torch.train.__main__ import main as train_main
from cloth_splatting_tpu_torch.utils import logging as tlog
from cloth_splatting_tpu_torch.utils import profiling as tprof
from cloth_splatting_tpu_torch.utils import viewer as tviewer

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import states, trainers  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOV = 2 * np.arctan(0.4)


# ------------------------------------------------------------------- viewer

SIBR = {"resolution_x": 32, "resolution_y": 24, "train": False, "fov_y": 0.8,
        "fov_x": 0.9, "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 0.7,
        "view_matrix": list(np.arange(16, dtype=float)),
        "view_projection_matrix": list(np.arange(16, dtype=float) * 0.5)}


@pytest.mark.parametrize("msg", [SIBR, dict(SIBR, resolution_x=0),
                                 dict(SIBR, time=0.25, keep_alive=False)])
def test_sibr_codec_matches_jax(msg):
    assert tviewer.decode_sibr_message(dict(msg)) == jviewer.decode_sibr_message(dict(msg))


@pytest.mark.parametrize("image", [b"\x01\x02\x03" * 4, None])
def test_sibr_reply_matches_jax(image):
    assert tviewer.encode_sibr_reply(image, "/scene") == \
        jviewer.encode_sibr_reply(image, "/scene")


def frame(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload)) + payload


def read_exact(sock, n):
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        assert chunk, "connection closed"
        data += chunk
    return data


@pytest.fixture
def served():
    """The viewer listening on a free local port, shut down afterwards."""
    tviewer.init("127.0.0.1", 0)
    yield tviewer._listener.getsockname()[1]
    tviewer.shutdown()


def test_viewer_round_trip_through_the_poll(served):
    """A JSON request over a local socket, answered by the loop's poll with
    the dense tier's render at the trainer's k_cap and the request's
    scaling modifier."""
    _, jtr, ttr = trainers({"OptimizationParams": {"raster_k_cap": 64,
                                                   "raster_k_chunk": 16}})
    _, state = states(jtr)
    wv = np.eye(4, dtype=np.float32)
    wv[3, 2] = 3.0
    proj = np.diag([2.5, 2.5, 1.0, 0.0]).astype(np.float32)
    proj[2, 3] = 1.0
    fp = wv @ proj
    request = {"world_view": wv.tolist(), "full_proj": fp.tolist(), "width": 32,
               "height": 16, "time": 0.5, "keep_alive": True,
               "scaling_modifier": 0.8}
    client = socket.create_connection(("127.0.0.1", served))
    try:
        client.sendall(frame(json.dumps(request).encode()))
        tloop._poll_viewer(ttr, state, 1)
        (length,) = struct.unpack("<I", read_exact(client, 4))
        got = np.frombuffer(read_exact(client, length), np.uint8).reshape(16, 32, 3)
        assert tviewer.conn is not None          # keep_alive: still connected

        cam = CameraArrays(world_view=torch.from_numpy(wv),
                           full_proj=torch.from_numpy(fp),
                           camera_center=torch.from_numpy(
                               np.linalg.inv(wv.T)[:3, 3].astype(np.float32)),
                           time=torch.tensor(0.5))
        from cloth_splatting_tpu_torch.models.deform import simulator_from_params

        with torch.no_grad():
            out = render(cam, 32, 16, ttr.tanfovx, ttr.tanfovy, state.params,
                         state.gstate, ttr.mesh,
                         simulator_from_params(state.sim_params),
                         ttr.mesh_predictions, ttr.bg, 1, scaling_modifier=0.8,
                         k_cap=64, k_chunk=16, backend="tiled", device="cpu")
        want = (torch.clamp(out.rgb, 0, 1).numpy().transpose(1, 2, 0) * 255
                ).astype(np.uint8)
        np.testing.assert_array_equal(got, want)
        assert (got < 250).any()

        # a request that fails to render drops the connection, nothing else
        client.sendall(frame(json.dumps(dict(request, width=30)).encode()))
        tloop._poll_viewer(ttr, state, 1)
        assert tviewer.conn is None
    finally:
        client.close()


def test_viewer_sibr_protocol_round_trip(served):
    tviewer.protocol = "sibr"
    client = socket.create_connection(("127.0.0.1", served))
    try:
        client.sendall(frame(json.dumps(SIBR).encode()))
        tviewer.try_connect()
        cam, do_training, keep_alive, scaling = tviewer.receive()
        assert (cam, do_training, keep_alive, scaling) == \
            jviewer.decode_sibr_message(dict(SIBR))
        tviewer.send(b"\x07" * 6, "/scene")
        assert read_exact(client, 6 + 4 + 6) == jviewer.encode_sibr_reply(
            b"\x07" * 6, "/scene")
    finally:
        tviewer.protocol = "json"
        client.close()


# ----------------------------------------------------------- the train CLI

def jax_parser():
    spec = importlib.util.spec_from_file_location("jax_train_cli",
                                                  os.path.join(REPO, "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_parser()


def test_train_parser_accepts_every_flag_of_the_root_train():
    jflags = {s for a in jax_parser()._actions for s in a.option_strings}
    tflags = {s for a in build_parser()._actions for s in a.option_strings}
    assert jflags <= tflags, sorted(jflags - tflags)
    assert tflags - jflags == {"--device"}
    args = build_parser().parse_args(
        ["-s", "x", "--ip", "0.0.0.0", "--port", "7000", "--protocol", "sibr",
         "--debug_from", "3", "--detect_anomaly", "--use_wandb", "--quiet",
         "--single_cam_video", "--no_shadow", "--debug", "--images", "img",
         "-r", "2", "--lambda_lpips", "0.1", "--raster_k_chunk", "8"])
    assert (args.ip, args.port, args.protocol, args.debug_from) == \
        ("0.0.0.0", 7000, "sibr", 3)
    assert args.detect_anomaly and args.use_wandb and args.quiet
    assert args.single_cam_video and args.no_shadow and args.raster_k_chunk == 8


def test_mesh_flag_raises_and_names_its_queue_item(capsys):
    """A malformed ``--mesh`` and one beyond the visible cards are parser
    errors with the JAX package's messages (no card is visible here)."""
    from cloth_splatting_tpu_torch.train.__main__ import mesh_from_args

    with pytest.raises(SystemExit):
        train_main(["-s", "x", "--mesh", "foo", "--device", "cpu"])
    assert "--mesh must be 'auto' or 'DxM', got 'foo'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        mesh_from_args(build_parser(), "2x4", torch.device("cuda"))
    assert "--mesh 2x4 needs 8 devices, have 0" in capsys.readouterr().err


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    generate_synthetic_scene(path, n_views=3, n_times=3, image_size=32, mesh_res=6,
                             device="cpu")
    return path


def test_train_command_line_with_the_hook_flags(scene_dir, tmp_path, capsys):
    """Two iterations with the viewer listening (sibr), wandb asked for (a
    no-op without the package), anomaly and NaN checks on, stdout silenced;
    the stdout and the debug checks are restored afterwards."""
    stdout = sys.stdout
    out = tmp_path / "cli"
    try:
        train_main(["-s", scene_dir, "-m", str(out), "--iterations", "2",
                    "--static_reconst", "--static_reconst_iteration", "2",
                    "--test_iterations", "2", "--save_iterations", "2",
                    "--port", "0", "--protocol", "sibr", "--use_wandb",
                    "--detect_anomaly", "--quiet", "--single_cam_video",
                    "--debug_from", "1", "--device", "cpu"])
        assert torch.is_anomaly_enabled()
    finally:
        tprof.disable_debug_checks()
    assert sys.stdout is stdout and tviewer._listener is None
    assert capsys.readouterr().out == ""
    assert (out / "point_cloud" / "iteration_2" / "point_cloud.ply").exists()
    assert "protocol='sibr'" in (out / "cfg_args").read_text()


# ------------------------------------------------------- logging, profiling

def test_logging_hooks(tmp_path, monkeypatch):
    tb = tlog.TensorBoardAdapter(str(tmp_path / "tb"))
    tb.scalar("loss", 0.5, 1)
    tb.image("img", np.zeros((3, 4, 4), np.float32), 1)
    tb.close()
    tlog.TensorBoardAdapter(None).scalar("loss", 0.5, 1)      # no-op
    w = tlog.WandbAdapter(project="p", enabled=True)          # no wandb here
    w.log({"loss": 1.0}, step=1)
    w.finish()

    timer = tlog.Timer().start()
    assert timer.get_elapsed_time() >= 0.0
    paused = timer.pause().get_elapsed_time()
    assert timer.get_elapsed_time() == paused

    sink = io.StringIO()
    monkeypatch.setattr(sys, "stdout", sink)
    tlog.timestamp_stdout()
    print("hello")
    tlog.timestamp_stdout(silent=True)
    print("hidden")
    monkeypatch.setattr(sys, "stdout", sys.__stdout__)
    assert sink.getvalue().startswith("hello [") and "hidden" not in sink.getvalue()

    draws = []
    for _ in range(2):
        tlog.seed_everything(11)
        draws.append((np.random.rand(), torch.rand(1).item(),
                      __import__("random").random()))
    assert draws[0] == draws[1]


def test_profiling_hooks():
    tprof.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.span("step"):
            torch.ones(4).sum()
    assert "step" in {e.name for e in prof.events()}
    tprof.enable_spans(True)
    try:
        with tprof.span("step", unit=5):
            torch.ones(4).sum()
    finally:
        tprof.enable_spans(False)
    (rec,) = tprof.take_spans()
    assert (rec.name, rec.parent, rec.unit) == ("step", None, 5)
    assert rec.end_ns >= rec.start_ns

    tprof.enable_debug_checks()
    try:
        assert torch.is_anomaly_enabled()
        torch.exp(torch.ones(3))
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(-torch.ones(3))
    finally:
        tprof.disable_debug_checks()
    assert not torch.is_anomaly_enabled()
    assert bool(torch.isnan(torch.log(-torch.ones(1))).all())


# -------------------------------------------------------------- predictions

def h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


def test_prediction_writers_match_jax(tmp_path):
    from cloth_splatting_tpu.data.meshing import grid_cloth_mesh

    mesh = grid_cloth_mesh(5, 4, size=1.0)
    faces = np.asarray(mesh.faces)
    rng = np.random.default_rng(0)
    gt = (np.asarray(mesh.pos)[None] + rng.normal(0, 0.05, (4, 20, 3))
          ).astype(np.float32)
    jout = jpred.generate_noisy_gt_predictions(str(tmp_path / "jax"), faces, gt, seed=3)
    tout = tpred.generate_noisy_gt_predictions(str(tmp_path / "torch"), faces, gt,
                                               seed=3)
    np.testing.assert_array_equal(tout, jout)
    names = ["init_mesh.hdf5"] + [f"mesh_predictions/mesh_{t:03d}.hdf5"
                                  for t in range(4)]
    for name in names:
        j, t = h5(tmp_path / "jax" / name), h5(tmp_path / "torch" / name)
        assert sorted(t) == sorted(j) == ["edge_index", "face", "norm", "pos"]
        for key in ("pos", "face", "edge_index"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=f"{name} {key}")
            assert t[key].dtype == j[key].dtype
        np.testing.assert_allclose(t["norm"], j["norm"], atol=1e-6)
    tm = tpred.mesh_from_positions(gt[0], faces, "cpu")
    jm = jpred.mesh_from_positions(gt[0], faces)
    for field in ("pos", "faces", "edge_index", "edge_norm"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                      np.asarray(getattr(jm, field)), err_msg=field)


def test_config_dataclasses_unchanged_by_the_cli_flags():
    """The flags of fields neither package reads set nothing."""
    from cloth_splatting_tpu_torch.train.__main__ import config_from_args
    from cloth_splatting_tpu_torch.train.config import Config

    args = build_parser().parse_args(["--debug", "--images", "x",
                                      "--meshnet_file", "m", "--data_device", "cpu"])
    assert dataclasses.asdict(config_from_args(args)) == dataclasses.asdict(Config())
