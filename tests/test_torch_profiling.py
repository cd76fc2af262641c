"""The port's spans (``utils/profiling.py``) on the CPU: off, enabled and
under ``torch.profiler``, and the span tree each hot path gives at a tiny
size: two iterations of ``fit_banks`` with a host event due, one serving
``render``, two iterations of the point trainer with a host event due, one
``MeshnetTrainer.train_step`` at unroll 2 and one ``MPC.model_rollout``."""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
from cloth_splatting_tpu_torch.data.synthetic import (
    orbit_camera,
    render_scene_banks,
    target_gaussians,
)
from cloth_splatting_tpu_torch.manipulation.mpc import MPC
from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
from cloth_splatting_tpu_torch.render import camera_arrays, render
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.loop import fit_banks
from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer
from cloth_splatting_tpu_torch.train.step import Trainer
from cloth_splatting_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

FOV = 2 * np.arctan(0.4)
PACK = ("raster.sort_pack", [("raster.expand", [])])
RENDER = ("render", [("render.project_view", []), PACK, ("raster.composite", [])])
MESHNET = [("meshnet.encode", []), ("meshnet.process", []), ("meshnet.decode", [])]


@pytest.fixture
def spans_on():
    P.take_spans()
    P.enable_spans(True)
    yield
    P.enable_spans(False)
    P.take_spans()


def trees(recs):
    """The records as nested (name, children) from their roots."""
    kids = {i: [] for i in range(len(recs))}
    roots = []
    for i, r in enumerate(recs):
        (roots if r.parent is None else kids[r.parent]).append(i)

    def node(i):
        return (recs[i].name, [node(k) for k in kids[i]])

    return [node(i) for i in roots]


def units_follow_roots(recs):
    for r in recs:
        if r.parent is not None:
            assert r.unit == recs[r.parent].unit, r
        assert r.end_ns is not None and r.end_ns >= r.start_ns, r


# ------------------------------------------------------------------- the API

def test_off_returns_one_shared_no_op_and_stores_nothing():
    P.take_spans()
    a, b = P.span("forward"), P.span("backward", unit=3)
    assert a is b
    with a:
        with b:
            torch.ones(3).sum()
    assert P.take_spans() == []


def test_nesting_parents_units_and_stacks_per_thread(spans_on):
    with P.span("root", unit=11):
        with P.span("child", unit=99):           # a child takes its root's unit
            with P.span("leaf"):
                pass
        with P.span("child"):
            pass
    with P.span("counted"):
        with P.span("inside"):
            pass
    with P.span("counted"):
        pass
    recs = P.take_spans()
    assert [(r.name, r.parent, r.unit) for r in recs[:5]] == [
        ("root", None, 11), ("child", 0, 11), ("leaf", 1, 11), ("child", 0, 11),
        ("counted", None, recs[4].unit)]
    assert recs[5].parent == 4 and recs[5].unit == recs[4].unit
    assert recs[6].parent is None and recs[6].unit != recs[4].unit
    units_follow_roots(recs)
    assert P.take_spans() == []

    # two threads, each with its own open stack: a span opened in one while
    # the other holds a span open is a root of its own
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait()
        with P.span("thread_root", unit=7):
            with P.span("thread_child"):
                pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with P.span("main_root", unit=3):
        opened.set()
        done.wait()
        with P.span("main_child"):
            pass
    t.join()
    recs = P.take_spans()
    by_name = {r.name: r for r in recs}
    assert by_name["thread_root"].parent is None and by_name["thread_root"].unit == 7
    assert recs[by_name["thread_child"].parent].name == "thread_root"
    assert by_name["thread_child"].unit == 7
    assert recs[by_name["main_child"].parent].name == "main_root"
    assert by_name["main_child"].unit == 3


def test_spans_show_in_the_profiler_around_their_operations():
    P.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("outer"):
            torch.ones(8).sum()
            with P.span("inner"):
                torch.exp(torch.ones(8))
    # recording spans for the profiler stores nothing unless they are enabled
    assert P.take_spans() == []
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def first(name):
        return next(e for e in host if e.name == name)

    outer, inner = first("outer"), first("inner")
    for span_ev, ops in ((outer, ("aten::sum", "aten::exp")), (inner, ("aten::exp",))):
        for op in ops:
            ev = first(op)
            assert span_ev.time_range.start <= ev.time_range.start
            assert ev.time_range.end <= span_ev.time_range.end
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert not (inner.time_range.start <= first("aten::sum").time_range.start
                <= inner.time_range.end)


# ----------------------------------------------------------------- the paths

def test_fit_iterations_give_the_fit_tree(spans_on):
    mesh = grid_cloth_mesh(4, 4, size=1.2, device="cpu")
    traj = np.repeat(mesh.pos.numpy()[None], 3, axis=0)
    cam_bank, gt_bank = render_scene_banks(mesh, traj, range(2), 2, 16, device="cpu")
    P.take_spans()
    cfg = Config()
    o = cfg.opt
    o.iterations = 2
    o.densify_from_iter, o.densification_interval, o.bary_cleanup = 0, 2, 2
    o.lambda_isometric, o.reg_iter, o.param_ema = 0.1, 0, 0.5
    tan = float(np.tan(FOV / 2))
    trainer = Trainer(cfg, mesh, torch.as_tensor(traj), 16, 16, tan, tan, 2.0)
    state = trainer.init_state(np.random.default_rng(0))
    fit_banks(trainer, state, cam_bank, gt_bank, None, first_iter=1, seed=1,
              progress_every=1)
    recs = P.take_spans()
    units_follow_roots(recs)
    forward = ("forward", [RENDER] * 3 + [("loss", [])])
    step = [forward, ("backward", []), ("update", []), ("fit.ema", [])]
    assert trees(recs) == [
        ("fit.iteration", [("fit.knn", [])] + step
         + [("fit.host_events", []), ("fit.fetch", [])]),
        ("fit.iteration", step
         + [("fit.host_events", [("density_control", []), ("cleanup_barycentric", [])]),
            ("fit.ema", []), ("fit.fetch", [])])]
    assert [r.unit for r in recs if r.parent is None] == [1, 2]


def test_render_gives_the_render_tree(spans_on):
    mesh = grid_cloth_mesh(4, 4, size=1.2, device="cpu")
    params, gstate = target_gaussians(mesh, 3, seed=0, device="cpu")
    cam = camera_arrays(orbit_camera(0, 4, FOV, 32, 32, 0.0), "cpu")
    tan = float(np.tan(FOV / 2))
    render(cam, 32, 32, tan, tan, params, gstate, mesh, None, None, (1.0, 1.0, 1.0), 3,
           backend="tiled_fwd", device="cpu")
    recs = P.take_spans()
    units_follow_roots(recs)
    assert trees(recs) == [RENDER]


def test_render_points_gives_the_points_tree(spans_on):
    from cloth_splatting_tpu_torch.models import point_gaussians as PG

    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
    params, state = PG.init_from_point_cloud(rng, pts, rng.random((40, 3)), 1,
                                             device="cpu")
    cam = camera_arrays(orbit_camera(0, 4, FOV, 40, 24, 0.0), "cpu")
    tan = float(np.tan(FOV / 2))
    PG.render_points(params, state, cam, 40, 24, tan, tan * 24 / 40, (0.0, 0.0, 0.0), 1)
    recs = P.take_spans()
    units_follow_roots(recs)
    assert trees(recs) == [("points.render", [("points.project_view", []), PACK,
                                              ("raster.composite", [])])]


def test_point_fit_iterations_give_the_points_fit_tree(spans_on):
    """Two iterations of the point trainer, a density event after the
    second: each iteration's spans are roots, the host events one more."""
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.train import points as TP
    from cloth_splatting_tpu_torch.train.step import adam_init

    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
    params, state = PG.init_from_point_cloud(rng, pts, rng.random((40, 3)), 1,
                                             capacity=64, device="cpu")
    cam = camera_arrays(orbit_camera(0, 4, FOV, 40, 24, 0.0), "cpu")
    tan = float(np.tan(FOV / 2))
    opt = TP.PointOptimization(densify_from_iter=1, densification_interval=2)
    trainer = TP.PointTrainer(opt, 40, 24, tan, tan * 24 / 40, (0.0, 0.0, 0.0), 1, 1.0)
    gt = torch.rand(3, 24, 40, generator=torch.Generator().manual_seed(0))
    P.take_spans()
    TP.fit_points(trainer, TP.PointTrainState(params, state, adam_init(params)), [cam],
                  [gt], 1, 2, TP.ViewStack(1, 0), 0)
    recs = P.take_spans()
    units_follow_roots(recs)
    step = [("forward", [("points.project_view", []), PACK, ("raster.composite", [])]),
            ("backward", []), ("update", [])]
    assert trees(recs) == step + step + [("points.host_events", [])]


def tiny_batch(rng, b=2, v=6, e=8, future=2, hist=2):
    edge_index = np.stack([rng.integers(0, v, (2, e)) for _ in range(b)])
    mask = np.ones((b, e), bool)
    mask[1, -3:] = False

    def f(*shape):
        return rng.normal(0, 0.01, shape).astype(np.float32)

    return {"velocity": f(b, v, 3 * hist), "edge_index": edge_index, "edge_mask": mask,
            "node_type": (np.arange(v)[None].repeat(b, 0) == 0).astype(np.int64),
            "positions": f(b, v, 3), "target_vel": f(b, v, future, 3),
            "particle_actions": f(b, v, future, 3)}


def test_gnn_train_step_gives_the_gnn_tree(spans_on):
    rng = np.random.default_rng(0)
    state = init_cloth_simulator(rng, n_message_passing=2, latent=8, device="cpu")
    trainer = MeshnetTrainer(device="cpu")
    opt = trainer.init_opt(state)
    trainer.train_step(state, opt, tiny_batch(rng), 0, 2)
    recs = P.take_spans()
    units_follow_roots(recs)
    assert trees(recs) == [("gnn.train_step", [
        ("gnn.batch_upload", []), ("gnn.normalizers", []),
        ("forward", MESHNET * 2), ("backward", []), ("update", [])])]


def test_model_rollout_gives_the_rollout_tree(spans_on):
    rng = np.random.default_rng(0)
    state = init_cloth_simulator(rng, n_message_passing=2, latent=8, device="cpu")
    mpc = MPC(state, n_candidates=3, horizon=2)
    mpc.candidates = rng.normal(0, 0.01, (3, 2, 3)).astype(np.float32)
    v = 6
    feats = {"pos0": rng.normal(0, 0.1, (v, 3)).astype(np.float32),
             "velocity_history": np.zeros((2, v, 3), np.float32),
             "node_type": (np.arange(v) == 0).astype(np.int64),
             "edge_index": np.stack([np.arange(v - 1), np.arange(1, v)]), "grasped": 0}
    out = mpc.model_rollout(feats)
    assert out.shape == (3, 3, v, 3)
    recs = P.take_spans()
    units_follow_roots(recs)
    assert trees(recs) == [("mpc.model_rollout", [
        ("rollout.graph", []), ("rollout.step", MESHNET), ("rollout.step", MESHNET),
        ("mpc.to_host", [])])]
