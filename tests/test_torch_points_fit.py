"""The point model's trainer (``train/points.py``): the published schedule,
one step and one density event against the benchmark's plain reference
(``benchmark/reference/points_fit.py``), ``fit_static_scene`` and
``fit_legacy`` on it; and, on the card, K2 and K3 on partial tiles.

On the CPU (tier 1): the schedule's values at chosen iterations; a step of
``PointTrainer`` on a seeded field at 70 x 45 (16 px tiles, the last row
and column partial) against the reference's step: the loss, each leaf's
gradient (Adam's first moment over 1 - b1), the statistic; the host events
of iteration 9,000 (clone, split, prune and the opacity reset) on one
state, both ways: the same slots added, removed and moved, the same rows;
the fit's view draws; a published fit from a point cloud, and the counters.

On the card (marker ``card``; this file imports no JAX:
``python -m pytest tests/test_torch_points_fit.py -m card --noconftest``):
K2, K3 and K4 against their plain versions on packs with partial tiles at
both tile sizes; K2-span refusing them.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.models import point_gaussians as PG
from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as ttr
from cloth_splatting_tpu_torch.render import CameraArrays
from cloth_splatting_tpu_torch.train import points as TP
from cloth_splatting_tpu_torch.train.step import adam_init

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmark.drivers.fit_points import view_draws  # noqa: E402
from benchmark.drivers.render_points import camera  # noqa: E402
from benchmark.reference import points_fit  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 70, 45
TAN_X = 0.62
TAN_Y = TAN_X * H / W
BG = (0.0, 0.0, 0.0)
# the step against the reference on the CPU: the same float32 function
# rounded in another order, and K2's tile-wide exit, which composites pairs
# after a pixel's T fell below 1e-4 (the reference stops the pixel); on
# this field those add under 1e-4 of a gradient's norm
TOL_LOSS = 1e-5
TOL_GRAD = 1e-3        # of each leaf's norm
TOL_ROWS = 1e-5        # a density event's rows, absolute
TOL_CARD = 1e-5        # K2/K3 against their plain versions (chip_smoke's)


def published() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "gs-360-3m-fit.json")) as f:
        return json.load(f)["optimization"]


def test_published_schedule():
    opt = TP.PointOptimization()
    assert dataclasses_equal(opt, published())
    # the position rate: 1.6e-4 x scale at 0, 1.6e-6 x scale from 30,000 on,
    # log-linear between
    assert math.isclose(TP.position_lr(0, opt, 2.0), 3.2e-4, rel_tol=1e-12)
    assert math.isclose(TP.position_lr(15_000, opt, 1.0), math.sqrt(1.6e-4 * 1.6e-6),
                        rel_tol=1e-12)
    assert math.isclose(TP.position_lr(40_000, opt, 1.0), 1.6e-6, rel_tol=1e-12)
    assert math.isclose(TP.position_lr(7099, opt, 1.0),
                        points_fit.position_lr(7099, published(), 1.0), rel_tol=1e-12)
    assert [TP.sh_degree_at(i, opt, 3) for i in (0, 999, 1000, 2999, 3000, 7099)] == \
        [0, 0, 1, 2, 3, 3]
    due = {i: TP.events_due(i, opt) for i in (500, 600, 3000, 7099, 7100, 15_000)}
    assert [due[i]["densify"] for i in due] == [False, True, True, False, True, False]
    assert [due[i]["reset"] for i in due] == [False, False, True, False, False, False]
    assert [due[i]["stats"] for i in due] == [True] * 5 + [False]
    assert TP.events_due(500, opt, white_background=True)["reset"]
    for i in (7099, 7100, 9000, 15_000):
        assert TP.events_due(i, opt) == points_fit.events_due(i, published())


def dataclasses_equal(opt, d: dict) -> bool:
    import dataclasses

    return dataclasses.asdict(opt) == d


def point_field(n: int, cap: int, seed: int) -> tuple[dict, torch.Tensor]:
    """A seeded field of ``n`` Gaussians in ``cap`` slots inside the view
    of ``cam()``: translucent, so that few pixels' T reaches 1e-4."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.cat([(torch.rand(n, 3, generator=g) - 0.5) * 2.4,
                     torch.zeros(cap - n, 3)])
    f = {"xyz": xyz,
         "features_dc": torch.randn(cap, 1, 3, generator=g),
         "features_rest": 0.1 * torch.randn(cap, 15, 3, generator=g),
         "scaling": math.log(0.06) + 0.5 * torch.randn(cap, 3, generator=g),
         "rotation": torch.randn(cap, 4, generator=g),
         "opacity": -1.5 + torch.randn(cap, 1, generator=g)}
    alive = torch.zeros(cap, dtype=torch.bool)
    alive[:n] = True
    return f, alive


def cam(az=0.6):
    return camera((az, 0.3, 3.4), TAN_X, TAN_Y, "cpu")


def arrays(c):
    return CameraArrays(world_view=c["world_view"], full_proj=c["full_proj"],
                        camera_center=c["center"], time=torch.zeros(()))


def program_state(field, alive):
    params = PG.PointGaussianParams(**{k: v.clone() for k, v in field.items()})
    cap = alive.shape[0]
    gstate = PG.PointGaussianState(alive=alive.clone(), max_radii2d=torch.zeros(cap),
                                   grad_accum=torch.zeros(cap), denom=torch.zeros(cap))
    return TP.PointTrainState(params, gstate, adam_init(params))


def reference_state(field, alive):
    cap = alive.shape[0]
    return {"field": {k: v.clone() for k, v in field.items()}, "alive": alive.clone(),
            "count": 0, "m": {k: torch.zeros_like(v) for k, v in field.items()},
            "v": {k: torch.zeros_like(v) for k, v in field.items()},
            "grad_accum": torch.zeros(cap), "denom": torch.zeros(cap),
            "max_radii": torch.zeros(cap)}


SCENE = {"width": W, "height": H, "tan_x": TAN_X, "tan_y": TAN_Y, "sh_degree": 3,
         "extent": 4.0, "bg": torch.tensor(BG)}


def trainer(opt=None):
    return TP.PointTrainer(opt or TP.PointOptimization(), W, H, TAN_X, TAN_Y, BG, 3,
                           SCENE["extent"])


def test_step_matches_the_reference():
    field, alive = point_field(500, 640, seed=3)
    gt = torch.rand(3, H, W, generator=torch.Generator().manual_seed(4))
    state, loss = trainer().step(program_state(field, alive), arrays(cam()), gt, 7099)
    ref, ref_loss, _ = points_fit.train_step(reference_state(field, alive), SCENE, cam(),
                                             gt, published(), 7099)
    assert abs(float(loss) - ref_loss) <= TOL_LOSS * ref_loss
    for k in points_fit.FIELD_KEYS:
        a = getattr(state.opt.mu, k) / 0.1
        b = ref["m"][k] / 0.1
        assert float(b.norm()) > 0, k
        assert float((a - b).norm()) <= TOL_GRAD * float(b.norm()), k
    a, b = state.gstate.grad_accum, ref["grad_accum"]
    assert int((b > 0).sum()) > 100
    assert float((a - b).norm()) <= TOL_GRAD * float(b.norm())
    np.testing.assert_array_equal(state.gstate.denom.numpy(), ref["denom"].numpy())
    np.testing.assert_array_equal(state.gstate.max_radii2d.numpy(), ref["max_radii"].numpy())


def test_host_events_match_the_reference():
    """Iteration 9,000's events (clone, split, prune, opacity reset) on one
    state: the program's and the reference's."""
    field, alive = point_field(500, 1024, seed=5)
    field["scaling"][:100] = math.log(0.3)              # split: above 0.01 x extent
    field["opacity"][100:110] = math.log(0.001 / 0.999)  # pruned as faint
    field["scaling"][110:115] = math.log(0.6)           # pruned as large in the world
    g = torch.Generator().manual_seed(6)
    stats = torch.where(alive, torch.rand(1024, generator=g) * 4e-4, torch.zeros(1024))
    denom = torch.where(alive, torch.full((1024,), 2.0), torch.zeros(1024))
    st = program_state(field, alive)
    mu = PG.PointGaussianParams(*(torch.rand(t.shape, generator=g) for t in st.params))
    st = TP.PointTrainState(st.params, st.gstate._replace(grad_accum=stats * denom,
                                                          denom=denom),
                            st.opt._replace(mu=mu, nu=mu))
    gen = torch.Generator().manual_seed(7)
    eps = torch.randn((2, 1024, 3), generator=torch.Generator().manual_seed(7))
    counts = dict(PG.COUNTS)
    new = trainer().host_events(st, 9000, gen)
    done = {k: PG.COUNTS[k] - counts.get(k, 0) for k in
            ("events", "cloned", "split", "pruned", "overflow")}
    ref = reference_state(field, alive)
    ref.update(grad_accum=stats * denom, denom=denom,
               m={k: getattr(mu, k).clone() for k in points_fit.FIELD_KEYS},
               v={k: getattr(mu, k).clone() for k in points_fit.FIELD_KEYS})
    out = points_fit.density_event(ref, SCENE, published(), 9000, eps)
    np.testing.assert_array_equal(new.gstate.alive.numpy(), out["alive"].numpy())
    added = int((out["alive"] & ~alive).sum())
    removed = int((alive & ~out["alive"]).sum())
    assert added > 200 and removed >= 10
    assert done == {"events": 1, "cloned": done["cloned"], "split": done["split"],
                    "pruned": done["pruned"], "overflow": 0}
    assert done["cloned"] > 0 and done["split"] >= 100
    # a new Gaussian may be pruned in its own event: counted, not seen
    assert done["cloned"] + done["split"] - added == done["pruned"] - removed >= 0
    live = out["alive"]
    for k in points_fit.FIELD_KEYS:
        np.testing.assert_allclose(getattr(new.params, k)[live].numpy(),
                                   out["field"][k][live].numpy(), atol=TOL_ROWS, err_msg=k)
        np.testing.assert_array_equal(getattr(new.opt.mu, k)[live].numpy(),
                                      out["m"][k][live].numpy(), err_msg=k)
    # opacities reset to at most 0.01, their moments zeroed, statistics restarted
    assert float(torch.sigmoid(new.params.opacity[live]).max()) <= 0.01 + 1e-7
    assert float(new.opt.nu.opacity.abs().max()) == 0.0
    assert float(new.gstate.grad_accum.abs().max()) == 0.0


def test_view_stack_draws_as_train_py():
    stack = TP.ViewStack(5, 11)
    views = [stack.next() for _ in range(12)]
    assert views == view_draws(5, 11, 12)
    assert sorted(views[:5]) == list(range(5)) and sorted(views[5:10]) == list(range(5))


def test_fit_static_scene_trains_on_the_training_tier(monkeypatch):
    """The published fit from a point cloud goes through
    ``rasterize_tiled_train`` with uncapped splats, at four times the
    cloud's capacity; ``fit_points`` on a shortened schedule (a density
    event every 3 iterations from 2) runs and counts its host events."""
    from types import SimpleNamespace

    field, alive = point_field(300, 300, seed=9)
    cloud = SimpleNamespace(points=field["xyz"].numpy(), colors=np.full((300, 3), 0.5))
    cams = [arrays(cam(a)) for a in (0.2, 0.9, 1.6)]
    gts = [torch.rand(3, H, W, generator=torch.Generator().manual_seed(s)) for s in range(3)]
    calls = {"train": 0, "radius": set()}
    raster = TP.rasterize_tiled_train

    def counted(proj, *a, **k):
        calls["train"] += 1
        return raster(proj, *a, **k)

    project = PG.project_gaussians

    def seen(*a, **k):
        calls["radius"].add(k.get("max_radius"))
        return project(*a, **k)

    monkeypatch.setattr(TP, "rasterize_tiled_train", counted)
    monkeypatch.setattr(PG, "project_gaussians", seen)
    params, state, loss = PG.fit_static_scene(cams, gts, cloud, W, H, TAN_X, TAN_Y,
                                              sh_degree=1, iterations=4, device="cpu")
    assert calls == {"train": 4, "radius": {None}}
    assert params.xyz.shape[0] == PG.round_capacity(4 * 300) and math.isfinite(loss)

    opt = TP.PointOptimization(densify_from_iter=2, densification_interval=3,
                               densify_grad_threshold=1e-6)
    t = TP.PointTrainer(opt, W, H, TAN_X, TAN_Y, BG, 1, TP.camera_extent(cams))
    st = TP.PointTrainState(params, state, adam_init(params))
    counts = dict(PG.COUNTS)
    losses = []
    st = TP.fit_points(t, st, cams, gts, 1, 7, TP.ViewStack(3, 0), 5,
                       on_iteration=lambda it, loss: losses.append(float(loss)))
    done = {k: PG.COUNTS[k] - counts.get(k, 0) for k in ("events", "cloned", "split")}
    assert len(losses) == 7 and done["events"] == 2            # iterations 3 and 6
    assert done["cloned"] + done["split"] > 0
    assert int(st.gstate.alive.sum()) > 300


# ------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_points_fit.py -m card --noconftest)")
    return torch.device("cuda")


def partial_proj(n, width, height, seed, dev):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xy = np.stack([rng.uniform(-10, width + 10, n), rng.uniform(-10, height + 10, n)], 1)
    radius = np.ceil(rng.uniform(4, 40, n))

    def t(a, dt=f32):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    return ProjectedGaussians(
        xy=t(xy), depth=t(rng.uniform(1, 5, n)),
        conic=t(np.stack([1.0 / (radius / 3) ** 2, np.zeros(n), 1.0 / (radius / 3) ** 2], 1)),
        radius=t(radius), color=t(rng.uniform(0, 1, (n, 3))),
        opacity=t(rng.uniform(0.1, 0.95, n)), valid=t(np.ones(n, bool), bool),
        power_cut=t(np.full(n, -4.5)))


@pytest.mark.card
@pytest.mark.parametrize("width,height,tile,span", [
    (1237, 822, 32, (None, None)), (1237, 822, 32, (3, 34)),
    (230, 135, 16, (None, None)), (230, 135, 16, (5, 41))])
def test_k2_k3_partial_tiles_on_the_card(card, width, height, tile, span):
    """K2 and K3 (K4, with the span options) against their plain versions
    on a pack with partial tiles: the image, the boundaries and the
    per-instance gradients. K2-span takes whole tiles only and refuses the
    frame before any launch; K4 is fed K2's boundaries."""
    proj = partial_proj(6000, width, height, tile, card)
    tw, th = tpt.tile_grid(width, height, tile)
    packed = tpt.sorted_pack(proj, tw, th, tile)
    before = dict(kernels.LAUNCHES)
    if span[0]:
        with pytest.raises(ValueError, match="whole tiles"):
            ttr.raster_forward_train(packed, width, height, tile, BG, *span)
    out_k, tb_k = ttr.raster_forward_train(packed, width, height, tile, BG)
    cpu = tpt.PackedTiles(*(t.cpu() for t in packed[:4]), aux=None)
    out_p, tb_p = ttr.raster_forward_train(cpu, width, height, tile, BG)
    a = tpt.tiles_to_images(out_k, width, height, tile)
    b = tpt.tiles_to_images(out_p, width, height, tile)
    err = max(float((x.cpu() - y).abs().max()) for x, y in zip(a, b))
    n_rows = int(tpt.chunk_span(cpu)[3].sum())
    tb_err = float((tb_k[:n_rows].cpu() - tb_p[:n_rows]).abs().max())
    rng = torch.Generator().manual_seed(3)
    cot = [torch.randn((c, height, width), generator=rng) for c in (3, 1, 1)]
    gimg = ttr.images_to_tiles(ttr.grad_image(*b, *cot, BG), width, height, tile)
    g_k = ttr.run_backward(packed, gimg.to(card), tb_k, width, height, tile, BG, *span)
    g_p = ttr.run_backward(cpu, gimg, tb_p, width, height, tile, BG, *span)
    g_err = float((g_k.cpu() - g_p).abs().max() / g_p.abs().max())
    names = ("K2", "K4") if span[0] else ("K2", "K3")
    assert all(kernels.LAUNCHES[k] == before.get(k, 0) + 1 for k in names)
    assert kernels.LAUNCHES["K2-span"] == before.get("K2-span", 0)
    print(f"{names} {width}x{height} at {tile} px: image {err:.3e}, boundaries "
          f"{tb_err:.3e}, gradients {g_err:.3e} of the largest")
    assert err <= TOL_CARD and tb_err <= TOL_CARD and g_err <= 1e-4


def test_fit_legacy_trains_on_the_training_tier(tmp_path, monkeypatch):
    """The command line's default fit is the published one: the training
    rasterizer with uncapped splats, and its held-out render uncapped too."""
    pytest.importorskip("PIL")
    pytest.importorskip("h5py")
    from cloth_splatting_tpu_torch.data.synthetic import generate_synthetic_scene
    from cloth_splatting_tpu_torch.fit_legacy import main

    generate_synthetic_scene(str(tmp_path / "scene"), n_views=4, n_times=3,
                             image_size=32, mesh_res=6, device="cpu")
    calls = {"train": 0, "radius": set()}
    raster = TP.rasterize_tiled_train

    def counted(proj, *a, **k):
        calls["train"] += 1
        return raster(proj, *a, **k)

    project = PG.project_gaussians

    def seen(*a, **k):
        calls["radius"].add(k.get("max_radius"))
        return project(*a, **k)

    monkeypatch.setattr(TP, "rasterize_tiled_train", counted)
    monkeypatch.setattr(PG, "project_gaussians", seen)
    main(["-s", str(tmp_path / "scene"), "-m", str(tmp_path / "out"), "--type", "Blender",
          "-w", "--iterations", "3", "--sh_degree", "1", "--device", "cpu"])
    assert calls == {"train": 3, "radius": {None}}
    with open(tmp_path / "out" / "results.json") as f:
        res = json.load(f)["ours_static"]
    assert res["iterations"] == 3 and math.isfinite(res["PSNR"])
