"""The ``render-gs360`` cell at a tiny size on the CPU: the contract's
result line with ``correct`` true, and the answer altered where it is
produced or the point model run with the cloth field's 24 px radius cap
coming out not correct."""

import copy
import json
import time

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

CELL = "render-gs360"


def gs_config() -> dict:
    """gs-360-3m cut to 3,000 Gaussians at 160 x 100 (partial 16 px tiles
    on the last row), its Gaussians larger, so that some splats pass 24 px."""
    cfg = copy.deepcopy(tiny.load("configs", "gs-360-3m"))
    cfg["gaussians"] = 3000
    cfg["image"].update(width=160, height=100)
    cfg["instance_tile"] = 16
    cfg["field"]["object"]["log_scale_mean"] = -2.5
    cfg["field"]["shell"]["angular_scale"] = 0.3
    return cfg


def orbit_traffic() -> dict:
    tr = copy.deepcopy(tiny.load("traffic", "orbit-360"))
    tr.update(warm_frames=1, check_frames=3, trace_frames=2)
    return tr


def run_cpu(seed: int = 5, seconds: float = 0.5) -> dict:
    return run.run_loaded(tiny.manifest(), CELL, gs_config(), orbit_traffic(), seed, seconds,
                          False, torch.device("cpu"), time.perf_counter())


def test_the_cell_is_in_the_manifest():
    m = tiny.manifest()
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert cell["config"] == "gs-360-3m" and cell["chips"] == 1
    assert run.end_to_end_names(m, CELL) == ["render_ms_p95", "setup_s"]
    assert run.per_layer_names(m, CELL) == ["k1_roofline.gs360", "launches.gs360",
                                           "idle_share.gs360", "mfu.gs360",
                                           "render_ms_p50.gs360"]
    cfg = tiny.load("configs", "gs-360-3m")
    assert cfg["gaussians"] == 3_000_000 and cfg["sh_degree"] == 3
    assert (cfg["image"]["width"], cfg["image"]["height"]) == (1237, 822)


def test_result_line_and_correct():
    r = run_cpu()
    r.pop("_forbidden")
    details = r.pop("_details")
    assert r["correct"], (r["checks"], details)
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"render_ms_p95", "setup_s"}
    assert set(r["checks"]) == {"frame_mean_abs", "instances_rel_gap"}
    # no instance dropped: what the binning emitted is the reference's count
    assert details["instances_emitted"] == details["reference_tile_pairs"]
    assert min(details["instances_emitted"]) > 0
    json.dumps(r)


def altered_frame(monkeypatch):
    from cloth_splatting_tpu_torch.models import point_gaussians as PG

    render = PG.render_points

    def broken(*a, **k):
        rgb, depth, radii = render(*a, **k)
        rgb = rgb.clone()
        rgb[:, : rgb.shape[1] // 4] += 0.01
        return rgb, depth, radii

    monkeypatch.setattr(PG, "render_points", broken)


def capped_radius(monkeypatch):
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS

    project = PG.project_gaussians

    def capped(*a, **k):
        return project(*a, **dict(k, max_radius=MAX_SPLAT_RADIUS))

    monkeypatch.setattr(PG, "project_gaussians", capped)


@pytest.mark.parametrize("fault", [altered_frame, capped_radius])
def test_faults_come_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run_cpu()
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("key, value", [("instance_tile", 32),
                                        ("raster_pack_order", "fused")])
def test_setup_refuses_what_the_program_does_not_run(key, value):
    """The check counts instances on ``instance_tile`` px tiles and the
    program packs in exact order: a configuration that says otherwise fails
    at set-up, before any field is drawn."""
    from benchmark.drivers.render_points import Driver

    cfg = dict(gs_config(), **{key: value})
    d = Driver(cfg, orbit_traffic(), 5, torch.device("cpu"))
    with pytest.raises(ValueError):
        d.setup()
    assert not hasattr(d, "field")


@pytest.mark.card
def test_control_and_capped_radius_at_full_size(card, monkeypatch):
    """At the cell's own size on the card: the sound run correct, the
    control (the reference in TF32 in the program's place) and the program
    with the 24 px cap not."""
    from benchmark.drivers.render_points import Driver
    from benchmark.harness.checks import judge

    _, config, traffic = run.cell_entries(tiny.manifest(), CELL)
    cfg = run.load_json(tiny.ROOT / config["file"])
    readings = {}
    for name in ("sound", "capped"):
        if name == "capped":
            capped_radius(monkeypatch)
        d = Driver(cfg, traffic, 2147483659, card)
        d.setup()
        d.window(2.0)
        d.release()
        readings[name] = judge(d.check(), traffic["limits"])
        if name == "sound":
            readings["control"] = judge(d.control(), traffic["limits"])
        del d
        torch.cuda.empty_cache()
    print(json.dumps({k: v[1] for k, v in readings.items()}))
    assert readings["sound"][0], readings["sound"]
    assert not readings["control"][0] and not readings["capped"][0], readings


def test_point_front_end_count():
    from benchmark.counts import point_front_end

    # rotation 45, covariance 42, direction 10, SH 136, projection 140, activations 34
    assert point_front_end.flops(5) == 5 * 407
