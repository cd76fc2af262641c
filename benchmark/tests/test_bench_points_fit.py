"""The ``fit-gs360`` cell at a tiny size on the CPU: the contract's result
line with ``correct`` true, and the point trainer run with the cloth
field's 24 px radius cap, or with its host events left out, coming out not
correct. The control (the reference in TF32 in the program's place) needs
the card."""

import copy
import json
import time

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

CELL = "fit-gs360"


def fit_config() -> dict:
    """gs-360-3m-fit cut to 3,000 Gaussians in 3,500 slots at 160 x 100
    (partial 16 px tiles on the last row) and 4 views, its Gaussians larger,
    so that some splats pass 24 px."""
    cfg = copy.deepcopy(tiny.load("configs", "gs-360-3m-fit"))
    cfg.update(gaussians=3000, capacity=3500, views=4, instance_tile=16)
    cfg["image"].update(width=160, height=100)
    cfg["field"]["object"]["log_scale_mean"] = -1.6
    cfg["field"]["shell"]["angular_scale"] = 0.05
    # two iterations' statistic at this size: a lower bar, so that the
    # event clones and splits
    cfg["optimization"]["densify_grad_threshold"] = 2e-5
    return cfg


def fit_traffic() -> dict:
    """fit-7099 at the tiny size: one Gaussian that one side alone picks at
    the densification threshold is 6e-4 of this size's ~1,700 event counts
    (1.5e-6 of the full size's), and two iterations' statistic over ~3,000
    Gaussians reads ~1e-2; ``change`` compares ~480 rows here (about two
    million at the full size), so one row whose rounding-level gradient
    Adam moves by a learning rate one way on one side and the other way on
    the other reads ~1e-2: ``population``, ``stats`` and ``change`` take
    limits of this size, still under what the 24 px cap reads on ``change``
    (~0.1) and the events left out on the others (~1)."""
    tr = copy.deepcopy(tiny.load("traffic", "fit-7099"))
    tr.update(segment=5, trace_iterations=1)
    tr["limits"].update(population=1e-2, stats=5e-2, change=3e-2)
    return tr


def run_cpu(seed: int = 2147483659, seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    return run.run_loaded(tiny.manifest(), CELL, fit_config(), fit_traffic(), seed, seconds,
                          False, torch.device("cpu"), time.perf_counter())


def test_the_cell_is_in_the_manifest():
    m = tiny.manifest()
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert cell["config"] == "gs-360-3m-fit" and cell["chips"] == 1
    assert run.end_to_end_names(m, CELL) == ["fit_it_per_s", "setup_s"]
    assert run.per_layer_names(m, CELL) == ["k2_roofline.gs360fit", "k3_roofline.gs360fit",
                                           "idle_share.gs360fit", "launches.gs360fit",
                                           "mfu.gs360fit"]
    cfg = tiny.load("configs", "gs-360-3m-fit")
    serve = tiny.load("configs", "gs-360-3m")
    for key in ("sh_degree", "raster_pack_order", "max_splat_radius", "gaussians",
                "instance_tile", "image", "field"):
        assert cfg[key] == serve[key], key
    assert cfg["capacity"] == 3_500_000 and cfg["reduced"] == ["views"]


def test_result_line_and_correct():
    r = run_cpu()
    r.pop("_forbidden")
    details = r.pop("_details")
    assert r["correct"], (r["checks"], details)
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"fit_it_per_s", "setup_s"}
    assert set(r["checks"]) == {"loss_step1", "grad", "change", "stats", "population",
                                "event_rows", "instances_rel_gap"}
    # the density event of 7,100 added and removed Gaussians on both sides,
    # and the packs dropped nothing
    assert min(details["events_program"][0] + details["events_reference"][0]) > 0
    assert details["instances_emitted"][0] == details["reference_tile_pairs"][0]
    assert set(details["host_ms_per_it"]) >= {"forward", "backward", "update"}
    json.dumps(r)


def capped_radius(monkeypatch):
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.projection import MAX_SPLAT_RADIUS

    project = PG.project_gaussians
    monkeypatch.setattr(PG, "project_gaussians",
                        lambda *a, **k: project(*a, **dict(k, max_radius=MAX_SPLAT_RADIUS)))


def no_events(monkeypatch):
    from cloth_splatting_tpu_torch.train.points import PointTrainer

    monkeypatch.setattr(PointTrainer, "host_events", lambda self, state, *a, **k: state)


@pytest.mark.parametrize("fault", [capped_radius, no_events])
def test_faults_come_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run_cpu()
    assert not r["correct"], r["checks"]
