"""The manifest against the contract's rules, the result line's shape, the
per-layer readers, and a cell, a mix and a metric added as files alone."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_manifest_names_units_and_keys():
    m = tiny.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = []
    for group, keys in ENTRY_KEYS.items():
        for e in m[group]:
            assert set(e) <= keys, (group, e)
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    assert len(set(names)) == len(names)
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (tiny.ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and w["chips"] in (1, 4)
        assert (tiny.ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    assert any(e["name"] == "setup_s" and e["bound"] <= 0.25 for e in m["end_to_end"])
    assert all(0.01 <= e["bound"] <= 0.25 for e in m["end_to_end"])
    assert m["paths"] == ["benchmark"] and len(json.dumps(m)) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    m = tiny.manifest()
    for w in m["workloads"]:
        e2e = run.end_to_end_names(m, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.per_layer_names(m, w["name"])


def test_per_layer_metrics_move_what_their_cells_report():
    """Each per-layer metric's end-to-end target is reported in every cell
    that reports the metric, and the metric has a reader."""
    m = tiny.manifest()
    for p in m["per_layer"]:
        cells = p.get("workloads") or [w["name"] for w in m["workloads"]]
        for c in cells:
            assert p["moves"] in run.end_to_end_names(m, c), (p["name"], c)
        assert run.reader_path(tiny.ROOT, p["name"]).is_file(), p["name"]
    layers = {}
    for p in m["per_layer"]:
        layers.setdefault(p["layer"], set()).add(p["name"])
    assert all("\n" not in layer for layer in layers)


def fake_ctx():
    trace = {"units": 2, "wall_s": 0.5, "busy_s": 0.05, "launches": 100,
             "kernels": {"void tiled_fwd_kernel<4>(int)": {"count": 2, "seconds": 0.001},
                         "void tiled_fwd_train_kernel<4>(int)": {"count": 2, "seconds": 0.002},
                         "void tiled_bwd_kernel<4>(int)": {"count": 2, "seconds": 0.003},
                         "sm80_xmma_gemm_f32f32": {"count": 4, "seconds": 0.01}},
             "device_ops": [], "idle_gaps": []}
    item = {"pairs": 10 ** 6, "gaussians": 65536, "pixels": 640000}
    work = {"raster_forward": [item, item], "raster_backward": [item, item], "flops": 1e9}
    window = {"p50_ms": 12.0, "elapsed_s": 10.0, "attempted": 40}
    return {"trace": trace, "work": work, "window": window, "unit_s": 0.25, "tf32": False,
            "peak_flops": run.PEAK_FLOPS["fp32"], "peak_bytes": run.PEAK_BYTES}


def test_per_layer_readers_give_shares_under_100_or_nothing():
    m = tiny.manifest()
    ctx = fake_ctx()
    for p in m["per_layer"]:
        mod = run.load_file(run.reader_path(tiny.ROOT, p["name"]))
        v = mod.read(ctx)
        assert v is not None and v > 0, p["name"]
        if p["unit"] == "%":
            assert v < 100, (p["name"], v)
        empty = dict(ctx, trace=None, work=None, window=None, unit_s=None)
        assert mod.read(empty) is None, p["name"]


def test_result_line_has_the_contract_shape():
    r = tiny.run_cpu("render-cs65k")
    r.pop("_forbidden"), r.pop("_details")
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert isinstance(r["correct"], bool) and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"render_ms_p95", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    json.dumps(r)


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_are_added_as_files_alone(tmp_path):
    """In a copy of the benchmark: a new configuration, traffic mix and
    per-layer metric as new files and manifest entries run with no edit to
    any file that was there."""
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "benchmark")
    cfg = tiny.cs_config()
    cfg["name"] = "cs-small"
    (tmp_path / "benchmark" / "configs" / "cs-small.json").write_text(json.dumps(cfg))
    mix = tiny.traffic("novel-views")
    mix["azimuth"] = [-0.3, 0.3]
    (tmp_path / "benchmark" / "traffic" / "near-front.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "frames_traced.render-small.py").write_text(
        'def read(ctx):\n    return ctx["trace"]["units"] if ctx["trace"] else None\n')
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "cs-small", "source": "https://example.org/cs-small",
                         "file": "benchmark/configs/cs-small.json", "reduced": [],
                         "why": "a small field"})
    m["workloads"].append({"name": "render-small", "config": "cs-small",
                           "traffic": "near-front", "chips": 1, "why": "near the front"})
    m["per_layer"].append({"name": "frames_traced.render-small", "unit": "frames",
                           "better": "higher", "source": "device_trace",
                           "layer": "render.render", "moves": "render_ms_p95",
                           "workloads": ["render-small"]})
    # a metric of a kind that has a reader needs no file
    m["per_layer"].append({"name": "launches.render-small", "unit": "launches/frame",
                           "better": "lower", "source": "device_trace",
                           "layer": "host dispatch", "moves": "render_ms_p95",
                           "workloads": ["render-small"]})
    for e in m["end_to_end"]:
        if e["name"] == "render_ms_p95":
            e["workloads"].append("render-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = """
import json, sys, time, torch
sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2])
from benchmark import run
assert str(run.ROOT) == sys.argv[1], run.ROOT
m = run.load_json(run.ROOT / "BENCHMARK.json")
cell, config, traffic = run.cell_entries(m, "render-small")
cfg = run.load_json(run.ROOT / config["file"])
r = run.run_loaded(m, "render-small", cfg, traffic, 7, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
names = run.per_layer_names(m, "render-small")
mod = run.load_file(run.reader_path(run.ROOT, names[-2]))
kind = run.load_file(run.reader_path(run.ROOT, names[-1]))
tr = {"units": 3, "launches": 12}
print(json.dumps({"correct": r["correct"], "metrics": sorted(r["metrics"]),
                  "per_layer": names, "read": [mod.read({"trace": tr}),
                                               kind.read({"trace": tr})]}))
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(tiny.ROOT)],
                         capture_output=True, text=True, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"] == ["render_ms_p95", "setup_s"]
    assert res["per_layer"][-2:] == ["frames_traced.render-small", "launches.render-small"]
    assert res["read"] == [3, 4]
    after = digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fit-cs65k",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=str(tiny.ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_control_comes_out_not_correct(card):
    """The control (the reference in TF32 in the program's place) at each
    cell's own size on the card: at least one compared number over its
    limit."""
    import importlib

    import torch

    from benchmark.harness.checks import judge

    m = tiny.manifest()
    for w in m["workloads"]:
        _, config, traffic = run.cell_entries(m, w["name"])
        cfg = run.load_json(tiny.ROOT / config["file"])
        d = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(
            cfg, traffic, 4242, card)
        d.setup()
        d.window(2.0)
        d.release()
        ok, table = judge(d.control(), traffic["limits"])
        assert not ok, (w["name"], table)
        del d
        torch.cuda.empty_cache()
