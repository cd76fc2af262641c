"""PyTorch port vs the JAX package: the parity run and the evaluation
command lines around it, on the CPU.

  - ``select_result_method``: the JAX script's choice on the same results;
  - ``eval.align_eval_trajs`` and ``eval.read_all_metrics``: the JAX
    scripts' printed lines on the same files (the MTE line exactly, the
    aligned trajectories within 1e-6); ``full_eval`` issues the root
    ``full_eval.py``'s calls, through the port's command lines;
  - ``parity_bench``'s JSON line: the JAX script's keys and values from the
    same results (both scripts' steps stubbed);
  - the port's file chain at 64 px for 12 iterations, then ``--in_memory``
    on the same arguments: the same numbers within 1e-3 dB and 1e-3 mm.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from cloth_splatting_tpu_torch import full_eval as tfull_eval
from cloth_splatting_tpu_torch import parity_bench as tpb
from cloth_splatting_tpu_torch.eval import align_eval_trajs as talign
from cloth_splatting_tpu_torch.eval import read_all_metrics as tread

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jpb = load_script("scripts/parity_bench.py", "jax_parity_bench")
jalign = load_script("scripts/align_eval_trajs.py", "jax_align_eval_trajs")
jread = load_script("scripts/read_all_metrics.py", "jax_read_all_metrics")
jfull_eval = load_script("full_eval.py", "jax_full_eval")


@pytest.mark.parametrize("results", [
    {"ours_7500": {}, "ours_20000": {}, "train/ours_30000": {}},
    {"ours_900": {}, "ours_1000": {}},
    {"train/ours_5": {}, "video/ours_5": {}},
])
def test_select_result_method_matches_jax(results):
    assert tpb.select_result_method(results) == jpb.select_result_method(results)


def test_align_eval_trajs_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    gt = rng.normal(0, 0.3, (4, 50, 3)).astype(np.float32)
    pred = (gt[:, rng.permutation(50)][:, :40]
            + rng.normal(0, 0.01, (4, 40, 3))).astype(np.float32)
    rot = rng.normal(size=(4, 40, 4)).astype(np.float32)
    np.savez(tmp_path / "gt.npz", traj=gt)
    np.savez(tmp_path / "all_trajs.npz", traj=pred, rotations=rot)
    outs = {}
    for name, main in (("jax", jalign.main), ("torch", talign.main)):
        out = str(tmp_path / f"{name}_aligned.npz")
        main(["--trajs", str(tmp_path / "all_trajs.npz"), "--gt",
              str(tmp_path / "gt.npz"), "--out", out])
        outs[name] = (capsys.readouterr().out.splitlines(), np.load(out))
    (jlines, jnpz), (tlines, tnpz) = outs["jax"], outs["torch"]
    assert tlines[0] == jlines[0] and tlines[0].startswith("MTE mean: ")
    assert tlines[1] == jlines[1].replace("jax_aligned", "torch_aligned")
    for key in ("aligned", "mte"):
        np.testing.assert_allclose(tnpz[key], jnpz[key], atol=1e-6, err_msg=key)
    # the default output name
    talign.main(["--trajs", str(tmp_path / "all_trajs.npz"), "--gt",
                 str(tmp_path / "gt.npz")])
    assert (tmp_path / "all_trajs_aligned.npz").exists()


def test_read_all_metrics_matches_jax(tmp_path, capsys):
    for exp, psnr in (("a", 20.5), ("b/c", 30.25)):
        os.makedirs(tmp_path / exp)
        with open(tmp_path / exp / "results.json", "w") as f:
            json.dump({"ours_10": {"SSIM": 0.9, "PSNR": psnr, "LPIPS": 0.1,
                                   "lpips_weights": "fixture-v1"},
                       "train/ours_10": {"PSNR": psnr + 1.0}}, f)
    jread.main(["--root", str(tmp_path)])
    jout = capsys.readouterr().out
    tread.main(["--root", str(tmp_path)])
    tout = capsys.readouterr().out
    assert tout == jout and "means across experiments" in tout


def test_full_eval_issues_the_root_calls(monkeypatch):
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jfull_eval, "run", calls["jax"].append)
    monkeypatch.setattr(tfull_eval, "run", calls["torch"].append)
    argv = ["-d", "data", "-o", "out", "--scenes", "A", "B", "--view_skip", "2"]
    jfull_eval.main(argv)
    tfull_eval.main(argv + ["--device", "cpu"])
    scripts = {"train.py": "train", "render.py": "eval.render",
               "metrics.py": "eval.metrics",
               "read_all_metrics.py": "eval.read_all_metrics"}
    assert len(calls["torch"]) == len(calls["jax"]) == 7
    for jcmd, tcmd in zip(calls["jax"], calls["torch"]):
        module = scripts[os.path.basename(jcmd[1])]
        assert tcmd[:3] == [sys.executable, "-m", f"cloth_splatting_tpu_torch.{module}"]
        rest = jcmd[2:] + ([] if module == "eval.read_all_metrics"
                           else ["--device", "cpu"])
        assert tcmd[3:] == rest


def test_result_line_matches_jax(tmp_path, monkeypatch, capsys):
    """Both scripts on the same results.json and MTE line, their steps
    stubbed: the same JSON line."""
    scene, exp = tmp_path / "scene", tmp_path / "exp"
    os.makedirs(scene)
    os.makedirs(exp)
    (scene / "transforms_train.json").write_text("{}")
    (exp / "results.json").write_text(json.dumps({
        "ours_900": {"PSNR": 27.1234567, "SSIM": 0.93456, "LPIPS": 0.00123},
        "ours_1000": {"PSNR": 28.9387654, "SSIM": 0.95392, "LPIPS": 0.00049}}))
    mte = "MTE mean: 20.1974 mm (median 18.0 mm, 10 points x 8 times)\n"
    monkeypatch.setattr(jpb, "run", lambda *a, **k: mte)
    monkeypatch.setattr(tpb, "_run", lambda *a, **k: mte)
    argv = ["--workdir", str(tmp_path), "--reuse_scene", "--wave", "isometric",
            "--prediction_noise", "0", "--iterations", "1000"]
    jpb.main(argv)
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tline = tpb.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == tline
    assert list(tline) == list(jline) and tline == jline
    assert tline["value"] == 28.939 and tline["mte_mm"] == 20.197


SMALL = ["--image_size", "64", "--mesh_res", "8", "--n_views", "6", "--n_times", "3",
         "--iterations", "12", "--static", "4", "--prediction_noise", "0.005",
         "--wave", "isometric", "--train_args", "--coarse_iterations 4 --param_ema 0.9",
         "--device", "cpu"]


def test_file_chain_and_in_memory_agree(tmp_path, monkeypatch, capsys):
    """The port's file chain through its command lines, then the in-memory
    form of the same run: the same JSON line, within 1e-3 dB and 1e-3 mm."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    files = tpb.main(["--workdir", str(tmp_path)] + SMALL)
    exp = tmp_path / "exp"
    assert (exp / "all_trajs_aligned.npz").exists()
    assert json.loads((exp / "results.json").read_text())["ours_12"]["PSNR"] > 10
    memory = tpb.main(["--in_memory"] + SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == memory and out[-2].startswith("parity (in memory)")
    assert list(memory) == list(files)
    for key in ("value", "mte_mm"):
        assert abs(memory[key] - files[key]) <= 1e-3 + 1e-9, (key, files, memory)
    for key in ("ssim", "lpips"):
        assert abs(memory[key] - files[key]) <= 1e-4 + 1e-9, (key, files, memory)
    assert {k: v for k, v in memory.items() if k not in ("value", "ssim", "lpips",
                                                         "mte_mm")} == {
        "metric": "parity_psnr_db", "unit": "dB", "image_size": 64,
        "iterations": 12, "prediction_noise": 0.005, "noise_mode": "iid",
        "wave": "isometric"}
