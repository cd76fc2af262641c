"""The port's config files and ``--configs``, against the JAX package, on
the CPU.

The published config files (``cloth_splatting_tpu/configs/``) overlay on
the port's ``Config`` through ``train/config.py::load_config_file`` and
through ``python -m cloth_splatting_tpu_torch.train --configs FILE``, and
leave every field the port has equal to the JAX package's after the same
overlay. The fields the JAX package accepts and never reads are ignored; a
field that changes behaviour and is not ported still raises.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from cloth_splatting_tpu.train.config import Config as JConfig
from cloth_splatting_tpu.train.config import load_config_file as jload

from cloth_splatting_tpu_torch.train.__main__ import build_parser, config_from_args
from cloth_splatting_tpu_torch.train.config import IGNORED
from cloth_splatting_tpu_torch.train.config import Config as TConfig
from cloth_splatting_tpu_torch.train.config import apply_overrides
from cloth_splatting_tpu_torch.train.config import load_config_file as tload

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "cloth_splatting_tpu" / "configs"
FILES = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.glob("*/*.py"))
GROUPS = ("model", "opt", "meshnet")


def assert_fields_equal(tcfg, jcfg):
    for group in GROUPS:
        for key, value in dataclasses.asdict(getattr(tcfg, group)).items():
            assert getattr(getattr(jcfg, group), key) == value, f"{group}.{key}"


def test_the_four_published_files_are_found():
    assert FILES == ["cloth_splatting/continual.py", "cloth_splatting/default.py",
                     "cloth_splatting/real_world.py", "mdnerf_dataset/cube.py"]


@pytest.mark.parametrize("name", FILES)
def test_config_file_overlays_like_jax(name):
    path = str(CONFIGS / name)
    tcfg = tload(TConfig(), path)
    jcfg = jload(JConfig(), path)
    assert_fields_equal(tcfg, jcfg)
    # the file moved the port's config off its defaults
    assert dataclasses.asdict(tcfg.opt) != dataclasses.asdict(TConfig().opt)


@pytest.mark.parametrize("name", FILES)
def test_configs_flag_applies_the_file(name):
    path = str(CONFIGS / name)
    args = build_parser().parse_args(["--configs", path, "-s", "scene",
                                      "--iterations", "7"])
    cfg = config_from_args(args)
    jcfg = jload(JConfig(), path)
    jcfg.opt.iterations = 7          # a field's flag overrides the file
    jcfg.model.source_path = "scene"
    assert_fields_equal(cfg, jcfg)
    assert args.save_test_images    # the root train.py's default


def test_ignored_fields_are_ignored_and_unported_ones_raise(tmp_path):
    """Every field of the JAX package's groups is ported or ignored: the
    ignored ones change nothing, ``raster_k_cap`` and ``raster_k_chunk``
    overlay as in JAX, and a field neither package has raises."""
    ignored = {g: {k: "x" for k in fields} for g, fields in IGNORED.items()
               if fields is not None}
    ignored["ModelHiddenParams"] = {"kplanes": 1}
    tcfg = apply_overrides(TConfig(), ignored)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(TConfig())
    cfg_file = tmp_path / "k_cap.py"
    cfg_file.write_text("OptimizationParams = dict(lambda_dssim=0.5, "
                        "raster_k_cap=64, raster_k_chunk=16)\n")
    jcfg = jload(JConfig(), str(cfg_file))
    for tcfg in (tload(TConfig(), str(cfg_file)),
                 config_from_args(build_parser().parse_args(
                     ["--configs", str(cfg_file)]))):
        assert_fields_equal(tcfg, jcfg)
        assert (tcfg.opt.raster_k_cap, tcfg.opt.raster_k_chunk) == (64, 16)
    args = build_parser().parse_args(["--configs", str(cfg_file),
                                      "--raster_k_cap", "128"])
    assert config_from_args(args).opt.raster_k_cap == 128
    cfg_file.write_text("OptimizationParams = dict(raster_k_capp=64)\n")
    with pytest.raises(KeyError, match="raster_k_capp"):
        tload(TConfig(), str(cfg_file))
    with pytest.raises(KeyError, match="raster_k_capp"):
        config_from_args(build_parser().parse_args(["--configs", str(cfg_file)]))
