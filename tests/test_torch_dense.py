"""PyTorch port vs the JAX package: the dense tile tier and its ``k_cap``
contract, on the CPU.

The JAX tier (``ops/rasterize/tiled.py``) is plain XLA, so the port's is
plain PyTorch; both run here without Pallas. Tolerances:
  - ``counting_rank``, ``rank_permutation`` and ``quantize_depth``: exact;
  - ``bin_gaussians``: the dense grid within 1e-6, ``RasterAux`` equal;
  - ``rasterize_tiled`` at 64x64: values within 1e-5, gradients within 1e-4
    of each field's largest magnitude (against ``jax.grad``);
  - ``render(backend="tiled")``: 1e-5 for the images (same tier);
  - one ``Trainer.step`` through the dense tier: the step's tolerances of
    tests/test_torch_train.py;
  - a short fit in both packages with a tiny ``k_cap``: the same sequence
    of ``k_cap`` growths; ``evaluate_split`` from an overflowing ``k_cap``
    on JAX's final state: the port's PSNR within 1e-4 dB of JAX's, nothing
    dropped at the cap it grew to.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.data import scene as jscene
from cloth_splatting_tpu.data.synthetic import generate_synthetic_scene
from cloth_splatting_tpu.ops import sort as jsort
from cloth_splatting_tpu.ops.rasterize import tiled as jtiled
from cloth_splatting_tpu.train import loop as jloop
from cloth_splatting_tpu.train.config import Config as JConfig
from cloth_splatting_tpu.train.step import Trainer as JTrainer

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data import scene as tscene
from cloth_splatting_tpu_torch.ops import sort as tsort
from cloth_splatting_tpu_torch.ops.rasterize import tiled as ttiled
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.train.config import Config as TConfig
from cloth_splatting_tpu_torch.train.step import Trainer as TTrainer

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_raster import hand_proj, to_torch  # noqa: E402
from test_torch_train import cameras, grad_close, states, t, tree_arrays  # noqa: E402
from test_torch_train import trainers as step_trainers  # noqa: E402

torch.set_num_threads(1)

TOL_IMG = 1e-5
TOL_GRAD = 1e-4          # times the field's largest magnitude
BG = (1.0, 1.0, 1.0)
PROJ_FIELDS = ("xy", "conic", "color", "opacity", "depth")


# ------------------------------------------------------------------ sorting

# either side of the JAX counting sort's chunk steps (_auto_chunk: 128 up to
# 16,384 keys, then 256, 512, 1024)
SIZES = (1, 127, 128, 129, 16384, 16385, 32769, 65537)


@pytest.mark.parametrize("n", SIZES)
def test_counting_rank_matches_jax(n):
    rng = np.random.default_rng(n)
    n_buckets = 61
    keys = rng.integers(0, n_buckets, n).astype(np.int32)
    keys[rng.uniform(size=n) < 0.2] = n_buckets - 1          # sentinel bucket
    want = np.asarray(jsort.counting_rank(jnp.asarray(keys), n_buckets))
    got = tsort.counting_rank(torch.from_numpy(keys), n_buckets)
    np.testing.assert_array_equal(got.numpy(), want)
    jr, ji = jsort.rank_permutation(jnp.asarray(keys), n_buckets)
    tr, ti = tsort.rank_permutation(torch.from_numpy(keys), n_buckets)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_depth_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 20000
    depth = rng.uniform(0.2, 9.0, n).astype(np.float32)
    depth[:50] = depth[50]                                     # ties
    valid = rng.uniform(size=n) < 0.9
    depth[~valid] = np.inf
    want = np.asarray(jsort.quantize_depth(jnp.asarray(depth), jnp.asarray(valid),
                                           jtiled.DEPTH_BUCKETS))
    got = tsort.quantize_depth(torch.from_numpy(depth), torch.from_numpy(valid),
                               ttiled.DEPTH_BUCKETS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_depth_without_valid_entries():
    depth = np.full(7, np.inf, np.float32)
    valid = np.zeros(7, bool)
    want = np.asarray(jsort.quantize_depth(jnp.asarray(depth), jnp.asarray(valid), 16))
    got = tsort.quantize_depth(torch.from_numpy(depth), torch.from_numpy(valid), 16)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ binning

def deep_scene(seed=5):
    """Hundreds of overlapping splats per tile, so a small k_cap drops."""
    rng = np.random.default_rng(seed)
    n = 600
    return hand_proj(rng.uniform(0, 64, (n, 2)), rng.uniform(1, 5, n), 20.0,
                     conic=(1 / 40, 0.0, 1 / 40),
                     opacity=rng.uniform(0.05, 0.3, n), seed=seed)


@pytest.mark.parametrize("k_cap", [16, 128])
def test_bin_gaussians_matches_jax(k_cap):
    pj = project_scene(n=96, seed=0)
    jb = jtiled.bin_gaussians(pj, W // 16, H // 16, 16, 5, k_cap)
    tb = ttiled.bin_gaussians(to_torch(pj), W // 16, H // 16, 16, 5, k_cap)
    np.testing.assert_allclose(tb.dense.numpy(), np.asarray(jb.dense), atol=1e-6)
    assert int(tb.aux.n_dropped) == int(jb.aux.n_dropped)
    assert int(tb.aux.max_tile_count) == int(jb.aux.max_tile_count)
    if k_cap == 16:
        assert int(tb.aux.n_dropped) > 0


# ---------------------------------------------------------------- rasterize

def raster_both(pj, k_cap, k_chunk):
    jout = jtiled.rasterize_tiled(pj, W, H, jnp.asarray(BG), k_cap=k_cap,
                                  k_chunk=k_chunk)
    tout = ttiled.rasterize_tiled(to_torch(pj), W, H, BG, k_cap=k_cap,
                                  k_chunk=k_chunk)
    return jout, tout


def assert_images_close(jout, tout):
    for name, j, t in zip(("rgb", "depth", "alpha"), jout[:3], tout[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL_IMG,
                                   err_msg=name)
    assert int(tout[3].n_dropped) == int(jout[3].n_dropped)
    assert int(tout[3].max_tile_count) == int(jout[3].max_tile_count)


@pytest.mark.parametrize("case", ["scene", "overflow", "deep_overflow"])
def test_rasterize_tiled_matches_jax(case):
    pj = deep_scene() if case == "deep_overflow" else project_scene(n=96, seed=1)
    k_cap, k_chunk = {"scene": (128, 16), "overflow": (8, 4),
                      "deep_overflow": (32, 8)}[case]
    jout, tout = raster_both(pj, k_cap, k_chunk)
    assert_images_close(jout, tout)
    assert (int(tout[3].n_dropped) > 0) == (case != "scene")


def test_rasterize_tiled_background_only():
    pj = project_scene(n=8, seed=3)
    pj = pj._replace(valid=jnp.zeros_like(pj.valid))
    jout, tout = raster_both(pj, 32, 8)
    assert_images_close(jout, tout)
    np.testing.assert_allclose(tout[0].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(tout[2].numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("case", ["scene", "deep_overflow"])
def test_rasterize_tiled_grads_match_jax(case):
    pj = deep_scene() if case == "deep_overflow" else project_scene(n=96, seed=2)
    k_cap, k_chunk = (32, 8) if case == "deep_overflow" else (64, 16)
    rng = np.random.default_rng(7)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((3, H, W), (1, H, W), (1, H, W))]

    def jloss(xy, conic, color, opacity, depth):
        p = pj._replace(xy=xy, conic=conic, color=color, opacity=opacity, depth=depth)
        rgb, dep, acc, _ = jtiled.rasterize_tiled(p, W, H, jnp.asarray(BG),
                                                  k_cap=k_cap, k_chunk=k_chunk)
        return sum(jnp.sum(o * c) for o, c in zip((rgb, dep, acc), cot))

    jg = jax.grad(jloss, argnums=tuple(range(5)))(
        *(getattr(pj, f) for f in PROJ_FIELDS))
    tp = to_torch(pj)
    leaves = {f: getattr(tp, f).clone().requires_grad_() for f in PROJ_FIELDS}
    rgb, dep, acc, _ = ttiled.rasterize_tiled(tp._replace(**leaves), W, H, BG,
                                              k_cap=k_cap, k_chunk=k_chunk)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip((rgb, dep, acc), cot))
    tg = torch.autograd.grad(loss, list(leaves.values()))
    for name, j, t in zip(PROJ_FIELDS, jg, tg):
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1e-12)
        assert float(np.abs(t.numpy() - j).max()) <= TOL_GRAD * scale, name


@pytest.mark.parametrize("size", [(72, 64), (64, 40)])
def test_frames_that_do_not_tile_raise_like_jax(size):
    w, h = size
    pj = project_scene(n=8, seed=0)
    with pytest.raises(ValueError, match="multiples of tile_size") as jerr:
        jtiled.rasterize_tiled(pj, w, h, jnp.asarray(BG))
    with pytest.raises(ValueError, match="multiples of tile_size") as terr:
        ttiled.rasterize_tiled(to_torch(pj), w, h, BG)
    assert str(terr.value) == str(jerr.value)


def test_small_window_raises_like_jax():
    pj = project_scene(n=8, seed=0)
    with pytest.raises(ValueError) as jerr:
        jtiled.rasterize_tiled(pj, W, H, jnp.asarray(BG), win=4)
    with pytest.raises(ValueError) as terr:
        ttiled.rasterize_tiled(to_torch(pj), W, H, BG, win=4)
    assert str(terr.value) == str(jerr.value)
    assert "need >= 5" in str(terr.value)


# ------------------------------------------------------- training and loop

DENSE = {"OptimizationParams": {"raster_backend": "tiled", "raster_k_cap": 16,
                                "raster_k_chunk": 8}}


def test_dense_train_step_matches_jax():
    """One dynamic step through the dense tier from the same state, 4x4
    mesh at 32x32, two cameras, k_cap 16 (instances drop in both)."""
    _, jtr, ttr = step_trainers(DENSE)
    assert jtr.backend == ttr.backend == "tiled"
    jstate, tstate = states(jtr)
    jcams, tcams = cameras(32, (0.0, 1.0))
    gts = np.full((2, 3, 32, 32), 0.5, np.float32)
    jnew, jm = jtr.step(jstate, jcams, jnp.asarray(gts), None, sh_degree=1,
                        static=False)
    fwd = ttr.forward(tstate, tcams, t(gts), None, 1, False)
    grads = ttr.backward(fwd)
    tnew, tm = ttr.update(tstate, fwd, grads)
    for name in ("loss", "psnr", "l1"):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=1e-5, err_msg=name)
    assert int(tm.n_dropped) == int(jm.n_dropped) > 0
    for label, g_t, jopt in (("gaussian", grads[0]._asdict(), jnew.g_opt),
                             ("simulator", grads[1], jnew.sim_opt)):
        for k, mu in jopt.mu._asdict().items():
            grad_close(g_t[k].numpy(), np.asarray(mu) / 0.1, 2e-4, f"{label}.{k}")
    grad_close(tnew.gstate.grad_accum.numpy(), jnew.gstate.grad_accum, 2e-4,
               "grad_accum")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    generate_synthetic_scene(path, n_views=3, n_times=3, image_size=64, mesh_res=8,
                             test_views=(1,), wave="isometric")
    return path


FIT = dict(iterations=8, static_reconst=True, static_reconst_iteration=100,
           raster_backend="tiled", raster_k_cap=4, raster_k_chunk=4,
           densify_from_iter=1000, opacity_reset_interval=1000, bary_cleanup=1000)


def test_short_dense_fit_grows_k_cap_like_jax(scene_dir, tmp_path):
    """Every iteration a tick (``on_iteration``): two overflowing ticks in a
    row double k_cap in both packages at the same iterations. Then the
    evaluation of JAX's final state, from a k_cap that overflows, in both
    packages."""
    js = jscene.load_cloth_scene(scene_dir)
    ts = tscene.load_cloth_scene(scene_dir, device="cpu")
    jcfg, tcfg = JConfig(), TConfig()
    for key, value in FIT.items():
        setattr(jcfg.opt, key, value)
        setattr(tcfg.opt, key, value)
    caps = {"jax": [], "torch": []}
    jfinal = jloop.train_scene(
        jcfg, js, str(tmp_path / "jax"), seed=3, progress_every=1000,
        on_iteration=lambda i, m: caps["jax"].append(jcfg.opt.raster_k_cap))
    tloop.train_scene(
        tcfg, ts, str(tmp_path / "torch"), seed=3, progress_every=1000,
        on_iteration=lambda i, m: caps["torch"].append(tcfg.opt.raster_k_cap),
        device="cpu")
    assert caps["torch"] == caps["jax"]
    assert caps["torch"][0] == 4 and caps["torch"][-1] > 8, caps

    # the evaluation grows its own cap from the trainer's until no frame drops
    cam0 = js.train.get(0, 0).camera
    jcfg.opt.raster_k_cap = tcfg.opt.raster_k_cap = 4
    jtr = JTrainer(jcfg, js.initial_mesh, jnp.asarray(js.mesh_predictions),
                   cam0.width, cam0.height, cam0.tanfovx, cam0.tanfovy, js.radius)
    ttr = TTrainer(tcfg, ts.initial_mesh, torch.from_numpy(ts.mesh_predictions),
                   cam0.width, cam0.height, cam0.tanfovx, cam0.tanfovy, ts.radius)
    tstate = convert.train_state(tree_arrays(jfinal), "cpu")
    jev = jloop.evaluate_split(jtr, jfinal, js.test, True, 0)
    tev = tloop.evaluate_split(ttr, tstate, ts.test, True, 0)
    assert tev["n_dropped"] == 0 and tev["k_cap"] > 4
    assert abs(tev["psnr"] - jev["psnr"]) < 1e-4, (tev, jev)
    assert abs(tev["l1"] - jev["l1"]) < 1e-6
