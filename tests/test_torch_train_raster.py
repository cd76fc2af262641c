"""PyTorch port vs the JAX package: the training rasterizer (K2 forward,
K3 backward, the autograd Function) on the CPU.

Inputs are 64x64 scenes from ``test_rasterize.project_scene`` at 16 px and
32 px tiles, plus a deep pack in which the tile-wide T <= 1e-4 exit fires.
The port's plain versions (what the wrappers run on CPU tensors) are held
to JAX Pallas in interpret mode. Tolerances:
  - K2 ``out``: 3e-4 rgb/alpha, 3e-3 depth (tests/test_pallas_raster.py);
    the saved boundaries within 1e-5 and zero on exactly the same chunks;
  - K3 per-instance grads and the Function's per-Gaussian grads: 2e-4 times
    each field's largest magnitude (tests/test_pallas_raster.py:221-223);
    the JAX backward classifies pairs through a log-space monomial matmul
    and the port elementwise, so a pair sitting on its cut may flip;
  - the loss: rtol 1e-5.
The kernels themselves run only on a CUDA card, where chip_smoke.py holds
them against these plain versions.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from cloth_splatting_tpu.ops.projection import ProjectedGaussians as JProj
from cloth_splatting_tpu.ops.rasterize import pallas_tiled as jpt
from cloth_splatting_tpu.ops.rasterize import pallas_train as jptr
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.render import render as jrender

from cloth_splatting_tpu_torch import convert, kernels
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as ttr
from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference
from cloth_splatting_tpu_torch.render import render as trender

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_raster import hand_proj, to_torch  # noqa: E402

torch.set_num_threads(1)

TOL_IMG = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}
TOL_TB = 1e-5
TOL_GRAD = 2e-4          # times the field's largest magnitude
BG = (1.0, 1.0, 1.0)
FIELDS = {"xy": slice(0, 2), "conic": slice(2, 5), "color": slice(5, 8),
          "opacity": slice(8, 9), "depth": slice(9, 10)}


def deep_scene(seed=4):
    """Hundreds of overlapping splats per tile: the exit fires mid-list."""
    rng = np.random.default_rng(seed)
    n = 1500
    return hand_proj(rng.uniform(0, 64, (n, 2)), rng.uniform(1, 5, n), 24.0,
                     conic=(1 / 64, 0.0, 1 / 64),
                     opacity=rng.uniform(0.2, 0.6, n), seed=seed)


SCENES = {
    "scene16": (lambda: project_scene(n=96, seed=0), 16, 5),
    "scene32": (lambda: project_scene(n=96, seed=2), 32, 3),
    "deep16": (deep_scene, 16, 5),
    "deep32": (deep_scene, 32, 3),
}


def packs(name):
    make, tile, win = SCENES[name]
    pj = make()
    jp = jpt.sorted_pack(pj, W // tile, H // tile, tile, win)
    tp = tpt.sorted_pack(to_torch(pj), W // tile, H // tile, tile)
    return pj, jp, tp, tile


def flat_bounds(jtb, n_rows):
    """JAX's group-packed [g, p, 128] boundaries as flat [rows, p]."""
    g, p, lanes = jtb.shape
    return np.asarray(jtb).transpose(0, 2, 1).reshape(g * lanes, p)[:n_rows]


def assert_field_close(a, b, name):
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(a, b, atol=TOL_GRAD * scale, err_msg=name)


@pytest.mark.parametrize("name", list(SCENES))
def test_forward_train_plain_matches_pallas(name):
    _, jp, tp, tile = packs(name)
    out_j, tb_j = jptr.raster_forward_train(jp, W, H, tile, BG, interpret=True)
    launches = kernels.LAUNCHES["K2"]
    out_t, tb_t = ttr.raster_forward_train(tp, W, H, tile, BG)
    assert kernels.LAUNCHES["K2"] == launches       # CPU: no kernel
    out_j = np.asarray(out_j)
    for name_, rows in (("rgb", slice(0, 3)), ("depth", slice(3, 4)),
                        ("alpha", slice(4, 5))):
        np.testing.assert_allclose(out_t[:, rows].numpy(), out_j[:, rows],
                                   atol=TOL_IMG[name_], err_msg=name_)
    tb_j = flat_bounds(tb_j, tb_t.shape[0])
    tb_t = tb_t.numpy()
    np.testing.assert_array_equal(tb_t.max(1) > 0, tb_j.max(1) > 0)
    np.testing.assert_allclose(tb_t, tb_j, atol=TOL_TB)
    if name.startswith("deep"):
        _, walk = tpt.raster_forward_tiles_plain(tp, W, H, tile, BG)
        assert tpt.walk_stats(tp, walk, tile)["tiles_exited_early"] > 0
        # chunks after the exit are laid out but never started
        n_laid = int(tpt.chunk_span(tp)[3].sum())
        assert int((tb_t[:n_laid].max(1) > 0).sum()) < n_laid


@pytest.mark.parametrize("name", list(SCENES))
def test_backward_plain_matches_pallas(name):
    _, jp, tp, tile = packs(name)
    rng = np.random.default_rng(7)
    out_t, tb_t = ttr.raster_forward_train(tp, W, H, tile, BG)
    rgb, dep, acc = tpt.tiles_to_images(out_t, W, H, tile)
    cot = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
           for s in ((3, H, W), (1, H, W), (1, H, W))]
    gimg_t = ttr.images_to_tiles(ttr.grad_image(rgb, dep, acc, *cot, BG),
                                 W, H, tile)
    _, tb_j = jptr.raster_forward_train(jp, W, H, tile, BG, interpret=True)
    g_j = np.asarray(jptr._run_backward(jp, jnp.asarray(gimg_t.numpy()), tb_j,
                                        W, H, tile, BG, interpret=True))
    launches = kernels.LAUNCHES["K3"]
    g_t = ttr.run_backward(tp, gimg_t, tb_t, W, H, tile, BG).numpy()
    assert kernels.LAUNCHES["K3"] == launches
    # the same instances; the JAX package's array is longer (its slot
    # windows), and its columns past them hold no gradient
    b = int(tp.counts.sum())
    np.testing.assert_array_equal(g_j[:, b:], 0.0)
    for field, rows in FIELDS.items():
        assert_field_close(g_t[rows, :b], g_j[rows, :b], field)
    np.testing.assert_array_equal(g_t[10:], 0.0)
    np.testing.assert_array_equal(g_t[:, b:], 0.0)


def losses(proj, tgt, raster):
    rgb, dep, acc = raster(proj)
    return (((rgb - tgt) ** 2).mean() + 0.1 * dep.mean() + 0.05 * acc.mean())


@pytest.mark.parametrize("seed", [0, 2])
def test_function_grads_match_pallas_and_oracle(seed):
    pj = project_scene(n=48, seed=seed)
    tgt = np.random.default_rng(1).uniform(0, 1, (3, H, W)).astype(np.float32)
    names = ("xy", "conic", "color", "opacity", "depth")

    def loss_j(xy, conic, color, op, depth):
        p = pj._replace(xy=xy, conic=conic, color=color, opacity=op, depth=depth)
        return losses(p, jnp.asarray(tgt), lambda q: jptr.rasterize_pallas_grad(
            q, W, H, BG, interpret=True))

    args = (pj.xy, pj.conic, pj.color, pj.opacity, pj.depth)
    val_j, g_j = jax.value_and_grad(loss_j, argnums=tuple(range(5)))(*args)

    pt = to_torch(pj)
    leaves = [getattr(pt, n).clone().requires_grad_() for n in names]
    pt = pt._replace(**dict(zip(names, leaves)))
    tgt_t = torch.from_numpy(tgt)
    val_t = losses(pt, tgt_t, lambda q: ttr.rasterize_tiled_train(q, W, H, BG))
    g_t = torch.autograd.grad(val_t, leaves)
    leaves_o = [x.detach().clone().requires_grad_() for x in leaves]
    po = pt._replace(**dict(zip(names, leaves_o)))
    val_o = losses(po, tgt_t, lambda q: rasterize_reference(q, W, H, torch.ones(3)))
    g_o = torch.autograd.grad(val_o, leaves_o)

    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    for name, a, b, o in zip(names, g_t, g_j, g_o):
        assert_field_close(a.numpy(), np.asarray(b), name + " vs pallas")
        assert_field_close(a.numpy(), o.numpy(), name + " vs oracle")


def test_grads_finite_under_opaque_stack():
    """~200 stacked near-opaque splats drive prod(1 - alpha) below fp32
    range inside one chunk; the backward stays finite and matches the
    oracle (5e-4 * scale, as tests/test_pallas_raster.py holds the JAX
    tier here)."""
    n = 200
    rng = np.random.default_rng(0)
    pt = to_torch(JProj(
        xy=jnp.asarray(W / 2 + rng.normal(0, 1.5, size=(n, 2)), jnp.float32),
        depth=jnp.asarray(np.linspace(1.0, 3.0, n), jnp.float32),
        conic=jnp.tile(jnp.asarray([[0.02, 0.0, 0.02]], jnp.float32), (n, 1)),
        radius=jnp.full((n,), 20.0, jnp.float32),
        color=jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32),
        opacity=jnp.full((n,), 0.995, jnp.float32),
        valid=jnp.ones((n,), bool),
        power_cut=jnp.full((n,), -50.0, jnp.float32)))
    names = ("opacity", "color", "xy")

    def grads(raster):
        leaves = [getattr(pt, k).clone().requires_grad_() for k in names]
        rgb, _, acc = raster(pt._replace(**dict(zip(names, leaves))))
        val = rgb.mean() + 0.1 * acc.mean()
        return val, torch.autograd.grad(val, leaves)

    val, g = grads(lambda q: ttr.rasterize_tiled_train(q, W, H, BG))
    _, g_o = grads(lambda q: rasterize_reference(q, W, H, torch.ones(3)))
    assert np.isfinite(float(val))
    for name, a, o in zip(names, g, g_o):
        assert bool(torch.isfinite(a).all()), name
        scale = float(o.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy(), o.numpy(), atol=5e-4 * scale,
                                   err_msg=name)


def arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def test_render_screen_offset_grad_matches_jax():
    """The density-control statistic: d loss / d screen_offset through the
    whole render, the port's ``tiled_train`` against JAX ``pallas``."""
    cfg, mesh, params, gstate, sim, preds, cam = graft._tiny_scene()
    cam = dataclasses.replace(cam, time=0.4)
    jcam = jcamera_arrays(cam)
    cap = int(params.opacity.shape[0])
    tgt = np.random.default_rng(2).uniform(0, 1, (3, cam.height, cam.width)
                                           ).astype(np.float32)

    def loss_j(offset):
        out = jrender(jcam, cam.width, cam.height, cam.tanfovx, cam.tanfovy,
                      params, gstate, mesh, sim, preds, jnp.ones(3), 3,
                      screen_offset=offset, backend="pallas", bg_static=BG)
        return jnp.mean((out.rgb - tgt) ** 2) + 0.1 * jnp.mean(out.alpha), out.rgb

    (val_j, rgb_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.zeros((cap, 2), jnp.float32))

    offset = torch.zeros((cap, 2), requires_grad=True)
    out = trender(convert.camera_arrays(arrays(jcam), "cpu"), cam.width,
                  cam.height, cam.tanfovx, cam.tanfovy,
                  convert.gaussian_params(arrays(params), "cpu"),
                  convert.gaussian_state(arrays(gstate), "cpu"),
                  convert.mesh(arrays(mesh), "cpu"),
                  convert.simulator(arrays(sim), "cpu"),
                  torch.from_numpy(np.array(preds)), BG, 3,
                  screen_offset=offset, backend="tiled_train", device="cpu")
    val_t = ((out.rgb - torch.from_numpy(tgt)) ** 2).mean() + 0.1 * out.alpha.mean()
    (g_t,) = torch.autograd.grad(val_t, offset)
    np.testing.assert_allclose(out.rgb.detach().numpy(), np.asarray(rgb_j),
                               atol=TOL_IMG["rgb"])
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    assert float(g_t.abs().max()) > 0.0
    assert_field_close(g_t.numpy(), np.asarray(g_j), "screen_offset")


def test_wrappers_check_inputs():
    _, _, tp, tile = packs("scene16")
    out_t, tb_t = ttr.raster_forward_train(tp, W, H, tile, BG)
    gimg_t = torch.zeros(((W // tile) * (H // tile), tile * tile, ttr.GCH))
    with pytest.raises(ValueError, match="gimg_t"):
        ttr.run_backward(tp, gimg_t[:, :, :7], tb_t, W, H, tile, BG)
    with pytest.raises(ValueError, match="tbounds"):
        ttr.run_backward(tp, gimg_t, tb_t[1:], W, H, tile, BG)
    with pytest.raises(ValueError, match="contiguous"):
        ttr.run_backward(tp, gimg_t.transpose(0, 1).contiguous().transpose(0, 1),
                         tb_t, W, H, tile, BG)
    with pytest.raises(ValueError, match="tile_size"):
        ttr.raster_forward_train(tp, W, H, 8, BG)


def test_library_name_follows_shared_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` renames every kernel library, so a build made
    from the old header is never loaded; an edited source renames only its
    own library. Nothing is compiled."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "SOURCES", {k: csrc / v.name
                                             for k, v in kernels.SOURCES.items()})

    def names():
        return {k: kernels.library_path(k).name for k in kernels.SOURCES}

    def append(name, text):
        path = csrc / name
        path.write_text(path.read_text() + text)

    before = names()
    assert set(before) == {"tiled_fwd", "tiled_train", "point_front", "point_front_bwd"}
    append("composite.cuh", "\n// edited\n")
    after = names()
    assert all(after[k] != before[k] for k in before)
    append("tiled_train.cu", "\n// edited\n")
    again = names()
    assert again["tiled_fwd"] == after["tiled_fwd"]
    assert again["tiled_train"] != after["tiled_train"]


def partial_scene(width, height, n=160, seed=5):
    """Splats over a frame whose sides the tile does not divide, some of
    them centred past its right and bottom edges, so the partial tiles'
    off-frame pixels lie inside their supports."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-4, width + 6, n), rng.uniform(-4, height + 6, n)], 1)
    return to_torch(hand_proj(xy, rng.uniform(1, 5, n), 22.0,
                              conic=(1 / 30, 0.004, 1 / 40),
                              opacity=rng.uniform(0.2, 0.9, n), seed=seed))


@pytest.mark.parametrize("width,height,tile,span", [
    (70, 45, 16, (None, None)), (97, 61, 32, (None, None)),
    (70, 45, 16, (5, 4)), (97, 61, 32, (4, 3))])
def test_partial_tiles_match_brute_force_and_its_autograd(monkeypatch, width, height,
                                                          tile, span):
    """K2's and K3's plain versions on ceil(W / tile) x ceil(H / tile) tiles:
    the image, and the gradients for xy, conic, colour, opacity and depth,
    against the O(N P) composite and its autograd, which has no pixel off
    the frame. Off-frame pixels record T = 0 at every chunk, and the grad
    image gives them zero cotangents. With the span options K2-span refuses
    the frame (whole tiles only) before any walk, and K4's plain version,
    fed K2's boundaries, gives K3's gradients."""
    monkeypatch.setattr(ttr, "tile_size_for", lambda w, h: tile)
    pt = partial_scene(width, height)
    names = ("xy", "conic", "color", "opacity", "depth")
    rng = np.random.default_rng(3)
    tgt = torch.from_numpy(rng.uniform(0, 1, (3, height, width)).astype(np.float32))

    def grads(raster):
        leaves = [getattr(pt, k).clone().requires_grad_() for k in names]
        rgb, dep, acc = raster(pt._replace(**dict(zip(names, leaves))))
        val = ((rgb - tgt) ** 2).mean() + 0.1 * dep.mean() + 0.05 * acc.mean()
        return rgb, torch.autograd.grad(val, leaves)

    if span[0]:
        with pytest.raises(ValueError, match="whole tiles"):
            ttr.rasterize_tiled_train(pt, width, height, BG, "exact", *span)
    rgb, g = grads(lambda q: ttr.rasterize_tiled_train(q, width, height, BG, "exact"))
    rgb_o, g_o = grads(lambda q: rasterize_reference(q, width, height, torch.ones(3)))
    assert rgb.shape == (3, height, width)
    np.testing.assert_allclose(rgb.detach().numpy(), rgb_o.detach().numpy(),
                               atol=TOL_IMG["rgb"])
    for name, a, o in zip(names, g, g_o):
        assert float(o.abs().max()) > 0, name
        assert_field_close(a.numpy(), o.numpy(), name + " vs oracle")

    # the boundaries and cotangents of off-frame pixels are 0
    tw, th = tpt.tile_grid(width, height, tile)
    packed = tpt.sorted_pack(pt, tw, th, tile)
    out_t, tb = ttr.raster_forward_train(packed, width, height, tile, BG)
    px, py = tpt.pixel_coords(width, tile, tw * th, "cpu")
    off = ((px >= width) | (py >= height))[..., 0]
    offsets = ttr.chunk_layout(packed, tw * th)[0].long()
    n_chunks = tpt.chunk_span(packed)[3]
    for t in torch.nonzero(off.any(1)).squeeze(1).tolist():
        rows = tb[offsets[t]:offsets[t] + n_chunks[t]]
        assert rows.shape[0] > 0 and float(rows[:, off[t]].abs().max()) == 0.0
    gimg = ttr.images_to_tiles(ttr.grad_image(*tpt.tiles_to_images(out_t, width, height,
                                                                   tile),
                                              *(torch.ones(c, height, width)
                                                for c in (3, 1, 1)), BG),
                               width, height, tile)
    if span[0]:
        g3 = ttr.run_backward(packed, gimg, tb, width, height, tile, BG).numpy()
        g4 = ttr.run_backward(packed, gimg, tb, width, height, tile, BG, *span).numpy()
        for field, rows in FIELDS.items():
            assert_field_close(g4[rows], g3[rows], field + " K4 vs K3")
    assert float(gimg[off].abs().max()) == 0.0
