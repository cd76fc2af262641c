"""PyTorch port vs the JAX package: the span options of the rasterizer
(``tiles_per_program``, ``span_cap``) on the CPU.

The port's plain versions of K1-span, K2-span and K4 (what the wrappers run
on CPU tensors) are held to JAX Pallas in interpret mode with the same
options, and to the port's own default path. 64x64 scenes from
``test_rasterize.project_scene`` at 16 px tiles (16 tiles), as
tests/test_pallas_raster.py::TestSpanPath; ``(2, 1)`` forces most programs
onto the overflow walk and the last program onto the shifted window.
Tolerances:
  - forward against JAX: 3e-4 rgb/alpha, 3e-3 depth
    (tests/test_pallas_raster.py); port span against port default: 1e-6 (the
    same chunks in the same order, read from another place); K2-span's
    boundaries equal to K2's;
  - gradients, against JAX's reverse-sweep kernel and against the port's
    forward-order sweep: 2e-4 times each field's largest magnitude (the
    two sweeps sum the occlusion suffix in another order).
The kernels themselves run only on a CUDA card, where chip_smoke.py holds
them against these plain versions.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.ops.rasterize import pallas_tiled as jpt
from cloth_splatting_tpu.ops.rasterize import pallas_train as jptr

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_raster import hand_proj, to_torch  # noqa: E402

torch.set_num_threads(1)

TOL_IMG = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}
TOL_SELF = 1e-6
TOL_GRAD = 2e-4          # times the field's largest magnitude
BG = (1.0, 1.0, 1.0)
TILE, WIN = 16, 5
N_TILES = (W // TILE) * (H // TILE)
FIELDS = {"xy": slice(0, 2), "conic": slice(2, 5), "color": slice(5, 8),
          "opacity": slice(8, 9), "depth": slice(9, 10)}
SPANS = [(4, 8), (8, 16), (2, 1)]


def opaque_scene(seed=4):
    """Hundreds of overlapping splats per tile: the exit fires mid-list, so
    the reverse sweep meets chunks that were never started."""
    rng = np.random.default_rng(seed)
    n = 1500
    return hand_proj(rng.uniform(0, 64, (n, 2)), rng.uniform(1, 5, n), 24.0,
                     conic=(1 / 64, 0.0, 1 / 64),
                     opacity=rng.uniform(0.2, 0.6, n), seed=seed)


SCENES = {
    "sparse": lambda: project_scene(n=250, seed=6),
    # many tiles sharing boundary chunks (tests/test_pallas_raster.py:514)
    "dense": lambda: project_scene(n=600, seed=9),
    "opaque": opaque_scene,
}


def packs(pj):
    jp = jpt.sorted_pack(pj, W // TILE, H // TILE, TILE, WIN)
    tp = tpt.sorted_pack(to_torch(pj), W // TILE, H // TILE, TILE)
    return jp, tp


def assert_field_close(a, b, name):
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(a, b, atol=TOL_GRAD * scale, err_msg=name)


@pytest.mark.parametrize("tpp,span_cap", SPANS)
def test_span_forward_matches_pallas(tpp, span_cap):
    pj = project_scene(n=300, seed=3)
    out_j = jpt.rasterize_pallas(pj, W, H, BG, tile_size=TILE, win=WIN,
                                 interpret=True, tiles_per_program=tpp,
                                 span_cap=span_cap)
    pt = to_torch(pj)
    launches = (kernels.LAUNCHES["K1"], kernels.LAUNCHES["K1-span"])
    out_t = tpt.rasterize_tiled_fwd(pt, W, H, BG, tiles_per_program=tpp,
                                    span_cap=span_cap)
    assert launches == (kernels.LAUNCHES["K1"],
                        kernels.LAUNCHES["K1-span"])      # CPU: no kernel
    base = tpt.rasterize_tiled_fwd(pt, W, H, BG)
    for name, a, b, c in zip(("rgb", "depth", "alpha"), out_t, out_j, base):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_IMG[name],
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=TOL_SELF,
                                   err_msg=name + " vs default")


@pytest.mark.parametrize("tpp,span_cap", SPANS)
def test_span_takes_both_branches_and_keeps_boundaries(tpp, span_cap):
    """Both branches are taken, K2-span's boundaries are K2's, and a tile's
    first chunk sits at slot kt - k0c of its program's window."""
    _, tp = packs(project_scene(n=300, seed=3))
    cap = tpt.resolve_span(N_TILES, tp.rows16.shape[1], tpp, span_cap, "fwd")[1]
    k0c, fits = tpt.span_programs(tp, tpp, cap)
    assert fits.shape == (N_TILES // tpp,)
    if (tpp, span_cap) == (2, 1):
        assert bool(fits.any()) and not bool(fits.all())
    else:
        assert bool(fits.all())
    out_s, tb_s, _ = ttr.raster_forward_train_plain(tp, W, H, TILE, BG, tpp,
                                                    span_cap)
    out_d, tb_d, _ = ttr.raster_forward_train_plain(tp, W, H, TILE, BG)
    np.testing.assert_allclose(out_s.numpy(), out_d.numpy(), atol=TOL_SELF)
    np.testing.assert_array_equal(tb_s.numpy(), tb_d.numpy())
    rows3d = tp.rows16.reshape(tpt.PACK16, -1, tpt.CHUNK).permute(1, 0, 2)
    win = tpt.span_windows(tp, rows3d, (tpp, cap))
    tiles = torch.arange(N_TILES)
    kt = tpt.chunk_span(tp)[2]
    has = (tpt.chunk_span(tp)[3] > 0) & (win.slot >= 0)
    np.testing.assert_array_equal(
        tpt.chunk_rows(rows3d, win, tiles[has], kt[has]).numpy(),
        rows3d[kt[has]].numpy())


def test_span_window_shifted_at_array_end():
    """A pack cut to the chunks its tiles use: the window of every program
    that starts near the end is shifted down (k0c < k0), so a chunk's slot
    is kt - k0c and not kt - k0. Both packages composite the cut pack."""
    jp, tp = packs(project_scene(n=300, seed=3))
    n_arr = int(-(-(int(tp.starts[-1]) + int(tp.counts[-1])) // tpt.CHUNK))
    jp = jp._replace(rows16=jp.rows16[:, :n_arr * tpt.CHUNK],
                     gauss_idx=jp.gauss_idx[:n_arr * tpt.CHUNK])
    tp = tp._replace(rows16=tp.rows16[:, :n_arr * tpt.CHUNK].contiguous(),
                     gauss_idx=tp.gauss_idx[:n_arr * tpt.CHUNK])
    tpp, span_cap = 4, 2
    k0c, fits = tpt.span_programs(tp, tpp, span_cap)
    k0 = tp.starts.long()[0::tpp] // tpt.CHUNK
    assert bool((k0c < k0).any()) and bool(fits.any()) and not bool(fits.all())
    out_j = np.asarray(jpt.raster_forward_tiles(
        jp, W, H, TILE, BG, interpret=True, tiles_per_program=tpp,
        span_cap=span_cap))
    out_t = tpt.raster_forward_tiles(tp, W, H, TILE, BG, tpp, span_cap).numpy()
    out_d = tpt.raster_forward_tiles(tp, W, H, TILE, BG).numpy()
    for name, rows in (("rgb", slice(0, 3)), ("depth", slice(3, 4)),
                       ("alpha", slice(4, 5))):
        np.testing.assert_allclose(out_t[:, rows], out_j[:, rows],
                                   atol=TOL_IMG[name], err_msg=name)
    np.testing.assert_allclose(out_t, out_d, atol=TOL_SELF)
    gimg_t, tb_t = tile_cotangent(tp)
    g_s = ttr.run_backward(tp, gimg_t, tb_t, W, H, TILE, BG, tpp, span_cap).numpy()
    g_d = ttr.run_backward(tp, gimg_t, tb_t, W, H, TILE, BG).numpy()
    for field, rows in FIELDS.items():
        assert_field_close(g_s[rows], g_d[rows], field)


def tile_cotangent(tp, seed=7):
    rng = np.random.default_rng(seed)
    out_t, tb_t = ttr.raster_forward_train(tp, W, H, TILE, BG)
    rgb, dep, acc = tpt.tiles_to_images(out_t, W, H, TILE)
    cot = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
           for s in ((3, H, W), (1, H, W), (1, H, W))]
    return ttr.images_to_tiles(ttr.grad_image(rgb, dep, acc, *cot, BG),
                               W, H, TILE), tb_t


@pytest.mark.parametrize("scene,tpp,span_cap,against_jax",
                         [("sparse", 2, 1, True), ("dense", 4, 8, False),
                          ("opaque", 4, 8, True)])
def test_reverse_sweep_matches_pallas_and_forward_order(scene, tpp, span_cap,
                                                        against_jax):
    """K4's plain version against the port's K3 plain version and (each
    JAX kernel in interpret mode costs ~15 s to trace, so not for every
    scene) against JAX's reverse-sweep kernel with the same options."""
    jp, tp = packs(SCENES[scene]())
    gimg_t, tb_t = tile_cotangent(tp)
    launches = (kernels.LAUNCHES["K3"], kernels.LAUNCHES["K4"])
    g_t = ttr.run_backward(tp, gimg_t, tb_t, W, H, TILE, BG, tpp, span_cap).numpy()
    assert launches == (kernels.LAUNCHES["K3"], kernels.LAUNCHES["K4"])
    g_k3 = ttr.run_backward(tp, gimg_t, tb_t, W, H, TILE, BG).numpy()
    for field, rows in FIELDS.items():
        assert_field_close(g_t[rows], g_k3[rows], field + " vs forward order")
    np.testing.assert_array_equal(g_t[10:], 0.0)
    if against_jax:
        _, tb_j = jptr.raster_forward_train(
            jp, W, H, TILE, BG, interpret=True, tiles_per_program=tpp,
            span_cap=span_cap)
        g_j = np.asarray(jptr._run_backward(
            jp, jnp.asarray(gimg_t.numpy()), tb_j, W, H, TILE, BG,
            interpret=True, tiles_per_program=tpp, span_cap=span_cap))
        # the same instances; the JAX package's array is longer (its slot
        # windows), and its columns past them hold no gradient
        b = int(tp.counts.sum())
        np.testing.assert_array_equal(g_j[:, b:], 0.0)
        for field, rows in FIELDS.items():
            assert_field_close(g_t[rows, :b], g_j[rows, :b], field + " vs pallas")
    if scene == "opaque":
        n_laid = int(tpt.chunk_span(tp)[3].sum())
        assert int((tb_t[:n_laid].amax(1) > 0).sum()) < n_laid   # some skipped
        # the slots of chunks never started keep zeros in both sweeps
        np.testing.assert_array_equal(g_t == 0.0, g_k3 == 0.0)


def test_reverse_sweep_ignores_u_tot():
    """K4 sums the suffix itself; K3 reads the closed-form U_tot."""
    _, tp = packs(SCENES["sparse"]())
    gimg_t, tb_t = tile_cotangent(tp)
    wrong = gimg_t.clone()
    wrong[..., 6] = 123.0
    np.testing.assert_array_equal(
        ttr.run_backward(tp, wrong, tb_t, W, H, TILE, BG, 4, 8).numpy(),
        ttr.run_backward(tp, gimg_t, tb_t, W, H, TILE, BG, 4, 8).numpy())
    assert not np.array_equal(
        ttr.run_backward(tp, wrong, tb_t, W, H, TILE, BG).numpy(),
        ttr.run_backward(tp, gimg_t, tb_t, W, H, TILE, BG).numpy())


def test_span_function_grads_match_pallas():
    """The autograd Function with span options (K2-span forward, K4
    backward) against JAX ``rasterize_pallas_grad`` with the same options
    and against the port's default path."""
    pj = project_scene(n=250, seed=6)
    names = ("xy", "conic", "color", "opacity")

    def loss_j(xy, conic, color, op):
        p = pj._replace(xy=xy, conic=conic, color=color, opacity=op)
        rgb, dep, acc = jptr.rasterize_pallas_grad(
            p, W, H, BG, tile_size=TILE, win=WIN, interpret=True,
            tiles_per_program=2, span_cap=1)
        return rgb.mean() + 0.3 * dep.mean() + 0.1 * acc.mean()

    val_j, g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3))(
        pj.xy, pj.conic, pj.color, pj.opacity)

    def grads_t(tpp, span_cap):
        pt = to_torch(pj)
        leaves = [getattr(pt, n).clone().requires_grad_() for n in names]
        rgb, dep, acc = ttr.rasterize_tiled_train(
            pt._replace(**dict(zip(names, leaves))), W, H, BG,
            tiles_per_program=tpp, span_cap=span_cap)
        val = rgb.mean() + 0.3 * dep.mean() + 0.1 * acc.mean()
        return val, torch.autograd.grad(val, leaves)

    val_s, g_s = grads_t(2, 1)
    val_d, g_d = grads_t(None, None)
    np.testing.assert_allclose(float(val_s.detach()), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(float(val_s.detach()), float(val_d.detach()),
                               rtol=1e-6)
    for name, a, b, d in zip(names, g_s, g_j, g_d):
        assert_field_close(a.numpy(), np.asarray(b), name + " vs pallas")
        assert_field_close(a.numpy(), d.numpy(), name + " vs default")


@pytest.mark.parametrize("n_tiles,b_pad,tpp,span_cap,kernel,expected", [
    (625, 128 * 500, 4, 96, "fwd", (1, 0)),        # tpp does not divide T
    (625, 128 * 500, 5, None, "fwd", (5, 0)),      # no span asked for
    (625, 128 * 500, None, 8, "fwd", (1, 0)),      # no tpp: span off
    (16, 128 * 6, 4, 8, "fwd", (4, 6)),            # span_cap > chunks
    # clusters of 5: a fifth of the window a CTA, so 96 chunks fit
    (625, 128 * 500, 5, 96, "fwd", (5, 96)),
    (625, 128 * 500, 5, 96, "fwd_train", (5, 96)),
    (625, 128 * 500, 5, 96, "bwd", (5, 96)),
    (2500, 128 * 500, 4, 24, "bwd", (4, 24)),
    (16, 128 * 6, 2, 0, "bwd", (2, 0)),
    # the shared-memory clamp: 5 CTAs of 39 chunks (32 for K4, beside
    # red[10][8][128])
    (625, 128 * 500, 5, 400, "fwd", (5, 195)),
    (625, 128 * 500, 5, 400, "fwd_train", (5, 195)),
    (625, 128 * 500, 5, 400, "bwd", (5, 160)),
    # tpp 11 runs clusters of one CTA, which holds the whole window
    (121, 128 * 500, 11, 96, "fwd", (11, 39)),
    (121, 128 * 500, 11, 96, "fwd_train", (11, 39)),
    (121, 128 * 500, 11, 96, "bwd", (11, 32)),
])
def test_resolve_span(n_tiles, b_pad, tpp, span_cap, kernel, expected):
    assert tpt.resolve_span(n_tiles, b_pad, tpp, span_cap, kernel) == expected


def test_span_window_fits_shared_memory():
    """Per CTA: at the clamp, a CTA's share of the window beside its static
    shared memory fits a block's, and one slot more would not."""
    for kernel in ("fwd", "fwd_train", "bwd"):
        for tpp in range(2, 17):
            cap = tpt.max_span_cap(kernel, tpp)
            c = tpt.span_cluster_size(tpp)
            used = (tpt.window_slots(cap, c) * tpt.CHUNK_BYTES
                    + tpt.SPAN_STATIC_BYTES[kernel])
            assert used <= tpt.SMEM_LIMIT < used + tpt.CHUNK_BYTES, (kernel, tpp)
