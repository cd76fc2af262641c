"""The forward walk of K1 and K2 with warp patches and the footprint cull,
emulated on the host, on the CPU.

K1 and K2 (``csrc/composite.cuh::composite_tile_patched``) give each warp a
compact patch of the tile (``tiled_fwd.patch_pixel``) and walk only the
instances whose footprint box meets it, in ascending lane order; a lane
classifies its pixels with the one classification (``chunk_alpha``'s rule)
and then runs ``w = alpha T; sum += w c; T *= 1 - alpha`` on each, a dead
pixel selected back, with the tile-wide exit after every chunk.
``sequential_walk`` below is that walk, one instance at a time per pixel in
the kernel's order, with the cull and without it. The two must give the
same bits, outputs and boundaries: a culled instance is dead at every pixel
of its warp and a dead pixel moves nothing. The walk is held to the plain
versions ``raster_forward_tiles_plain`` / ``raster_forward_train_plain``
and to JAX ``pallas_tiled.raster_forward_tiles`` (Pallas in interpret mode)
at chip_smoke's TOL_PLAIN (1e-5): they differ only by rounding (sequential
products here, cumprod in the plain versions). Last, the forward cull audit
(``tiled_fwd.cull_audit`` over the chunks K2 starts) finds no culled pair
alive on the seeded scenes and on random packs at both tile sizes.
"""

import os
import sys

import numpy as np
import pytest
import torch

from cloth_splatting_tpu.ops.rasterize import pallas_tiled as jpt

from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W  # noqa: E402
from test_torch_k3_cull import random_proj  # noqa: E402
from test_torch_raster import to_torch  # noqa: E402
from test_torch_train_raster import SCENES  # noqa: E402

torch.set_num_threads(1)

BG = (1.0, 1.0, 1.0)
TOL_PLAIN = 1e-5


def warp_hits(blk, live, tile_ox, tile_oy, tile_size):
    """[A, WARPS, 128]: whether instance l's footprint box meets warp w's
    patch of tile a, for the live lanes (the kernel's 4 ballots)."""
    box = tpt.footprint_boxes(blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3],
                              blk[:, 4], blk[:, 8], blk[:, 10])       # [4, A, 128]
    w = torch.arange(tpt.WARPS)
    pw, ph = tile_size // 2, tile_size // 4
    x0 = tile_ox[:, None] + (w % 2)[None, :] * pw                      # [A, 8]
    y0 = tile_oy[:, None] + (w // 2)[None, :] * ph
    x0, y0 = x0.to(torch.float32)[..., None], y0.to(torch.float32)[..., None]
    return ((box[0][:, None] <= x0 + (pw - 1)) & (box[1][:, None] >= x0)
            & (box[2][:, None] <= y0 + (ph - 1)) & (box[3][:, None] >= y0)
            & live[:, None])


def sequential_walk(packed, width, height, tile_size, bg, cull: bool):
    """K1's and K2's walk in the kernel's order: (out [T, 8, p], tbounds
    [rows, p] as K2 writes them, rows past the laid chunks zero).

    Per chunk and pixel, the instances go one at a time in lane order; with
    ``cull`` a pixel takes only those whose box meets its warp's patch. A
    pixel the classification finds dead is selected back (T and sums keep
    their bits). After each chunk the tile goes on while the max of its T
    exceeds TRANS_EPS."""
    tw, th = width // tile_size, height // tile_size
    n_tiles, p = tw * th, tile_size * tile_size
    ppt = p // (tpt.WARPS * 32)
    rows3d = packed.rows16.reshape(tpt.PACK16, -1, tpt.CHUNK).permute(1, 0, 2)
    starts, ends, kt, n_chunks = tpt.chunk_span(packed)
    px, py = tpt.pixel_coords(width, tile_size, n_tiles, "cpu")
    # each pixel's warp under the patch map
    wli = torch.arange(p)
    warp_of = torch.empty(p, dtype=torch.int64)
    warp_of[tpt.patch_pixel(wli // (32 * ppt), (wli // ppt) % 32, wli % ppt,
                            tile_size)] = wli // (32 * ppt)
    offsets, n_rows = ttr.chunk_layout(packed, n_tiles)
    offsets = offsets.to(torch.int64)
    lane = torch.arange(tpt.CHUNK)

    trans = torch.ones((n_tiles, p))
    acc = torch.zeros((n_tiles, 5, p))
    tbounds = torch.zeros((n_rows, p))
    for ci in range(int(n_chunks.max())):
        ta = ((ci < n_chunks) & (trans.amax(dim=1) > tpt.TRANS_EPS)).nonzero()[:, 0]
        if ta.numel() == 0:
            break
        tbounds[offsets[ta] + ci] = trans[ta]
        blk = rows3d[kt[ta] + ci]                                       # [A, 16, 128]
        pos = (kt[ta] + ci)[:, None] * tpt.CHUNK + lane[None, :]
        live = (pos >= starts[ta, None]) & (pos < ends[ta, None])
        _, _, _, alpha, dead = tpt.chunk_alpha(blk, px[ta], py[ta], live)
        update = ~dead                                                  # [A, p, 128]
        if cull:
            hit = warp_hits(blk, live, (ta % tw) * tile_size,
                            (ta // tw) * tile_size, tile_size)          # [A, 8, 128]
            update = update & hit[:, warp_of, :]
        chans = torch.cat([blk[:, 5:8], blk[:, 9:10]], dim=1)           # [A, 4, 128]
        t, s = trans[ta], acc[ta]
        for j in range(tpt.CHUNK):
            m, a = update[:, :, j], alpha[:, :, j]
            w = a * t
            for c in range(4):
                s[:, c] = torch.where(m, s[:, c] + w * chans[:, c, j, None], s[:, c])
            s[:, 4] = torch.where(m, s[:, 4] + w, s[:, 4])
            t = torch.where(m, t * (1.0 - a), t)
        trans[ta], acc[ta] = t, s

    out = torch.zeros((n_tiles, 8, p))
    t_final = 1.0 - acc[:, 4]
    for c in range(3):
        out[:, c] = acc[:, c] + t_final * bg[c]
    out[:, 3:5] = acc[:, 3:5]
    return out, tbounds


def random_pack(tile_size):
    """Anisotropic, rotated splats with random opacities and cuts, ~10
    chunks deep per tile (the exit fires in most 16 px tiles)."""
    proj = random_proj(1500, W, H, seed=10 + tile_size)
    return tpt.sorted_pack(proj, W // tile_size, H // tile_size, tile_size,
                           5 if tile_size == 16 else 3)


def scene_pack(name):
    make, tile, win = SCENES[name]
    pj = make()
    return pj, tpt.sorted_pack(to_torch(pj), W // tile, H // tile, tile, win), tile


CASES = [*SCENES, "random16", "random32"]


def case(name):
    """(packed, width, height, tile size) of a seeded scene of
    test_torch_train_raster or a random pack."""
    if name.startswith("random"):
        ts = int(name[len("random"):])
        return random_pack(ts), W, H, ts
    _, packed, tile = scene_pack(name)
    return packed, W, H, tile


@pytest.mark.parametrize("name", CASES)
def test_culled_walk_is_bit_identical_to_the_walk_without_cull(name):
    packed, width, height, ts = case(name)
    out_c, tb_c = sequential_walk(packed, width, height, ts, BG, cull=True)
    out_n, tb_n = sequential_walk(packed, width, height, ts, BG, cull=False)
    assert torch.equal(out_c, out_n)
    assert torch.equal(tb_c, tb_n)
    assert float(out_c[:, 4].max()) > 0.5


@pytest.mark.parametrize("name", CASES)
def test_culled_walk_matches_the_plain_versions(name):
    packed, width, height, ts = case(name)
    out, tb = sequential_walk(packed, width, height, ts, BG, cull=True)
    out_1, walk = tpt.raster_forward_tiles_plain(packed, width, height, ts, BG)
    out_2, tb_2, _ = ttr.raster_forward_train_plain(packed, width, height, ts, BG)
    assert float((out - out_1).abs().max()) <= TOL_PLAIN
    assert float((out - out_2).abs().max()) <= TOL_PLAIN
    # the same chunks started, the same boundaries
    assert torch.equal(tb.amax(dim=1) > 0, tb_2.amax(dim=1) > 0)
    assert float((tb - tb_2).abs().max()) <= TOL_PLAIN
    if name.startswith("deep") or name == "random16":
        assert tpt.walk_stats(packed, walk, ts)["tiles_exited_early"] > 0


@pytest.mark.parametrize("name", ["scene16", "scene32"])
def test_culled_walk_matches_pallas(name):
    pj, packed, tile = scene_pack(name)
    jp = jpt.sorted_pack(pj, W // tile, H // tile, tile, SCENES[name][2])
    out_j = np.asarray(jpt.raster_forward_tiles(jp, W, H, tile, BG, interpret=True))
    out, _ = sequential_walk(packed, W, H, tile, BG, cull=True)
    np.testing.assert_allclose(out.numpy(), out_j, atol=TOL_PLAIN, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_forward_cull_audit_finds_no_culled_pair_alive(name):
    packed, width, height, ts = case(name)
    tb = ttr.raster_forward_train_plain(packed, width, height, ts, BG)[1]
    every = tpt.cull_audit(packed, width, height, ts)
    walked = tpt.cull_audit(packed, width, height, ts, tb)
    p = ts * ts
    for a in (every, walked):
        assert a["culled_pairs_alive"] == 0, a
        assert 0 < a["pairs_classified"] < a["pairs_walked"], a
        # the busiest warp of a chunk walks at least the warps' mean
        assert a["slowest_warp_hits"] * p >= a["pairs_classified"], a
        assert 0 < a["heaviest_tile_hits"] <= a["slowest_warp_hits"], a
    # K2's boundaries restrict the audit to the chunks the walk entered
    assert walked["pairs_walked"] <= every["pairs_walked"]
    if name.startswith("deep") or name == "random16":
        assert walked["pairs_walked"] < every["pairs_walked"]
