"""K1-span's cluster walk, emulated on the host, on the CPU.

K1-span (``csrc/tiled_fwd.cu::tiled_fwd_span_kernel``) runs a program of
``tpp`` consecutive tiles as thread-block clusters of
c = ``span_cluster_size(tpp)`` CTAs, one a tile
(``composite.cuh::run_cluster_program``). When the program fits its window
of ``span_cap`` chunks, CTA r of a cluster stages the chunks a + r + q c of
the cluster's run at its slots q (``stage_window_share``), and each CTA
copies every chunk its tile walks from slot rel // c of CTA rel % c, rel =
k - a (``WindowStage``); a program that does not fit stages each chunk from
rows16, as K1 does. The CTA's tile then takes K1's walk
(``composite_tile_patched``: warp patches, the footprint cull, the
tile-wide exit).

``cluster_walk`` below stages the slots from the pack as
``test_torch_k4_cull.cluster_window`` splits them, copies each chunk a tile
walks out of its owner's slot, and walks it with
``test_torch_fwd_cull.sequential_walk`` (the patched, culled walk in the
kernel's order). It must give K1's emulated walk bit for bit, which is what
chip_smoke holds K1-span to on the card; the plain span version
``raster_forward_tiles_plain`` within chip_smoke's TOL_PLAIN (1e-5:
sequential products against cumprod); and, on the 64x64 shape that
``tests/test_torch_span.py`` traces, JAX ``pallas_tiled`` with the same
span options (Pallas in interpret mode) within TOL_IMG (3e-4 rgb/alpha,
3e-3 depth).
"""

import os
import sys

import numpy as np
import pytest
import torch

from cloth_splatting_tpu.ops.rasterize import pallas_tiled as jpt

from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_fwd_cull import sequential_walk  # noqa: E402
from test_torch_k4_cull import cluster_window, wide121_pack  # noqa: E402
from test_torch_raster import to_torch  # noqa: E402

torch.set_num_threads(1)

BG = (1.0, 1.0, 1.0)
TOL_PLAIN = 1e-5
TOL_IMG = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}
CHANNELS = {"rgb": slice(0, 3), "depth": slice(3, 4), "alpha": slice(4, 5)}
TILE, WIN = 16, 5


def scene():
    """test_torch_span's 64x64 scene at 16 px tiles (16 tiles): JAX and
    port packs."""
    pj = project_scene(n=300, seed=3)
    return (pj, tpt.sorted_pack(to_torch(pj), W // TILE, H // TILE, TILE),
            W, H)


def wide():
    """121 tiles at 176x176: tpp 11 runs clusters of one CTA."""
    return None, wide121_pack(), 176, 176


def cluster_walk(packed, width, height, span):
    """K1-span's walk with the resolved ``span``: (out [T, 8, p], chunks a
    tile read from its cluster's window). Tiles of fitting programs read
    each chunk from the slots their cluster staged."""
    tpp, cap = span
    rows3d = packed.rows16.reshape(tpt.PACK16, -1, tpt.CHUNK).permute(1, 0, 2)
    shares, held = cluster_window(packed, tpp, cap)
    c = shares.size
    for (_, rank, q) in held:
        assert rank < c and q < tpt.window_slots(cap, c)
    slots = {key: rows3d[k].clone() for key, k in held.items()}
    from_window = [0]

    def rows_of(tiles, chunks):
        blk = rows3d[chunks].clone()
        for i, (t, k) in enumerate(zip(tiles.tolist(), chunks.tolist())):
            g = t // c
            if bool(shares.fits[g]):
                rel = k - int(shares.first[g])
                blk[i] = slots[(g, rel % c, rel // c)]
                from_window[0] += 1
        return blk

    out, _ = sequential_walk(packed, width, height, TILE, BG, cull=True,
                             rows_of=rows_of)
    return out, from_window[0]


@pytest.mark.parametrize("name,tpp,span_cap,resolved,against_jax", [
    ("scene", 2, 12, (2, 8), False),       # the pack's 8 chunks bound the window
    ("scene", 4, 8, (4, 8), True),
    ("scene", 16, 41, (16, 8), False),     # clusters of 8, two a program
    ("scene", 2, 1, (2, 1), True),         # most programs do not fit
    ("wide", 11, 96, (11, 39), False),     # clusters of one CTA
])
def test_cluster_walk_gives_k1_bits(name, tpp, span_cap, resolved, against_jax):
    pj, packed, width, height = {"scene": scene, "wide": wide}[name]()
    n_tiles = packed.starts.numel()
    span = tpt.resolve_span(n_tiles, packed.rows16.shape[1], tpp, span_cap, "fwd")
    assert span == resolved
    c = tpt.span_cluster_size(span[0])
    assert (tpt.window_slots(span[1], c) * tpt.CHUNK_BYTES
            + tpt.SPAN_STATIC_BYTES["fwd"]) <= tpt.SMEM_LIMIT
    fits = tpt.span_programs(packed, *span)[1]
    assert bool(fits.any())
    if span == (2, 1):
        assert not bool(fits.all())

    out, from_window = cluster_walk(packed, width, height, span)
    out_k1, _ = sequential_walk(packed, width, height, TILE, BG, cull=True)
    assert torch.equal(out, out_k1)
    assert float(out[:, 4].max()) > 0.5

    out_p, walk = tpt.raster_forward_tiles_plain(packed, width, height, TILE,
                                                 BG, tpp, span_cap)
    assert float((out - out_p).abs().max()) <= TOL_PLAIN
    # every chunk a tile of a fitting program walks came from the window
    in_window = walk.walked[fits.repeat_interleave(span[0])]
    assert from_window == int(in_window.sum()) > 0
    if against_jax:
        jp = jpt.sorted_pack(pj, W // TILE, H // TILE, TILE, WIN)
        out_j = np.asarray(jpt.raster_forward_tiles(
            jp, W, H, TILE, BG, interpret=True, tiles_per_program=tpp,
            span_cap=span_cap))
        for ch, rows in CHANNELS.items():
            np.testing.assert_allclose(out[:, rows].numpy(), out_j[:, rows],
                                       atol=TOL_IMG[ch], rtol=0, err_msg=ch)
