"""Serving rasterizer: sort-based tile binning + the per-tile compositor K1;
counterpart of ``cloth_splatting_tpu/ops/rasterize/pallas_tiled.py``.

1. ``sorted_pack`` expands each projected Gaussian into the tiles its
   screen rect covers (a static ``win x win`` slot window, with a capped
   side stream for big splats), sorts the instances by (tile, depth) with
   one stable ``torch.sort`` and packs their parameters tile-grouped and
   front-to-back as ``rows16`` [16, B_pad].
2. ``raster_forward_tiles`` composites every tile: on a CUDA tensor it
   launches K1, the hand-written kernel in ``csrc/tiled_fwd.cu``; on a CPU
   tensor it runs ``raster_forward_tiles_plain``, the same walk in plain
   PyTorch.

K1 replaces the TPU kernel ``pallas_tiled.py::_kernel`` (tile walk
``_one_tile``, per-chunk math ``_composite_chunk``). One thread block per
tile walks the tile's instances in 128-wide chunks ALIGNED to the global
sorted array (the first chunk is ``start // 128``), composites each pixel
front to back, and stops after the first chunk at which the MAX over the
tile's pixels of the transmittance T is <= 1e-4. The background term is
``bg * (1 - sum w)``; T only drives the exit. Most instance-pixel pairs a
tile walks are dead, so the kernel's time goes to finding the live ones:
each warp owns a compact patch of the tile (``patch_pixel``) and walks only
the instances whose conservative footprint box (``footprint_boxes``) meets
it; ``cull_audit`` counts what that skips, none of which may be alive. The
plain version needs neither: the skipped pairs are dead.

The span options of the JAX rasterizer, ``tiles_per_program`` and
``span_cap``, select K1-span (same source): one block owns
``tiles_per_program`` consecutive tiles and, when their chunks fit a window
of ``span_cap`` chunks, stages them once and composites every tile from
shared memory; a program that does not fit walks chunk by chunk. Which
branch a program takes never changes what it computes. ``resolve_span`` is
the one place where the options are resolved, for this kernel and for the
training tier's K2-span and K4, which run a program as clusters of one CTA
per tile with the window spread over the cluster (``cluster_shares``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    ProjectedGaussians,
)

PACK16 = 16      # param rows: x y conic(3) rgb(3) opacity depth cut pad(5)
CHUNK = 128      # instances per compositing chunk
TRANS_EPS = 1e-4
WIN_SMALL = 2    # slot window (tiles per axis) of the small-splat stream
# shared memory of one H100 block: the 227 KB opt-in limit, one chunk's 11
# used rows, and what each span kernel kept statically beside a whole window
# in one block (K4: the reduction scratch red[10][8][128]). The clamps they
# give (41, 34 for K4) stand for all three span kernels; K2-span and K4 now
# hold ceil(span_cap / cluster size) chunks a CTA.
SMEM_LIMIT = 232_448
CHUNK_BYTES = 11 * CHUNK * 4
SPAN_STATIC_BYTES = {"fwd": 0, "fwd_train": 0, "bwd": 10 * 8 * CHUNK * 4}


class RasterAux(NamedTuple):
    """Diagnostics from binning."""

    n_dropped: torch.Tensor       # instances dropped (always 0 in this tier)
    max_tile_count: torch.Tensor  # deepest per-tile list


class PackedTiles(NamedTuple):
    rows16: torch.Tensor     # [16, B_pad] f32 param-major, tile-grouped,
                             # depth-ordered along dim 1, contiguous
    starts: torch.Tensor     # [T] i32 segment starts (unaligned)
    counts: torch.Tensor     # [T] i32 segment lengths
    gauss_idx: torch.Tensor  # [B_pad] i32 source Gaussian per instance
    aux: RasterAux


def pack_rows(proj: ProjectedGaussians) -> torch.Tensor:
    """[N, 16] per-Gaussian parameter rows."""
    n = proj.xy.shape[0]
    opacity = torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))
    depth = torch.where(torch.isfinite(proj.depth), proj.depth,
                        torch.zeros_like(proj.depth))
    return torch.cat(
        [proj.xy, proj.conic, proj.color, opacity[:, None], depth[:, None],
         proj.power_cut[:, None],
         torch.zeros((n, PACK16 - 11), dtype=torch.float32, device=proj.xy.device)],
        dim=1)


def _expand_slots(xy, r, valid, depth, gidx_src, tw, th, tile_size, win):
    """Per-slot (tile_id, depth, gauss_idx) for a win x win window, flat.

    Dead slots (outside the Gaussian's span, or invalid Gaussians) get the
    sentinel tile tw*th so the sort groups them last."""
    n = xy.shape[0]
    slots = win * win
    n_tiles = tw * th
    # An invalid Gaussian's xy may be non-finite, and torch's float->int cast
    # of NaN/inf is undefined; its slots are masked dead below either way.
    zero = torch.zeros_like(r)
    x = torch.where(valid, xy[:, 0], zero)
    y = torch.where(valid, xy[:, 1], zero)
    r = torch.where(valid, r, zero)
    x0 = torch.clamp(torch.floor((x - r) / tile_size), 0, tw).to(torch.int32)
    y0 = torch.clamp(torch.floor((y - r) / tile_size), 0, th).to(torch.int32)
    x1 = torch.clamp(torch.floor((x + r) / tile_size) + 1, 0, tw).to(torch.int32)
    y1 = torch.clamp(torch.floor((y + r) / tile_size) + 1, 0, th).to(torch.int32)

    dj = torch.arange(slots, dtype=torch.int32, device=xy.device)
    tx = x0[:, None] + (dj % win)[None, :]
    ty = y0[:, None] + (dj // win)[None, :]
    in_span = (tx < x1[:, None]) & (ty < y1[:, None]) & valid[:, None]
    tile_id = torch.where(in_span, ty * tw + tx, n_tiles).reshape(-1)
    depth_c = torch.where(torch.isfinite(depth), depth,
                          torch.full_like(depth, 3.4e38))
    depth_b = depth_c[:, None].expand(n, slots).reshape(-1)
    gidx = gidx_src[:, None].expand(n, slots).reshape(-1)
    return tile_id, depth_b, gidx


def round_big_cap(n: int) -> int:
    """Static size of the big-Gaussian side stream."""
    return min(n, max(2048, n // 8))


def fused_depth_bits(n_tiles: int) -> int:
    """Bits of depth kept in the fused (tile << bits) | depth i32 sort key:
    what the tile field (values 0..n_tiles) leaves of the 31 non-sign bits."""
    return 31 - max(1, n_tiles.bit_length())


def _float_order_key(d: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) ordered like the finite float32 values ``d``, with
    -0.0 and +0.0 equal (they compare equal in the JAX package's sort)."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)   # -0.0 + 0.0 = +0.0
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + (1 << 31)


def tile_and_win(width: int, height: int) -> tuple[int, int]:
    """(tile_size, win) for a frame: 32 px tiles for frames of 512 px and
    more that 32 divides, else 16 px; ``win`` is the span in tiles that a
    MAX_SPLAT_RADIUS splat needs."""
    if width % 32 == 0 and height % 32 == 0 and min(width, height) >= 512:
        return 32, 3
    return 16, 5


def sorted_pack(proj: ProjectedGaussians, tw: int, th: int, tile_size: int,
                win: int, big_cap: int | None = None,
                order: str = "exact") -> PackedTiles:
    """Sort-based tile binning in front-to-back order.

    Gaussians whose span exceeds ``WIN_SMALL`` tiles per axis go into a side
    stream of ``big_cap`` (default ``round_big_cap(N)``) slots expanded at
    the full ``win``; the rest expand at ``WIN_SMALL``. Big Gaussians beyond the cap have their
    support shrunk to the small span (``power_cut`` scaled to match). Both
    streams share one stable sort, so compositing order stays exact.

    ``order``: 'exact' sorts by (tile, f32 depth); 'fused' by one i32 key
    ``(tile << bits) | (depth bits >> (31 - bits))`` (quantized depth).
    Instances with equal keys keep their expansion order (Gaussian index),
    as under the JAX package's stable ``lax.sort``."""
    n_tiles = tw * th
    n = proj.xy.shape[0]
    dev = proj.xy.device
    xy, r, valid, depth = proj.xy, proj.radius, proj.valid, proj.depth
    gidx_all = torch.arange(n, dtype=torch.int32, device=dev)

    if win <= WIN_SMALL:
        tile_id, depth_b, gidx = _expand_slots(
            xy, r, valid, depth, gidx_all, tw, th, tile_size, win)
        proj_adj = proj
    else:
        if big_cap is None:
            big_cap = round_big_cap(n)
        small_rmax = (WIN_SMALL - 1) * tile_size / 2.0 - 0.51
        is_big = (r > small_rmax) & valid
        score = torch.where(is_big, r, torch.full_like(r, -1.0))
        # jax.lax.top_k puts the lower index first among equal scores, and
        # integer radii tie often; torch.topk promises no tie order, so take
        # a stable descending sort instead.
        big_idx = torch.sort(score, descending=True, stable=True).indices[:big_cap]
        big_sel = score[big_idx] > 0.0
        in_big = torch.zeros(n, dtype=torch.bool, device=dev)
        in_big[big_idx] = big_sel

        shrink = is_big & ~in_big
        r_small = torch.where(shrink, torch.full_like(r, small_rmax), r)
        cut_adj = torch.where(
            shrink,
            proj.power_cut * (small_rmax / torch.clamp_min(r, 1e-6)) ** 2,
            proj.power_cut)
        proj_adj = proj._replace(power_cut=cut_adj)
        tid_s, dep_s, gid_s = _expand_slots(
            xy, r_small, valid & ~in_big, depth, gidx_all,
            tw, th, tile_size, WIN_SMALL)
        tid_b, dep_b, gid_b = _expand_slots(
            xy[big_idx], r[big_idx], big_sel & valid[big_idx], depth[big_idx],
            big_idx.to(torch.int32), tw, th, tile_size, win)
        tile_id = torch.cat([tid_s, tid_b])
        depth_b = torch.cat([dep_s, dep_b])
        gidx = torch.cat([gid_s, gid_b])

    b = tile_id.shape[0]
    bounds = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)
    if order == "fused":
        bits_d = fused_depth_bits(n_tiles)
        dbits = torch.clamp_min(depth_b, 0.0).view(torch.int32)
        # clamp_min may keep -0.0 (bit 0x80000000); mask the sign bit so -0.0
        # keys like +0.0 instead of sorting before tile 0
        key = (tile_id << bits_d) | ((dbits & 0x7FFFFFFF) >> (31 - bits_d))
        sorted_key, perm = torch.sort(key, stable=True)
        edges = torch.searchsorted(sorted_key, bounds << bits_d, right=False)
    elif order == "exact":
        key = (tile_id.to(torch.int64) << 32) | _float_order_key(depth_b)
        sorted_key, perm = torch.sort(key, stable=True)
        edges = torch.searchsorted(sorted_key, bounds.to(torch.int64) << 32,
                                   right=False)
    else:
        raise ValueError(f"unknown pack order: {order!r}")
    sorted_gidx = gidx[perm]
    edges = edges.to(torch.int32)
    starts = edges[:-1]
    counts = edges[1:] - starts

    rows_sorted = pack_rows(proj_adj)[sorted_gidx]                   # [B, 16]
    # pad to a whole number of chunks plus one, as the JAX package does
    b_pad = ((b + CHUNK - 1) // CHUNK) * CHUNK + CHUNK
    rows_sorted = torch.cat(
        [rows_sorted, rows_sorted.new_zeros((b_pad - b, PACK16))])
    sorted_gidx = torch.cat(
        [sorted_gidx, torch.full((b_pad - b,), n, dtype=torch.int32, device=dev)])
    rows16 = rows_sorted.T.contiguous()                               # [16, B_pad]

    aux = RasterAux(n_dropped=torch.zeros((), dtype=torch.int32, device=dev),
                    max_tile_count=counts.max())
    return PackedTiles(rows16, starts, counts, sorted_gidx, aux)


class PlainWalk(NamedTuple):
    """Counters of the plain compositor's walk."""

    walked: torch.Tensor        # [T] chunks walked per tile
    contributing: torch.Tensor  # [T] instance-pixel pairs with nonzero alpha


def chunk_span(packed: PackedTiles):
    """(starts, ends, first aligned chunk, aligned chunk count) per tile."""
    starts = packed.starts.to(torch.int64)
    ends = starts + packed.counts.to(torch.int64)
    kt = starts // CHUNK
    return starts, ends, kt, (ends - kt * CHUNK + CHUNK - 1) // CHUNK


def max_span_cap(kernel: str) -> int:
    """Chunks that fit one block's shared memory beside ``kernel``'s static
    use: 41 for K1-span and K2-span, 34 for K4."""
    return (SMEM_LIMIT - SPAN_STATIC_BYTES[kernel]) // CHUNK_BYTES


def resolve_span(n_tiles: int, b_pad: int, tiles_per_program: int | None,
                 span_cap: int | None, kernel: str) -> tuple[int, int]:
    """(tpp, span_cap) as the kernels take them, by the JAX rasterizer's
    rules: tpp = 1 when it is None or does not divide ``n_tiles``;
    span_cap = 0 (the default kernels K1/K2/K3) when it is None or tpp is 1;
    span_cap <= the array's chunk count. The card adds one: span_cap <=
    ``max_span_cap(kernel)``. ``kernel`` is 'fwd', 'fwd_train' or 'bwd'."""
    tpp = tiles_per_program
    if tpp is None or tpp < 1 or n_tiles % tpp:
        tpp = 1
    if span_cap is None or tpp == 1:
        return tpp, 0
    return tpp, max(0, min(int(span_cap), b_pad // CHUNK, max_span_cap(kernel)))


def span_programs(packed: PackedTiles, tpp: int, span_cap: int):
    """Per program of ``tpp`` consecutive tiles: (k0c i64 [P], the first
    chunk of its window of ``span_cap`` chunks, shifted down at the end of
    the array; fits bool [P], whether the window holds all its tiles'
    chunks). What the span kernels compute per block."""
    starts = packed.starts.to(torch.int64)
    ends = starts + packed.counts.to(torch.int64)
    k0 = starts[0::tpp] // CHUNK
    k_end = (ends[tpp - 1::tpp] + CHUNK - 1) // CHUNK
    k0c = torch.clamp_max(k0, packed.rows16.shape[1] // CHUNK - span_cap)
    return k0c, (k_end - k0c) <= span_cap


def span_cluster_size(tpp: int) -> int:
    """CTAs in a thread-block cluster of K2-span and K4 for ``tpp`` tiles a
    program: ``tpp`` up to 8 (the portable limit), else its largest divisor
    <= 8. Plain copy of ``csrc/composite.cuh::span_cluster_size``."""
    for c in range(min(tpp, 8), 1, -1):
        if tpp % c == 0:
            return c
    return 1


def window_slots(span_cap: int, c: int) -> int:
    """Chunk slots one CTA of a cluster of ``c`` holds for a window of
    ``span_cap`` chunks."""
    return -(-span_cap // c)


class ClusterShares(NamedTuple):
    """How K2-span and K4 spread a fitting program's window over a cluster
    (``csrc/composite.cuh::run_cluster_program``): cluster g holds the
    chunks [first[g], end[g]) of its own ``size`` tiles, chunk k at slot
    (k - first) // size of its CTA (k - first) % size."""

    size: int
    fits: torch.Tensor    # [n_tiles // size] bool, its program's fits
    first: torch.Tensor   # [n_tiles // size] i64
    end: torch.Tensor     # [n_tiles // size] i64, exclusive


def cluster_shares(packed: PackedTiles, tpp: int, span_cap: int) -> ClusterShares:
    """The clusters of a span launch with the resolved (``tpp``,
    ``span_cap``) and the chunks each stages when its program fits."""
    c = span_cluster_size(tpp)
    starts = packed.starts.to(torch.int64)
    ends = starts + packed.counts.to(torch.int64)
    fits = span_programs(packed, tpp, span_cap)[1].repeat_interleave(tpp // c)
    return ClusterShares(c, fits, starts[0::c] // CHUNK,
                         (ends[c - 1::c] + CHUNK - 1) // CHUNK)


def pixel_coords(width: int, tile_size: int, n_tiles: int, dev):
    """Absolute pixel coordinates (px, py), each f32 [T, p, 1]."""
    tw = width // tile_size
    tiles = torch.arange(n_tiles, device=dev)
    pidx = torch.arange(tile_size * tile_size, device=dev)
    px = ((tiles % tw) * tile_size)[:, None] + (pidx % tile_size)[None, :]
    py = ((tiles // tw) * tile_size)[:, None] + (pidx // tile_size)[None, :]
    return px.to(torch.float32)[..., None], py.to(torch.float32)[..., None]


def chunk_alpha(blk: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                live: torch.Tensor):
    """Plain version of ``csrc/composite.cuh::splat_alpha`` over chunks:
    blk [A, 16, 128], px/py [A, p, 1], live [A, 128] -> (dx, dy, a_raw,
    alpha, dead), each [A, p, 128], with alpha zero where dead. The one
    classification of K1, K2 and K3: the quadratic form in the kernels'
    order, dead where power > 0, power < cut, alpha < 1/255 or off the
    tile's segment."""
    dx = px - blk[:, None, 0, :]
    dy = py - blk[:, None, 1, :]
    ca, cb, cc = blk[:, None, 2, :], blk[:, None, 3, :], blk[:, None, 4, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    a_raw = blk[:, None, 8, :] * torch.exp(power)
    alpha = torch.clamp_max(a_raw, ALPHA_MAX)
    dead = ((power > 0.0) | (power < blk[:, None, 10, :])
            | (alpha < ALPHA_MIN) | ~live[:, None, :])
    alpha = torch.where(dead, torch.zeros_like(alpha), alpha)
    return dx, dy, a_raw, alpha, dead


def raster_forward_tiles_plain(
        packed: PackedTiles, width: int, height: int, tile_size: int,
        bg: tuple[float, float, float], tiles_per_program: int | None = None,
        span_cap: int | None = None) -> tuple[torch.Tensor, PlainWalk]:
    """Plain PyTorch version of K1 and, with the span options, of K1-span;
    the CPU path and the on-card reference: (out [T, 8, p], the walk's
    counters).

    All tiles advance together over chunk index ``ci``; a tile takes part
    while ``ci < n_chunks`` and the max of its T exceeds TRANS_EPS, exactly
    the loop condition of K1 and of the TPU kernel."""
    n_tiles = (width // tile_size) * (height // tile_size)
    span = resolve_span(n_tiles, packed.rows16.shape[1], tiles_per_program,
                        span_cap, "fwd")
    out, walk, _ = plain_walk(packed, width, height, tile_size, bg, span=span)
    return out, walk


class SpanWindows(NamedTuple):
    """The chunks the fitting programs of a span kernel stage: what
    ``chunk_rows`` reads for their tiles."""

    window: torch.Tensor   # [F, span_cap, 16, 128] one per fitting program
    slot: torch.Tensor     # [T] the tile's window, -1 for overflow programs
    k0c: torch.Tensor      # [T] first chunk of the tile's program's window


def span_windows(packed: PackedTiles, rows3d: torch.Tensor,
                 span: tuple[int, int]) -> SpanWindows | None:
    """Gathers ``rows3d[k0c : k0c + span_cap]`` per fitting program; None
    when the span is off."""
    tpp, span_cap = span
    if not span_cap:
        return None
    k0c, fits = span_programs(packed, tpp, span_cap)
    dev = rows3d.device
    window = rows3d[k0c[fits][:, None]
                    + torch.arange(span_cap, device=dev)[None, :]]
    slot = torch.where(fits, torch.cumsum(fits, 0) - 1,
                       torch.full_like(k0c, -1))
    return SpanWindows(window, slot.repeat_interleave(tpp),
                       k0c.repeat_interleave(tpp))


def chunk_rows(rows3d: torch.Tensor, windows: SpanWindows | None,
               tiles: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """[A, 16, 128] rows of global chunk ``chunk[a]`` for tile ``tiles[a]``:
    from the global array, or, for tiles of fitting span programs, from
    their program's window at slot chunk - k0c (as the span kernels read)."""
    blk = rows3d[chunk]
    if windows is not None:
        in_span = windows.slot[tiles] >= 0
        ts = tiles[in_span]
        blk[in_span] = windows.window[windows.slot[ts],
                                      chunk[in_span] - windows.k0c[ts]]
    return blk


def plain_walk(packed: PackedTiles, width: int, height: int, tile_size: int,
               bg: tuple[float, float, float],
               boundaries: tuple[torch.Tensor, int] | None = None,
               span: tuple[int, int] = (1, 0)):
    """The walk of ``raster_forward_tiles_plain``: (out, counters, tbounds).

    ``boundaries`` = (per-tile flat chunk offsets [T], number of rows) also
    records, as K2 does, every pixel's T at the start of each chunk a tile
    walks into tbounds [rows, p] at row offset + ci; rows of chunks never
    started stay zero. tbounds is None without it. ``span`` is a resolved
    (tpp, span_cap): tiles of programs that fit read their chunks from the
    program's window."""
    tw, th = width // tile_size, height // tile_size
    n_tiles = tw * th
    p = tile_size * tile_size
    dev = packed.rows16.device
    n_chunks_arr = packed.rows16.shape[1] // CHUNK
    rows3d = packed.rows16.reshape(PACK16, n_chunks_arr, CHUNK).permute(1, 0, 2)

    starts, ends, kt, n_chunks = chunk_span(packed)
    px, py = pixel_coords(width, tile_size, n_tiles, dev)            # [T, p, 1]
    lane = torch.arange(CHUNK, device=dev)
    windows = span_windows(packed, rows3d, span)

    trans = torch.ones((n_tiles, p), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_tiles, 5, p), dtype=torch.float32, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    contributing = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    tbounds = None
    if boundaries is not None:
        offsets, n_rows = boundaries
        offsets = offsets.to(torch.int64)
        tbounds = torch.zeros((n_rows, p), dtype=torch.float32, device=dev)
    for ci in range(int(n_chunks.max()) if n_tiles else 0):
        active = (ci < n_chunks) & (trans.amax(dim=1) > TRANS_EPS)
        ta = active.nonzero().squeeze(1)
        if ta.numel() == 0:
            break
        if tbounds is not None:
            tbounds[offsets[ta] + ci] = trans[ta]
        walked[ta] += 1
        blk = chunk_rows(rows3d, windows, ta, kt[ta] + ci)           # [A, 16, 128]
        pos = (kt[ta] + ci)[:, None] * CHUNK + lane[None, :]
        live = (pos >= starts[ta, None]) & (pos < ends[ta, None])    # [A, 128]
        _, _, _, alpha, dead = chunk_alpha(blk, px[ta], py[ta], live)
        contributing[ta] += (~dead).sum(dim=(1, 2))

        incl = torch.cumprod(1.0 - alpha, dim=2)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=2)
        w = alpha * excl * trans[ta, :, None]                        # [A, p, 128]
        chans = torch.cat([blk[:, 5:8], blk[:, 9:10],
                           torch.ones_like(blk[:, :1])], dim=1)      # [A, 5, 128]
        acc[ta] += torch.einsum("acl,apl->acp", chans, w)
        trans[ta] *= incl[..., -1]

    alpha_img = acc[:, 4]
    bg_t = torch.tensor(bg, dtype=torch.float32, device=dev)
    out = torch.zeros((n_tiles, 8, p), dtype=torch.float32, device=dev)
    out[:, 0:3] = acc[:, 0:3] + (1.0 - alpha_img)[:, None, :] * bg_t[None, :, None]
    out[:, 3] = acc[:, 3]
    out[:, 4] = alpha_img
    return out, PlainWalk(walked, contributing), tbounds


def walk_stats(packed: PackedTiles, walk: PlainWalk, tile_size: int) -> dict:
    """What compositing ``packed`` needs, from the counters of the plain
    version's walk: tiles whose transmittance exit fired, live instances
    walked and instance-pixel pairs (walked, and contributing a nonzero
    alpha)."""
    starts, ends, kt, n_chunks = chunk_span(packed)
    live_walked = torch.clamp(
        torch.minimum(ends, (kt + walk.walked) * CHUNK) - starts, min=0)
    return {
        "tiles": int(starts.numel()),
        "tiles_exited_early": int((walk.walked < n_chunks).sum()),
        "instances": int(packed.counts.to(torch.int64).sum()),
        "instances_walked": int(live_walked.sum()),
        "pairs_walked": int(live_walked.sum()) * tile_size * tile_size,
        "pairs_contributing": int(walk.contributing.sum()),
    }


# The warp patches and footprint culling of K1, K2 and K3
# (csrc/composite.cuh::patch_pixel, footprint_box): the same margins as
# literals there
CULL_LOG_MARGIN = 1e-3
CULL_DET_SCALE = 0.99998
CULL_WIDEN = 1.001
CULL_ABS = 1e-2
CULL_MEAN_REL = 1e-6
WARPS = 8


def patch_pixel(warp, lane, i, tile_size: int):
    """Plain copy of ``csrc/composite.cuh::patch_pixel``: the pixel (index
    y * tile_size + x in its tile) that lane ``lane`` of warp ``warp`` holds
    as its ``i``-th in K1, K2 and K3. Warps own 2 x 4 patches of
    (tile_size / 2) x (tile_size / 4) pixels, lanes 8 x 4 quads of q x q
    (q = tile_size / 16) of a patch, row-major. Takes ints or integer
    tensors."""
    q = tile_size // 16
    x = (warp & 1) * 8 * q + (lane & 7) * q + i % q
    y = (warp >> 1) * 4 * q + (lane >> 3) * q + i // q
    return y * tile_size + x


def footprint_boxes(x, y, a, b, c, op, cut) -> torch.Tensor:
    """Plain version of ``csrc/composite.cuh::footprint_box`` for tensors of
    one shape S: [4, *S] boxes (x_lo, x_hi, y_lo, y_hi) that hold every
    pixel at which ``chunk_alpha`` can find the instance alive.

    A live pair has cut <= power <= 0 and op e^power >= 1/255, so power >=
    tau = max(cut, log(1 / (255 op))); for a positive definite conic the
    offsets with power >= tau lie in |dx| <= sqrt(-2 tau c / det), |dy| <=
    sqrt(-2 tau a / det). The margins (CULL_*) cover the rounding of the
    kernel's quadratic form, of exp and log and of the box itself. A conic
    that is not positive definite, or a determinant or box that is not
    finite, gives the whole plane. Nothing on the card path calls it; the
    kernels compute their own."""
    tau = torch.fmax(cut, -torch.log(255.0 * op) - CULL_LOG_MARGIN)
    r2 = torch.where(tau >= 0.0, 0.0, -2.0 * tau)     # NaN stays NaN
    det = a * c * CULL_DET_SCALE - b * b
    rx = torch.sqrt(r2 * c / det) * CULL_WIDEN + CULL_ABS + CULL_MEAN_REL * x.abs()
    ry = torch.sqrt(r2 * a / det) * CULL_WIDEN + CULL_ABS + CULL_MEAN_REL * y.abs()
    box = torch.stack([x - rx, x + rx, y - ry, y + ry])
    inf = float("inf")
    # NaN fails every comparison, so `< inf` also tests for NaN
    ok = ((a > 0.0) & (det > 0.0) & (det < inf) & (x.abs() + rx < inf)
          & (y.abs() + ry < inf))
    whole = torch.tensor([-inf, inf, -inf, inf], dtype=box.dtype,
                         device=box.device).reshape(4, *([1] * x.dim()))
    return torch.where(ok, box, whole)


def cull_audit(packed: PackedTiles, width: int, height: int, tile_size: int,
               tbounds: torch.Tensor | None = None) -> dict:
    """What the footprint cull of K1, K2 and K3 does on ``packed``, from
    ``footprint_boxes`` and the plain classification ``chunk_alpha``: the
    pairs a warp skips that are alive (``culled_pairs_alive``, which must be
    0), the pairs the warps classify against all walked pairs (every warp
    would classify every pair without the cull), and K3's (warp, instance)
    reductions, those where a pixel of the warp sees the instance (the same
    with or without the cull when no skipped pair is alive). What the
    chunks' barriers wait for: ``slowest_warp_hits`` sums over the walked
    chunks the instances that the chunk's busiest warp walks (the warps'
    mean is pairs_classified / p), and ``heaviest_tile_hits`` is the
    largest such sum of one tile.

    Which chunks: with ``tbounds`` None every chunk of every tile, a
    superset of what K1 walks (K1 stops at the tile-wide exit); with K2's
    boundaries [rows, p] (``tiled_train.chunk_layout``'s rows) exactly the
    chunks K2 started, which are the chunks K1, K2 and K3 walk."""
    n_tiles = (width // tile_size) * (height // tile_size)
    p = tile_size * tile_size
    ppt = p // (WARPS * 32)
    dev = packed.rows16.device
    b_pad = packed.rows16.shape[1]
    rows3d = packed.rows16.reshape(PACK16, b_pad // CHUNK, CHUNK).permute(1, 0, 2)
    starts, ends, kt, n_chunks = chunk_span(packed)
    px, py = pixel_coords(width, tile_size, n_tiles, dev)
    # the tile's pixels in (warp, lane, i) order of the patch layout
    wli = torch.arange(p, device=dev)
    pix = patch_pixel(wli // (32 * ppt), (wli // ppt) % 32, wli % ppt, tile_size)

    tiles = torch.repeat_interleave(torch.arange(n_tiles, device=dev), n_chunks)
    # the tiles' first rows in the boundary buffer (chunk_layout's offsets)
    first = torch.cumsum(n_chunks, 0) - n_chunks
    ci = torch.arange(tiles.numel(), device=dev) - first[tiles]
    if tbounds is not None:
        keep = tbounds[first[tiles] + ci].amax(dim=1) > 0.0
        tiles, ci = tiles[keep], ci[keep]
    out = dict.fromkeys(("pairs_walked", "pairs_classified", "reductions",
                         "culled_pairs_alive"), 0)
    slowest = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    batch = max(1, (1 << 22) // (p * CHUNK))
    for s in range(0, tiles.numel(), batch):
        t, c = tiles[s:s + batch], ci[s:s + batch]
        a = t.numel()
        blk = rows3d[kt[t] + c]                                        # [A, 16, 128]
        pos = (kt[t] + c)[:, None] * CHUNK + lane[None, :]
        live = (pos >= starts[t, None]) & (pos < ends[t, None])       # [A, 128]
        alive = ~chunk_alpha(blk, px[t], py[t], live)[4]              # [A, p, 128]
        box = footprint_boxes(blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3],
                              blk[:, 4], blk[:, 8], blk[:, 10])       # [4, A, 128]
        wx = px[t][:, pix, 0].reshape(a, WARPS, -1)                   # [A, 8, p/8]
        wy = py[t][:, pix, 0].reshape(a, WARPS, -1)
        hit = ((box[0][:, None] <= wx.amax(2, keepdim=True))
               & (box[1][:, None] >= wx.amin(2, keepdim=True))
               & (box[2][:, None] <= wy.amax(2, keepdim=True))
               & (box[3][:, None] >= wy.amin(2, keepdim=True))
               & live[:, None])                                       # [A, 8, 128]
        alive_w = alive[:, pix].reshape(a, WARPS, -1, CHUNK)          # [A, 8, p/8, 128]
        out["pairs_walked"] += int(live.sum()) * p
        out["pairs_classified"] += int(hit.sum()) * (p // WARPS)
        out["reductions"] += int((alive_w.any(dim=2) & hit).sum())
        out["culled_pairs_alive"] += int((alive_w & ~hit[:, :, None]).sum())
        slowest.index_add_(0, t, hit.sum(2).amax(1))
    out["slowest_warp_hits"] = int(slowest.sum())
    out["heaviest_tile_hits"] = int(slowest.max()) if n_tiles else 0
    return out


def check_packed(packed: PackedTiles, width: int, height: int, tile_size: int) -> None:
    rows16, starts, counts = packed.rows16, packed.starts, packed.counts
    if tile_size not in (16, 32):
        raise ValueError(f"tile_size must be 16 or 32, got {tile_size}")
    if width % tile_size or height % tile_size:
        raise ValueError("width/height must be multiples of tile_size")
    n_tiles = (width // tile_size) * (height // tile_size)
    if rows16.dtype != torch.float32 or rows16.dim() != 2 \
            or rows16.shape[0] != PACK16 or rows16.shape[1] % CHUNK:
        raise ValueError(f"rows16 must be f32 [16, k*{CHUNK}], got "
                         f"{rows16.dtype} {tuple(rows16.shape)}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n_tiles,):
            raise ValueError(f"{name} must be i32 [{n_tiles}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("rows16", rows16), ("starts", starts), ("counts", counts)):
        if t.device != rows16.device:
            raise ValueError(f"{name} is on {t.device}, rows16 on {rows16.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _launchers():
    lib = kernels.load("tiled_fwd")
    fn, span = lib.tiled_fwd_launch, lib.tiled_fwd_span_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [ptr, ptr, ptr, ptr, i32, i32, ctypes.c_int64, i32, f32, f32, f32]
    fn.argtypes = head + [ptr]
    span.argtypes = head + [i32, i32, ptr]
    fn.restype = span.restype = ctypes.c_int
    return fn, span


def raster_forward_tiles(packed: PackedTiles, width: int, height: int,
                         tile_size: int, bg: tuple[float, float, float],
                         tiles_per_program: int | None = None,
                         span_cap: int | None = None) -> torch.Tensor:
    """Composite every tile; returns [n_tiles, 8, tile_size^2] with channels
    (r, g, b with background, depth, alpha, 0, 0, 0).

    A CUDA ``packed`` launches K1 or, when ``resolve_span`` leaves a span,
    K1-span on the current stream (or raises); a CPU one runs the plain
    version. ``raster_forward_tiles.launches`` counts K1 launches and
    ``raster_forward_tiles.span_launches`` K1-span launches."""
    check_packed(packed, width, height, tile_size)
    dev = packed.rows16.device
    if dev.type == "cpu":
        return raster_forward_tiles_plain(packed, width, height, tile_size, bg,
                                          tiles_per_program, span_cap)[0]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tw = width // tile_size
    n_tiles = tw * (height // tile_size)
    p = tile_size * tile_size
    b_pad = packed.rows16.shape[1]
    tpp, cap = resolve_span(n_tiles, b_pad, tiles_per_program, span_cap, "fwd")
    out = torch.empty((n_tiles, 8, p), dtype=torch.float32, device=dev)
    args = [packed.starts.data_ptr(), packed.counts.data_ptr(),
            packed.rows16.data_ptr(), out.data_ptr(), n_tiles, tw, b_pad,
            tile_size, float(bg[0]), float(bg[1]), float(bg[2])]
    launch = _launchers()[1 if cap else 0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*args, tpp, cap, stream) if cap else launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"tiled_fwd{'_span' if cap else ''} kernel launch "
                           f"failed: CUDA error {err}")
    if cap:
        raster_forward_tiles.span_launches += 1
    else:
        raster_forward_tiles.launches += 1
    return out


raster_forward_tiles.launches = 0
raster_forward_tiles.span_launches = 0


def tiles_to_images(out_t: torch.Tensor, width: int, height: int,
                    tile_size: int):
    """[T, 8, p] tile slabs -> (rgb [3,H,W], depth [1,H,W], alpha [1,H,W])."""
    tw, th = width // tile_size, height // tile_size

    def to_image(tiled, ch):
        flat = tiled.reshape(th, tw, ch, tile_size, tile_size)
        return flat.permute(2, 0, 3, 1, 4).reshape(ch, height, width)

    return (to_image(out_t[:, 0:3, :], 3), to_image(out_t[:, 3:4, :], 1),
            to_image(out_t[:, 4:5, :], 1))


def rasterize_tiled_fwd(proj: ProjectedGaussians, width: int, height: int,
                        bg: tuple[float, float, float] = (1.0, 1.0, 1.0),
                        pack_order: str = "exact",
                        tiles_per_program: int | None = None,
                        span_cap: int | None = None):
    """Pack + composite at ``tile_and_win``'s tiling; returns
    (rgb [3,H,W], depth [1,H,W], alpha [1,H,W], aux). ``tiles_per_program``
    and ``span_cap`` are the JAX ``rasterize_pallas``'s span options."""
    tile_size, win = tile_and_win(width, height)
    if width % tile_size or height % tile_size:
        raise ValueError("width/height must be multiples of tile_size")
    tw, th = width // tile_size, height // tile_size
    packed = sorted_pack(proj, tw, th, tile_size, win, order=pack_order)
    out_t = raster_forward_tiles(packed, width, height, tile_size, bg,
                                 tiles_per_program, span_cap)
    rgb, dep, acc = tiles_to_images(out_t, width, height, tile_size)
    return rgb, dep, acc, packed.aux
