"""Differentiable rasterizer, the training tier: sort binning, the forward
K2 and the backward K3 (or, with the span options, K2-span and K4) behind
one ``torch.autograd.Function``; counterpart of
``cloth_splatting_tpu/ops/rasterize/pallas_train.py``.

1. ``sorted_pack`` (from ``tiled_fwd``) bins and orders the instances.
2. ``raster_forward_train`` composites every tile like K1 and also records
   each pixel's transmittance at the start of every chunk the walk enters,
   in tbounds [rows, p] (tile t's chunk ci at row ``offsets[t] + ci``, from
   ``chunk_layout``); chunks after a tile's exit get zeros.
3. ``run_backward`` walks the started chunks again in forward order and
   emits per-instance gradients [16, B_pad] (rows as ``rows16``: x, y,
   conic a/b/c, r, g, b, opacity, depth).
4. The backward reduces instances to Gaussians with ``index_add_`` into
   N + 1 rows; row N is the sentinel of padding slots and is dropped.

On a CUDA tensor the wrappers launch K2 and K3, the hand-written kernels in
``csrc/tiled_train.cu``, or raise; on a CPU tensor they run the plain
versions beside them. Gradients flow to xy, depth, conic, color and
opacity; radius, valid and power_cut gate support and take none.

The backward's suffix S_i = U_tot - prefix comes from the closed form
U_tot = sum_c g_c (out_c - bg_c T_N) + g_dep out_dep with T_N = 1 - acc
(the JAX package's forward-order sweep), and every pair is classified by
the one rule of ``tiled_fwd.chunk_alpha`` / ``csrc/composite.cuh``, so the
backward sees exactly the instances the forward composited. K3, like K2,
gives each warp a compact patch of the tile and skips the instances whose
conservative footprint box misses it (``tiled_fwd.patch_pixel``,
``footprint_boxes`` and ``cull_audit``, which counts what the cull skips).
The plain versions need neither: the skipped pairs are dead.

With ``tiles_per_program`` and ``span_cap`` (``tiled_fwd.resolve_span``)
the forward is K2-span and the backward K4, the JAX package's reverse
sweep: per tile the chunks go last to first with a per-pixel carry of the
later chunks' sum of u w, S_i = (chunk total - prefix) + carry, chunks the
forward never started are skipped, and U_tot is not read. Both launch one
CTA per tile in thread-block clusters, a program's chunks staged once
across its cluster when they fit its window (``tiled_fwd.cluster_shares``),
and walk as K2 and K3 do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import (
    ALPHA_MAX,
    ProjectedGaussians,
)
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
    CHUNK,
    PACK16,
    PackedTiles,
    check_packed,
    chunk_alpha,
    chunk_span,
    pixel_coords,
    chunk_rows,
    plain_walk,
    resolve_span,
    sorted_pack,
    span_windows,
    tile_and_win,
    tiles_to_images,
)

GCH = 8  # grad-image channels: g_r g_g g_b g_dep g_acc acc u_tot pad


def layout_rows(packed: PackedTiles, n_tiles: int) -> int:
    """Rows of the boundary buffer: consecutive tiles overlap by at most one
    chunk, so B_pad / 128 + T bounds the total without a device sync."""
    return packed.rows16.shape[1] // CHUNK + n_tiles


def chunk_layout(packed: PackedTiles, n_tiles: int):
    """(offsets i32 [T], ``layout_rows``): tile t's boundary of its chunk ci
    lives at row offsets[t] + ci."""
    starts = packed.starts
    astart = (starts // CHUNK) * CHUNK
    n_chunks = (starts - astart + packed.counts + CHUNK - 1) // CHUNK
    offsets = (torch.cumsum(n_chunks, 0) - n_chunks).to(torch.int32)
    return offsets, layout_rows(packed, n_tiles)


def raster_forward_train_plain(packed: PackedTiles, width: int, height: int,
                               tile_size: int, bg: tuple[float, float, float],
                               tiles_per_program: int | None = None,
                               span_cap: int | None = None):
    """Plain PyTorch version of K2 and, with the span options, of K2-span:
    (out [T, 8, p], tbounds [rows, p], the walk's counters). K1's plain
    walk, recording the boundaries."""
    n_tiles = (width // tile_size) * (height // tile_size)
    span = resolve_span(n_tiles, packed.rows16.shape[1], tiles_per_program,
                        span_cap, "fwd_train")
    out, walk, tbounds = plain_walk(packed, width, height, tile_size, bg,
                                    boundaries=chunk_layout(packed, n_tiles),
                                    span=span)
    return out, tbounds, walk


@functools.cache
def _launchers():
    """(K2, K3, K2-span, K4) launch functions."""
    lib = kernels.load("tiled_train")
    fwd, bwd = lib.tiled_fwd_train_launch, lib.tiled_bwd_launch
    fwd_span, bwd_rev = (lib.tiled_fwd_train_span_launch,
                         lib.tiled_bwd_reverse_launch)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geom = [i32, i32, ctypes.c_int64, i32, ctypes.c_float, ctypes.c_float,
            ctypes.c_float]
    fwd.argtypes = [ptr] * 6 + geom + [ptr]
    bwd.argtypes = [ptr] * 7 + geom + [ptr]
    fwd_span.argtypes = [ptr] * 6 + geom + [i32, i32, ptr]
    bwd_rev.argtypes = [ptr] * 7 + geom + [i32, i32, ptr]
    for fn in (fwd, bwd, fwd_span, bwd_rev):
        fn.restype = ctypes.c_int
    return fwd, bwd, fwd_span, bwd_rev


def _launch(fn, name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _device(packed: PackedTiles) -> torch.device:
    dev = packed.rows16.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def raster_forward_train(packed: PackedTiles, width: int, height: int,
                         tile_size: int, bg: tuple[float, float, float],
                         tiles_per_program: int | None = None,
                         span_cap: int | None = None):
    """Composite every tile and record the chunk boundaries: (out_t
    [T, 8, p] as ``raster_forward_tiles``, tbounds [rows, p]).

    A CUDA ``packed`` launches K2 or, when ``resolve_span`` leaves a span,
    K2-span (or raises): rows of tbounds past the sum of the tiles' chunk
    counts are left unwritten, and the backward never reads them. A CPU one
    runs the plain version. ``raster_forward_train.launches`` counts K2
    launches and ``raster_forward_train.span_launches`` K2-span launches."""
    check_packed(packed, width, height, tile_size)
    dev = _device(packed)
    if dev.type == "cpu":
        return raster_forward_train_plain(packed, width, height, tile_size, bg,
                                          tiles_per_program, span_cap)[:2]
    tw = width // tile_size
    n_tiles = tw * (height // tile_size)
    p = tile_size * tile_size
    b_pad = packed.rows16.shape[1]
    tpp, cap = resolve_span(n_tiles, b_pad, tiles_per_program, span_cap,
                            "fwd_train")
    offsets, n_rows = chunk_layout(packed, n_tiles)
    out = torch.empty((n_tiles, 8, p), dtype=torch.float32, device=dev)
    tbounds = torch.empty((n_rows, p), dtype=torch.float32, device=dev)
    args = [packed.starts.data_ptr(), packed.counts.data_ptr(),
            offsets.data_ptr(), packed.rows16.data_ptr(), out.data_ptr(),
            tbounds.data_ptr(), n_tiles, tw, b_pad, tile_size, float(bg[0]),
            float(bg[1]), float(bg[2])]
    if cap:
        _launch(_launchers()[2], "tiled_fwd_train_span", dev, *args, tpp, cap)
        raster_forward_train.span_launches += 1
    else:
        _launch(_launchers()[0], "tiled_fwd_train", dev, *args)
        raster_forward_train.launches += 1
    return out, tbounds


raster_forward_train.launches = 0
raster_forward_train.span_launches = 0


def chunk_grads_plain(blk, px, py, live, g4, kk, t_start, suffix,
                      suffix_is_remainder: bool):
    """One chunk's gradient block [A, 16, 128] and its total of u w per
    pixel [A, p], for A tiles at once: blk [A, 16, 128], px/py [A, p, 1],
    live [A, 128], g4 [A, p, 4], kk/t_start/suffix [A, p].

    With ``suffix_is_remainder`` the suffix is U_tot minus the EARLIER
    chunks' totals and S_i = suffix - prefix (K3's forward sweep); without
    it the suffix is the carry of the LATER chunks and S_i = (chunk total -
    prefix) + suffix (K4's reverse sweep)."""
    dx, dy, a_raw, alpha, dead = chunk_alpha(blk, px, py, live)
    incl = torch.cumprod(1.0 - alpha, dim=2)
    excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=2)
    t_i = t_start[..., None] * excl                                   # [A, p, 128]
    w = alpha * t_i
    ch4 = torch.cat([blk[:, 5:8], blk[:, 9:10]], dim=1)               # [A, 4, 128]
    u = torch.einsum("apc,acl->apl", g4, ch4)
    cum = torch.cumsum(u * w, dim=2)
    chunk_total = cum[..., -1]
    if suffix_is_remainder:
        s_i = suffix[..., None] - cum
    else:
        s_i = (chunk_total[..., None] - cum) + suffix[..., None]
    dl_da = u * t_i + ((kk[..., None] - s_i)
                       / torch.clamp_min(1.0 - alpha, 1e-3))
    dpow = torch.where(dead | (a_raw > ALPHA_MAX), torch.zeros_like(dl_da),
                       dl_da * a_raw)

    ca, cb, cc = blk[:, 2], blk[:, 3], blk[:, 4]                      # [A, 128]
    sdx = (dpow * dx).sum(1)
    sdy = (dpow * dy).sum(1)
    gblk = torch.zeros_like(blk)
    gblk[:, 0] = ca * sdx + cb * sdy
    gblk[:, 1] = cc * sdy + cb * sdx
    gblk[:, 2] = -0.5 * (dpow * dx * dx).sum(1)
    gblk[:, 3] = -(dpow * dx * dy).sum(1)
    gblk[:, 4] = -0.5 * (dpow * dy * dy).sum(1)
    cg = torch.einsum("apc,apl->acl", g4, w)                          # [A, 4, 128]
    gblk[:, 5:8] = cg[:, 0:3]
    gblk[:, 8] = dpow.sum(1) / torch.clamp_min(blk[:, 8], 1e-30)
    gblk[:, 9] = cg[:, 3]
    return gblk, chunk_total


def run_backward_plain(packed: PackedTiles, gimg_t: torch.Tensor,
                       tbounds: torch.Tensor, width: int, height: int,
                       tile_size: int, bg: tuple[float, float, float],
                       tiles_per_program: int | None = None,
                       span_cap: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3 and, when the span options leave a span,
    of K4: per-instance grads [16, B_pad].

    All tiles advance together over a step k. K3's sweep takes chunk ci = k:
    a tile takes part while ``ci < n_chunks`` and its saved boundary at ci
    is not all zero (K2 started the chunk). K4's sweep takes ci =
    n_chunks - 1 - k per tile, skips chunks never started, and carries the
    later chunks' totals instead of reading U_tot; tiles of programs that
    fit read their chunks from the program's window."""
    tw, th = width // tile_size, height // tile_size
    n_tiles = tw * th
    dev = packed.rows16.device
    b_pad = packed.rows16.shape[1]
    span = resolve_span(n_tiles, b_pad, tiles_per_program, span_cap, "bwd")
    reverse = span[1] > 0
    rows3d = packed.rows16.reshape(PACK16, b_pad // CHUNK, CHUNK).permute(1, 0, 2)
    windows = span_windows(packed, rows3d, span)
    starts, ends, kt, n_chunks = chunk_span(packed)
    offsets = chunk_layout(packed, n_tiles)[0].to(torch.int64)
    px, py = pixel_coords(width, tile_size, n_tiles, dev)
    lane = torch.arange(CHUNK, device=dev)

    g4 = gimg_t[..., 0:4]                                             # [T, p, 4]
    kk = ((gimg_t[..., 4] - (gimg_t[..., 0] * bg[0] + gimg_t[..., 1] * bg[1]
                             + gimg_t[..., 2] * bg[2]))
          * (1.0 - gimg_t[..., 5]))                                   # [T, p]
    u_tot = gimg_t[..., 6]
    carry = torch.zeros_like(u_tot)
    grads = torch.zeros((PACK16, b_pad), dtype=torch.float32, device=dev)
    for k in range(int(n_chunks.max()) if n_tiles else 0):
        cand = (k < n_chunks).nonzero().squeeze(1)
        ci = n_chunks[cand] - 1 - k if reverse else torch.full_like(cand, k)
        t_start = tbounds[offsets[cand] + ci]                         # [A, p]
        started = t_start.amax(dim=1) > 0.0
        ta, ci, t_start = cand[started], ci[started], t_start[started]
        if ta.numel() == 0:
            if reverse:
                continue
            break
        blk = chunk_rows(rows3d, windows, ta, kt[ta] + ci)            # [A, 16, 128]
        pos = (kt[ta] + ci)[:, None] * CHUNK + lane[None, :]
        live = (pos >= starts[ta, None]) & (pos < ends[ta, None])     # [A, 128]
        suffix = carry[ta] if reverse else u_tot[ta] - carry[ta]
        gblk, chunk_total = chunk_grads_plain(
            blk, px[ta], py[ta], live, g4[ta], kk[ta], t_start, suffix,
            suffix_is_remainder=not reverse)
        # every live slot belongs to exactly one tile: plain assignment
        grads[:, pos[live]] = gblk.permute(1, 0, 2)[:, live]
        carry[ta] += chunk_total
    return grads


def check_backward_inputs(packed: PackedTiles, gimg_t: torch.Tensor,
                          tbounds: torch.Tensor, width: int, height: int,
                          tile_size: int) -> None:
    check_packed(packed, width, height, tile_size)
    n_tiles = (width // tile_size) * (height // tile_size)
    p = tile_size * tile_size
    n_rows = layout_rows(packed, n_tiles)
    for name, t, shape in (("gimg_t", gimg_t, (n_tiles, p, GCH)),
                           ("tbounds", tbounds, (n_rows, p))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != packed.rows16.device:
            raise ValueError(f"{name} is on {t.device}, rows16 on "
                             f"{packed.rows16.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def run_backward(packed: PackedTiles, gimg_t: torch.Tensor,
                 tbounds: torch.Tensor, width: int, height: int,
                 tile_size: int, bg: tuple[float, float, float],
                 tiles_per_program: int | None = None,
                 span_cap: int | None = None) -> torch.Tensor:
    """Per-instance grads [16, B_pad] from the grad image ``gimg_t``
    [T, p, 8] and the forward's boundaries.

    A CUDA ``packed`` launches K3 or, when ``resolve_span`` leaves a span,
    K4 (or raises); a CPU one runs the plain version.
    ``run_backward.launches`` counts K3 launches and
    ``run_backward.reverse_launches`` K4 launches."""
    check_backward_inputs(packed, gimg_t, tbounds, width, height, tile_size)
    dev = _device(packed)
    if dev.type == "cpu":
        return run_backward_plain(packed, gimg_t, tbounds, width, height,
                                  tile_size, bg, tiles_per_program, span_cap)
    tw = width // tile_size
    n_tiles = tw * (height // tile_size)
    b_pad = packed.rows16.shape[1]
    tpp, cap = resolve_span(n_tiles, b_pad, tiles_per_program, span_cap, "bwd")
    offsets, _ = chunk_layout(packed, n_tiles)
    grads = torch.zeros((PACK16, b_pad), dtype=torch.float32, device=dev)
    args = [packed.starts.data_ptr(), packed.counts.data_ptr(),
            offsets.data_ptr(), packed.rows16.data_ptr(), gimg_t.data_ptr(),
            tbounds.data_ptr(), grads.data_ptr(), n_tiles, tw, b_pad,
            tile_size, float(bg[0]), float(bg[1]), float(bg[2])]
    if cap:
        _launch(_launchers()[3], "tiled_bwd_reverse", dev, *args, tpp, cap)
        run_backward.reverse_launches += 1
    else:
        _launch(_launchers()[1], "tiled_bwd", dev, *args)
        run_backward.launches += 1
    return grads


run_backward.launches = 0
run_backward.reverse_launches = 0


def images_to_tiles(img: torch.Tensor, width: int, height: int,
                    tile_size: int) -> torch.Tensor:
    """[C, H, W] -> [n_tiles, p, C] (pixel-major per tile), contiguous."""
    c = img.shape[0]
    tw, th = width // tile_size, height // tile_size
    t = img.reshape(c, th, tile_size, tw, tile_size)
    return t.permute(1, 3, 2, 4, 0).reshape(th * tw, tile_size * tile_size,
                                            c).contiguous()


def grad_image(rgb, dep, acc, g_rgb, g_dep, g_acc,
               bg: tuple[float, float, float]) -> torch.Tensor:
    """The backward's per-pixel inputs [8, H, W]: g_r g_g g_b g_dep g_acc,
    acc, U_tot = sum_i u_i w_i in closed form from the forward outputs
    (out_c = sum_i c_i alpha_i T_i + bg_c T_N, T_N = 1 - acc), and 0."""
    t_fin = 1.0 - acc
    u_tot = (g_rgb[0:1] * (rgb[0:1] - bg[0] * t_fin)
             + g_rgb[1:2] * (rgb[1:2] - bg[1] * t_fin)
             + g_rgb[2:3] * (rgb[2:3] - bg[2] * t_fin)
             + g_dep * dep)
    return torch.cat([g_rgb, g_dep, g_acc, acc, u_tot, torch.zeros_like(acc)])


class _TiledTrainRaster(torch.autograd.Function):
    """(xy, depth, conic, color, opacity, valid, power_cut, radius) ->
    (rgb [3,H,W], depth [1,H,W], alpha [1,H,W]) through K2, with K3 as its
    backward; with span options, through K2-span and K4."""

    @staticmethod
    def forward(ctx, xy, depth, conic, color, opacity, valid, power_cut,
                radius, width, height, bg, pack_order, tiles_per_program,
                span_cap):
        tile_size, win = tile_and_win(width, height)
        tw, th = width // tile_size, height // tile_size
        proj = ProjectedGaussians(xy=xy, depth=depth, conic=conic,
                                  radius=radius, color=color, opacity=opacity,
                                  valid=valid, power_cut=power_cut)
        packed = sorted_pack(proj, tw, th, tile_size, win, order=pack_order)
        out_t, tbounds = raster_forward_train(packed, width, height, tile_size,
                                              bg, tiles_per_program, span_cap)
        rgb, dep, acc = tiles_to_images(out_t, width, height, tile_size)
        ctx.save_for_backward(packed.rows16, packed.starts, packed.counts,
                              packed.gauss_idx, tbounds, rgb, dep, acc)
        ctx.geometry = (width, height, tile_size, bg, xy.shape[0],
                        tiles_per_program, span_cap)
        return rgb, dep, acc

    @staticmethod
    def backward(ctx, g_rgb, g_dep, g_acc):
        rows16, starts, counts, gauss_idx, tbounds, rgb, dep, acc = \
            ctx.saved_tensors
        width, height, tile_size, bg, n, tiles_per_program, span_cap = \
            ctx.geometry
        packed = PackedTiles(rows16, starts, counts, gauss_idx, aux=None)
        gimg_t = images_to_tiles(grad_image(rgb, dep, acc, g_rgb, g_dep, g_acc,
                                            bg), width, height, tile_size)
        grads16 = run_backward(packed, gimg_t, tbounds, width, height,
                               tile_size, bg, tiles_per_program, span_cap)
        per_gauss = grads16.new_zeros((n + 1, PACK16)).index_add_(
            0, gauss_idx, grads16.T)[:n]
        return (per_gauss[:, 0:2], per_gauss[:, 9], per_gauss[:, 2:5],
                per_gauss[:, 5:8], per_gauss[:, 8],
                None, None, None, None, None, None, None, None, None)


def rasterize_tiled_train(proj: ProjectedGaussians, width: int, height: int,
                          bg: tuple[float, float, float] = (1.0, 1.0, 1.0),
                          pack_order: str = "exact",
                          tiles_per_program: int | None = None,
                          span_cap: int | None = None):
    """Differentiable rasterization at ``tile_and_win``'s tiling: (rgb
    [3,H,W], depth [1,H,W], alpha [1,H,W]); counterpart of JAX
    ``rasterize_pallas_grad``, span options included."""
    tile_size, _ = tile_and_win(width, height)
    if width % tile_size or height % tile_size:
        raise ValueError("width/height must be multiples of tile_size")
    return _TiledTrainRaster.apply(
        proj.xy, proj.depth, proj.conic, proj.color, proj.opacity, proj.valid,
        proj.power_cut, proj.radius, width, height,
        tuple(float(c) for c in bg), pack_order, tiles_per_program, span_cap)
