"""Differentiable rasterizer, the training tier: sort binning, the forward
K2 and the backward K3 behind one ``torch.autograd.Function``; counterpart
of ``cloth_splatting_tpu/ops/rasterize/pallas_train.py``.

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
backward sees exactly the instances the forward composited.
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
    plain_walk,
    sorted_pack,
    tile_and_win,
    tiles_to_images,
)

GCH = 8  # grad-image channels: g_r g_g g_b g_dep g_acc acc u_tot pad


def chunk_layout(packed: PackedTiles, n_tiles: int):
    """(offsets i32 [T], rows): tile t's boundary of its chunk ci lives at
    row offsets[t] + ci. Consecutive tiles overlap by at most one chunk, so
    ``rows`` = B_pad / 128 + T bounds the total without a device sync."""
    starts = packed.starts
    astart = (starts // CHUNK) * CHUNK
    n_chunks = (starts - astart + packed.counts + CHUNK - 1) // CHUNK
    offsets = (torch.cumsum(n_chunks, 0) - n_chunks).to(torch.int32)
    return offsets, packed.rows16.shape[1] // CHUNK + n_tiles


def raster_forward_train_plain(packed: PackedTiles, width: int, height: int,
                               tile_size: int, bg: tuple[float, float, float]):
    """Plain PyTorch version of K2: (out [T, 8, p], tbounds [rows, p], the
    walk's counters). K1's plain walk, recording the boundaries."""
    n_tiles = (width // tile_size) * (height // tile_size)
    out, walk, tbounds = plain_walk(packed, width, height, tile_size, bg,
                                    boundaries=chunk_layout(packed, n_tiles))
    return out, tbounds, walk


@functools.cache
def _launchers():
    lib = kernels.load("tiled_train")
    fwd, bwd = lib.tiled_fwd_train_launch, lib.tiled_bwd_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32, i32, ctypes.c_int64, i32, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ptr]
    fwd.argtypes = [ptr] * 6 + tail
    bwd.argtypes = [ptr] * 7 + tail
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


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
                         tile_size: int, bg: tuple[float, float, float]):
    """Composite every tile and record the chunk boundaries: (out_t
    [T, 8, p] as ``raster_forward_tiles``, tbounds [rows, p]).

    A CUDA ``packed`` launches K2 (or raises): rows of tbounds past the sum
    of the tiles' chunk counts are left unwritten, and K3 never reads them.
    A CPU one runs the plain version. ``raster_forward_train.launches``
    counts K2 launches."""
    check_packed(packed, width, height, tile_size)
    dev = _device(packed)
    if dev.type == "cpu":
        return raster_forward_train_plain(packed, width, height, tile_size, bg)[:2]
    tw = width // tile_size
    n_tiles = tw * (height // tile_size)
    p = tile_size * tile_size
    offsets, n_rows = chunk_layout(packed, n_tiles)
    out = torch.empty((n_tiles, 8, p), dtype=torch.float32, device=dev)
    tbounds = torch.empty((n_rows, p), dtype=torch.float32, device=dev)
    _launch(_launchers()[0], "tiled_fwd_train", dev, packed.starts.data_ptr(),
            packed.counts.data_ptr(), offsets.data_ptr(),
            packed.rows16.data_ptr(), out.data_ptr(), tbounds.data_ptr(),
            n_tiles, tw, packed.rows16.shape[1], tile_size, float(bg[0]),
            float(bg[1]), float(bg[2]))
    raster_forward_train.launches += 1
    return out, tbounds


raster_forward_train.launches = 0


def run_backward_plain(packed: PackedTiles, gimg_t: torch.Tensor,
                       tbounds: torch.Tensor, width: int, height: int,
                       tile_size: int, bg: tuple[float, float, float]
                       ) -> torch.Tensor:
    """Plain PyTorch version of K3: per-instance grads [16, B_pad].

    All tiles advance together over chunk index ``ci``, as the forward's
    plain walk does; a tile takes part while ``ci < n_chunks`` and its
    saved boundary at ci is not all zero (K2 started the chunk)."""
    tw, th = width // tile_size, height // tile_size
    n_tiles = tw * th
    dev = packed.rows16.device
    b_pad = packed.rows16.shape[1]
    rows3d = packed.rows16.reshape(PACK16, b_pad // CHUNK, CHUNK).permute(1, 0, 2)
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
    for ci in range(int(n_chunks.max()) if n_tiles else 0):
        cand = (ci < n_chunks).nonzero().squeeze(1)
        t_start = tbounds[offsets[cand] + ci]                         # [A, p]
        started = t_start.amax(dim=1) > 0.0
        ta, t_start = cand[started], t_start[started]
        if ta.numel() == 0:
            break
        blk = rows3d[kt[ta] + ci]                                     # [A, 16, 128]
        pos = (kt[ta] + ci)[:, None] * CHUNK + lane[None, :]
        live = (pos >= starts[ta, None]) & (pos < ends[ta, None])     # [A, 128]
        dx, dy, a_raw, alpha, dead = chunk_alpha(blk, px[ta], py[ta], live)

        incl = torch.cumprod(1.0 - alpha, dim=2)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=2)
        t_i = t_start[..., None] * excl                               # [A, p, 128]
        w = alpha * t_i
        ch4 = torch.cat([blk[:, 5:8], blk[:, 9:10]], dim=1)           # [A, 4, 128]
        u = torch.einsum("apc,acl->apl", g4[ta], ch4)
        cum = torch.cumsum(u * w, dim=2)
        s_i = (u_tot[ta] - carry[ta])[..., None] - cum
        dl_da = u * t_i + ((kk[ta][..., None] - s_i)
                           / torch.clamp_min(1.0 - alpha, 1e-3))
        dpow = torch.where(dead | (a_raw > ALPHA_MAX), torch.zeros_like(dl_da),
                           dl_da * a_raw)

        ca, cb, cc = blk[:, 2], blk[:, 3], blk[:, 4]                  # [A, 128]
        sdx = (dpow * dx).sum(1)
        sdy = (dpow * dy).sum(1)
        gblk = torch.zeros_like(blk)
        gblk[:, 0] = ca * sdx + cb * sdy
        gblk[:, 1] = cc * sdy + cb * sdx
        gblk[:, 2] = -0.5 * (dpow * dx * dx).sum(1)
        gblk[:, 3] = -(dpow * dx * dy).sum(1)
        gblk[:, 4] = -0.5 * (dpow * dy * dy).sum(1)
        cg = torch.einsum("apc,apl->acl", g4[ta], w)                  # [A, 4, 128]
        gblk[:, 5:8] = cg[:, 0:3]
        gblk[:, 8] = dpow.sum(1) / torch.clamp_min(blk[:, 8], 1e-30)
        gblk[:, 9] = cg[:, 3]
        # every live slot belongs to exactly one tile: plain assignment
        grads[:, pos[live]] = gblk.permute(1, 0, 2)[:, live]
        carry[ta] += cum[..., -1]
    return grads


def check_backward_inputs(packed: PackedTiles, gimg_t: torch.Tensor,
                          tbounds: torch.Tensor, width: int, height: int,
                          tile_size: int) -> None:
    check_packed(packed, width, height, tile_size)
    n_tiles = (width // tile_size) * (height // tile_size)
    p = tile_size * tile_size
    n_rows = chunk_layout(packed, n_tiles)[1]
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
                 tile_size: int, bg: tuple[float, float, float]
                 ) -> torch.Tensor:
    """Per-instance grads [16, B_pad] from the grad image ``gimg_t``
    [T, p, 8] and the forward's boundaries.

    A CUDA ``packed`` launches K3 (or raises); a CPU one runs the plain
    version. ``run_backward.launches`` counts K3 launches."""
    check_backward_inputs(packed, gimg_t, tbounds, width, height, tile_size)
    dev = _device(packed)
    if dev.type == "cpu":
        return run_backward_plain(packed, gimg_t, tbounds, width, height,
                                  tile_size, bg)
    tw = width // tile_size
    n_tiles = tw * (height // tile_size)
    offsets, _ = chunk_layout(packed, n_tiles)
    grads = torch.zeros((PACK16, packed.rows16.shape[1]), dtype=torch.float32,
                        device=dev)
    _launch(_launchers()[1], "tiled_bwd", dev, packed.starts.data_ptr(),
            packed.counts.data_ptr(), offsets.data_ptr(),
            packed.rows16.data_ptr(), gimg_t.data_ptr(), tbounds.data_ptr(),
            grads.data_ptr(), n_tiles, tw, packed.rows16.shape[1], tile_size,
            float(bg[0]), float(bg[1]), float(bg[2]))
    run_backward.launches += 1
    return grads


run_backward.launches = 0


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
    backward."""

    @staticmethod
    def forward(ctx, xy, depth, conic, color, opacity, valid, power_cut,
                radius, width, height, bg, pack_order):
        tile_size, win = tile_and_win(width, height)
        tw, th = width // tile_size, height // tile_size
        proj = ProjectedGaussians(xy=xy, depth=depth, conic=conic,
                                  radius=radius, color=color, opacity=opacity,
                                  valid=valid, power_cut=power_cut)
        packed = sorted_pack(proj, tw, th, tile_size, win, order=pack_order)
        out_t, tbounds = raster_forward_train(packed, width, height, tile_size,
                                              bg)
        rgb, dep, acc = tiles_to_images(out_t, width, height, tile_size)
        ctx.save_for_backward(packed.rows16, packed.starts, packed.counts,
                              packed.gauss_idx, tbounds, rgb, dep, acc)
        ctx.geometry = (width, height, tile_size, bg, xy.shape[0])
        return rgb, dep, acc

    @staticmethod
    def backward(ctx, g_rgb, g_dep, g_acc):
        rows16, starts, counts, gauss_idx, tbounds, rgb, dep, acc = \
            ctx.saved_tensors
        width, height, tile_size, bg, n = ctx.geometry
        packed = PackedTiles(rows16, starts, counts, gauss_idx, aux=None)
        gimg_t = images_to_tiles(grad_image(rgb, dep, acc, g_rgb, g_dep, g_acc,
                                            bg), width, height, tile_size)
        grads16 = run_backward(packed, gimg_t, tbounds, width, height,
                               tile_size, bg)
        per_gauss = grads16.new_zeros((n + 1, PACK16)).index_add_(
            0, gauss_idx, grads16.T)[:n]
        return (per_gauss[:, 0:2], per_gauss[:, 9], per_gauss[:, 2:5],
                per_gauss[:, 5:8], per_gauss[:, 8],
                None, None, None, None, None, None, None)


def rasterize_tiled_train(proj: ProjectedGaussians, width: int, height: int,
                          bg: tuple[float, float, float] = (1.0, 1.0, 1.0),
                          pack_order: str = "exact"):
    """Differentiable rasterization at ``tile_and_win``'s tiling: (rgb
    [3,H,W], depth [1,H,W], alpha [1,H,W]); counterpart of JAX
    ``rasterize_pallas_grad``."""
    tile_size, _ = tile_and_win(width, height)
    if width % tile_size or height % tile_size:
        raise ValueError("width/height must be multiples of tile_size")
    return _TiledTrainRaster.apply(
        proj.xy, proj.depth, proj.conic, proj.color, proj.opacity, proj.valid,
        proj.power_cut, proj.radius, width, height,
        tuple(float(c) for c in bg), pack_order)
