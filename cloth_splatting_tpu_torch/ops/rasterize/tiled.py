"""The dense tile rasterizer (the JAX package's XLA tier); counterpart of
``cloth_splatting_tpu/ops/rasterize/tiled.py``.

Plain PyTorch, differentiable by autograd, on the CPU or the card alike: the
JAX tier reaches no Pallas kernel, so this one has none either.

  1. Depth order from a quantized stable rank (``ops/sort.py``, 4096 depth
     buckets).
  2. Each depth-ordered Gaussian owns a static ``win x win`` window of
     candidate tile slots over its screen rect (the projection caps the
     radius, so the rect always fits).
  3. A stable rank of the instances' tile ids gives each instance its place
     in its tile's front-to-back list; one scatter fills a dense
     [tiles, k_cap, 12] grid. Instances past ``k_cap`` in a tile are
     dropped and counted (``RasterAux.n_dropped``); the scatter writes each
     of them to a trash row of its own past the grid, sliced off, so its
     gradient is the gather of the kept rows.
  4. Front-to-back alpha compositing over chunks of ``k_chunk`` list
     entries, each chunk under ``torch.utils.checkpoint``, so the backward
     holds one chunk's intermediates at a time.

Alpha clamp 0.99, 1/255 floor, the per-Gaussian support cut ``power_cut``;
returns (rgb [3, H, W], depth [1, H, W], alpha [1, H, W], RasterAux).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from cloth_splatting_tpu_torch.ops.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    MAX_SPLAT_RADIUS,
    ProjectedGaussians,
)
from cloth_splatting_tpu_torch.ops.sort import (
    counting_rank,
    quantize_depth,
    rank_permutation,
)

DEPTH_BUCKETS = 4096
PACK = 12  # xy(2) conic(3) rgb(3) opacity(1) depth(1) cut(1) pad(1)


class RasterAux(NamedTuple):
    """Binning diagnostics (not differentiated)."""

    n_dropped: torch.Tensor       # instances beyond a tile's capacity
    max_tile_count: torch.Tensor  # the deepest tile's list length


class TileBins(NamedTuple):
    dense: torch.Tensor   # [n_tiles, k_cap, PACK] (an empty slot: opacity 0)
    aux: RasterAux


def bin_gaussians(proj: ProjectedGaussians, tw: int, th: int, tile_size: int,
                  win: int, k_cap: int) -> TileBins:
    """Depth order, tile binning and the scatter into the dense grid."""
    dev = proj.xy.device
    n_tiles = tw * th
    n = proj.xy.shape[0]
    slots = win * win

    buckets = quantize_depth(proj.depth, proj.valid, DEPTH_BUCKETS)
    _, inverse = rank_permutation(buckets, DEPTH_BUCKETS)
    inverse = inverse.long()
    xy = proj.xy[inverse]
    valid = proj.valid[inverse]
    opacity = torch.where(valid, proj.opacity[inverse],
                          torch.zeros_like(proj.opacity[inverse]))
    depth_in = proj.depth[inverse]
    depth = torch.where(torch.isfinite(depth_in), depth_in,
                        torch.zeros_like(depth_in))

    # the static instance window over each Gaussian's tile rect
    with torch.no_grad():
        px, py = xy[:, 0].detach(), xy[:, 1].detach()
        r = proj.radius[inverse].detach()
        x0 = torch.clamp(torch.floor((px - r) / tile_size), 0, tw).to(torch.int32)
        y0 = torch.clamp(torch.floor((py - r) / tile_size), 0, th).to(torch.int32)
        x1 = torch.clamp(torch.floor((px + r) / tile_size) + 1, 0, tw).to(torch.int32)
        y1 = torch.clamp(torch.floor((py + r) / tile_size) + 1, 0, th).to(torch.int32)
        dj = torch.arange(slots, dtype=torch.int32, device=dev)
        tx = x0[:, None] + (dj % win)[None, :]
        ty = y0[:, None] + (dj // win)[None, :]
        in_span = (tx < x1[:, None]) & (ty < y1[:, None]) & valid[:, None]
        tile_id = torch.where(in_span, ty * tw + tx,
                              torch.full_like(tx, n_tiles)).reshape(-1)

        # each instance's place in its tile's front-to-back list
        pos = counting_rank(tile_id, n_tiles + 1)
        counts = torch.bincount(tile_id, minlength=n_tiles + 1)[:n_tiles]
        offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        local = pos.long() - offsets[torch.clamp_max(tile_id, n_tiles).long()]
        keep = (tile_id < n_tiles) & (local < k_cap)
        # a dropped instance writes a trash row of its own: with every index
        # distinct, the card's deterministic scatter runs in parallel (one
        # shared trash row serializes its ~10^6 writes)
        trash = n_tiles * k_cap
        inst = torch.arange(n * slots, device=dev)
        scatter_idx = torch.where(keep, tile_id.long() * k_cap + local, trash + inst)
        gauss_of_inst = inst // slots

    rows = torch.cat([xy, proj.conic[inverse], proj.color[inverse],
                      opacity[:, None], depth[:, None],
                      proj.power_cut[inverse][:, None],
                      torch.zeros_like(depth)[:, None]], dim=1)[gauss_of_inst]
    dense = rows.new_zeros((trash + n * slots, PACK)).index_put((scatter_idx,), rows)
    dense = dense[:trash].reshape(n_tiles, k_cap, PACK)
    aux = RasterAux(n_dropped=torch.clamp_min(counts - k_cap, 0).sum(),
                    max_tile_count=counts.max())
    return TileBins(dense=dense, aux=aux)


def _composite_chunk(trans, rgb_acc, dep_acc, chunk, pix):
    """One chunk of every tile's list: [T, kc, PACK] against the tiles'
    pixels [T, P, 2]; returns the updated (trans, rgb_acc, dep_acc)."""
    g_xy = chunk[..., 0:2]                                  # [T, kc, 2]
    a = chunk[..., 2:3]
    bco = chunk[..., 3:4]
    c = chunk[..., 4:5]
    g_color = chunk[..., 5:8]                               # [T, kc, 3]
    g_op = chunk[..., 8]                                    # [T, kc]
    g_dep = chunk[..., 9]
    g_cut = chunk[..., 10]

    d = pix[:, None, :, :] - g_xy[:, :, None, :]            # [T, kc, P, 2]
    dx, dy = d[..., 0], d[..., 1]
    power = -0.5 * (a * dx ** 2 + c * dy ** 2) - bco * dx * dy    # [T, kc, P]
    alpha = torch.clamp_max(g_op[..., None] * torch.exp(power), ALPHA_MAX)
    dead = (power > 0.0) | (power < g_cut[..., None]) | (alpha < ALPHA_MIN)
    alpha = torch.where(dead, torch.zeros_like(alpha), alpha)

    cp = torch.cumprod(1.0 - alpha, dim=1)
    cp_excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    w = trans[:, None, :] * cp_excl * alpha                 # [T, kc, P]
    rgb_acc = rgb_acc + torch.stack(
        [torch.sum(w * g_color[:, :, k, None], dim=1) for k in range(3)], dim=1)
    dep_acc = dep_acc + torch.sum(w * g_dep[..., None], dim=1)
    return trans * cp[:, -1, :], rgb_acc, dep_acc


def rasterize_tiled(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg_color: Sequence[float] | torch.Tensor,
    tile_size: int = 16,
    win: int = 5,
    k_cap: int = 512,
    k_chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, RasterAux]:
    """Rasterize projected Gaussians (see the module docstring).

    ``width`` and ``height`` must be multiples of ``tile_size``; ``win``
    must cover 2 + 2 MAX_SPLAT_RADIUS / tile_size tiles; ``k_cap`` is each
    tile's list capacity (the front-most ``k_cap`` instances survive) and
    ``k_chunk`` the compositing chunk, which must divide it."""
    if width % tile_size or height % tile_size:
        raise ValueError("width/height must be multiples of tile_size")
    min_win = 2 + 2 * int(MAX_SPLAT_RADIUS) // tile_size
    if win < min_win:
        raise ValueError(f"win={win} too small for MAX_SPLAT_RADIUS; need >= {min_win}")
    tw, th = width // tile_size, height // tile_size
    n_tiles = tw * th
    p = tile_size * tile_size
    dev, dt = proj.xy.device, proj.xy.dtype

    bins = bin_gaussians(proj, tw, th, tile_size, win, k_cap)
    dense = bins.dense

    tile_ids = torch.arange(n_tiles, device=dev)
    lx = torch.arange(tile_size, device=dev)
    pix_x = ((tile_ids % tw) * tile_size)[:, None] + lx.repeat(tile_size)[None, :]
    pix_y = ((tile_ids // tw) * tile_size)[:, None] \
        + lx.repeat_interleave(tile_size)[None, :]
    pix = torch.stack([pix_x, pix_y], dim=-1).to(dt)        # [T, P, 2]

    trans = torch.ones((n_tiles, p), dtype=dt, device=dev)
    rgb_t = torch.zeros((n_tiles, 3, p), dtype=dt, device=dev)
    dep_t = torch.zeros((n_tiles, p), dtype=dt, device=dev)
    chunks = dense.reshape(n_tiles, k_cap // k_chunk, k_chunk, PACK)
    for s in range(k_cap // k_chunk):
        trans, rgb_t, dep_t = checkpoint(_composite_chunk, trans, rgb_t, dep_t,
                                         chunks[:, s], pix, use_reentrant=False)

    bg = torch.as_tensor(bg_color, dtype=dt, device=dev)
    rgb_t = rgb_t + trans[:, None, :] * bg[None, :, None]
    acc_t = 1.0 - trans

    def tiles_to_image(tiled, ch):
        img = tiled.reshape(th, tw, ch, tile_size, tile_size)
        return img.permute(2, 0, 3, 1, 4).reshape(ch, height, width)

    return (tiles_to_image(rgb_t, 3), tiles_to_image(dep_t[:, None, :], 1),
            tiles_to_image(acc_t[:, None, :], 1), bins.aux)
