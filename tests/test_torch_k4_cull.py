"""K4's reverse walk with warp patches and the footprint cull, and the
cluster window of K2-span and K4, emulated on the host, on the CPU.

K4 (``csrc/tiled_train.cu::reverse_tile``) sweeps a tile's chunks last to
first. Each warp owns a compact patch of the tile (``tiled_fwd.patch_pixel``)
and walks only the live instances whose footprint box meets it, in
ascending lane order, twice a chunk: pass 1 runs each pixel's T chain and
sums the chunk's total of u w; pass 2 runs it again and forms the gradient
terms with S_i = (total - cum) + s_carry, where cum is the running sum of u
w and s_carry the later chunks' totals. A warp none of whose pixels sees an
instance skips it in both passes; the others run every pixel, a dead pixel
with alpha, a_raw and offsets at 0. ``reverse_walk`` below is that walk, one
instance at a time per pixel in the kernel's order, with the cull and
without it. The two must give every pixel's T, chunk total, running cum and
s_carry the same bits (a culled instance is dead at every pixel of its
warp). Its gradients are held to the plain reverse sweep
``run_backward_plain`` (what K4 is held to on the card) at chip_smoke's
TOL_K3 (3e-6 of each field's largest magnitude).

The walk reads its chunks through the cluster's window when its program
fits: ``cluster_window`` emulates ``composite.cuh::stage_window_share``,
which gives CTA r of a cluster of c the chunks a + r + q c at its slots q.
Every chunk of the cluster's tiles must be held exactly once, in at most
ceil(span_cap / c) slots a CTA, and found again by the walk's lookup.

Last, the plain reverse sweep under the autograd Function, with span options
where some programs fit and some overflow, against JAX
``rasterize_pallas_grad`` with the same options (Pallas in interpret mode),
on the shape ``tests/test_torch_span.py`` traces.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.ops.rasterize import pallas_train as jptr

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import ALPHA_MAX
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_fwd_cull import random_pack, warp_hits  # noqa: E402
from test_torch_k3_cull import edge_proj, random_proj  # noqa: E402
from test_torch_raster import to_torch  # noqa: E402
from test_torch_train_raster import SCENES, assert_field_close  # noqa: E402

torch.set_num_threads(1)

BG = (1.0, 1.0, 1.0)
TOL_K3 = 3e-6
FIELDS = {"xy": slice(0, 2), "conic": slice(2, 5), "color": slice(5, 8),
          "opacity": slice(8, 9), "depth": slice(9, 10)}
# the span options of the walks at 64x64 (16 tiles of 16 px, 4 of 32 px):
# the seeded scenes' programs fit, half of random16's, none of random32's
SPANS = {16: (2, 12), 32: (2, 12)}


def cluster_window(packed, tpp, span_cap):
    """The cluster's window split as ``stage_window_share`` stages it:
    (``tiled_fwd.cluster_shares``, {(cluster, rank, slot): chunk}) over the
    clusters whose program fits."""
    shares = tpt.cluster_shares(packed, tpp, span_cap)
    c = shares.size
    held = {}
    for g in range(shares.fits.numel()):
        if not bool(shares.fits[g]):
            continue
        a, b = int(shares.first[g]), int(shares.end[g])
        for rank in range(c):
            n = (b - a - rank + c - 1) // c if b - a > rank else 0
            for q in range(n):
                held[(g, rank, q)] = a + rank + q * c
    return shares, held


def window_chunk(shares, held, tile, k):
    """The chunk a CTA of a fitting cluster reads for global chunk ``k``:
    ``WindowStage``'s lookup, slot (k - a) // c of CTA (k - a) % c."""
    c = shares.size
    g = tile // c
    rel = k - int(shares.first[g])
    return held[(g, rel % c, rel // c)]


def pixel_warps(tile_size):
    """([p] the tile's pixels in (warp, lane, i) order of the patch map,
    [p] the warp that holds each pixel)."""
    p = tile_size * tile_size
    ppt = p // (tpt.WARPS * 32)
    wli = torch.arange(p)
    pix = tpt.patch_pixel(wli // (32 * ppt), (wli // ppt) % 32, wli % ppt,
                          tile_size)
    warp_of = torch.empty(p, dtype=torch.int64)
    warp_of[pix] = wli // (32 * ppt)
    return pix, warp_of


def reverse_walk(packed, gimg_t, tbounds, width, height, tile_size, bg, span,
                 cull: bool):
    """K4's walk in the kernel's order: (grads [16, B_pad], {(tile, chunk):
    per-pixel T after pass 1, total, T after pass 2, cum, s_carry after the
    chunk}). ``span`` is a resolved (tpp, span_cap): tiles of fitting
    programs read their chunks through ``cluster_window``."""
    tw = width // tile_size
    n_tiles = tw * (height // tile_size)
    b_pad = packed.rows16.shape[1]
    rows3d = packed.rows16.reshape(tpt.PACK16, -1, tpt.CHUNK).permute(1, 0, 2)
    starts, ends, kt, n_chunks = tpt.chunk_span(packed)
    px, py = tpt.pixel_coords(width, tile_size, n_tiles, "cpu")
    pix, warp_of = pixel_warps(tile_size)
    offsets = ttr.chunk_layout(packed, n_tiles)[0].to(torch.int64)
    shares, held = cluster_window(packed, *span) if span[1] else (None, {})
    lane = torch.arange(tpt.CHUNK)

    g4 = gimg_t[..., 0:4]
    kk = ((gimg_t[..., 4] - (gimg_t[..., 0] * bg[0] + gimg_t[..., 1] * bg[1]
                             + gimg_t[..., 2] * bg[2])) * (1.0 - gimg_t[..., 5]))
    carry = torch.zeros_like(kk)
    grads = torch.zeros((tpt.PACK16, b_pad))
    record = {}
    for step in range(int(n_chunks.max())):
        cand = (step < n_chunks).nonzero()[:, 0]
        ci = n_chunks[cand] - 1 - step
        t_start = tbounds[offsets[cand] + ci]
        started = t_start.amax(dim=1) > 0.0
        ta, ci, t_start = cand[started], ci[started], t_start[started]
        if ta.numel() == 0:
            continue                       # never started: the carry stays
        k = kt[ta] + ci
        src = k.clone()
        if shares is not None:
            for i, (t, kc) in enumerate(zip(ta.tolist(), k.tolist())):
                if bool(shares.fits[t // shares.size]):
                    src[i] = window_chunk(shares, held, t, kc)
        assert torch.equal(src, k)
        blk = rows3d[src]                                               # [A, 16, 128]
        pos = k[:, None] * tpt.CHUNK + lane[None, :]
        live = (pos >= starts[ta, None]) & (pos < ends[ta, None])
        dx, dy, a_raw, alpha, dead = tpt.chunk_alpha(blk, px[ta], py[ta], live)
        alive = ~dead                                                   # [A, p, 128]
        a = ta.numel()
        alive_w = alive[:, pix].reshape(a, tpt.WARPS, -1, tpt.CHUNK).any(dim=2)
        lanes = (warp_hits(blk, live, (ta % tw) * tile_size,
                           (ta // tw) * tile_size, tile_size)
                 if cull else live[:, None, :].expand(-1, tpt.WARPS, -1))
        runs = (lanes & alive_w)[:, warp_of, :]                         # [A, p, 128]
        zero = torch.zeros(())
        al = torch.where(alive, alpha, zero)
        ar = torch.where(alive, a_raw, zero)
        dx, dy = torch.where(alive, dx, zero), torch.where(alive, dy, zero)
        ch4 = torch.cat([blk[:, 5:8], blk[:, 9:10]], dim=1)             # [A, 4, 128]
        u = torch.einsum("apc,acl->apl", g4[ta], ch4)
        gk, kk_a, carry_a = g4[ta], kk[ta], carry[ta]

        T, total = t_start.clone(), torch.zeros_like(t_start)
        for j in range(tpt.CHUNK):
            m, alj = runs[..., j], al[..., j]
            w = alj * T
            total = torch.where(m, total + u[..., j] * w, total)
            T = torch.where(m, T * (1.0 - alj), T)
        t_pass1 = T

        T, cum = t_start.clone(), torch.zeros_like(t_start)
        sums = torch.zeros((a, 10, tpt.CHUNK))
        for j in range(tpt.CHUNK):
            m, alj, arj, uj = runs[..., j], al[..., j], ar[..., j], u[..., j]
            w = alj * T
            cum = torch.where(m, cum + uj * w, cum)
            s_i = (total - cum) + carry_a
            dl_da = uj * T + (kk_a - s_i) / torch.clamp_min(1.0 - alj, 1e-3)
            dpow = torch.where(m & (arj <= ALPHA_MAX), dl_da * arj, zero)
            dxj, dyj = dx[..., j], dy[..., j]
            terms = [dpow, dpow * dxj, dpow * dyj, dpow * dxj * dxj,
                     dpow * dyj * dyj, dpow * dxj * dyj,
                     *(torch.where(m, gk[..., c] * w, zero) for c in range(4))]
            sums[:, :, j] = torch.stack([t.sum(1) for t in terms], dim=1)
            T = torch.where(m, T * (1.0 - alj), T)
        carry[ta] += total
        for i, t in enumerate(ta.tolist()):
            record[(t, int(ci[i]))] = (t_pass1[i], total[i], T[i], cum[i],
                                       carry[t].clone())

        ca, cb, cc = blk[:, 2], blk[:, 3], blk[:, 4]
        gblk = torch.zeros_like(blk)
        gblk[:, 0] = ca * sums[:, 1] + cb * sums[:, 2]
        gblk[:, 1] = cc * sums[:, 2] + cb * sums[:, 1]
        gblk[:, 2] = -0.5 * sums[:, 3]
        gblk[:, 3] = -sums[:, 5]
        gblk[:, 4] = -0.5 * sums[:, 4]
        gblk[:, 5:8] = sums[:, 6:9]
        gblk[:, 8] = sums[:, 0] / torch.clamp_min(blk[:, 8], 1e-30)
        gblk[:, 9] = sums[:, 9]
        grads[:, pos[live]] = gblk.permute(1, 0, 2)[:, live]
    return grads, record


def edge_pack(tile_size):
    return tpt.sorted_pack(edge_proj(), 64 // tile_size, 64 // tile_size, tile_size)


def case(name):
    """(packed, tile size) at 64x64: a seeded scene of
    test_torch_train_raster, a deep random pack or the edge-case pack."""
    for kind, make in (("random", random_pack), ("edge", edge_pack)):
        if name.startswith(kind):
            ts = int(name[len(kind):])
            return make(ts), ts
    make, ts, _ = SCENES[name]
    return tpt.sorted_pack(to_torch(make()), W // ts, H // ts, ts), ts


def walk_inputs(packed, ts, seed=7):
    """(gimg_t, tbounds, resolved span) of a pack: the plain forward's
    boundaries and a seeded random cotangent."""
    rng = np.random.default_rng(seed)
    out_t, tb = ttr.raster_forward_train_plain(packed, W, H, ts, BG)[:2]
    rgb, dep, acc = tpt.tiles_to_images(out_t, W, H, ts)
    cot = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
           for s in ((3, H, W), (1, H, W), (1, H, W))]
    gimg_t = ttr.images_to_tiles(ttr.grad_image(rgb, dep, acc, *cot, BG), W, H, ts)
    n_tiles = (W // ts) * (H // ts)
    span = tpt.resolve_span(n_tiles, packed.rows16.shape[1], *SPANS[ts], "bwd")
    return gimg_t, tb, span


WALK_CASES = [*SCENES, "random16", "random32"]


@pytest.mark.parametrize("name", [*WALK_CASES, "edge16", "edge32"])
def test_culled_reverse_walk_is_bit_identical_to_the_walk_without_cull(name):
    packed, ts = case(name)
    gimg_t, tb, span = walk_inputs(packed, ts)
    g_c, rec_c = reverse_walk(packed, gimg_t, tb, W, H, ts, BG, span, cull=True)
    g_n, rec_n = reverse_walk(packed, gimg_t, tb, W, H, ts, BG, span, cull=False)
    assert rec_c.keys() == rec_n.keys() and rec_c
    for key in rec_c:
        for a, b in zip(rec_c[key], rec_n[key]):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=str(key))
    np.testing.assert_array_equal(g_c.numpy(), g_n.numpy())


@pytest.mark.parametrize("name", WALK_CASES)
def test_reverse_walk_matches_the_plain_reverse_sweep(name):
    packed, ts = case(name)
    gimg_t, tb, span = walk_inputs(packed, ts)
    g_w, rec = reverse_walk(packed, gimg_t, tb, W, H, ts, BG, span, cull=True)
    g_p = ttr.run_backward_plain(packed, gimg_t, tb, W, H, ts, BG, *span)
    for field, rows in FIELDS.items():
        scale = float(g_p[rows].abs().max())
        assert scale > 0.0, field
        assert float((g_w[rows] - g_p[rows]).abs().max()) <= TOL_K3 * scale, field
    assert float(g_w[10:].abs().max()) == 0.0
    # pass 2 runs pass 1's T chain and sums again: the same bits at its end
    for t_pass1, total, t_pass2, cum, _ in rec.values():
        assert torch.equal(t_pass1, t_pass2) and torch.equal(total, cum)
    if name.startswith("deep"):
        n_laid = int(tpt.chunk_span(packed)[3].sum())
        assert len(rec) < n_laid              # chunks never started are skipped


def wide_pack():
    """80x80 at 16 px: 25 tiles, so tpp 5 and 25 run clusters of 5."""
    return tpt.sorted_pack(to_torch(project_scene(n=300, seed=3)), 5, 5, 16)


def wide121_pack():
    """176x176 at 16 px: 121 tiles of random anisotropic splats, up to 3
    chunks a tile, so tpp 11 runs clusters of one CTA."""
    return tpt.sorted_pack(random_proj(1500, 176, 176, seed=11), 11, 11, 16)


@pytest.mark.parametrize("name,tpp,span_cap", [
    ("scene16", 2, 41), ("scene16", 4, 8), ("scene16", 8, 1),
    ("scene16", 16, 41),      # clusters of 8: two a program
    ("random16", 2, 12), ("random16", 4, 34), ("random32", 2, 20),
    ("wide", 5, 41), ("wide", 25, 41),
    ("wide121", 11, 96),      # clusters of one CTA, span_cap clamped to 39
])
def test_cluster_window_holds_every_chunk_once(name, tpp, span_cap):
    wide = {"wide": wide_pack, "wide121": wide121_pack}
    packed, ts = (wide[name](), 16) if name in wide else case(name)
    n_tiles = packed.starts.numel()
    tpp, cap = tpt.resolve_span(n_tiles, packed.rows16.shape[1], tpp, span_cap,
                                "fwd_train")
    shares, held = cluster_window(packed, tpp, cap)
    c = shares.size
    assert c == tpt.span_cluster_size(tpp) and tpp % c == 0 and c <= 8
    k0c, fits = tpt.span_programs(packed, tpp, cap)
    assert bool(fits.any())
    assert torch.equal(shares.fits, fits.repeat_interleave(tpp // c))
    starts, ends, kt, n_chunks = tpt.chunk_span(packed)
    k0 = kt[0::tpp]
    k_end = (ends[tpp - 1::tpp] + tpt.CHUNK - 1) // tpt.CHUNK
    for g in range(n_tiles // c):
        mine = sorted(k for (h, _, _), k in held.items() if h == g)
        if not bool(shares.fits[g]):
            assert not mine
            continue
        a, b = int(shares.first[g]), int(shares.end[g])
        assert mine == list(range(a, b))                 # each chunk once
        assert b - a <= cap
        # the program's whole window when the cluster is the program
        if c == tpp:
            assert (a, b) == (int(k0[g]), int(k_end[g]))
        assert a >= int(k0c[g * c // tpp])
        for t in range(g * c, (g + 1) * c):
            for k in range(int(kt[t]), int(kt[t] + n_chunks[t])):
                assert window_chunk(shares, held, t, k) == k
    for (_, rank, q) in held:
        assert rank < c and q < tpt.window_slots(cap, c)


def test_span_cluster_size():
    got = {tpp: tpt.span_cluster_size(tpp)
           for tpp in (1, 2, 4, 5, 8, 10, 11, 12, 16, 25, 125)}
    assert got == {1: 1, 2: 2, 4: 4, 5: 5, 8: 8, 10: 5, 11: 1, 12: 6, 16: 8,
                   25: 5, 125: 5}
    assert [tpt.window_slots(41, c) for c in (1, 2, 4, 5, 8)] == [41, 21, 11, 9, 6]


def test_reverse_sweep_with_span_matches_rasterize_pallas_grad():
    """The autograd Function with span options (the plain K2-span forward
    and the plain reverse sweep K4 is held to), against JAX
    ``rasterize_pallas_grad`` with the same options in interpret mode, on a
    pack where some programs fit their window and some overflow."""
    pj = project_scene(n=250, seed=8)
    tpp, span_cap = 2, 1
    tp = tpt.sorted_pack(to_torch(pj), W // 16, H // 16, 16)
    fits = tpt.span_programs(tp, tpp, span_cap)[1]
    assert bool(fits.any()) and not bool(fits.all())
    tgt = np.random.default_rng(6).uniform(0, 1, (3, H, W)).astype(np.float32)
    names = ("xy", "conic", "color", "opacity", "depth")

    def loss(rgb, dep, acc, t):
        return ((rgb - t) ** 2).mean() + 0.1 * dep.mean() + 0.05 * acc.mean()

    def loss_j(*leaves):
        q = pj._replace(**dict(zip(names, leaves)))
        return loss(*jptr.rasterize_pallas_grad(
            q, W, H, BG, tile_size=16, win=5, interpret=True,
            tiles_per_program=tpp, span_cap=span_cap), jnp.asarray(tgt))

    val_j, g_j = jax.value_and_grad(loss_j, argnums=tuple(range(5)))(
        *(getattr(pj, k) for k in names))
    pt = to_torch(pj)
    leaves = [getattr(pt, k).clone().requires_grad_() for k in names]
    launches = kernels.LAUNCHES["K4"]
    val_t = loss(*ttr.rasterize_tiled_train(
        pt._replace(**dict(zip(names, leaves))), W, H, BG,
        tiles_per_program=tpp, span_cap=span_cap), torch.from_numpy(tgt))
    g_t = torch.autograd.grad(val_t, leaves)
    assert kernels.LAUNCHES["K4"] == launches   # CPU: plain version
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    for name, a, b in zip(names, g_t, g_j):
        assert_field_close(a.numpy(), np.asarray(b), name)
