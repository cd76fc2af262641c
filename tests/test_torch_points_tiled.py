"""The point model on the serving rasterizer: exact binning, partial tiles
and the uncapped radius (``ops/rasterize/tiled_fwd.py``,
``models/point_gaussians.py``).

On the CPU (tier 1), on the plain walk that ``raster_forward_tiles`` runs
for a CPU tensor: ``sorted_pack``'s instances are a brute-force
enumeration of every (tile, Gaussian) pair of the splats' rects, in (tile,
depth, tie) order, with splats wider than the frame and partial tiles on
both axes; ``COUNTS`` adds what the pack emitted; ``render_points`` without
a gradient goes through the serving rasterizer and agrees with the
benchmark's plain reference ``benchmark/reference/points.py`` on seeded
fields of about 2k Gaussians.

On the card (marker ``card``, skipped without CUDA; this file imports no
JAX, so it runs without the suite's conftest:
``python -m pytest tests/test_torch_points_tiled.py -m card --noconftest``):
K1 against its plain walk on the same packs, with partial tiles at both
tile sizes and with uncapped splats of hundreds of pixels at 1237 x 822.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.models import point_gaussians as PG
from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.render import CameraArrays

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmark.drivers.render_points import camera  # noqa: E402
from benchmark.reference import points as ref_points  # noqa: E402

torch.set_num_threads(1)

# the plain walk against the reference: the same float32 function, rounded
# in another order (the front end's matmuls, the compositor's cumulative
# products), and two exits: the port's tile-wide vote composites pairs
# after a pixel's T fell below 1e-4, which the reference's pixel leaves
# out, and these add less than 1e-4 of a colour to a saturated pixel (read:
# means 0.7-1.7e-5, largest 8e-5 on the three fields). A pair on its alpha
# or power cut may flip with rounding and move a pixel by ~1/255 of a
# colour, which the largest difference has room for.
TOL_MEAN = 5e-5
TOL_MAX = 1e-2
# K1 against its plain walk on one pack (chip_smoke's limit)
TOL_CARD = 1e-5


def brute_instances(xy, radius, valid, depth, tw, th, tile):
    """Every (tile, Gaussian) pair whose tile the rect mean +- radius
    touches, counted one tile at a time in float32, sorted by tile, then
    depth, then the tie order (Gaussians of radius <= tile / 2 - 0.51 by
    index, then the others by radius, largest first, then index): a list of
    (tile id, Gaussian index)."""
    xy = np.asarray(xy, np.float32)
    r = np.asarray(radius, np.float32)
    out = []
    for i in range(len(xy)):
        if not valid[i]:
            continue
        lo_x, hi_x = xy[i, 0] - r[i], xy[i, 0] + r[i]
        lo_y, hi_y = xy[i, 1] - r[i], xy[i, 1] + r[i]
        wide = float(r[i]) > tile / 2 - 0.51
        for ty in range(th):
            for tx in range(tw):
                if (tx * tile <= hi_x and lo_x < (tx + 1) * tile
                        and ty * tile <= hi_y and lo_y < (ty + 1) * tile):
                    out.append((ty * tw + tx, float(depth[i]), wide,
                                -float(r[i]) if wide else 0.0, i))
    out.sort()
    return [(rec[0], rec[-1]) for rec in out]


def random_proj(n, width, height, seed, wide_share=0.1):
    """Projected Gaussians with integer radii, a share of them wider than
    the frame, some invalid, some centred off the frame."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xy = rng.uniform(-0.3 * width, 1.3 * width, (n, 2)).astype(f32)
    xy[:, 1] *= height / width
    radius = np.ceil(rng.uniform(2, 30, n)).astype(f32)
    wide = rng.random(n) < wide_share
    radius[wide] = np.ceil(rng.uniform(width, 3 * width, wide.sum()))
    valid = ((xy[:, 0] + radius > 0) & (xy[:, 0] - radius < width)
             & (xy[:, 1] + radius > 0) & (xy[:, 1] - radius < height)
             & (rng.random(n) > 0.1))
    depth = rng.choice([1.0, 2.0, 2.5, 4.0], n).astype(f32)   # depth ties as well

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return ProjectedGaussians(
        xy=t(xy), depth=t(np.where(valid, depth, np.inf).astype(f32)),
        conic=t(np.tile(np.asarray([0.02, 0.0, 0.02], f32), (n, 1))),
        radius=t(np.where(valid, radius, 0).astype(f32)),
        color=t(rng.uniform(0, 1, (n, 3)).astype(f32)),
        opacity=t(rng.uniform(0.1, 0.9, n).astype(f32)), valid=t(valid),
        power_cut=t(np.full(n, -4.5, f32)))


@pytest.mark.parametrize("order", ["exact", "fused"])
@pytest.mark.parametrize("width,height,tile", [(77, 45, 16), (77, 45, 32), (96, 64, 16)])
def test_sorted_pack_emits_every_tile_gaussian_pair(order, width, height, tile):
    proj = random_proj(120, width, height, seed=width + tile)
    tw, th = tpt.tile_grid(width, height, tile)
    before = dict(tpt.COUNTS)
    packed = tpt.sorted_pack(proj, tw, th, tile, order=order)
    want = brute_instances(proj.xy.numpy(), proj.radius.numpy(), proj.valid.numpy(),
                           proj.depth.numpy(), tw, th, tile)
    b = int(packed.counts.sum())
    assert b == len(want) and int(packed.starts[-1] + packed.counts[-1]) == b
    assert [int(g) for g in packed.gauss_idx[:b]] == [g for _, g in want]
    np.testing.assert_array_equal(packed.starts.numpy(),
                                  np.searchsorted([t for t, _ in want], np.arange(tw * th)))
    # every column is the Gaussian's own row, the support as projected
    rows = tpt.pack_rows(proj)[packed.gauss_idx[:b].long()].T
    assert torch.equal(packed.rows16[:, :b], rows)
    assert bool((packed.rows16[10, :b] == -4.5).all())
    # padding: a whole number of chunks plus one, zero rows, sentinel index
    assert packed.rows16.shape[1] % tpt.CHUNK == 0 and packed.rows16.shape[1] > b
    assert not packed.rows16[:, b:].any()
    assert bool((packed.gauss_idx[b:] == len(proj.xy)).all())
    x0, x1, y0, y1 = tpt.tile_rects(proj.xy, proj.radius, proj.valid, tw, th, tile)
    wide = int((((x1 - x0) > 2) | ((y1 - y0) > 2)).sum())
    assert wide > 0
    assert {k: tpt.COUNTS[k] - before.get(k, 0) for k in ("frames", "instances",
                                                          "wide_gaussians")} == \
        {"frames": 1, "instances": b, "wide_gaussians": wide}


def test_sorted_pack_of_nothing():
    proj = random_proj(6, 40, 40, seed=1)._replace(valid=torch.zeros(6, dtype=torch.bool))
    packed = tpt.sorted_pack(proj, 3, 3, 16)
    assert int(packed.counts.sum()) == 0 and packed.rows16.shape == (16, tpt.CHUNK)
    empty = tpt.sorted_pack(random_proj(0, 40, 40, seed=1), 3, 3, 16)
    assert int(empty.counts.sum()) == 0


@pytest.mark.parametrize("size", [(800, 800), (1237, 822), (800, 600), (800, 592), (640, 480),
                                  (77, 45)])
def test_tile_size_for(size):
    """32 px from 512 px up, but where 16 divides the sides and 32 does not
    (as the JAX package tiles them)."""
    want = {(800, 800): 32, (1237, 822): 32, (800, 600): 32, (800, 592): 16,
            (640, 480): 16, (77, 45): 16}
    assert tpt.tile_size_for(*size) == want[size]


def point_scene(n, seed):
    """A seeded point field of ``n`` Gaussians around the origin (leaves
    by ``PointGaussianParams``' names), a few of them large."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(n, 3, generator=g)
    xyz = d / d.norm(dim=1, keepdim=True) * torch.rand(n, 1, generator=g) ** (1 / 3)
    scaling = math.log(0.04) + 0.5 * torch.randn(n, 3, generator=g)
    scaling[: n // 50] += 2.5         # splats of many tiles
    color = 0.1 + 0.8 * torch.rand(n, 3, generator=g)
    opacity = 0.05 + 0.9 * torch.rand(n, 1, generator=g)
    return {"xyz": xyz, "features_dc": ((color - 0.5) / 0.28209479177387814)[:, None],
            "features_rest": 0.05 * torch.randn(n, 15, 3, generator=g),
            "scaling": scaling, "rotation": torch.randn(n, 4, generator=g),
            "opacity": torch.log(opacity / (1 - opacity))}


def program(field):
    n = field["xyz"].shape[0]
    params = PG.PointGaussianParams(**{k: v.clone() for k, v in field.items()})
    state = PG.PointGaussianState(alive=torch.ones(n, dtype=torch.bool),
                                  max_radii2d=torch.zeros(n), grad_accum=torch.zeros(n),
                                  denom=torch.zeros(n))
    return params, state


@pytest.mark.parametrize("case", [(2000, 96, 64, 0.0, 3.0, 11),
                                  (2000, 77, 45, 1.1, 2.6, 12),
                                  (1500, 133, 70, 2.5, 3.4, 13)])
def test_render_points_serves_exactly_and_matches_the_reference(case):
    n, width, height, az, radius, seed = case
    field = point_scene(n, seed)
    params, state = program(field)
    tan_x = 0.62
    tan_y = tan_x * height / width
    cam = camera((az, 0.3, radius), tan_x, tan_y, torch.device("cpu"))
    arrays = CameraArrays(world_view=cam["world_view"], full_proj=cam["full_proj"],
                          camera_center=cam["center"], time=torch.zeros(()))
    before = dict(tpt.COUNTS)
    rgb, depth, radii = PG.render_points(params, state, arrays, width, height, tan_x,
                                         tan_y, (0.0, 0.0, 0.0), 3)
    emitted = tpt.COUNTS["instances"] - before.get("instances", 0)
    assert tpt.COUNTS["frames"] - before.get("frames", 0) == 1
    assert rgb.shape == (3, height, width) and depth.shape == (1, height, width)
    assert not rgb.requires_grad
    want, pairs, proj = ref_points.render(field, cam, width, height, tan_x, tan_y, 3,
                                          torch.zeros(3))
    d = (rgb - want).abs()
    print(f"{width}x{height}: mean {float(d.mean()):.3e} max {float(d.max()):.3e}, "
          f"{emitted} instances, {pairs} live pairs")
    assert pairs > width * height and float(want.max()) > 0.3
    assert float(d.mean()) <= TOL_MEAN and float(d.max()) <= TOL_MAX
    # uncapped and exact: the reference's (tile, Gaussian) pairs, and some
    # splats far beyond the cloth field's 24 px cap
    tile = tpt.tile_size_for(width, height)
    assert emitted == ref_points.tile_pairs(proj, width, height, tile)
    assert float(radii.max()) > 48
    np.testing.assert_array_equal(radii.numpy(), proj["radius"].numpy())


def test_render_points_with_a_gradient_keeps_the_dense_tier():
    field = point_scene(300, 5)
    params, state = program(field)
    leaves = PG.PointGaussianParams(*(p.requires_grad_() for p in params))
    cam = camera((0.4, 0.2, 3.0), 0.62, 0.62, torch.device("cpu"))
    arrays = CameraArrays(world_view=cam["world_view"], full_proj=cam["full_proj"],
                          camera_center=cam["center"], time=torch.zeros(()))
    frames = tpt.COUNTS["frames"]
    rgb, _, _ = PG.render_points(leaves, state, arrays, 48, 48, 0.62, 0.62,
                                 (1.0, 1.0, 1.0), 3, k_cap=512)
    assert rgb.requires_grad and tpt.COUNTS["frames"] == frames
    with torch.no_grad():
        served, _, _ = PG.render_points(leaves, state, arrays, 48, 48, 0.62, 0.62,
                                        (1.0, 1.0, 1.0), 3)
    assert tpt.COUNTS["frames"] == frames + 1
    # nothing dropped at k_cap 512: the two tiers draw the same image
    assert float((served - rgb.detach()).abs().max()) < 1e-3


# ------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_points_tiled.py -m card --noconftest)")
    return torch.device("cuda")


def k1_against_plain(proj, width, height, tile, bg):
    """K1 and its plain walk on one pack: the largest difference over the
    frame's pixels (the kernel leaves those off the frame unwritten)."""
    tw, th = tpt.tile_grid(width, height, tile)
    packed = tpt.sorted_pack(proj, tw, th, tile, order="exact")
    launches = kernels.LAUNCHES["K1"]
    out_k = tpt.raster_forward_tiles(packed, width, height, tile, bg)
    assert kernels.LAUNCHES["K1"] == launches + 1
    out_p, walk = tpt.raster_forward_tiles_plain(packed, width, height, tile, bg)
    a = tpt.tiles_to_images(out_k, width, height, tile)
    b = tpt.tiles_to_images(out_p, width, height, tile)
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    return err, tpt.walk_stats(packed, walk, tile), a[0]


@pytest.mark.card
@pytest.mark.parametrize("tile", [16, 32])
def test_k1_partial_tiles_on_the_card(card, tile):
    proj = random_proj(3000, 77 * 3, 45 * 3, seed=tile)
    proj = ProjectedGaussians(*(t.to(card) for t in proj))
    err, stats, rgb = k1_against_plain(proj, 77 * 3, 45 * 3, tile, (0.2, 0.4, 0.6))
    print(f"K1 {tile} px tiles at 231x135: {err:.3e} {stats}")
    assert err <= TOL_CARD and stats["instances"] > 0
    assert rgb.shape == (3, 135, 231) and bool(torch.isfinite(rgb).all())


@pytest.mark.card
def test_k1_uncapped_splats_on_the_card(card):
    """A 60k-Gaussian point field at 1237 x 822 through the point model's
    front end (uncapped: splats of hundreds of pixels), K1 against its
    plain walk, and the serving call's frame equal to K1's."""
    field = {k: v.to(card) for k, v in point_scene(60000, 21).items()}
    params, state = program(field)
    state = PG.PointGaussianState(*(t.to(card) for t in state))
    width, height, tan_x = 1237, 822, 0.62
    tan_y = tan_x * height / width
    cam = camera((0.7, 0.25, 3.2), tan_x, tan_y, card)
    arrays = CameraArrays(world_view=cam["world_view"], full_proj=cam["full_proj"],
                          camera_center=cam["center"], time=torch.zeros((), device=card))
    with torch.no_grad():
        proj = PG.project_points_view(params, state, arrays, width, height, tan_x, tan_y,
                                      3)
        assert float(proj.radius.max()) > 200
        err, stats, rgb_k = k1_against_plain(proj, width, height, 32, (0.0, 0.0, 0.0))
        served = PG.render_points(params, state, arrays, width, height, tan_x, tan_y,
                                  (0.0, 0.0, 0.0), 3)[0]
    print(f"K1 uncapped at {width}x{height}: {err:.3e} {stats}")
    assert err <= TOL_CARD and stats["tiles_exited_early"] > 0
    assert torch.equal(served, rgb_k)
