"""PyTorch port vs the JAX package: sort binning and the tile compositor K1.

``sorted_pack``'s integer outputs must be IDENTICAL to JAX in both orders.
K1's plain version (what ``raster_forward_tiles`` runs on a CPU tensor) is
held to JAX ``rasterize_pallas(..., interpret=True)`` with the tolerances of
tests/test_pallas_raster.py: 3e-4 rgb/alpha, 3e-3 depth. A chunk whose max
transmittance sits within rounding of the 1e-4 exit threshold may be walked
by one implementation and not the other; that moves a pixel by up to
~1e-4 * (colour + bg). The kernel itself runs only on a CUDA card, where
chip_smoke.py holds it against this plain version.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cloth_splatting_tpu.ops.projection import ProjectedGaussians as JProj
from cloth_splatting_tpu.ops.rasterize import pallas_tiled as jpt

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians as TProj
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_points_tiled import brute_instances  # noqa: E402

torch.set_num_threads(1)

TOL = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}


def to_torch(pj) -> TProj:
    return TProj(*(torch.from_numpy(np.array(x)) for x in pj))


def hand_proj(xy, depth, radius, conic=(0.05, 0.0, 0.05), opacity=0.8,
              valid=None, power_cut=-4.5, seed=0) -> JProj:
    """A JAX ProjectedGaussians from numpy fields (broadcast scalars)."""
    n = len(xy)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return JProj(
        xy=jnp.asarray(np.asarray(xy, f32)),
        depth=jnp.asarray(np.asarray(depth, f32)),
        conic=jnp.asarray(np.broadcast_to(np.asarray(conic, f32), (n, 3))),
        radius=jnp.asarray(np.broadcast_to(np.asarray(radius, f32), (n,))),
        color=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(f32)),
        opacity=jnp.asarray(np.broadcast_to(np.asarray(opacity, f32), (n,))),
        valid=jnp.asarray(np.ones(n, bool) if valid is None else valid),
        power_cut=jnp.asarray(np.broadcast_to(np.asarray(power_cut, f32), (n,))),
    )


def assert_packs_identical(pj, tw, th, tile, win, order):
    """The port's instances are the JAX package's: the same starts and
    counts, and the same gauss_idx and rows16 over the instances. The JAX
    package sizes its array by its slot windows, the port by its instances,
    so only the padding after them differs."""
    jp = jpt.sorted_pack(pj, tw, th, tile, win, order=order)
    tp = tpt.sorted_pack(to_torch(pj), tw, th, tile, order=order)
    for name in ("starts", "counts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    b = int(tp.counts.sum())
    np.testing.assert_array_equal(tp.gauss_idx[:b].numpy(), np.asarray(jp.gauss_idx)[:b])
    np.testing.assert_array_equal(tp.rows16[:, :b].numpy(), np.asarray(jp.rows16)[:, :b])
    assert not tp.rows16[:, b:].any() and bool((tp.gauss_idx[b:] == len(pj.xy)).all())
    assert int(tp.aux.max_tile_count) == int(jp.aux.max_tile_count)
    return jp, tp


@pytest.mark.parametrize("order", ["fused", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_pack_identical(order, seed):
    pj = project_scene(n=200, seed=seed)
    assert_packs_identical(pj, W // 16, H // 16, 16, 5, order)


@pytest.mark.parametrize("order", ["fused", "exact"])
def test_sorted_pack_big_cap_ties(order):
    """More big splats than the JAX package's side stream holds (big_cap 7),
    with tied integer radii and tied depths: the JAX package shrinks the
    support of those past its cap; the port drops nothing and shrinks
    nothing. Its instances are every (tile, Gaussian) pair of the splats'
    rects, ordered by tile, then depth (quantized in the fused order), then
    radius, largest first, then index: the JAX package's pack when its side
    stream holds them all, which follows top_k (the lower index first among
    equal radii)."""
    rng = np.random.default_rng(3)
    n = 40
    xy = rng.uniform(4, 60, (n, 2))
    radius = rng.choice([9.0, 12.0, 12.0, 20.0], n)   # > 7.49: all big at 16 px
    depth = rng.choice([1.0, 2.0, 3.0], n)             # depth ties as well
    pj = hand_proj(xy, depth, radius)
    assert_packs_identical(pj, 4, 4, 16, 5, order)          # big_cap n
    jp = jpt.sorted_pack(pj, 4, 4, 16, 5, big_cap=7, order=order)
    tp = tpt.sorted_pack(to_torch(pj), 4, 4, 16, order=order)
    b = int(tp.counts.sum())
    want = brute_instances(np.asarray(pj.xy), np.asarray(pj.radius), np.ones(n, bool),
                           np.asarray(pj.depth), 4, 4, 16)
    assert [int(g) for g in tp.gauss_idx[:b]] == [g for _, g in want]
    starts = np.searchsorted([t for t, _ in want], np.arange(16))
    np.testing.assert_array_equal(tp.starts.numpy(), starts)
    # the cap binds in the JAX package: some splats were shrunk there, and
    # none in the port
    jcuts = np.asarray(jp.rows16)[10, :int(np.asarray(jp.counts).sum())]
    assert bool((jcuts > -4.5).any())
    assert bool((tp.rows16[10, :b] == -4.5).all())
    assert int(np.asarray(jp.counts).sum()) < b


@pytest.mark.parametrize("order", ["fused", "exact"])
def test_sorted_pack_negative_zero_depth(order):
    xy = [[8.0, 8.0], [9.0, 7.0], [10.0, 9.0], [7.5, 8.5], [40.0, 40.0]]
    depth = [-0.0, 0.0, -0.0, 0.5, -0.0]
    pj = hand_proj(xy, depth, 3.0)
    jp, tp = assert_packs_identical(pj, 4, 4, 16, 5, order)
    assert int(tp.starts[0]) == 0 and int(tp.counts[0]) == 4


def composite_both(pj, width, height, bg):
    rgb_j, dep_j, acc_j, _ = jpt.rasterize_pallas(
        pj, width, height, bg_static=bg, interpret=True)
    rgb_t, dep_t, acc_t, _ = tpt.rasterize_tiled_fwd(to_torch(pj), width, height, bg)
    for name, a, b in (("rgb", rgb_t, rgb_j), ("depth", dep_t, dep_j),
                       ("alpha", acc_t, acc_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL[name],
                                   err_msg=name)
    return rgb_t, dep_t, acc_t


@pytest.mark.parametrize("seed", [0, 2])
def test_plain_compositor_matches_pallas(seed):
    pj = project_scene(n=96, seed=seed)
    launches = kernels.LAUNCHES["K1"]
    composite_both(pj, W, H, (1.0, 1.0, 1.0))
    assert kernels.LAUNCHES["K1"] == launches   # CPU: no kernel


def test_plain_compositor_empty_scene():
    pj = project_scene(n=8, seed=1)
    pj = pj._replace(valid=jnp.zeros_like(pj.valid))
    rgb, _, acc = composite_both(pj, W, H, (0.5, 0.25, 0.75))
    np.testing.assert_allclose(rgb.numpy()[1], 0.25, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), 0.0, atol=1e-6)


def test_plain_compositor_saturated_early_exit():
    """Hundreds of overlapping splats per tile: the tile-wide T <= 1e-4 exit
    fires mid-list, and both implementations stop at the same chunk."""
    rng = np.random.default_rng(4)
    n = 600
    pj = hand_proj(rng.uniform(12, 52, (n, 2)), rng.uniform(1, 5, n), 24.0,
                   conic=(1 / 64, 0.0, 1 / 64),
                   opacity=rng.uniform(0.1, 0.5, n), seed=4)
    composite_both(pj, W, H, (1.0, 1.0, 1.0))
    packed = tpt.sorted_pack(to_torch(pj), W // 16, H // 16, 16)
    _, walk = tpt.raster_forward_tiles_plain(packed, W, H, 16, (1.0, 1.0, 1.0))
    stats = tpt.walk_stats(packed, walk, 16)
    assert stats["tiles_exited_early"] > 0
    assert stats["instances_walked"] < stats["instances"]


def test_plain_compositor_far_corner_precision():
    """A ~0.7 px sigma splat in the far corner of an 800 px frame."""
    pj = hand_proj([[790.3, 789.7]], [2.0], 3.0, conic=(2.0, 0.3, 2.2),
                   opacity=0.85)
    pt = to_torch(pj)
    rgb, dep, acc, _ = tpt.rasterize_tiled_fwd(pt, 800, 800, (0.0, 0.0, 0.0))
    rgb_o, dep_o, acc_o = rasterize_reference(pt, 800, 800, torch.zeros(3))
    rgb_j, _, acc_j, _ = jpt.rasterize_pallas(pj, 800, 800, bg_static=(0.0, 0.0, 0.0),
                                              interpret=True)
    sl = np.s_[:, 780:800, 780:800]
    assert float(acc[sl].max()) > 0.5
    np.testing.assert_allclose(rgb[sl].numpy(), rgb_o[sl].numpy(), atol=2e-3)
    np.testing.assert_allclose(rgb[sl].numpy(), np.asarray(rgb_j)[sl], atol=TOL["rgb"])
    np.testing.assert_allclose(acc[sl].numpy(), np.asarray(acc_j)[sl], atol=TOL["alpha"])


def test_wrapper_checks_inputs():
    pj = project_scene(n=16, seed=0)
    packed = tpt.sorted_pack(to_torch(pj), W // 16, H // 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tpt.raster_forward_tiles(
            packed._replace(rows16=packed.rows16.T.contiguous().T), W, H, 16,
            (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="starts"):
        tpt.raster_forward_tiles(packed._replace(starts=packed.starts.long()),
                                 W, H, 16, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="tile_size"):
        tpt.raster_forward_tiles(packed, W, H, 8, (1.0, 1.0, 1.0))


@pytest.mark.parametrize("order", ["exact", "fused"])
def test_cloth_render_unchanged_at_32px_tiles(order):
    """The cloth field's serving render at 512 x 512 (32 px tiles) is, bit for
    bit, the same compositor on the JAX package's two-stream pack, which is
    the binning the port had before it binned exactly: the same instances in
    the same order, so the same frame."""
    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh
    from cloth_splatting_tpu_torch.data.synthetic import orbit_camera, target_gaussians
    from cloth_splatting_tpu_torch.render import camera_arrays, project_view, render

    size, tile = 512, 32
    assert tpt.tile_size_for(size, size) == tile
    mesh = grid_cloth_mesh(12, 12, size=1.4, device="cpu")
    params, gstate = target_gaussians(mesh, 3, seed=2, device="cpu")
    fov = 2 * np.arctan(0.4)
    cam = camera_arrays(orbit_camera(1, 4, fov, size, size, 0.0), "cpu")
    tan = float(np.tan(fov / 2))
    bg = (1.0, 1.0, 1.0)
    out = render(cam, size, size, tan, tan, params, gstate, mesh, None, None, bg, 3,
                 backend="tiled_fwd", pack_order=order, device="cpu")
    with torch.no_grad():
        proj = project_view(cam, size, size, tan, tan, params, gstate, mesh, None, None,
                            3)[0]
    pj = JProj(*(jnp.asarray(t.numpy()) for t in proj))
    jp = jpt.sorted_pack(pj, size // tile, size // tile, tile, 3, order=order)
    old = tpt.PackedTiles(*(torch.from_numpy(np.array(getattr(jp, f)))
                            for f in ("rows16", "starts", "counts", "gauss_idx")), aux=None)
    assert int(old.counts.sum()) > 1000 and int(old.counts.max()) > tpt.CHUNK
    rgb, _, _ = tpt.tiles_to_images(
        tpt.raster_forward_tiles(old, size, size, tile, bg), size, size, tile)
    assert torch.equal(out.rgb, rgb)
