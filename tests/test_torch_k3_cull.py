"""K3's pixel map and footprint culling, on the CPU.

K3 (``csrc/tiled_train.cu``), like K1 and K2, gives each warp a compact
patch of the tile (``tiled_fwd.patch_pixel``) and walks only the instances
whose ``footprint_box`` meets the patch. The cull changes no result only if
the box is conservative: every pair it skips must be dead under the one
classification, ``tiled_fwd.chunk_alpha``. ``tiled_fwd.cull_audit`` counts,
with the plain box and the plain classification, the skipped pairs that are
alive; it must read 0 on the seeded scenes of ``test_torch_train_raster``, on
deep random packs with anisotropic conics at both tile sizes, and on edge
cases (opacity at 1/255, cuts near 0, nearly singular, indefinite, huge and
tiny conics, NaN opacity and cut). Last, the plain backward that K3 is held
to on the card still matches JAX ``rasterize_pallas_grad`` in interpret mode
at ``test_torch_train_raster``'s tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.ops.rasterize import pallas_train as jptr

from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd as tpt
from cloth_splatting_tpu_torch.ops.rasterize import tiled_train as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_rasterize import H, W, project_scene  # noqa: E402
from test_torch_raster import to_torch  # noqa: E402
from test_torch_train_raster import SCENES, assert_field_close  # noqa: E402

torch.set_num_threads(1)

BG = (1.0, 1.0, 1.0)


@pytest.mark.parametrize("tile_size", [16, 32])
def test_patch_pixel_is_a_bijection_onto_compact_patches(tile_size):
    p = tile_size * tile_size
    ppt = p // (tpt.WARPS * 32)
    warp, lane, i = np.meshgrid(np.arange(tpt.WARPS), np.arange(32),
                                np.arange(ppt), indexing="ij")
    pix = tpt.patch_pixel(warp, lane, i, tile_size)
    assert sorted(pix.ravel().tolist()) == list(range(p))
    # each warp holds a (tile / 2) x (tile / 4) rectangle, each lane a
    # q x q quad of it
    pw, ph, q = tile_size // 2, tile_size // 4, tile_size // 16
    for w in range(tpt.WARPS):
        x, y = pix[w] % tile_size, pix[w] // tile_size
        assert (x.min(), y.min()) == ((w % 2) * pw, (w // 2) * ph)
        assert (x.max() - x.min() + 1, y.max() - y.min() + 1) == (pw, ph)
        for ln in range(32):
            assert x[ln].max() - x[ln].min() + 1 == q
            assert y[ln].max() - y[ln].min() + 1 == q


def audit(proj, width, height, tile_size, order="exact"):
    win = 5 if tile_size == 16 else 3
    packed = tpt.sorted_pack(proj, width // tile_size, height // tile_size,
                             tile_size, win, order=order)
    return tpt.cull_audit(packed, width, height, tile_size)


@pytest.mark.parametrize("name", list(SCENES))
def test_cull_is_conservative_on_seeded_scenes(name):
    make, tile, win = SCENES[name]
    packed = tpt.sorted_pack(to_torch(make()), W // tile, H // tile, tile, win)
    # every chunk, and the chunks the forward started (what K3 walks)
    tbounds = ttr.raster_forward_train(packed, W, H, tile, BG)[1]
    for tb in (None, tbounds):
        a = tpt.cull_audit(packed, W, H, tile, tb)
        assert a["culled_pairs_alive"] == 0, a
        assert a["reductions"] > 0, a
        assert a["pairs_classified"] < a["pairs_walked"], a
        # a warp reduces only instances it walked: p / 8 pairs classified each
        per_warp = tile * tile // tpt.WARPS
        assert a["reductions"] * per_warp <= a["pairs_classified"], a


def random_proj(n, width, height, seed):
    """Anisotropic, rotated splats of 1-8 px sigma with random opacity (from
    below 1/255 up to 1) and random cuts, piled on the frame."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n)
    s1, s2 = rng.uniform(1, 8, n), rng.uniform(1, 8, n)
    c, s = np.cos(theta), np.sin(theta)
    conic = np.stack([c * c / s1**2 + s * s / s2**2,
                      c * s * (1 / s1**2 - 1 / s2**2),
                      s * s / s1**2 + c * c / s2**2], axis=1)
    f32 = np.float32
    t = lambda a: torch.from_numpy(np.asarray(a, f32))  # noqa: E731
    return ProjectedGaussians(
        xy=t(rng.uniform(0, [width, height], (n, 2))),
        depth=t(rng.uniform(1, 5, n)), conic=t(conic),
        radius=torch.full((n,), 24.0),
        color=t(rng.uniform(0, 1, (n, 3))),
        opacity=t(rng.uniform(0.5 / 255, 1.0, n)),
        valid=torch.ones(n, dtype=torch.bool),
        power_cut=t(rng.uniform(-12.0, -0.01, n)))


@pytest.mark.parametrize("tile_size", [16, 32])
def test_cull_is_conservative_on_deep_random_packs(tile_size):
    a = audit(random_proj(1500, 128, 128, seed=tile_size), 128, 128, tile_size)
    assert a["culled_pairs_alive"] == 0, a
    assert a["pairs_walked"] > 20 * 128 * 128, a
    # the cull skips most (warp, instance) pairs here
    assert a["pairs_classified"] < 0.6 * a["pairs_walked"], a


def edge_proj():
    """Instances for each edge case, at an integer pixel, offset from one
    by (0.004, 0.004) px (inside the box's absolute margin), (0.02, 0) and
    (0, 0.02) px (outside it), and at x = 15.6, 0.4 px before a patch's
    edge at both tile sizes."""
    f32 = np.float32
    at255 = f32(1.0) / f32(255.0)
    cases = []   # (conic, opacity, cut)
    for op in (np.nextafter(at255, f32(0)), at255, np.nextafter(at255, f32(1)),
               f32(1.0001) * at255):
        cases.append(((1 / 64, 0.0, 1 / 64), op, -4.5))
    for cut in (-1e-30, -1e-6, -1e-3, -0.0, 0.0, 1e-6):
        cases.append(((1 / 64, 0.0, 1 / 64), 0.5, cut))
    for eps in (1e-7, 1e-6, 1e-5, 1e-4, 1e-2, 0.0):
        for sign in (1.0, -1.0):
            cases.append(((0.5, sign * 0.5 * (1.0 - eps), 0.5), 0.9, -4.5))
    for conic in ((0.1, 0.2, 0.1), (-0.1, 0.0, 0.1), (0.1, 0.0, -0.1),
                  (0.0, 0.0, 0.1), (-0.1, 0.0, -0.1)):
        cases.append((conic, 0.9, -4.5))
    for scale in (1e-8, 1e-3, 1e2, 1e4, 1e8, 1e19, 1e30):
        cases.append(((scale, 0.3 * scale, scale), 0.9, -4.5))
    # a c overflows float32 while det = a c - b^2 does not: a long, thin
    # ellipse whose box must not collapse to the margins
    cases.append(((35.0, 1.83e19, 1e37), 0.9, -4.5))
    cases.append(((1 / 64, 0.0, 1 / 64), float("nan"), -4.5))
    cases.append(((1 / 64, 0.0, 1 / 64), 0.5, float("nan")))
    cases.append(((1 / 64, 0.0, 1 / 64), float("nan"), float("nan")))
    cases.append(((1 / 64, 0.0, 1 / 64), 0.0, -4.5))
    cases.append(((1 / 64, 0.0, 1 / 64), 0.5, -float("inf")))
    rng = np.random.default_rng(3)
    rows = []
    for conic, op, cut in cases:
        for dx, dy in ((0.0, 0.0), (0.004, 0.004), (0.02, 0.0), (0.0, 0.02)):
            x, y = rng.integers(4, 60, 2)
            rows.append((x + dx, y - dy, *conic, op, cut))
        rows.append((15.6, rng.integers(4, 60), *conic, op, cut))
    r = np.asarray(rows, np.float64)
    n = len(r)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return ProjectedGaussians(
        xy=t(r[:, 0:2]), depth=t(np.linspace(1, 5, n)), conic=t(r[:, 2:5]),
        radius=torch.full((n,), 24.0), color=t(np.full((n, 3), 0.5)),
        opacity=t(r[:, 5]), valid=torch.ones(n, dtype=torch.bool),
        power_cut=t(r[:, 6]))


@pytest.mark.parametrize("tile_size", [16, 32])
def test_cull_is_conservative_on_edge_cases(tile_size):
    a = audit(edge_proj(), 64, 64, tile_size)
    assert a["culled_pairs_alive"] == 0, a
    assert a["reductions"] > 0, a


def test_footprint_box_edge_cases():
    """The box of an instance that can be alive somewhere is never empty
    around its mean; conics that are not positive definite, or whose box
    is not finite, get the whole plane; an instance dead everywhere may get
    a point-sized box."""
    f32 = torch.float32
    inf = float("inf")

    def box(conic, op, cut, x=10.0, y=20.0):
        v = [torch.tensor([q], dtype=f32) for q in (x, y, *conic, op, cut)]
        return tpt.footprint_boxes(*v)[:, 0].tolist()

    whole = [-inf, inf, -inf, inf]
    for conic in ((0.1, 0.2, 0.1), (-0.1, 0.0, 0.1), (0.1, 0.0, -0.1),
                  (0.0, 0.0, 0.1), (0.5, 0.5, 0.5), (1e30, 0.0, 1e30),
                  (35.0, 1.83e19, 1e37), (float("nan"), 0.0, 0.1)):
        assert box(conic, 0.9, -4.5) == whole, conic
    assert box((0.1, 0.0, 0.1), float("nan"), float("nan")) == whole
    # an isotropic splat of sigma 8 alive down to exp(-4.5): |dx| <= 8 * 3
    x_lo, x_hi, y_lo, y_hi = box((1 / 64, 0.0, 1 / 64), 1.0, -4.5)
    assert x_hi - 10.0 == pytest.approx(24.0, rel=2e-3)
    assert 20.0 - y_lo == pytest.approx(24.0, rel=2e-3)
    # opacity 1/255 is alive only where power == 0: a box of the margins
    x_lo, x_hi, _, _ = box((1 / 64, 0.0, 1 / 64), 1.0 / 255.0, -4.5)
    assert 0.0 < x_hi - 10.0 < 0.6
    # a positive cut or zero opacity: dead everywhere, a point-sized box
    for op, cut in ((0.5, 1e-6), (0.0, -4.5)):
        x_lo, x_hi, _, _ = box((1 / 64, 0.0, 1 / 64), op, cut)
        assert x_hi - x_lo <= 2 * tpt.CULL_ABS + 1e-4


def test_backward_plain_matches_rasterize_pallas_grad():
    """The plain backward (what K3 is held to on the card) under the autograd
    Function, against JAX ``rasterize_pallas_grad`` in interpret mode, on
    the 48-splat scene shape of ``test_torch_train_raster``."""
    pj = project_scene(n=48, seed=1)
    tgt = np.random.default_rng(5).uniform(0, 1, (3, H, W)).astype(np.float32)
    names = ("xy", "conic", "color", "opacity", "depth")

    def loss(rgb, dep, acc, t):
        return ((rgb - t) ** 2).mean() + 0.1 * dep.mean() + 0.05 * acc.mean()

    def loss_j(*leaves):
        q = pj._replace(**dict(zip(names, leaves)))
        return loss(*jptr.rasterize_pallas_grad(q, W, H, BG, interpret=True),
                    jnp.asarray(tgt))

    val_j, g_j = jax.value_and_grad(loss_j, argnums=tuple(range(5)))(
        *(getattr(pj, k) for k in names))
    pt = to_torch(pj)
    leaves = [getattr(pt, k).clone().requires_grad_() for k in names]
    launches = ttr.run_backward.launches
    val_t = loss(*ttr.rasterize_tiled_train(pt._replace(**dict(zip(names, leaves))),
                                            W, H, BG), torch.from_numpy(tgt))
    g_t = torch.autograd.grad(val_t, leaves)
    assert ttr.run_backward.launches == launches       # CPU: the plain version
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    for name, a, b in zip(names, g_t, g_j):
        assert_field_close(a.numpy(), np.asarray(b), name)
