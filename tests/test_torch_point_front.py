"""The point front end's kernel (``csrc/point_front.cu``, called by
``ops.point_front.project_points_fused``) against the PyTorch ops it
replaces on the serving path (``models.point_gaussians.project_points_eager``).

On the CPU (tier 1): which path a call takes (CPU tensors, and leaves that
need a gradient, take the PyTorch ops; ``serving`` is the one rule that
``render_points`` and ``project_points_view`` share), the counter
``COUNTS`` (one a call), the wrapper's checks, which raise before any
library is loaded and launch nothing, and chip_smoke's build phase, which
needs every SH degree of the kernel in its build log.

On the card (marker ``card``, skipped without CUDA; this file imports no
JAX, so it runs without the suite's conftest:
``python -m pytest tests/test_torch_point_front.py -m card --noconftest``):
the kernel's ``ProjectedGaussians`` against the PyTorch ops on the
benchmark's gs-360-3m field (3.0M Gaussians, ``make_field``) at three
``orbit-360`` cameras, at SH degrees 0-3 (and 3-4 on a field stored at
degree 4), uncapped and capped at 24 px, with dead slots, Gaussians at and
behind the camera, off-screen Gaussians and zero quaternions planted; a
count that is not a multiple of 32 and rows
off a 16-byte boundary; no launch for no Gaussians; ``render_points``'
frame against the frame of the PyTorch front end, with one launch of the
kernel; and ``fit_static_scene``, whose leaves need a gradient, on the
PyTorch ops.
"""

import collections
import contextlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.models import point_gaussians as PG
from cloth_splatting_tpu_torch.ops import point_front as PF
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import rasterize_tiled_fwd
from cloth_splatting_tpu_torch.render import CameraArrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.drivers.render_points import camera, make_field  # noqa: E402

torch.set_num_threads(1)

with open(os.path.join(ROOT, "benchmark", "configs", "gs-360-3m.json")) as _f:
    CFG = json.load(_f)
WIDTH, HEIGHT = CFG["image"]["width"], CFG["image"]["height"]
TAN_X = CFG["image"]["tan_half_fov_x"]
TAN_Y = TAN_X * HEIGHT / WIDTH
# (azimuth, elevation rad, radius) inside orbit-360's ranges
CAMERAS = ((0.3, 0.1, 3.2), (2.5, 0.45, 4.4), (4.9, 0.25, 3.7))
SEED = 2147483731


def field(n, device, seed=SEED):
    """The gs-360-3m configuration's field at ``n`` Gaussians, all alive."""
    f = make_field({**CFG, "gaussians": n}, seed, device)
    params = PG.PointGaussianParams(**f)
    state = PG.PointGaussianState(
        alive=torch.ones(n, dtype=torch.bool, device=device),
        max_radii2d=torch.zeros(n, device=device),
        grad_accum=torch.zeros(n, device=device), denom=torch.zeros(n, device=device))
    return params, state


def camera_arrays(req, device):
    cam = camera(req, TAN_X, TAN_Y, device)
    return CameraArrays(world_view=cam["world_view"], full_proj=cam["full_proj"],
                        camera_center=cam["center"],
                        time=torch.zeros((), device=device))


def front(params, state, cam, sh_degree=3, max_radius=None):
    return PG.project_points_view(params, state, cam, WIDTH, HEIGHT, TAN_X, TAN_Y,
                                  sh_degree, max_radius)


# ------------------------------------------------------------------ CPU


def test_cpu_calls_take_the_pytorch_ops(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(PG, "project_points_fused", refuse)
    params, state = field(500, "cpu")
    cam = camera_arrays(CAMERAS[0], "cpu")
    before = dict(PG.COUNTS)
    with torch.no_grad():
        proj = front(params, state, cam)
    assert dict(PG.COUNTS) == {**before,
                               "front_eager": before.get("front_eager", 0) + 1}
    want = PG.project_points_eager(params, state.alive, cam, WIDTH, HEIGHT, TAN_X,
                                   TAN_Y, 3)
    assert all(torch.equal(a, b) for a, b in zip(proj, want))
    assert int(proj.valid.sum()) > 0


def test_leaves_that_need_a_gradient_take_the_pytorch_ops(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran with a gradient")

    monkeypatch.setattr(PG, "project_points_fused", refuse)
    params, state = field(400, "cpu")
    leaves = PG.PointGaussianParams(*(p.clone().requires_grad_() for p in params))
    assert PG.serving(params) and not PG.serving(leaves)
    with torch.no_grad():
        assert PG.serving(leaves)
    cam = camera_arrays(CAMERAS[1], "cpu")
    eager = PG.COUNTS["front_eager"]
    rgb, _, _ = PG.render_points(leaves, state, cam, 64, 48, TAN_X, TAN_X * 48 / 64,
                                 (0.0, 0.0, 0.0), 3)
    assert rgb.requires_grad and PG.COUNTS["front_eager"] == eager + 1


@pytest.mark.parametrize("grad", [False, True])
def test_counts_add_one_a_call(grad):
    params, state = field(200, "cpu")
    if grad:
        params = PG.PointGaussianParams(*(p.requires_grad_() for p in params))
    cam = camera_arrays(CAMERAS[2], "cpu")
    total = sum(PG.COUNTS.values())
    for i in range(3):
        front(params, state, cam)
        assert sum(PG.COUNTS.values()) == total + i + 1
    PG.render_points(params, state, cam, 32, 32, TAN_X, TAN_X, (0.0, 0.0, 0.0), 3)
    assert sum(PG.COUNTS.values()) == total + 4


def _bad_inputs(case):
    """(params, alive, cam, sh_degree) on the CPU, broken as ``case`` says."""
    params, state = field(64, "cpu")
    alive, cam, deg = state.alive, camera_arrays(CAMERAS[0], "cpu"), 3
    if case == "degree":
        deg = 5
    elif case == "dtype":
        params = params._replace(xyz=params.xyz.double())
    elif case == "rest_rows":
        params = params._replace(features_rest=params.features_rest[:, :8].contiguous())
    elif case == "rotation_shape":
        params = params._replace(rotation=params.rotation[:, :3].contiguous())
    elif case == "opacity_shape":
        params = params._replace(opacity=params.opacity[:, 0].contiguous())
    elif case == "alive_dtype":
        alive = alive.float()
    elif case == "contiguity":
        params = params._replace(scaling=torch.zeros(64, 6)[:, ::2])
    elif case == "camera_shape":
        cam = cam._replace(world_view=cam.world_view[:3])
    return params, alive, cam, deg


@pytest.mark.parametrize("case,message", [
    ("degree", "SH degree"), ("dtype", "xyz must be torch.float32"),
    ("rest_rows", "features_rest must be"), ("rotation_shape", "rotation must be"),
    ("opacity_shape", "opacity must be"), ("alive_dtype", "alive must be torch.bool"),
    ("contiguity", "scaling must be contiguous"), ("camera_shape", "world_view must be"),
    ("device", "one CUDA device")])
def test_wrapper_checks_raise_before_any_library_loads(monkeypatch, case, message):
    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(kernels, "load", refuse)
    PF._launcher.cache_clear()
    params, alive, cam, deg = _bad_inputs(case)
    launches = kernels.LAUNCHES["front"]
    with pytest.raises(ValueError, match=message):
        PF.project_points_fused(params, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, deg)
    assert kernels.LAUNCHES["front"] == launches


def test_launch_counts_only_successful_launches_by_name(monkeypatch):
    """``kernels.launch`` hands the launcher the current stream last, raises
    with the kernel's name on a CUDA error, and counts only the launches
    that succeeded, each kernel's name apart."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(kernels, "LAUNCHES", collections.Counter())
    calls = []

    def succeeds(*args):
        calls.append(args)
        return 0

    kernels.launch("K1", succeeds, "cpu", 1, 2)
    kernels.launch("K1", succeeds, "cpu", 3)
    kernels.launch("front", succeeds, "cpu")
    with pytest.raises(RuntimeError, match=r"^K4 kernel launch failed: CUDA error 3$"):
        kernels.launch("K4", lambda *args: 3, "cpu")
    assert calls == [(1, 2, 7), (3, 7), (7,)]
    assert kernels.LAUNCHES == {"K1": 2, "front": 1}


def test_transposed_camera_passes_the_checks_but_the_device():
    """A ``world_view`` laid out transposed (as ``ops.camera.Camera``'s can
    be) is copied to row-major: the only complaint left is the device."""
    params, state = field(64, "cpu")
    cam = camera_arrays(CAMERAS[0], "cpu")
    cam = cam._replace(world_view=cam.world_view.t().contiguous().t())
    assert not cam.world_view.is_contiguous()
    with pytest.raises(ValueError, match="one CUDA device"):
        PF.project_points_fused(params, state.alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, 3)


def _ptxas_log(entries) -> str:
    """An ``nvcc -Xptxas -v`` log of the entry functions ``entries``
    (mangled as in an anonymous namespace): name -> bytes spilled."""
    lines = []
    for entry, spilled in entries.items():
        name, deg = entry[:-1].split("<")
        lines += [f"ptxas info    : Compiling entry function "
                  f"'_ZN12_GLOBAL__N_1{len(name)}{name}ILi{deg}EEEv4Args' for 'sm_90a'",
                  f"    0 bytes stack frame, {spilled} bytes spill stores, "
                  f"{spilled} bytes spill loads",
                  "ptxas info    : Used 56 registers, 384 bytes cmem[0]"]
    return "\n".join(lines)


@pytest.mark.parametrize("case,message", [
    ("whole", None), ("front_degree_missing", "point_front_kernel<4>"),
    ("front_spills", "point_front_kernel<2> spills"),
    ("cloth_degree_missing", "cloth_front_kernel<0>"),
    ("cloth_spills", "cloth_front_kernel<3> spills"),
    ("span_missing", "tiled_bwd_reverse_kernel<4>")])
def test_chip_smoke_spill_check_needs_every_entry(case, message):
    """chip_smoke's build phase fails on a spill, and on a span kernel or SH
    degree of the point or cloth front end that its build log does not
    hold."""
    import chip_smoke as cs

    entries = {cs.KERNEL_ENTRIES[key]: 0 for key in cs.SPAN_KERNELS}
    entries.update({f"{front}_front_kernel<{deg}>": 0 for front in ("point", "cloth")
                    for deg in range(5)})
    if case == "front_degree_missing":
        del entries["point_front_kernel<4>"]
    elif case == "front_spills":
        entries["point_front_kernel<2>"] = 16
    elif case == "cloth_degree_missing":
        del entries["cloth_front_kernel<0>"]
    elif case == "cloth_spills":
        entries["cloth_front_kernel<3>"] = 8
    elif case == "span_missing":
        del entries["tiled_bwd_reverse_kernel<4>"]
    usage = cs.ptxas_usage(_ptxas_log(entries))
    assert len(usage) == len(entries)
    if message is None:
        cs.check_spills(usage)
    else:
        with pytest.raises(RuntimeError, match=message):
            cs.check_spills(usage)


def test_chip_smoke_compiles_again_what_was_built_before(monkeypatch, tmp_path):
    """A library built before leaves no log: chip_smoke compiles it again
    into a temporary directory, and leaves the build directory as it was."""
    import chip_smoke as cs

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    calls = []

    def build_all(names=None):
        calls.append((names, kernels.BUILD_DIR))
        if names is None:
            return {"tiled_fwd": "fresh log", "point_front": None}
        return {name: f"log of {name}" for name in names}

    monkeypatch.setattr(kernels, "build_all", build_all)
    assert cs.build_logs() == {"tiled_fwd": "fresh log",
                               "point_front": "log of point_front"}
    assert calls[0] == (None, tmp_path)
    assert calls[1][0] == ["point_front"] and calls[1][1] != tmp_path
    assert kernels.BUILD_DIR == tmp_path


# ----------------------------------------------------------------- card

SKIP_REASON = ("needs a CUDA device (run on the card: python -m pytest "
               "tests/test_torch_point_front.py -m card --noconftest)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip(SKIP_REASON)
    return torch.device("cuda")


@pytest.fixture(scope="module")
def gs360():
    """The gs-360-3m field on the card with edge cases planted: 10% of the
    slots dead, every 97th quaternion zero, every 101st Gaussian at the
    first camera's centre, every 103rd behind it and every 107th far off
    its screen."""
    if not torch.cuda.is_available():
        pytest.skip(SKIP_REASON)
    dev = torch.device("cuda")
    params, state = field(CFG["gaussians"], dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    alive = torch.rand(CFG["gaussians"], generator=gen, device=dev) > 0.1
    centre = camera_arrays(CAMERAS[0], dev).camera_center
    xyz, rot = params.xyz.clone(), params.rotation.clone()
    rot[::97] = 0.0
    xyz[::101] = centre
    xyz[::103] = centre * 1.5
    xyz[::107] = centre + torch.tensor([40.0, -30.0, 5.0], device=dev)
    params = params._replace(xyz=xyz, rotation=rot)
    return params, state._replace(alive=alive)


def field_gaps(got, want) -> dict:
    """Per field of two ``ProjectedGaussians``: elements whose bits differ
    (NaNs of either sign equal) and the largest difference among the finite
    ones."""
    out = {}
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == torch.bool:
            out[name] = (int((a != b).sum()), 0.0)
            continue
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        finite = a.isfinite() & b.isfinite()
        diff = (a - b).abs()[finite]
        out[name] = (int((~same).sum()), float(diff.max()) if diff.numel() else 0.0)
    return out


def assert_same(got, want, label):
    gaps = field_gaps(got, want)
    print(f"{label}: {gaps}")
    assert gaps["valid"][0] == 0 and gaps["radius"][0] == 0, label
    assert all(n == 0 for n, _ in gaps.values()), label


@pytest.mark.card
@pytest.mark.parametrize("max_radius", [None, 24.0])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_kernel_equals_the_pytorch_ops_on_the_gs360_field(gs360, sh_degree, max_radius):
    params, state = gs360
    dev = params.xyz.device
    for req in CAMERAS:
        cam = camera_arrays(req, dev)
        with torch.no_grad():
            fused, launches = PG.COUNTS["front_fused"], kernels.LAUNCHES["front"]
            got = front(params, state, cam, sh_degree, max_radius)
            assert PG.COUNTS["front_fused"] == fused + 1
            assert kernels.LAUNCHES["front"] == launches + 1
            want = PG.project_points_eager(params, state.alive, cam, WIDTH, HEIGHT,
                                           TAN_X, TAN_Y, sh_degree, max_radius)
        torch.cuda.synchronize()
        assert 0 < int(want.valid.sum()) < int(state.alive.sum())
        assert_same(got, want, f"degree {sh_degree}, max_radius {max_radius}, {req}")


@pytest.mark.card
def test_kernel_at_sh_degree_4(card):
    """A field stored at SH degree 4 (24 rest rows), at degrees 4 and 3."""
    n = 300_000
    params = PG.PointGaussianParams(**make_field({**CFG, "gaussians": n, "sh_degree": 4},
                                                 SEED, card))
    alive = torch.rand(n, device=card) > 0.1
    for sh_degree in (4, 3):
        for req in CAMERAS:
            cam = camera_arrays(req, card)
            args = (params, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, sh_degree)
            with torch.no_grad():
                got, want = PF.project_points_fused(*args), PG.project_points_eager(*args)
            torch.cuda.synchronize()
            assert_same(got, want, f"stored degree 4, degree {sh_degree}, {req}")


@pytest.mark.card
def test_kernel_on_a_ragged_count_and_unaligned_rows(gs360):
    """100,003 Gaussians (the last warp holds 3) and the same rows one
    Gaussian further on (no input on a 16-byte boundary: every row is
    copied by scalar loads)."""
    params, state = gs360
    cam = camera_arrays(CAMERAS[0], params.xyz.device)
    for lo in (0, 1):
        p = PG.PointGaussianParams(*(t[lo:lo + 100_003] for t in params))
        alive = state.alive[lo:lo + 100_003]
        with torch.no_grad():
            got = PF.project_points_fused(p, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, 3)
            want = PG.project_points_eager(p, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, 3)
        torch.cuda.synchronize()
        assert_same(got, want, f"100,003 Gaussians from {lo}")


@pytest.mark.card
def test_no_gaussians_launch_nothing(gs360):
    params, state = gs360
    cam = camera_arrays(CAMERAS[0], params.xyz.device)
    empty = PG.PointGaussianParams(*(t[:0] for t in params))
    launches = kernels.LAUNCHES["front"]
    got = PF.project_points_fused(empty, state.alive[:0], cam, WIDTH, HEIGHT, TAN_X,
                                  TAN_Y, 3)
    assert kernels.LAUNCHES["front"] == launches
    assert got.xy.shape == (0, 2) and got.valid.shape == (0,)


@pytest.mark.card
def test_served_frame_equals_the_frame_of_the_pytorch_front_end(gs360):
    params, state = gs360
    cam = camera_arrays(CAMERAS[1], params.xyz.device)
    bg = tuple(float(c) for c in CFG["image"]["background"])
    before, launches = dict(PG.COUNTS), kernels.LAUNCHES["front"]
    rgb, _, radii = PG.render_points(params, state, cam, WIDTH, HEIGHT, TAN_X, TAN_Y,
                                     bg, 3)
    assert kernels.LAUNCHES["front"] == launches + 1
    assert PG.COUNTS["front_fused"] == before.get("front_fused", 0) + 1
    assert PG.COUNTS["front_eager"] == before.get("front_eager", 0)
    with torch.no_grad():
        proj = PG.project_points_eager(params, state.alive, cam, WIDTH, HEIGHT, TAN_X,
                                       TAN_Y, 3)
        want = rasterize_tiled_fwd(proj, WIDTH, HEIGHT, bg, pack_order="exact")[0]
    assert torch.equal(radii, proj.radius)
    assert torch.equal(rgb, want)


@pytest.mark.card
def test_fit_static_scene_takes_the_pytorch_ops_on_the_card(card):
    """The fit's leaves need a gradient: every iteration's front end runs the
    PyTorch ops, never the kernel."""
    rng = np.random.default_rng(0)
    cloud = types.SimpleNamespace(
        points=rng.normal(0.0, 0.5, (500, 3)).astype(np.float32),
        colors=rng.uniform(0.0, 1.0, (500, 3)).astype(np.float32))
    cams = [camera_arrays(req, card) for req in CAMERAS]
    gts = [torch.rand(3, 64, 64, device=card) for _ in cams]
    before, launches = dict(PG.COUNTS), kernels.LAUNCHES["front"]
    PG.fit_static_scene(cams, gts, cloud, 64, 64, TAN_X, TAN_Y, sh_degree=1,
                        iterations=3, device=card)
    assert kernels.LAUNCHES["front"] == launches
    assert PG.COUNTS["front_eager"] == before.get("front_eager", 0) + 3
    assert PG.COUNTS["front_fused"] == before.get("front_fused", 0)
