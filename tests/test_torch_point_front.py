"""The point front end's kernels (``csrc/point_front.cu``, called by
``ops.point_front.project_points_fused``, and its backward
``csrc/point_front_bwd.cu``, called by
``ops.point_front.project_points_backward_fused``, the two behind one
autograd function, ``project_points_autograd``) against the PyTorch ops
they replace (``models.point_gaussians.project_points_eager`` and autograd
through it).

On the CPU (tier 1): which path a call takes (CPU tensors take the PyTorch
ops, with or without a gradient; ``serving`` still picks
``render_points``' rasterizer), the counter ``COUNTS`` (one a call), the
wrappers' checks, which raise before any library is loaded and launch
nothing, the backward's plain version (``project_points_backward_plain``)
against autograd through the PyTorch ops at SH degrees 0-4 and both caps
with edge cases planted, the autograd function's wiring with the plain
versions in the kernels' place, and chip_smoke's build phase, which needs
every SH degree of the three passes in its build log.

On the card (marker ``card``, skipped without CUDA; this file imports no
JAX, so it runs without the suite's conftest:
``python -m pytest tests/test_torch_point_front.py -m card --noconftest``):
the forward kernel's ``ProjectedGaussians`` against the PyTorch ops on the
benchmark's gs-360-3m field (3.0M Gaussians, ``make_field``) at three
``orbit-360`` cameras, at SH degrees 0-3 (and 3-4 on a field stored at
degree 4), uncapped and capped at 24 px, with dead slots, Gaussians at and
behind the camera, off-screen Gaussians and zero quaternions planted; a
count that is not a multiple of 32 and rows off a 16-byte boundary; no
launch for no Gaussians; ``render_points``' frame against the frame of the
PyTorch front end, with one launch of the kernel; the backward kernel
against its plain version and autograd on the same field with the
cotangents of a real K3 backward (degrees 0-4, both caps, ragged and
unaligned rows), one ``PointTrainer.step`` on the kernels against the same
step on the PyTorch ops, a camera needing a gradient taking the PyTorch
ops, and ``fit_static_scene`` on the kernels, one launch of each an
iteration.
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
    monkeypatch.setattr(PG, "project_points_autograd", refuse)
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
    """On the CPU, leaves that need a gradient take the PyTorch ops, and
    ``serving`` (which picks ``render_points``' rasterizer) is False for
    them while autograd records; on the card they take the kernels
    (``test_trainer_step_on_the_kernels_equals_the_pytorch_ops``)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(PG, "project_points_fused", refuse)
    monkeypatch.setattr(PG, "project_points_autograd", refuse)
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


# the backward on the CPU: its plain version against autograd

PLANTED = {"near": range(0, 10), "behind": range(10, 20), "clamp_x": range(20, 30),
           "clamp_y": range(30, 40), "dark": range(40, 50), "tie": range(50, 53),
           "dead": range(60, 70), "unreached": range(70, 80)}


def tie_dc() -> float:
    """A DC coefficient whose colour sits exactly on the clamp:
    float32(C0) x dc = -0.5, so max(sum + 0.5, 0) reads max(0, 0)."""
    from cloth_splatting_tpu_torch.ops.sh import C0

    c0 = torch.tensor(C0, dtype=torch.float32)
    dc = torch.tensor(-0.5 / C0, dtype=torch.float32)
    for _ in range(8):
        if float(c0 * dc) == -0.5:
            return float(dc)
        dc = torch.nextafter(dc, torch.tensor(-10.0) if float(c0 * dc) > -0.5
                             else torch.tensor(10.0))
    raise AssertionError("no float32 DC coefficient lands the colour on 0")


def planted_field(n: int, stored: int, seed: int = SEED):
    """(params, alive, cam, zero rows) on the CPU: the gs-360-3m field at n
    Gaussians stored at SH degree ``stored``, seen from CAMERAS[0], with
    PLANTED's rows moved: in front of the camera inside the near cull
    (camera z 0.05-0.14), behind it, far to its side and far above it
    (txtz and tytz clamped at +-1.3 tan(fov/2), off screen), dark (every
    channel clamped at 0), on the clamp's tie, dead (alive False) and
    unreached; the last two are the zero rows, whose cotangents the
    rasterizer leaves at zero."""
    f = make_field({**CFG, "gaussians": n, "sh_degree": stored}, seed, "cpu")
    cam = camera_arrays(CAMERAS[0], "cpu")
    centre = cam.camera_center
    fwd = -centre / torch.linalg.norm(centre)
    side = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0]))
    side = side / torch.linalg.norm(side)
    up = torch.linalg.cross(side, fwd)
    xyz, fdc, frest = f["xyz"].clone(), f["features_dc"].clone(), f["features_rest"].clone()
    for i, k in enumerate(PLANTED["near"]):
        xyz[k] = centre + (0.05 + 0.01 * i) * fwd + 0.01 * side
    for i, k in enumerate(PLANTED["behind"]):
        xyz[k] = centre - (0.5 + 0.1 * i) * fwd
    for i, k in enumerate(PLANTED["clamp_x"]):
        xyz[k] = centre + 3.0 * fwd + (8.0 + i) * side
    for i, k in enumerate(PLANTED["clamp_y"]):
        xyz[k] = centre + 3.0 * fwd - (6.0 + i) * up
    fdc[list(PLANTED["dark"])] = -5.0
    fdc[list(PLANTED["tie"])] = tie_dc()
    frest[list(PLANTED["tie"])] = 0.0
    params = PG.PointGaussianParams(**{**f, "xyz": xyz, "features_dc": fdc,
                                       "features_rest": frest})
    alive = torch.ones(n, dtype=torch.bool)
    alive[list(PLANTED["dead"])] = False
    zero = torch.zeros(n, dtype=torch.bool)
    zero[list(PLANTED["dead"]) + list(PLANTED["unreached"])] = True
    return params, alive, cam, zero


def random_cotangents(proj, zero, gen):
    """Standard-normal cotangents of (xy, depth, conic, color, opacity), zero
    on the rows ``zero``."""
    outs = (proj.xy, proj.depth, proj.conic, proj.color, proj.opacity)
    cots = [torch.randn(t.shape, generator=gen, device=t.device) for t in outs]
    return [torch.where(zero.view(-1, *[1] * (c.dim() - 1)), torch.zeros_like(c), c)
            for c in cots]


def leaf_gaps(got, want) -> dict:
    """Per leaf: |got - want| over |want| (norms), and whether got's row is
    all zeros wherever want's is (dead, invalid and unreached Gaussians, SH
    coefficients above the degree; a single element of a live row may
    cancel to an exact zero in one order of summation and not in the
    other)."""
    out = {}
    for name, a, b in zip(PG.PointGaussianParams._fields, got, want):
        b = torch.zeros_like(a) if b is None else b
        rows_a, rows_b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        if name == "features_rest":
            rows_a, rows_b = a.reshape(-1, 3), b.reshape(-1, 3)
        zero = ~(rows_b != 0).any(1)
        out[name] = (float((a - b).norm() / b.norm().clamp_min(1e-30)),
                     bool((rows_a[zero] == 0).all()))
    return out


@pytest.mark.parametrize("max_radius", [None, 24.0])
@pytest.mark.parametrize("sh_degree,stored", [(0, 3), (1, 3), (2, 3), (3, 3), (4, 4),
                                              (3, 4)])
def test_plain_backward_equals_autograd(sh_degree, stored, max_radius):
    """``project_points_backward_plain`` against ``torch.autograd.grad``
    through ``project_points_eager`` on PLANTED's field: each leaf within
    1e-5 of autograd's norm (read: at most 3.7e-7, the rotation's), exact
    zeros wherever autograd's rows are (the dead and unreached rows, the SH
    coefficients above the degree, the dark colours), and the tie's
    colour passing its gradient as ``clamp_min`` does."""
    n = 2000
    params, alive, cam, zero = planted_field(n, stored)
    leaves = PG.PointGaussianParams(*(p.clone().requires_grad_() for p in params))
    proj = PG.project_points_eager(leaves, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y,
                                   sh_degree, max_radius)
    for key in ("near", "behind", "clamp_x", "clamp_y", "dead"):
        assert not proj.valid[list(PLANTED[key])].any(), key
    assert bool((proj.color[list(PLANTED["tie"])] == 0.0).all())
    cots = random_cotangents(proj, zero, torch.Generator().manual_seed(SEED))
    want = torch.autograd.grad([proj.xy, proj.depth, proj.conic, proj.color, proj.opacity],
                               list(leaves), cots, allow_unused=True)
    got = PF.project_points_backward_plain(params, proj.valid.detach(), cam, WIDTH, HEIGHT,
                                           TAN_X, TAN_Y, sh_degree, *cots)
    gaps = leaf_gaps(got, want)
    print(f"degree {sh_degree} (stored {stored}), max_radius {max_radius}: {gaps}")
    assert all(rel <= 1e-5 and zeros for rel, zeros in gaps.values()), gaps
    for g in got:
        assert bool((g[zero] == 0).all())
    assert bool((got.features_rest[:, (sh_degree + 1) ** 2 - 1:] == 0).all())
    assert bool((got.features_dc[list(PLANTED["dark"])] == 0).all())
    assert bool((got.features_dc[list(PLANTED["tie"])] != 0).all())


def test_autograd_function_wires_the_backward(monkeypatch):
    """``project_points_autograd`` on the CPU with the plain versions in the
    kernels' place: its outputs are the PyTorch ops', radius, valid and
    power_cut need no gradient, the leaves' gradients (a loss of every
    differentiable output) equal ``project_points_backward_plain``'s on the
    cotangents autograd hands the function, within 1e-5 of autograd's
    through the PyTorch ops, and a leaf that needs none gets none."""
    seen = []

    def fused(params, alive, cam, *geometry):
        return PG.project_points_eager(params, alive, cam, *geometry)

    def backward(params, valid, cam, *rest):
        seen.append(rest[5:])
        return PF.project_points_backward_plain(params, valid, cam, *rest)

    monkeypatch.setattr(PF, "project_points_fused", fused)
    monkeypatch.setattr(PF, "project_points_backward_fused", backward)
    params, alive, cam, zero = planted_field(1000, 3)

    def leaves():
        return PG.PointGaussianParams(*(p.clone().requires_grad_(name != "opacity")
                                        for name, p in zip(PG.PointGaussianParams._fields,
                                                           params)))

    mine, theirs = leaves(), leaves()
    got = PF.project_points_autograd(mine, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, 2)
    want = PG.project_points_eager(theirs, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(t.requires_grad for t in (got.radius, got.valid, got.power_cut))
    cots = random_cotangents(want, zero, torch.Generator().manual_seed(SEED))

    def loss(p):
        return sum((t * c).sum() for t, c in zip((p.xy, p.depth.clamp_max(1e6), p.conic,
                                                  p.color, p.opacity), cots))

    loss(got).backward()
    loss(want).backward()
    assert len(seen) == 1
    assert mine.opacity.grad is None and theirs.opacity.grad is None
    gaps = leaf_gaps([p.grad for p in mine[:-1]], [p.grad for p in theirs[:-1]])
    assert all(rel <= 1e-5 and zeros for rel, zeros in gaps.values()), gaps


@pytest.mark.parametrize("case,message", [
    ("cotangent_shape", "the cotangent of conic must be"),
    ("cotangent_dtype", "the cotangent of xy must be"),
    ("valid_dtype", "valid must be torch.bool"), ("degree", "SH degree"),
    ("device", "one CUDA device")])
def test_backward_wrapper_checks_raise_before_any_library_loads(monkeypatch, case,
                                                                message):
    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(kernels, "load", refuse)
    PF._bwd_launcher.cache_clear()
    params, state = field(64, "cpu")
    cam, deg, valid = camera_arrays(CAMERAS[0], "cpu"), 3, state.alive
    rows = torch.zeros(64, 16)
    cots = [rows[:, 0:2], rows[:, 9], rows[:, 2:5], rows[:, 5:8], rows[:, 8]]
    if case == "cotangent_shape":
        cots[2] = rows[:, 2:4]
    elif case == "cotangent_dtype":
        cots[0] = cots[0].double()
    elif case == "valid_dtype":
        valid = valid.float()
    elif case == "degree":
        deg = 5
    launches = kernels.LAUNCHES["front_bwd"]
    with pytest.raises(ValueError, match=message):
        PF.project_points_backward_fused(params, valid, cam, WIDTH, HEIGHT, TAN_X, TAN_Y,
                                         deg, *cots)
    assert kernels.LAUNCHES["front_bwd"] == launches


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
    ("bwd_degree_missing", "point_front_bwd_kernel<1>"),
    ("bwd_spills", "point_front_bwd_kernel<4> spills"),
    ("span_missing", "tiled_bwd_reverse_kernel<4>")])
def test_chip_smoke_spill_check_needs_every_entry(case, message):
    """chip_smoke's build phase fails on a spill, and on a span kernel or SH
    degree of the point front end, its backward or the cloth front end that
    its build log does not hold."""
    import chip_smoke as cs

    entries = {cs.KERNEL_ENTRIES[key]: 0 for key in cs.SPAN_KERNELS}
    entries.update({f"{front}_kernel<{deg}>": 0 for front in
                    ("point_front", "cloth_front", "point_front_bwd") for deg in range(5)})
    if case == "front_degree_missing":
        del entries["point_front_kernel<4>"]
    elif case == "front_spills":
        entries["point_front_kernel<2>"] = 16
    elif case == "cloth_degree_missing":
        del entries["cloth_front_kernel<0>"]
    elif case == "cloth_spills":
        entries["cloth_front_kernel<3>"] = 8
    elif case == "bwd_degree_missing":
        del entries["point_front_bwd_kernel<1>"]
    elif case == "bwd_spills":
        entries["point_front_bwd_kernel<4>"] = 24
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


def structural_zeros(grads, valid, cots, sh_degree) -> bool:
    """Whether ``grads`` are exact zeros on every row whose cotangents are
    all zero (the depth's counted only where ``valid``: dead slots, invalid
    Gaussians, those no pixel reached) and in the SH coefficients above
    ``sh_degree``. (Elsewhere a gradient may round to a denormal in one
    order of operations and to 0 in another: autograd's 0 against the
    kernel's ~5e-44 on the card.)"""
    g_xy, g_depth, g_conic, g_color, g_opacity = cots
    reached = ((g_xy != 0).any(1) | ((g_depth != 0) & valid) | (g_conic != 0).any(1)
               | (g_color != 0).any(1) | (g_opacity != 0))
    rows = all(bool((g.reshape(g.shape[0], -1)[~reached] == 0).all()) for g in grads)
    return rows and bool((grads.features_rest[:, (sh_degree + 1) ** 2 - 1:] == 0).all())


def backward_on_the_card(params, alive, cam, sh_degree, max_radius, label, seed=SEED):
    """The backward kernel through a real training step's chain: the front
    end on the kernels (``project_points_autograd``), the training
    rasterizer (K2, K3) and a loss of the frame against a random image,
    against the same chain through ``project_points_eager``, whose outputs
    are the same bits, so K3 hands both the same cotangents. Checks one
    ``front_bwd`` launch, that the cotangents reach the kernel as views of
    K3's [C, 16] per-Gaussian rows (no copy), each leaf within 1e-5 of
    autograd's norm and of the plain version's on those cotangents (read on
    the H100: at most 1.9e-6, the rotation's against the plain version),
    and ``structural_zeros``. Returns the gaps."""
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import rasterize_tiled_train

    dev = params.xyz.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    target = torch.rand((3, HEIGHT, WIDTH), generator=gen, device=dev)
    seen = []
    real = PF.project_points_backward_fused

    def backward(params, valid, cam, *rest):
        seen.append((params, valid, rest))
        return real(params, valid, cam, *rest)

    def grads(project):
        leaves = PG.PointGaussianParams(*(p.detach().clone().requires_grad_()
                                          for p in params))
        proj = project(leaves, alive, cam, WIDTH, HEIGHT, TAN_X, TAN_Y, sh_degree,
                       max_radius)
        rgb = rasterize_tiled_train(proj, WIDTH, HEIGHT, (0.0, 0.0, 0.0))[0]
        return PG.PointGaussianParams(*torch.autograd.grad((rgb * target).sum(),
                                                           list(leaves)))

    PF.project_points_backward_fused = backward
    try:
        launches = kernels.LAUNCHES["front_bwd"]
        got = grads(PF.project_points_autograd)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["front_bwd"] == launches + 1
    finally:
        PF.project_points_backward_fused = real
    want = grads(PG.project_points_eager)
    (_, valid, rest), = seen
    cots = rest[5:]
    assert all(t.stride(0) == 16 for t in cots), [t.stride() for t in cots]
    plain = PF.project_points_backward_plain(params, valid, cam, *rest)
    gaps = {"autograd": {k: v[0] for k, v in leaf_gaps(got, want).items()},
            "plain": {k: v[0] for k, v in leaf_gaps(got, plain).items()}}
    print(f"{label}: {gaps}")
    for side in gaps.values():
        assert all(rel <= 1e-5 for rel in side.values()), gaps
    assert structural_zeros(got, valid, cots, sh_degree)
    return gaps


@pytest.mark.card
@pytest.mark.parametrize("max_radius", [None, 24.0])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_backward_kernel_on_the_gs360_field(gs360, sh_degree, max_radius):
    """The backward kernel on the gs-360-3m field with its planted edge
    cases, at the first camera (``backward_on_the_card``)."""
    params, state = gs360
    cam = camera_arrays(CAMERAS[0], params.xyz.device)
    backward_on_the_card(params, state.alive, cam, sh_degree, max_radius,
                         f"backward, degree {sh_degree}, max_radius {max_radius}")


@pytest.mark.card
def test_backward_kernel_at_sh_degree_4_ragged_and_unaligned(gs360, card):
    """The backward kernel on a field stored at SH degree 4 (at degrees 4
    and 2: the coefficients above the degree zero), and on 100,003 of the
    gs-360-3m field's Gaussians (the last warp holds 3) from the first and
    from the second (no row on a 16-byte boundary)."""
    n = 300_000
    params = PG.PointGaussianParams(**make_field({**CFG, "gaussians": n, "sh_degree": 4},
                                                 SEED, card))
    alive = torch.rand(n, device=card) > 0.1
    cam = camera_arrays(CAMERAS[1], card)
    for sh_degree in (4, 2):
        backward_on_the_card(params, alive, cam, sh_degree, None,
                             f"backward, stored degree 4, degree {sh_degree}")
    params, state = gs360
    cam = camera_arrays(CAMERAS[0], card)
    for lo in (0, 1):
        p = PG.PointGaussianParams(*(t[lo:lo + 100_003] for t in params))
        backward_on_the_card(p, state.alive[lo:lo + 100_003], cam, 3, None,
                             f"backward, 100,003 Gaussians from {lo}")


@pytest.mark.card
def test_trainer_step_on_the_kernels_equals_the_pytorch_ops(gs360, monkeypatch):
    """One ``PointTrainer.step`` on 500,000 of the gs-360-3m field's
    Gaussians through the kernels (the forward and its backward once each,
    K2 and K3 once each) against the same step with the PyTorch ops in the
    front end's place: the same loss bits and NDC statistic, and Adam's
    first moments (a tenth of the gradients) within 1e-5 of each leaf's
    norm."""
    from cloth_splatting_tpu_torch.train import points as TP
    from cloth_splatting_tpu_torch.train.step import adam_init

    params, state = gs360
    n = 500_000
    params = PG.PointGaussianParams(*(t[:n].contiguous() for t in params))
    state = PG.PointGaussianState(*(t[:n].contiguous() for t in state))
    cam = camera_arrays(CAMERAS[2], params.xyz.device)
    gt = torch.rand((3, HEIGHT, WIDTH), generator=torch.Generator(
        device=params.xyz.device).manual_seed(SEED), device=params.xyz.device)
    trainer = TP.PointTrainer(TP.PointOptimization(), WIDTH, HEIGHT, TAN_X, TAN_Y,
                              (0.0, 0.0, 0.0), 3, 4.0)

    def step():
        st = TP.PointTrainState(params, state, adam_init(params))
        out, loss = trainer.step(st, cam, gt, 3_000)
        torch.cuda.synchronize()
        return out, loss

    kernels.LAUNCHES.clear()
    got, loss = step()
    assert dict(kernels.LAUNCHES) == {"front": 1, "front_bwd": 1, "K2": 1, "K3": 1}
    monkeypatch.setattr(PG, "project_points_autograd", PG.project_points_eager)
    want, want_loss = step()
    assert torch.equal(loss, want_loss)
    assert torch.equal(got.gstate.grad_accum, want.gstate.grad_accum)
    gaps = {k: rel for k, (rel, _) in leaf_gaps(got.opt.mu, want.opt.mu).items()}
    print(f"trainer step: loss {float(loss)}, {gaps}")
    assert all(rel <= 1e-5 for rel in gaps.values()), gaps


@pytest.mark.card
def test_camera_needing_a_gradient_takes_the_pytorch_ops(gs360):
    """A camera tensor that needs a gradient sends the call to the PyTorch
    ops, with or without leaves needing one."""
    params, state = gs360
    n = 10_000
    params = PG.PointGaussianParams(*(t[:n].clone().requires_grad_() for t in params))
    state = PG.PointGaussianState(*(t[:n] for t in state))
    cam = camera_arrays(CAMERAS[0], params.xyz.device)
    cam = cam._replace(world_view=cam.world_view.clone().requires_grad_())
    before, launches = dict(PG.COUNTS), dict(kernels.LAUNCHES)
    proj = front(params, state, cam)
    proj.conic.sum().backward()
    assert cam.world_view.grad is not None
    assert PG.COUNTS["front_eager"] == before.get("front_eager", 0) + 1
    assert PG.COUNTS["front_fused"] == before.get("front_fused", 0)
    assert dict(kernels.LAUNCHES) == launches


@pytest.mark.card
def test_fit_static_scene_takes_the_kernels_on_the_card(card):
    """The fit's leaves need a gradient: every iteration's front end runs
    the forward kernel and its backward kernel, once each, and never the
    PyTorch ops."""
    rng = np.random.default_rng(0)
    cloud = types.SimpleNamespace(
        points=rng.normal(0.0, 0.5, (500, 3)).astype(np.float32),
        colors=rng.uniform(0.0, 1.0, (500, 3)).astype(np.float32))
    cams = [camera_arrays(req, card) for req in CAMERAS]
    gts = [torch.rand(3, 64, 64, device=card) for _ in cams]
    before, launches = dict(PG.COUNTS), dict(kernels.LAUNCHES)
    PG.fit_static_scene(cams, gts, cloud, 64, 64, TAN_X, TAN_Y, sh_degree=1,
                        iterations=3, device=card)
    for name in ("front", "front_bwd"):
        assert kernels.LAUNCHES[name] == launches.get(name, 0) + 3, name
    assert PG.COUNTS["front_fused"] == before.get("front_fused", 0) + 3
    assert PG.COUNTS["front_eager"] == before.get("front_eager", 0)
