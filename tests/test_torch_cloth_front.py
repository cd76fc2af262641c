"""The cloth field's front-end kernel (the ``MeshAnchored`` pass of
``csrc/point_front.cu``, called by ``ops.cloth_front.project_cloth_fused``)
against the PyTorch ops it replaces on the serving path
(``render.project_view_eager``).

On the CPU (tier 1): which path ``render.project_view`` takes (CPU tensors
take the PyTorch ops; ``serving`` says no wherever autograd is on and a
parameter, a simulator weight or another input needs a gradient), the
counter ``render.COUNTS`` (one a call), and the wrapper's checks, which
raise before any library is loaded and launch nothing.

On the card (marker ``card``, skipped without CUDA; this file imports no
JAX, so it runs without the suite's conftest:
``python -m pytest tests/test_torch_cloth_front.py -m card --noconftest``):
the kernel's ``ProjectedGaussians``, means and rotations against the
PyTorch ops bit for bit, on the benchmark's cs-field-65k scene (64,516
Gaussians at capacity 65,536, 800x800, SH 3) at several cameras and times;
at SH degrees 0-4; on a count that is not a multiple of 32 and rows off a
16-byte boundary, with dead slots; on degenerate (zero-area) faces and on
rotations that force each of ``rotmat_to_quat``'s four constructions; on
Gaussians behind the near plane and off screen; for ``render_static``,
``override_vertices``, ``override_color``, ``scaling_modifier``,
``screen_offset`` and an ``EmbeddingSimulator``; the served frame with one
launch of the kernel and one of K1; no launch for no Gaussians; and leaves
that need a gradient on the PyTorch ops.
"""

import json
import math
import os
import sys

import pytest
import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch import render as R
from cloth_splatting_tpu_torch.models.deform import (
    EmbeddingSimulator,
    simulator_from_params,
)
from cloth_splatting_tpu_torch.ops import cloth_front as CF
from cloth_splatting_tpu_torch.ops.quaternion import quat_to_rotmat
from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import rasterize_tiled_fwd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.drivers import splat_common  # noqa: E402
from benchmark.harness import scene as scene_mod  # noqa: E402

torch.set_num_threads(1)

with open(os.path.join(ROOT, "benchmark", "configs", "cs-field-65k.json")) as _f:
    CFG = json.load(_f)
SEED = 2147483777
# (azimuth, elevation, radius, time) inside novel-views' ranges
CAMERAS = ((-0.8, 0.3, 2.7, 0.15), (0.4, 0.65, 3.3, 0.55), (1.1, 0.25, 2.9, 0.95))


class Scene:
    """A cs configuration's scene in the program's types: mesh, field,
    simulator and predicted trajectory, and its cameras."""

    def __init__(self, cfg, device, seed=SEED):
        sc = scene_mod.make_scene(cfg, seed, device)
        self.cfg, self.dev = cfg, device
        self.params, self.state = splat_common.program_field(
            sc["target"], sc["face_ids"], sc["alive"])
        self.mesh = splat_common.program_mesh(sc["mesh"])
        self.sim = simulator_from_params({k: v.clone() for k, v in sc["sim"].items()})
        self.preds = sc["predictions"]
        img = cfg["image"]
        self.width, self.height = img["width"], img["height"]
        self.tan = math.tan(img["fov"] / 2)

    def camera(self, req):
        img = self.cfg["image"]
        cam = scene_mod.look_at(*req[:3], img["fov"], self.width, self.height, req[3],
                                self.dev)
        return splat_common.camera_arrays(cam)

    def args(self, cam, params=None, state=None, sim="scene", sh_degree=None):
        return (cam, self.width, self.height, self.tan, self.tan,
                self.params if params is None else params,
                self.state if state is None else state, self.mesh,
                self.sim if sim == "scene" else sim, self.preds,
                self.cfg["sh_degree"] if sh_degree is None else sh_degree)


def small_cfg(sh_degree=3):
    """cs-field-65k cut to a 10 x 10 grid (324 Gaussians, capacity 512) at
    96 x 96."""
    return {**CFG, "sh_degree": sh_degree, "capacity": 512,
            "mesh": {**CFG["mesh"], "vertices_per_side": 10},
            "image": {**CFG["image"], "width": 96, "height": 96}}


# ------------------------------------------------------------------ CPU


@pytest.fixture(scope="module")
def small():
    return Scene(small_cfg(), torch.device("cpu"))


def test_cpu_calls_take_the_pytorch_ops(monkeypatch, small):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(R, "project_cloth_fused", refuse)
    cam = small.camera(CAMERAS[0])
    before = dict(R.COUNTS)
    with torch.no_grad():
        got = R.project_view(*small.args(cam))
        want = R.project_view_eager(*small.args(cam))
    assert dict(R.COUNTS) == {**before, "front_eager": before.get("front_eager", 0) + 1}
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    assert int(want[0].valid.sum()) > 0


LEAVES = ("params", "simulator", "mesh_predictions", "screen_offset",
          "override_color", "override_vertices")


@pytest.mark.parametrize("leaf", LEAVES)
def test_a_leaf_that_needs_a_gradient_takes_the_pytorch_ops(small, leaf):
    """``serving`` is the rule the dispatch applies beside the device: it
    says no when autograd is on and any input of the view needs a gradient,
    yes under ``torch.no_grad`` and when nothing needs one."""
    c = small.params.face_bary.shape[0]
    inputs = {"params": small.params, "simulator": small.sim,
              "mesh_predictions": small.preds, "screen_offset": torch.zeros(c, 2),
              "override_color": torch.zeros(c, 3),
              "override_vertices": small.mesh.pos.clone()}
    sim = simulator_from_params({k: p.detach().clone()
                                 for k, p in small.sim.named_parameters()})
    for p in sim.parameters():
        p.requires_grad_(False)
    inputs["simulator"] = sim

    def rule():
        return R.serving(inputs["params"], inputs["simulator"],
                         *(inputs[k] for k in LEAVES[2:]), small.mesh.pos)

    assert rule()
    if leaf == "params":
        inputs[leaf] = type(small.params)(*(p.clone().requires_grad_()
                                            for p in small.params))
    elif leaf == "simulator":
        inputs[leaf] = small.sim                 # nn.Parameters need a gradient
    else:
        inputs[leaf] = inputs[leaf].clone().requires_grad_()
    assert not rule()
    with torch.no_grad():
        assert rule()


@pytest.mark.parametrize("grad", [False, True])
def test_counts_add_one_a_call(small, grad):
    params = small.params
    if grad:
        params = type(params)(*(p.clone().requires_grad_() for p in params))
    cam = small.camera(CAMERAS[1])
    total = sum(R.COUNTS.values())
    eager = R.COUNTS["front_eager"]
    for i in range(3):
        R.project_view(*small.args(cam, params=params))
        assert sum(R.COUNTS.values()) == total + i + 1
    R.render(*small.args(cam, params=params)[:10], CFG["image"]["background"], 3,
             backend="tiled_train" if grad else "tiled_fwd", device="cpu")
    assert sum(R.COUNTS.values()) == total + 4
    assert R.COUNTS["front_eager"] == eager + 4


def _bad_inputs(small, case):
    """project_cloth_fused's arguments on the CPU, broken as ``case`` says."""
    params, state, mesh = small.params, small.state, small.mesh
    cam, verts, deg, kw = small.camera(CAMERAS[0]), mesh.pos.clone(), 3, {}
    c = params.face_bary.shape[0]
    if case == "degree":
        deg = 5
    elif case == "dtype":
        params = params._replace(face_bary=params.face_bary.double())
    elif case == "rest_rows":
        params = params._replace(features_rest=params.features_rest[:, :8])
    elif case == "face_ids_dtype":
        state = state._replace(face_ids=state.face_ids.to(torch.int32))
    elif case == "faces_shape":
        mesh = mesh._replace(faces=mesh.faces[:, :2])
    elif case == "vertices_shape":
        verts = verts[:-1]
    elif case == "alive_dtype":
        state = state._replace(alive=state.alive.float())
    elif case == "color_shape":
        kw["override_color"] = torch.zeros(c, 4)
    elif case == "offset_shape":
        kw["screen_offset"] = torch.zeros(c + 1, 2)
    elif case == "camera_shape":
        cam = cam._replace(world_view=cam.world_view[:3])
    return (params, state, mesh, verts, cam, small.width, small.height, small.tan,
            small.tan, deg, True), kw


@pytest.mark.parametrize("case,message", [
    ("degree", "SH degree"), ("dtype", "face_bary must be torch.float32"),
    ("rest_rows", "features_rest must be"),
    ("face_ids_dtype", "face_ids must be torch.int64"), ("faces_shape", "faces must be"),
    ("vertices_shape", "vertices must be"), ("alive_dtype", "alive must be torch.bool"),
    ("color_shape", "override_color must be"), ("offset_shape", "screen_offset must be"),
    ("camera_shape", "world_view must be"), ("device", "one CUDA device")])
def test_wrapper_checks_raise_before_any_library_loads(monkeypatch, small, case,
                                                       message):
    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(kernels, "load", refuse)
    CF._launcher.cache_clear()
    args, kw = _bad_inputs(small, case)
    launches = kernels.LAUNCHES["cloth_front"]
    with pytest.raises(ValueError, match=message):
        CF.project_cloth_fused(*args, **kw)
    assert kernels.LAUNCHES["cloth_front"] == launches


def test_transposed_and_strided_inputs_pass_the_checks_but_the_device(small):
    """Inputs of another layout (a transposed ``world_view``, strided
    vertices) are copied contiguous: the only complaint left is the
    device."""
    args, kw = _bad_inputs(small, "none")
    cam = args[4]
    cam = cam._replace(world_view=cam.world_view.t().contiguous().t())
    verts = torch.zeros(args[3].shape[0], 6)[:, ::2]
    assert not cam.world_view.is_contiguous() and not verts.is_contiguous()
    args = args[:3] + (verts, cam) + args[5:]
    with pytest.raises(ValueError, match="one CUDA device"):
        CF.project_cloth_fused(*args, **kw)


# ----------------------------------------------------------------- card

SKIP_REASON = ("needs a CUDA device (run on the card: python -m pytest "
               "tests/test_torch_cloth_front.py -m card --noconftest)")


@pytest.fixture(scope="module")
def cs65k():
    if not torch.cuda.is_available():
        pytest.skip(SKIP_REASON)
    return Scene(CFG, torch.device("cuda"))


@pytest.fixture(scope="module")
def cs65k_sh4():
    """The scene's field stored at SH degree 4 (24 rest rows), dead slots
    planted."""
    if not torch.cuda.is_available():
        pytest.skip(SKIP_REASON)
    sc = Scene({**CFG, "sh_degree": 4}, torch.device("cuda"))
    gen = torch.Generator(device=sc.dev).manual_seed(SEED)
    sc.state = sc.state._replace(
        alive=sc.state.alive & (torch.rand(sc.state.alive.shape[0], generator=gen,
                                           device=sc.dev) > 0.1))
    return sc


def bits_differ(got, want) -> dict:
    """Per output of ``project_view``: elements whose bits differ (NaNs of
    either sign equal)."""
    out = {}
    named = list(zip(got[0]._fields, got[0], want[0]))
    named += [("vertices", got[1], want[1]), ("means3d", got[2], want[2]),
              ("rotations", got[3], want[3])]
    for name, a, b in named:
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == torch.bool:
            out[name] = int((a != b).sum())
            continue
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        out[name] = int((~same).sum())
    return out


def fused_and_eager(sc, cam, **kw):
    """(the kernel's outputs through ``project_view``, the PyTorch ops'),
    checking that the call took the kernel once."""
    args = sc.args(cam, **{k: kw.pop(k) for k in ("params", "state", "sim",
                                                  "sh_degree") if k in kw})
    with torch.no_grad():
        fused, launches = R.COUNTS["front_fused"], kernels.LAUNCHES["cloth_front"]
        got = R.project_view(*args, **kw)
        assert R.COUNTS["front_fused"] == fused + 1
        assert kernels.LAUNCHES["cloth_front"] == launches + 1
        want = R.project_view_eager(*args, **kw)
    torch.cuda.synchronize()
    return got, want


def assert_same(got, want, label):
    differ = bits_differ(got, want)
    print(f"{label}: {differ}, valid {int(want[0].valid.sum())}")
    assert not any(differ.values()), label


@pytest.mark.card
@pytest.mark.parametrize("req", CAMERAS)
def test_kernel_equals_the_pytorch_ops_at_the_cells_scale(cs65k, req):
    got, want = fused_and_eager(cs65k, cs65k.camera(req))
    valid = int(want[0].valid.sum())
    assert 0.5 * int(cs65k.state.alive.sum()) < valid <= int(cs65k.state.alive.sum())
    assert_same(got, want, f"cs-field-65k {req}")


@pytest.mark.card
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3, 4])
def test_kernel_at_each_sh_degree_with_dead_slots(cs65k_sh4, sh_degree):
    for req in CAMERAS[:2]:
        got, want = fused_and_eager(cs65k_sh4, cs65k_sh4.camera(req),
                                    sh_degree=sh_degree)
        assert_same(got, want, f"degree {sh_degree}, {req}")


@pytest.mark.card
@pytest.mark.parametrize("lo", [0, 1])
def test_kernel_on_a_ragged_count_and_unaligned_rows(cs65k, lo):
    """65,519 Gaussians (the last warp holds 15), from row 0 and from row 1
    (no input on a 16-byte boundary: every row copied by scalar loads)."""
    n = 65_519
    params = type(cs65k.params)(*(t[lo:lo + n] for t in cs65k.params))
    state = type(cs65k.state)(*(t[lo:lo + n] for t in cs65k.state))
    got, want = fused_and_eager(cs65k, cs65k.camera(CAMERAS[0]), params=params,
                                state=state)
    assert_same(got, want, f"{n} Gaussians from {lo}")


def rotation_about(axis, angle, device):
    axis = torch.tensor(axis, dtype=torch.float32)
    axis = axis / torch.linalg.norm(axis)
    half = 0.5 * angle
    q = torch.cat([torch.tensor([math.cos(half)]), math.sin(half) * axis])
    return quat_to_rotmat(q[None])[0].to(device)


@pytest.mark.card
@pytest.mark.parametrize("branch,axis,angle", [
    ("trace", (0.3, 1.0, 0.2), 0.7), ("x", (1.0, 0.05, 0.1), 3.0),
    ("y", (0.05, 1.0, 0.1), 3.0), ("z", (0.1, 0.05, 1.0), 3.0)])
def test_kernel_on_each_rotmat_to_quat_branch_and_degenerate_faces(cs65k, branch,
                                                                   axis, angle):
    """The mesh turned by one rotation, each face bent a little, so that the
    face rotations take the named construction of ``rotmat_to_quat``
    (checked on the PyTorch side), with every 97th vertex moved onto its
    neighbour (zero-area faces)."""
    sc = cs65k
    gen = torch.Generator(device=sc.dev).manual_seed(SEED + len(branch))
    rot = rotation_about(axis, angle, sc.dev)
    verts = sc.mesh.pos @ rot.T + 5e-4 * torch.randn(sc.mesh.pos.shape, generator=gen,
                                                     device=sc.dev)
    moved = torch.arange(0, verts.shape[0] - 1, 97, device=sc.dev)
    verts[moved] = verts[moved + 1]
    from cloth_splatting_tpu_torch.models.gaussians import _triangle_frames
    from cloth_splatting_tpu_torch.ops.smallmat import bmm33_nt

    m = bmm33_nt(_triangle_frames(verts[sc.mesh.faces]),
                 _triangle_frames(sc.mesh.pos[sc.mesh.faces]))
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    x = (tr <= 0) & (m[:, 0, 0] >= m[:, 1, 1]) & (m[:, 0, 0] >= m[:, 2, 2])
    y = (tr <= 0) & ~x & (m[:, 1, 1] >= m[:, 2, 2])
    taken = {"trace": tr > 0, "x": x, "y": y, "z": (tr <= 0) & ~x & ~y}[branch]
    assert int(taken.sum()) > 0.5 * m.shape[0], branch
    got, want = fused_and_eager(sc, sc.camera(CAMERAS[1]), override_vertices=verts)
    assert_same(got, want, f"branch {branch}: {int(taken.sum())} of {m.shape[0]} faces")


@pytest.mark.card
def test_kernel_behind_the_near_plane_and_off_screen(cs65k):
    """Every 101st vertex at the camera's centre, every 103rd behind it and
    every 107th far off its screen."""
    sc = cs65k
    cam = sc.camera(CAMERAS[0])
    centre = cam.camera_center
    verts = sc.mesh.pos.clone()
    verts[::101] = centre
    verts[::103] = centre * 1.5
    verts[::107] = centre + torch.tensor([40.0, -30.0, 5.0], device=sc.dev)
    got, want = fused_and_eager(sc, cam, override_vertices=verts)
    assert_same(got, want, "near and off screen")


@pytest.mark.card
@pytest.mark.parametrize("case", ["render_static", "no_simulator", "override_vertices",
                                  "override_color", "scaling_modifier",
                                  "screen_offset", "embedding_simulator"])
def test_kernel_on_each_option_of_project_view(cs65k, case):
    sc = cs65k
    c = sc.params.face_bary.shape[0]
    gen = torch.Generator(device=sc.dev).manual_seed(SEED + 7)
    kw = {}
    if case == "render_static":
        kw["render_static"] = True
    elif case == "no_simulator":
        kw["sim"] = None
    elif case == "override_vertices":
        kw["override_vertices"] = sc.mesh.pos + 0.01 * torch.randn(
            sc.mesh.pos.shape, generator=gen, device=sc.dev)
    elif case == "override_color":
        kw["override_color"] = torch.rand(c, 3, generator=gen, device=sc.dev)
    elif case == "scaling_modifier":
        kw["scaling_modifier"] = 0.7
    elif case == "screen_offset":
        kw["screen_offset"] = 0.01 * torch.randn(c, 2, generator=gen, device=sc.dev)
    else:
        n_times, v = sc.preds.shape[0], sc.mesh.pos.shape[0]
        kw["sim"] = EmbeddingSimulator(1e-3 * torch.randn(
            n_times, 3 * v, generator=gen, device=sc.dev))
    got, want = fused_and_eager(sc, sc.camera(CAMERAS[2]), **kw)
    if case == "override_color":
        assert got[0].color is kw["override_color"]
    assert_same(got, want, case)


@pytest.mark.card
def test_no_gaussians_launch_nothing(cs65k):
    sc = cs65k
    params = type(sc.params)(*(t[:0] for t in sc.params))
    state = type(sc.state)(*(t[:0] for t in sc.state))
    launches = kernels.LAUNCHES["cloth_front"]
    with torch.no_grad():
        proj, means, rotations = CF.project_cloth_fused(
            params, state, sc.mesh, sc.mesh.pos, sc.camera(CAMERAS[0]), sc.width,
            sc.height, sc.tan, sc.tan, 3, True)
    assert kernels.LAUNCHES["cloth_front"] == launches
    assert proj.xy.shape == (0, 2) and means.shape == (0, 3) and rotations.shape == (0, 4)


@pytest.mark.card
def test_served_frame_launches_the_kernel_and_k1_once(cs65k):
    sc = cs65k
    cam = sc.camera(CAMERAS[1])
    bg = tuple(CFG["image"]["background"])
    order = CFG["program_config"]["OptimizationParams"]["raster_pack_order"]
    kernels.LAUNCHES.clear()
    out = R.render(*sc.args(cam)[:10], bg, 3, backend="tiled_fwd", device=sc.dev,
                   pack_order=order)
    assert dict(kernels.LAUNCHES) == {"cloth_front": 1, "K1": 1}
    with torch.no_grad():
        proj = R.project_view_eager(*sc.args(cam))[0]
        want = rasterize_tiled_fwd(proj, sc.width, sc.height, bg, pack_order=order)[0]
    assert torch.equal(out.radii, proj.radius)
    assert torch.equal(out.rgb, want)


@pytest.mark.card
def test_leaves_that_need_a_gradient_take_the_pytorch_ops_on_the_card(cs65k):
    """A training render (the parameters as leaves that need a gradient):
    the PyTorch ops, and the gradient reaches the leaves."""
    sc = cs65k
    leaves = type(sc.params)(*(p.detach().clone().requires_grad_() for p in sc.params))
    before = dict(R.COUNTS)
    kernels.LAUNCHES.clear()
    out = R.render(*sc.args(sc.camera(CAMERAS[0]), params=leaves)[:10],
                   tuple(CFG["image"]["background"]), 3, backend="tiled_train",
                   device=sc.dev)
    out.rgb.mean().backward()
    assert "cloth_front" not in kernels.LAUNCHES
    assert R.COUNTS["front_eager"] == before.get("front_eager", 0) + 1
    assert R.COUNTS["front_fused"] == before.get("front_fused", 0)
    assert leaves.face_bary.grad is not None and bool(leaves.face_bary.grad.abs().sum() > 0)
