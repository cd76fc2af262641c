"""PyTorch port vs the JAX package: the whole serving slice, and the port's
boundaries (no JAX import, CUDA by default, chip_smoke's refusal to run
without a card).

The tiny scene of ``__graft_entry__._tiny_scene`` (32 px, 6x6 mesh, capacity
512, residual simulator) renders through JAX ``render(...,
backend="pallas_fwd")`` (Pallas in interpret mode on the CPU) and through the
port's ``render`` on the CPU; the state crosses through ``convert``.
Tolerances: 3e-4 rgb/alpha and 3e-3 depth for the images (those of
tests/test_pallas_raster.py), 1e-5 for positions and rotations, radii exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.render import render as jrender

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.render import render as trender

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"rgb": 3e-4, "depth": 3e-3, "alpha": 3e-4}
BG = (1.0, 1.0, 1.0)


def arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def tiny():
    cfg, mesh, params, gstate, sim, preds, cam = graft._tiny_scene()
    port = dict(params=convert.gaussian_params(arrays(params), "cpu"),
                state=convert.gaussian_state(arrays(gstate), "cpu"),
                mesh=convert.mesh(arrays(mesh), "cpu"),
                simulator=convert.simulator(arrays(sim), "cpu"),
                preds=torch.from_numpy(np.array(preds)))
    jax_state = dict(params=params, state=gstate, mesh=mesh, sim=sim, preds=preds)
    return cam, jax_state, port


def render_both(tiny, time, pack_order="fused", **kw):
    import dataclasses

    cam, js, ps = tiny
    cam = dataclasses.replace(cam, time=time)
    jcam = jcamera_arrays(cam)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    out_j = jrender(jcam, cam.width, cam.height, cam.tanfovx, cam.tanfovy,
                    js["params"], js["state"], js["mesh"], js["sim"], js["preds"],
                    jnp.ones(3), 3, backend="pallas_fwd", bg_static=BG,
                    pack_order=pack_order, **jkw)
    out_t = trender(convert.camera_arrays(arrays(jcam), "cpu"), cam.width,
                    cam.height, cam.tanfovx, cam.tanfovy, ps["params"],
                    ps["state"], ps["mesh"], ps["simulator"], ps["preds"], BG, 3,
                    pack_order=pack_order, device="cpu", **tkw)
    return out_j, out_t


def assert_outputs_match(out_j, out_t):
    for name in ("rgb", "depth", "alpha"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   atol=TOL[name], err_msg=name)
    for name in ("means3d", "rotations", "vertices", "projections"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out_t.radii.numpy(), np.asarray(out_j.radii))
    np.testing.assert_array_equal(out_t.visibility.numpy(),
                                  np.asarray(out_j.visibility))
    assert float(out_t.alpha.max()) > 0.1


@pytest.mark.parametrize("pack_order,time", [("fused", 0.5), ("exact", 0.8)])
def test_render_matches_jax(tiny, pack_order, time):
    assert_outputs_match(*render_both(tiny, time, pack_order))


def test_render_static_and_overrides_match_jax(tiny):
    _, js, _ = tiny
    rng = np.random.default_rng(0)
    pos = np.asarray(js["mesh"].pos)
    verts = (pos + rng.normal(0, 0.03, pos.shape)).astype(np.float32)
    colors = rng.uniform(0, 1, (512, 3)).astype(np.float32)   # capacity 512
    assert_outputs_match(*render_both(tiny, 0.5, render_static=True))
    assert_outputs_match(*render_both(tiny, 0.5, override_vertices=verts,
                                      override_color=colors,
                                      scaling_modifier=0.8))


def test_render_screen_offset_matches_jax(tiny):
    offset = np.random.default_rng(1).normal(0, 0.01, (512, 2)).astype(np.float32)
    assert_outputs_match(*render_both(tiny, 0.2, screen_offset=offset))


@pytest.mark.parametrize("case", ["simulator", "static", "overrides", "screen_offset"])
def test_project_view_eager_matches_jax(tiny, case):
    """``project_view_eager`` (the PyTorch ops the card's front-end kernel
    answers bit for bit) on the JAX comparison inputs: its vertices, means,
    rotations, projected means and radii against the JAX package's render
    on the same inputs, and ``project_view`` on the CPU its bits."""
    import dataclasses

    from cloth_splatting_tpu_torch.render import project_view, project_view_eager

    cam, js, ps = tiny
    cam = dataclasses.replace(cam, time=0.35)
    rng = np.random.default_rng(2)
    kw = {}
    if case == "static":
        kw["render_static"] = True
    elif case == "overrides":
        pos = np.asarray(js["mesh"].pos)
        kw = {"override_vertices": (pos + rng.normal(0, 0.03, pos.shape)).astype(np.float32),
              "override_color": rng.uniform(0, 1, (512, 3)).astype(np.float32),
              "scaling_modifier": 0.8}
    elif case == "screen_offset":
        kw["screen_offset"] = rng.normal(0, 0.01, (512, 2)).astype(np.float32)
    jcam = jcamera_arrays(cam)
    out_j = jrender(jcam, cam.width, cam.height, cam.tanfovx, cam.tanfovy,
                    js["params"], js["state"], js["mesh"], js["sim"], js["preds"],
                    jnp.asarray(BG), 3, k_cap=8, k_chunk=4, backend="tiled",
                    **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                       for k, v in kw.items()})
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    args = (convert.camera_arrays(arrays(jcam), "cpu"), cam.width, cam.height,
            cam.tanfovx, cam.tanfovy, ps["params"], ps["state"], ps["mesh"],
            ps["simulator"], ps["preds"], 3)
    with torch.no_grad():
        proj, vertices, means3d, rotations = project_view_eager(*args, **tkw)
        dispatched = project_view(*args, **tkw)
    for name, got in (("vertices", vertices), ("means3d", means3d),
                      ("rotations", rotations), ("projections", proj.xy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(out_j, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(proj.radius.numpy(), np.asarray(out_j.radii))
    assert int(proj.valid.sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(dispatched[0], proj))
    assert all(torch.equal(a, b) for a, b in
               zip(dispatched[1:], (vertices, means3d, rotations)))


def test_render_other_backends_raise(tiny):
    """The dense tier renders as the JAX package's default backend does (same
    tier, values within 1e-5, the same dropped count at a small k_cap); an
    unknown backend raises."""
    cam, js, ps = tiny
    jcam = jcamera_arrays(cam)
    tcam = convert.camera_arrays(arrays(jcam), "cpu")
    args = (tcam, cam.width, cam.height, cam.tanfovx, cam.tanfovy, ps["params"],
            ps["state"], ps["mesh"], ps["simulator"], ps["preds"], BG, 3)
    for k_cap, k_chunk in ((512, 32), (8, 4)):
        out_j = jrender(jcam, cam.width, cam.height, cam.tanfovx, cam.tanfovy,
                        js["params"], js["state"], js["mesh"], js["sim"],
                        js["preds"], jnp.asarray(BG), 3, k_cap=k_cap,
                        k_chunk=k_chunk, backend="tiled")
        out_t = trender(*args, k_cap=k_cap, k_chunk=k_chunk, backend="tiled",
                        device="cpu")
        for name in ("rgb", "depth", "alpha"):
            np.testing.assert_allclose(getattr(out_t, name).detach().numpy(),
                                       np.asarray(getattr(out_j, name)),
                                       atol=1e-5, err_msg=name)
        assert int(out_t.n_dropped) == int(out_j.n_dropped)
    assert int(out_t.n_dropped) > 0
    with pytest.raises(ValueError, match="unknown backend"):
        trender(*args, backend="nope", device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    from cloth_splatting_tpu_torch.data.meshing import grid_cloth_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grid_cloth_mesh(4, 4)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, imports with JAX and the
    JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cloth_splatting_tpu'] = None\n"
        "import cloth_splatting_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert len(names) >= 20, names\n"
        "print('ok', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    """Without a CUDA card, or without the rest of the repo, chip_smoke exits
    non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
