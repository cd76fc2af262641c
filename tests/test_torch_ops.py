"""PyTorch port vs the JAX package: the render front end.

Quaternions, SH, EWA projection, mesh anchoring, simulators, kNN and the
scene builders. Inputs come from numpy with a fixed seed and go through both
packages; JAX state crosses into the port through ``convert``. Tolerance:
atol 1e-5 (float32 arithmetic in a different order), plus rtol 1e-4 for
conics, whose entries scale like 1/det and reach ~1e2 for sharp splats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cloth_splatting_tpu.data import meshing as jmeshing
from cloth_splatting_tpu.data import synthetic as jsynthetic
from cloth_splatting_tpu.models import deform as jdeform
from cloth_splatting_tpu.models import gaussians as jG
from cloth_splatting_tpu.ops import knn as jknn
from cloth_splatting_tpu.ops import projection as jproj
from cloth_splatting_tpu.ops import quaternion as jquat
from cloth_splatting_tpu.ops import sh as jsh
from cloth_splatting_tpu.ops.camera import Camera as JCamera

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data import meshing as tmeshing
from cloth_splatting_tpu_torch.data import synthetic as tsynthetic
from cloth_splatting_tpu_torch.models import deform as tdeform
from cloth_splatting_tpu_torch.models import gaussians as tG
from cloth_splatting_tpu_torch.ops import knn as tknn
from cloth_splatting_tpu_torch.ops import projection as tproj
from cloth_splatting_tpu_torch.ops import quaternion as tquat
from cloth_splatting_tpu_torch.ops import sh as tsh

torch.set_num_threads(1)

ATOL = 1e-5
CPU = "cpu"


def arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def close(torch_value, jax_value, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(torch_value.detach().cpu().numpy(),
                               np.asarray(jax_value), atol=atol, rtol=rtol)


def t(a):
    return torch.from_numpy(np.array(a))


def test_quat_to_rotmat():
    q = np.random.default_rng(0).normal(size=(257, 4)).astype(np.float32)
    close(tquat.quat_to_rotmat(t(q)), jquat.quat_to_rotmat(jnp.asarray(q)))


def test_rotmat_to_quat_all_branches():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(256, 4)).astype(np.float32)
    # rotations by ~pi about each axis make the x, y and z branches win
    q[:16] = [0.01, 1.0, 0.02, 0.0]
    q[16:32] = [0.01, 0.0, 1.0, 0.03]
    q[32:48] = [0.01, 0.02, 0.0, 1.0]
    m = np.asarray(jquat.quat_to_rotmat(jnp.asarray(q)))
    close(tquat.rotmat_to_quat(t(m)), jquat.rotmat_to_quat(jnp.asarray(m)))


def test_quat_multiply():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(64, 4)).astype(np.float32) for _ in range(2))
    close(tquat.quat_multiply(t(a), t(b)),
          jquat.quat_multiply(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(deg):
    rng = np.random.default_rng(3 + deg)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    close(tsh.eval_sh(deg, t(sh), t(d)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))


def _random_gaussians(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.0, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    return means, scales, quats, colors, opac, alive


def test_build_covariance():
    _, scales, quats, *_ = _random_gaussians(300, 4)
    close(tproj.build_covariance(t(scales), t(quats), 1.3),
          jproj.build_covariance(jnp.asarray(scales), jnp.asarray(quats), 1.3))


@pytest.mark.parametrize("seed", [0, 1])
def test_project_gaussians_all_fields(seed):
    means, scales, quats, colors, opac, alive = _random_gaussians(300, 10 + seed)
    # some behind the near plane, some huge (radius cap + power_cut shrink)
    means[:20, 2] = 4.1
    scales[20:40] *= 30.0
    cam = JCamera.create(R=np.eye(3), t=np.asarray([0.0, 0.0, 4.0]),
                         fovx=2 * np.arctan(0.5), fovy=2 * np.arctan(0.4),
                         width=64, height=48)
    cov_j = jproj.build_covariance(jnp.asarray(scales), jnp.asarray(quats))
    pj = jproj.project_gaussians(
        jnp.asarray(means), cov_j, jnp.asarray(colors), jnp.asarray(opac),
        jnp.asarray(cam.world_view), jnp.asarray(cam.full_proj), 64, 48,
        cam.tanfovx, cam.tanfovy, alive=jnp.asarray(alive))
    cov_t = tproj.build_covariance(t(scales), t(quats))
    pt = tproj.project_gaussians(
        t(means), cov_t, t(colors), t(opac), t(cam.world_view),
        t(cam.full_proj), 64, 48, cam.tanfovx, cam.tanfovy, alive=t(alive))
    assert bool(np.asarray(pj.valid).any()) and not bool(np.asarray(pj.valid).all())
    assert float(np.asarray(pj.power_cut).max()) > jproj.POWER_CUTOFF  # shrunk
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
    np.testing.assert_array_equal(pt.radius.numpy(), np.asarray(pj.radius))
    np.testing.assert_array_equal(pt.depth.numpy(), np.asarray(pj.depth))
    v = np.array(pj.valid)
    close(pt.xy, pj.xy, atol=1e-4)   # pixel units, |xy| up to ~1e2
    close(pt.conic[v], np.asarray(pj.conic)[v], atol=ATOL, rtol=1e-4)
    close(pt.power_cut, pj.power_cut)
    close(pt.color, pj.color)
    close(pt.opacity, pj.opacity)


def _mesh_pair(res=6):
    jm = jmeshing.grid_cloth_mesh(res, res, size=1.2)
    return jm, tmeshing.grid_cloth_mesh(res, res, size=1.2, device=CPU)


def test_grid_cloth_mesh():
    jm, tm = _mesh_pair(7)
    for name in ("faces", "edge_index"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    for name in ("pos", "edge_norm", "normals"):
        close(getattr(tm, name), getattr(jm, name))


def test_positions_and_rotations_on_deformed_mesh():
    jm, _ = _mesh_pair(6)
    rng = np.random.default_rng(5)
    params, state = jG.init_from_mesh(rng, jm, 3, 2, capacity=128)
    verts = np.asarray(jm.pos) + rng.normal(0, 0.05, np.asarray(jm.pos).shape
                                            ).astype(np.float32)
    rot = rng.normal(size=(128, 4)).astype(np.float32)
    params = params._replace(rotation=jnp.asarray(rot))
    tp = convert.gaussian_params(arrays(params), CPU)
    ts = convert.gaussian_state(arrays(state), CPU)
    tm = convert.mesh(arrays(jm), CPU)
    close(tG.gaussian_positions(tp, ts, tm, t(verts)),
          jG.gaussian_positions(params, state, jm, jnp.asarray(verts)))
    close(tG.gaussian_rotations(tp, ts, tm, t(verts)),
          jG.gaussian_rotations(params, state, jm, jnp.asarray(verts)))
    close(tG.gaussian_rotations(tp, ts, tm), jG.gaussian_rotations(params, state, jm))


@pytest.mark.parametrize("kind", ["residual", "embedding"])
def test_simulate_any(kind):
    jm, _ = _mesh_pair(5)
    n_v = int(jm.pos.shape[0])
    rng = np.random.default_rng(6)
    if kind == "residual":
        sim = jdeform.init_residual_simulator(rng, n_v)
        # larger output weights so the residual is visible at atol
        sim = sim._replace(w_out=sim.w_out * 1e3)
    else:
        sim = jdeform.init_embedding_simulator(rng, 3, n_v)
    preds = np.asarray(jm.pos)[None] + rng.normal(0, 0.1, (3, n_v, 3)).astype(np.float32)
    tsim = convert.simulator(arrays(sim), CPU)
    # 0.25 / 0.5 and 0.75 / 0.5 are halves: round half to even -> frames 0, 2
    for time in (0.0, 0.25, 0.4, 0.75, 1.0):
        close(tdeform.simulate_any(tsim, t(preds), torch.tensor(time)),
              jdeform.simulate_any(sim, jnp.asarray(preds), jnp.asarray(time)))


def test_init_residual_simulator_same_draws():
    jsim = jdeform.init_residual_simulator(np.random.default_rng(7), 20)
    tsim = tdeform.init_residual_simulator(np.random.default_rng(7), 20, device=CPU)
    for name, value in arrays(jsim).items():
        np.testing.assert_array_equal(getattr(tsim, name).detach().numpy(), value)


def test_mean_knn_sq_dist():
    rng = np.random.default_rng(8)
    # a cloud far from the origin: centring keeps the cross term accurate
    pts = (rng.uniform(-1, 1, (700, 3)) + [30.0, -20.0, 5.0]).astype(np.float32)
    close(tknn.mean_knn_sq_dist(t(pts)), jknn.mean_knn_sq_dist(jnp.asarray(pts)),
          atol=1e-6, rtol=1e-3)


def test_target_gaussians():
    jm, tm = _mesh_pair(6)
    jp, js = jsynthetic.target_gaussians(jm, 3)
    tp, ts = tsynthetic.target_gaussians(tm, 3, device=CPU)
    for name, value in arrays(jp).items():
        close(getattr(tp, name), value)
    for name, value in arrays(js).items():
        np.testing.assert_array_equal(getattr(ts, name).numpy(), value)


# --------------------------------------------------- the breadth helpers

def test_sh_to_rgb_inverts_rgb_to_sh():
    rgb = np.random.default_rng(11).random((64, 3)).astype(np.float32)
    close(tsh.sh_to_rgb(t(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))
    close(tsh.sh_to_rgb(tsh.rgb_to_sh(t(rgb))), rgb, atol=1e-6)
    np.testing.assert_array_equal(tsh.sh_to_rgb(rgb.astype(np.float64)),
                                  jsh.sh_to_rgb(rgb.astype(np.float64)))


def test_bmm33_and_covariance_strip():
    from cloth_splatting_tpu.ops import smallmat as jsmall
    from cloth_splatting_tpu_torch.ops import smallmat as tsmall

    rng = np.random.default_rng(12)
    a, b = (rng.normal(size=(33, 3, 3)).astype(np.float32) for _ in range(2))
    close(tsmall.bmm33(t(a), t(b)), jsmall.bmm33(jnp.asarray(a), jnp.asarray(b)))
    close(tsmall.bmm33(t(a), t(b)), a @ b)
    cov = rng.normal(size=(9, 6)).astype(np.float32)
    close(tproj.covariance_strip(t(cov)), jproj.covariance_strip(jnp.asarray(cov)),
          atol=0.0)


def test_axis_angle_and_rotation_between_normals():
    rng = np.random.default_rng(13)
    axis = rng.normal(size=(40, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, 40).astype(np.float32)
    close(tquat.axis_angle_to_quat(t(axis), t(angle)),
          jquat.axis_angle_to_quat(jnp.asarray(axis), jnp.asarray(angle)))
    na = rng.normal(size=(40, 3)).astype(np.float32)
    nb = rng.normal(size=(40, 3)).astype(np.float32)
    na /= np.linalg.norm(na, axis=-1, keepdims=True)
    nb /= np.linalg.norm(nb, axis=-1, keepdims=True)
    na[:4] = nb[:4] = np.eye(3, dtype=np.float32)[[0, 1, 2, 2]]  # no axis: identity
    q = tquat.rotation_between_normals(t(na), t(nb))
    close(q, jquat.rotation_between_normals(jnp.asarray(na), jnp.asarray(nb)))
    np.testing.assert_array_equal(q[:4].numpy(), np.tile([1.0, 0, 0, 0], (4, 1)))
    r = tquat.quat_to_rotmat(q).numpy()
    close(torch.from_numpy(np.einsum("nij,nj->ni", r, na)), nb, atol=1e-5)


def test_kabsch_rotation_keeps_its_reflection_guard():
    rng = np.random.default_rng(14)
    src = rng.normal(size=(12, 3, 3)).astype(np.float32)
    rot = tquat.quat_to_rotmat(t(rng.normal(size=(12, 4)).astype(np.float32))).numpy()
    dst = np.einsum("nij,npj->npi", rot, src) + rng.normal(size=(12, 1, 3)).astype(np.float32)
    dst[6:] = dst[6:] * np.asarray([-1.0, 1.0, 1.0], np.float32)   # mirrored sets
    r_t = tquat.kabsch_rotation(t(src), t(dst))
    close(r_t, jquat.kabsch_rotation(jnp.asarray(src), jnp.asarray(dst)), atol=1e-5)
    close(r_t[:6], rot[:6], atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r_t.numpy()), 1.0, atol=1e-5)


def test_project_points_and_edge_features():
    from cloth_splatting_tpu.ops.camera import project_points as jproject
    from cloth_splatting_tpu_torch.ops.camera import project_points as tproject

    cam = JCamera.create(R=np.eye(3), t=np.asarray([0.1, -0.2, 3.0]), fovx=0.8,
                         fovy=0.7, width=64, height=48)
    pts = np.random.default_rng(15).normal(0, 0.5, (50, 3)).astype(np.float32)
    close(tproject(t(pts), t(cam.full_proj), 64, 48),
          jproject(jnp.asarray(pts), jnp.asarray(cam.full_proj), 64, 48), atol=1e-4)
    jm, tm = _mesh_pair(5)
    for a, b in zip(tG.compute_edge_features(tm.pos, tm.edge_index),
                    jG.compute_edge_features(jm.pos, jm.edge_index)):
        close(a, b)
