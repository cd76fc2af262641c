"""PyTorch port vs the JAX package: losses, schedules and one train step.

Inputs are made with numpy from a seed and given to both packages; the
state of the step crosses through ``convert``. Tolerances:
  - losses, SSIM, schedules and learning rates: rtol 1e-5 (float32 sums in
    another order; SSIM's blur is a conv here and a banded matmul in JAX),
    their input gradients at 1e-5 times the largest;
  - the step (JAX ``raster_backend="pallas"`` in interpret mode against the
    port's ``tiled_train`` plain versions): loss rtol 1e-5; every gradient
    leaf, Adam's mu and nu and the accumulated screen-gradient norms at
    2e-4 times the leaf's largest magnitude (the rasterizer's gradient
    tolerance); JAX's gradients are read back from its first Adam moment
    (mu = 0.1 g after one step from zero);
  - updated parameters only where |g| > 1e-3 of the leaf's largest: Adam's
    first step moves every element by +-lr whatever the gradient's size, so
    a gradient of 1e-12 in one package and -1e-12 in the other differ by
    2 lr.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.data.meshing import grid_cloth_mesh as jgrid_mesh
from cloth_splatting_tpu.models import gaussians as JG
from cloth_splatting_tpu.ops.camera import Camera
from cloth_splatting_tpu.ops.ssim import ssim as jssim
from cloth_splatting_tpu.render import CameraArrays as JCameraArrays
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.train import losses as jlosses
from cloth_splatting_tpu.train.config import Config as JConfig
from cloth_splatting_tpu.train.schedules import expon_lr as jexpon_lr
from cloth_splatting_tpu.train.step import Trainer as JTrainer

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.ops.ssim import ssim as tssim
from cloth_splatting_tpu_torch.render import CameraArrays as TCameraArrays
from cloth_splatting_tpu_torch.train import losses as tlosses
from cloth_splatting_tpu_torch.train.config import Config as TConfig
from cloth_splatting_tpu_torch.train.config import apply_overrides
from cloth_splatting_tpu_torch.train.schedules import expon_lr as texpon_lr
from cloth_splatting_tpu_torch.train.step import Trainer as TTrainer

torch.set_num_threads(1)

RTOL = 1e-5
TOL_GRAD = 2e-4
FOV = 2 * np.arctan(0.4)


def tree_arrays(x):
    """A JAX NamedTuple tree as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: tree_arrays(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def t(a):
    return torch.from_numpy(np.array(a))


def grad_close(a, b, rel=1e-5, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(a, b, atol=rel * scale, err_msg=err_msg)


def images(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_ssim_matches_jax():
    a, b = images(0, (2, 3, 32, 40)), images(1, (2, 3, 32, 40))
    np.testing.assert_allclose(float(tssim(t(a), t(b))),
                               float(jssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL)
    np.testing.assert_allclose(
        tssim(t(a), t(b), return_map=True).numpy(),
        np.asarray(jssim(jnp.asarray(a), jnp.asarray(b), return_map=True)),
        atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_image_losses_match_jax(masked):
    a, b = images(2, (3, 3, 24, 24)), images(3, (3, 3, 24, 24))
    m = (images(4, (3, 1, 24, 24)) > 0.3).astype(np.float32) if masked else None

    def jloss(x):
        return jlosses.image_losses(x, jnp.asarray(b), 0.2,
                                    None if m is None else jnp.asarray(m))

    (lj, dj), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(a))
    x = t(a).requires_grad_()
    lt, dt = tlosses.image_losses(x, t(b), 0.2, None if m is None else t(m))
    (gt,) = torch.autograd.grad(lt, x)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=RTOL)
    for k in dj:
        np.testing.assert_allclose(float(dt[k].detach()), float(dj[k]), rtol=RTOL)
    grad_close(gt.numpy(), gj, err_msg="image grad")


def test_regularization_matches_jax():
    jm = jgrid_mesh(4, 4, size=1.2)
    tm = convert.mesh(tree_arrays(jm), "cpu")
    rng = np.random.default_rng(5)
    pos = np.asarray(jm.pos)
    verts = (pos[None] + rng.normal(0, 0.05, (3,) + pos.shape)).astype(np.float32)
    verts[1, 3] = verts[0, 3]           # a zero displacement: safe_norm's eps
    base = (pos[None] + rng.normal(0, 0.02, verts.shape)).astype(np.float32)
    kw = dict(lambda_deform_mag=0.01, lambda_rigid=0.3, lambda_momentum=0.1,
              lambda_anchor=0.5)

    lj, gj = jax.value_and_grad(lambda v: jlosses.regularization(
        v, jm, static=False, anchor_base=jnp.asarray(base), **kw))(jnp.asarray(verts))
    v = t(verts).requires_grad_()
    lt = tlosses.regularization(v, tm, static=False, anchor_base=t(base), **kw)
    (gt,) = torch.autograd.grad(lt, v)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=RTOL)
    grad_close(gt.numpy(), gj, err_msg="vertex grad")
    assert float(tlosses.regularization(v, tm, static=True, **kw)) == 0.0


def test_knn_regularization_matches_jax():
    rng = np.random.default_rng(6)
    b, c, k = 3, 40, 5
    means = rng.normal(0, 0.3, (b, c, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (b, c, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    idx = rng.integers(0, c, (c, k)).astype(np.int32)
    d0 = rng.uniform(0.05, 0.5, (c, k)).astype(np.float32)
    valid = rng.uniform(size=(c, k)) > 0.2
    w = np.where(valid, np.exp(-20.0 * d0 ** 2), 0.0).astype(np.float32)
    lam = (0.3, 0.2, 0.4)

    jknn = jlosses.KnnState(jnp.asarray(idx), jnp.asarray(d0), jnp.asarray(w),
                            jnp.asarray(valid))
    lj, gj = jax.value_and_grad(
        lambda m, q: jlosses.knn_regularization(m, q, jknn, *lam),
        argnums=(0, 1))(jnp.asarray(means), jnp.asarray(quats))
    tknn = tlosses.KnnState(t(idx).long(), t(d0), t(w), t(valid))
    m, q = t(means).requires_grad_(), t(quats).requires_grad_()
    lt = tlosses.knn_regularization(m, q, tknn, *lam)
    gt = torch.autograd.grad(lt, (m, q))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=RTOL)
    for name, a, b_ in zip(("means", "rotations"), gt, gj):
        grad_close(a.numpy(), b_, err_msg=name)


@pytest.mark.parametrize("delay", [0, 500])
def test_expon_lr_matches_jax(delay):
    for step in (-1, 0, 1, 250, 7000, 20000, 40000):
        kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01, max_steps=20000)
        np.testing.assert_allclose(
            float(texpon_lr(torch.tensor(step, dtype=torch.int32), 3.2e-4, 3.2e-6, **kw)),
            float(jexpon_lr(step, 3.2e-4, 3.2e-6, **kw)), rtol=RTOL, err_msg=str(step))
    assert float(texpon_lr(torch.tensor(3), 0.0, 0.0)) == 0.0


def trainers(overrides=None, size=32):
    jm = jgrid_mesh(4, 4, size=1.2)
    tm = convert.mesh(tree_arrays(jm), "cpu")
    jcfg, tcfg = JConfig(), TConfig()
    jcfg.opt.raster_backend = "pallas"
    apply_overrides(tcfg, overrides or {})
    for group, values in (overrides or {}).items():
        for key, value in values.items():
            setattr(getattr(jcfg, {"OptimizationParams": "opt"}[group]), key, value)
    tan = float(np.tan(FOV / 2))
    jtr = JTrainer(jcfg, jm, jnp.tile(jm.pos[None], (3, 1, 1)), size, size,
                   tan, tan, 2.0)
    ttr = TTrainer(tcfg, tm, tm.pos[None].repeat(3, 1, 1), size, size, tan,
                   tan, 2.0)
    return jm, jtr, ttr


@pytest.mark.parametrize("tail", [False, True])
def test_lr_tree_matches_jax(tail):
    over = {"OptimizationParams": {"iterations": 1000, "lr_tail_start": 0.5}}
    _, jtr, ttr = trainers(over if tail else None)
    for step in (0, 100, 700, 1000):
        lj = jtr._lr_tree(jnp.asarray(step, jnp.int32))
        lt = ttr._lr_tree(torch.tensor(step, dtype=torch.int32))
        for name, a, b in zip(lj._fields, lt, lj):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL,
                                       err_msg=f"{name} at {step}")


def states(jtr, capacity=128):
    """The same state in both packages. The mesh init gives isotropic scales
    and identity rotations, where the rotation gradient is zero up to
    round-off; anisotropic scales and random unit rotations make it real."""
    rng = np.random.default_rng(0)
    params, gstate = JG.init_from_mesh(rng, jtr.mesh, 3, 2, capacity=capacity)
    quats = rng.normal(0, 1, params.rotation.shape)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    params = params._replace(
        scaling=params.scaling + jnp.asarray(
            rng.normal(0, 0.4, params.scaling.shape), jnp.float32),
        rotation=jnp.asarray(quats, jnp.float32))
    jstate = jtr.init_state(rng, params, gstate)
    return jstate, convert.train_state(tree_arrays(jstate), "cpu")


def cameras(size, times):
    cam = Camera.create(R=np.eye(3), t=np.asarray([0.0, 0.0, 3.0]), fovx=FOV,
                        fovy=FOV, width=size, height=size, time=0.5)
    arrs = [jcamera_arrays(dataclasses.replace(cam, time=float(x))) for x in times]
    jcams = JCameraArrays(*[jnp.stack([getattr(a, f) for a in arrs])
                            for f in JCameraArrays._fields])
    tcams = TCameraArrays(*(t(np.asarray(x)) for x in jcams))
    return jcams, tcams


@pytest.mark.parametrize("static,sh_degree", [(True, 0), (False, 1)])
def test_train_step_matches_jax(static, sh_degree):
    """One step from the same state on the 4x4 mesh at 32x32, two cameras;
    the dynamic step also carries the anchor loss (its time index comes
    from models/deform.py::time_index in the port)."""
    over = None if static else {"OptimizationParams": {"lambda_anchor": 0.5}}
    _, jtr, ttr = trainers(over)
    jstate, tstate = states(jtr)
    jcams, tcams = cameras(32, (0.0, 1.0))
    gts = np.full((2, 3, 32, 32), 0.5, np.float32)

    jnew, jm = jtr.step(jstate, jcams, jnp.asarray(gts), None,
                        sh_degree=sh_degree, static=static)
    fwd = ttr.forward(tstate, tcams, t(gts), None, sh_degree, static)
    grads = ttr.backward(fwd)
    tnew, tm = ttr.update(tstate, fwd, grads)

    for name in ("loss", "psnr", "l1"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(jm, name)), rtol=RTOL,
                                   err_msg=name)
    assert int(tm.n_alive) == int(jm.n_alive)
    assert int(tnew.step) == int(jnew.step) == 1

    groups = [("gaussian", grads[0]._asdict(), jnew.g_opt, tnew.g_opt,
               jnew.params._asdict(), tnew.params._asdict())]
    if not static:
        groups.append(("simulator", grads[1], jnew.sim_opt, tnew.sim_opt,
                       jnew.sim_params._asdict(), tnew.sim_params))
    else:
        for k, v in tstate.sim_params.items():
            assert torch.equal(tnew.sim_params[k], v)
    for label, g_t, jopt, topt, jparams, tparams in groups:
        jmu, jnu = jopt.mu._asdict(), jopt.nu._asdict()
        tmu, tnu = dict(topt.mu if isinstance(topt.mu, dict) else topt.mu._asdict()), \
            dict(topt.nu if isinstance(topt.nu, dict) else topt.nu._asdict())
        assert int(topt.count) == int(jopt.count) == 1
        moved = False
        for k in jmu:
            g_j = np.asarray(jmu[k]) / 0.1
            err = f"{label}.{k}"
            grad_close(g_t[k].numpy(), g_j, TOL_GRAD, err + " grad")
            grad_close(tmu[k].numpy(), jmu[k], TOL_GRAD, err + " mu")
            grad_close(tnu[k].numpy(), jnu[k], TOL_GRAD, err + " nu")
            sure = np.abs(g_j) > 1e-3 * (np.abs(g_j).max() + 1e-30)
            np.testing.assert_allclose(tparams[k].numpy()[sure],
                                       np.asarray(jparams[k])[sure],
                                       rtol=1e-5, atol=1e-7, err_msg=err + " param")
            moved |= bool(sure.any())
        assert moved, label

    grad_close(tnew.gstate.grad_accum.numpy(), jnew.gstate.grad_accum, TOL_GRAD,
               "grad_accum")
    assert float(tnew.gstate.grad_accum.max()) > 0.0
    np.testing.assert_array_equal(tnew.gstate.denom.numpy(), jnew.gstate.denom)
    np.testing.assert_array_equal(tnew.gstate.max_radii2d.numpy(),
                                  jnew.gstate.max_radii2d)


def test_compute_knn_state_matches_jax():
    """All slots alive (parked dead slots far from the origin make the
    |q|^2 - 2 q.p + |p|^2 distances of both packages cancel)."""
    _, jtr, ttr = trainers()
    jstate, tstate = states(jtr, capacity=42)     # 4x4 mesh: 21 faces x 2
    assert bool(np.asarray(jstate.gstate.alive).all())
    jk = jtr.compute_knn_state(jstate)
    tk = ttr.compute_knn_state(tstate)
    # neighbour order among equal distances may differ: compare sorted rows
    np.testing.assert_allclose(np.sort(tk.d0.numpy(), 1), np.sort(np.asarray(jk.d0), 1),
                               atol=1e-5)
    # w = exp(-lambda_w d^2) scales the ~3e-8 round-off of d^2 (its cross
    # term summed in another order) by lambda_w = 2000
    np.testing.assert_allclose(np.sort(tk.w.numpy(), 1), np.sort(np.asarray(jk.w), 1),
                               atol=1e-4)
    np.testing.assert_array_equal(tk.valid.numpy().sum(1), np.asarray(jk.valid).sum(1))


def test_trainer_init_state_draws_like_jax():
    """The same numpy draws in the same order. The log-scales come from kNN
    distances |q|^2 - 2 q.p + |p|^2 summed in another order: rtol 1e-5."""
    jm, jtr, ttr = trainers()
    jstate = jtr.init_state(np.random.default_rng(3))
    tstate = ttr.init_state(np.random.default_rng(3))
    for k, v in jstate.params._asdict().items():
        np.testing.assert_allclose(getattr(tstate.params, k).numpy(), v,
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    for k, v in jstate.sim_params._asdict().items():
        np.testing.assert_array_equal(tstate.sim_params[k].numpy(), v, err_msg=k)
    assert int(tstate.step) == 0 and int(tstate.g_opt.count) == 0


def test_trainer_backend_choice():
    """The JAX package's "auto" and "pallas" both train through the port's
    K2/K3 tier; "tiled" trains through the dense tier (its step against
    JAX: tests/test_torch_dense.py)."""
    for backend in ("auto", "pallas"):
        _, _, ttr = trainers({"OptimizationParams": {"raster_backend": backend}})
        assert ttr.backend == "tiled_train"
    _, jtr, ttr = trainers({"OptimizationParams": {"raster_backend": "tiled"}})
    assert ttr.backend == jtr.backend == "tiled"
    assert ttr.grow_k_cap() == jtr.grow_k_cap() == 1024
    assert ttr.cfg.opt.raster_k_cap == jtr.cfg.opt.raster_k_cap == 1024
    with pytest.raises(ValueError, match="unknown raster_backend"):
        trainers({"OptimizationParams": {"raster_backend": "nope"}})


def test_config_defaults_match_jax():
    """Every field of the port's Config has the JAX package's default."""
    jcfg, tcfg = JConfig(), TConfig()
    for group in ("model", "opt", "meshnet"):
        for key, value in dataclasses.asdict(getattr(tcfg, group)).items():
            assert getattr(getattr(jcfg, group), key) == value, f"{group}.{key}"


def test_apply_overrides_rejects_fields_the_port_lacks():
    """The dense tier's fields are ported and PipelineParams is accepted and
    ignored (the JAX package reads none of it); a field or group that
    neither package has raises."""
    tcfg = apply_overrides(TConfig(), {"MeshnetParams": {"lr_init": 1e-3},
                                       "OptimizationParams": {"raster_k_cap": 1},
                                       "PipelineParams": {"debug": True}})
    assert tcfg.meshnet.lr_init == 1e-3 and tcfg.opt.raster_k_cap == 1
    with pytest.raises(KeyError, match="raster_k_capp"):
        apply_overrides(TConfig(), {"OptimizationParams": {"raster_k_capp": 1}})
    with pytest.raises(KeyError, match="PipelineParams has no field 'debugg'"):
        apply_overrides(TConfig(), {"PipelineParams": {"debugg": True}})
    with pytest.raises(KeyError, match="NopeParams"):
        apply_overrides(TConfig(), {"NopeParams": {"debug": True}})
