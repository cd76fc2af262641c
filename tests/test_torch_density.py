"""PyTorch port vs the JAX package: density control, capacity growth, the
barycentric cleanup, the host-side schedule, time sampling and the banked
step, each on the same arrays.

States are made with numpy from a seed on a 6x6 grid mesh (59 faces, 118
Gaussians) and cross through ``convert``. Integer and boolean outputs
(``alive``, ``face_ids``, touched masks, overflow counts, sampled ids) must
be IDENTICAL; floats agree to 1e-6 (the same elementwise arithmetic in both
packages). The split's normal jitter is drawn once with ``jax.random.normal``
from a key: JAX gets the key, the port the array.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cloth_splatting_tpu.data.meshing import grid_cloth_mesh as jgrid_mesh
from cloth_splatting_tpu.models import gaussians as JG
from cloth_splatting_tpu.ops.camera import Camera
from cloth_splatting_tpu.render import CameraArrays as JCameraArrays
from cloth_splatting_tpu.render import camera_arrays as jcamera_arrays
from cloth_splatting_tpu.train import loop as jloop
from cloth_splatting_tpu.train import step as jstep
from cloth_splatting_tpu.train.config import Config as JConfig

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.models import gaussians as TG
from cloth_splatting_tpu_torch.render import CameraArrays as TCameraArrays
from cloth_splatting_tpu_torch.train import loop as tloop
from cloth_splatting_tpu_torch.train import step as tstep
from cloth_splatting_tpu_torch.train.config import Config as TConfig

torch.set_num_threads(1)

ATOL = 1e-6
FOV = 2 * np.arctan(0.4)
EXTENT = 2.0


def tree_arrays(x):
    """A JAX NamedTuple tree as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: tree_arrays(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def assert_same(t_tree, j_tree, name=""):
    """Port tree against JAX tree: exact for ints and bools, ATOL for floats."""
    if hasattr(j_tree, "_asdict"):
        t_items = t_tree if isinstance(t_tree, dict) else t_tree._asdict()
        for k, v in j_tree._asdict().items():
            assert_same(t_items[k], v, f"{name}.{k}")
        return
    a = t_tree.numpy() if isinstance(t_tree, torch.Tensor) else np.asarray(t_tree)
    b = np.asarray(j_tree)
    assert a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}"
    if b.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)


def meshes():
    jm = jgrid_mesh(6, 6, size=1.2)
    return jm, convert.mesh(tree_arrays(jm), "cpu")


def field(capacity, seed, n_dead=0):
    """(JAX params, JAX gstate) with varied scales, rotations, opacities and
    statistics; the last ``n_dead`` of the initialized Gaussians are dead, and
    so are the slots past them."""
    jm, _ = meshes()
    rng = np.random.default_rng(seed)
    params, gstate = JG.init_from_mesh(rng, jm, 1, 2, capacity=capacity)
    cap = capacity
    n = 2 * int(jm.faces.shape[0])
    quats = rng.normal(0, 1, (cap, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    alive = np.asarray(gstate.alive).copy()
    alive[n - n_dead:n] = False
    params = params._replace(
        scaling=jnp.asarray(np.log(np.exp(rng.uniform(np.log(0.004), np.log(0.06),
                                                      (cap, 1)))
                                   * rng.uniform(0.7, 1.0, (cap, 3))), jnp.float32),
        rotation=jnp.asarray(quats, jnp.float32),
        opacity=jnp.asarray(rng.normal(-2.0, 3.0, (cap, 1)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.1, params.features_rest.shape),
                                  jnp.float32))
    gstate = gstate._replace(
        alive=jnp.asarray(alive),
        max_radii2d=jnp.asarray(rng.uniform(0, 40, cap), jnp.float32),
        grad_accum=jnp.asarray(rng.uniform(0, 1e-3, cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 4, cap), jnp.float32))
    return params, gstate


def assert_split_bary_close(t_bary, j_bary, face_ids, name="face_bary"):
    """A split's children take barycentric coordinates against the parent's
    face, dividing by its squared area (~1e-3 here), which scales float32
    round-off up: 1e-4. The grid's Delaunay triangulation also holds sliver
    faces of no area along the boundary, where the quotient is round-off over
    round-off (JAX's own jitted and eager results differ there by ~10):
    rows on those faces are only required to be finite."""
    jm, _ = meshes()
    tri = np.asarray(jm.pos)[np.asarray(jm.faces)[np.asarray(face_ids)]]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                          axis=1)
    well = area > 1e-6
    assert well.sum() > 0.8 * well.size
    np.testing.assert_allclose(np.asarray(t_bary)[well], np.asarray(j_bary)[well],
                               atol=1e-4, err_msg=name)
    assert np.isfinite(np.asarray(t_bary)).all()


def both(params, gstate):
    return (convert.gaussian_params(tree_arrays(params), "cpu"),
            convert.gaussian_state(tree_arrays(gstate), "cpu"))


def grads_of(gstate):
    g = np.asarray(gstate.grad_accum) / np.maximum(np.asarray(gstate.denom), 1e-12)
    return g.astype(np.float32)


@pytest.mark.parametrize("capacity,n_dead", [(512, 0), (124, 3), (118, 0)])
def test_densify_clone_matches_jax(capacity, n_dead):
    """Free slots at the end and in the middle; 124 overflows, 118 is full."""
    params, gstate = field(capacity, 0, n_dead)
    tp, tg = both(params, gstate)
    g = grads_of(gstate)
    rj = JG.densify_clone(params, gstate, jnp.asarray(g), 2e-4, 0.01, EXTENT)
    rt = TG.densify_clone(tp, tg, torch.from_numpy(g), 2e-4, 0.01, EXTENT)
    assert_same(rt.params, rj.params, "params")
    assert_same(rt.state, rj.state, "state")
    assert_same(rt.touched, rj.touched, "touched")
    assert int(rt.overflow) == int(rj.overflow)
    if capacity == 512:
        assert int(rt.touched.sum()) > 0 and int(rt.overflow) == 0
    else:
        assert int(rt.overflow) > 0


@pytest.mark.parametrize("capacity,n_dead", [(512, 0), (124, 3)])
def test_densify_split_matches_jax(capacity, n_dead):
    params, gstate = field(capacity, 1, n_dead)
    jm, tm = meshes()
    tp, tg = both(params, gstate)
    g = grads_of(gstate)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, (2,) + params.scaling.shape))
    rj = JG.densify_split(params, gstate, jm, jnp.asarray(g), 2e-4, 0.01,
                          EXTENT, key)
    rt = TG.densify_split(tp, tg, tm, torch.from_numpy(g), 2e-4, 0.01, EXTENT,
                          torch.from_numpy(eps.copy()))
    assert_split_bary_close(rt.params.face_bary.numpy(), rj.params.face_bary,
                            rj.state.face_ids)
    assert_same(rt.params._replace(face_bary=rt.params.face_bary * 0),
                rj.params._replace(face_bary=rj.params.face_bary * 0), "params")
    assert_same(rt.state, rj.state, "state")
    assert_same(rt.touched, rj.touched, "touched")
    assert int(rt.overflow) == int(rj.overflow)
    assert int(rt.touched.sum()) > int((rt.state.alive & ~tg.alive).sum()) > 0
    assert (int(rt.overflow) > 0) == (capacity == 124)


@pytest.mark.parametrize("size_threshold", [None, 20.0])
def test_prune_matches_jax(size_threshold):
    params, gstate = field(128, 2, 3)
    tp, tg = both(params, gstate)
    sj = JG.prune(params, gstate, 0.05, EXTENT, size_threshold)
    st = TG.prune(tp, tg, 0.05, EXTENT, size_threshold)
    assert_same(st, sj, "state")
    killed = int(tg.alive.sum()) - int(st.alive.sum())
    assert 0 < killed < int(tg.alive.sum())


def test_prune_size_threshold_kills_more():
    params, gstate = field(128, 2)
    tp, tg = both(params, gstate)
    assert int(TG.prune(tp, tg, 0.05, EXTENT, 20.0).alive.sum()) \
        < int(TG.prune(tp, tg, 0.05, EXTENT, None).alive.sum())


def test_reset_opacity_matches_jax():
    params, gstate = field(128, 3)
    tp, _ = both(params, gstate)
    pj, touched_j = JG.reset_opacity(params)
    pt, touched_t = TG.reset_opacity(tp)
    assert_same(pt, pj, "params")
    assert_same(touched_t, touched_j, "touched")
    assert float(torch.sigmoid(pt.opacity).max()) <= 0.01 + 1e-6


def trainers(overrides=None, size=32):
    jm, tm = meshes()
    jcfg, tcfg = JConfig(), TConfig()
    jcfg.opt.raster_backend = "pallas"
    for key, value in (overrides or {}).items():
        setattr(jcfg.opt, key, value)
        setattr(tcfg.opt, key, value)
    tan = float(np.tan(FOV / 2))
    jtr = jstep.Trainer(jcfg, jm, jnp.tile(jm.pos[None], (3, 1, 1)), size, size,
                        tan, tan, EXTENT)
    ttr = tstep.Trainer(tcfg, tm, tm.pos[None].repeat(3, 1, 1), size, size, tan,
                        tan, EXTENT)
    return jtr, ttr


def train_states(jtr, capacity, seed, n_dead=0):
    """The same train state in both packages, with nonzero Adam moments."""
    params, gstate = field(capacity, seed, n_dead)
    rng = np.random.default_rng(seed + 100)
    jstate = jtr.init_state(rng, params, gstate)

    def noise(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    g_opt = noise(jstate.g_opt)
    # face_offset takes no gradient, so its moments are zero in any run (the
    # JAX opacity reset clears every [C, 1] leaf, the port the opacity leaf)
    zero = jnp.zeros_like(jstate.params.face_offset)
    g_opt = g_opt._replace(mu=g_opt.mu._replace(face_offset=zero),
                           nu=g_opt.nu._replace(face_offset=zero))
    jstate = jstate._replace(g_opt=g_opt)
    return jstate, convert.train_state(tree_arrays(jstate), "cpu")


def test_zero_opt_rows_matches_jax():
    jtr, _ = trainers()
    jstate, tstate = train_states(jtr, 128, 4)
    touched = np.random.default_rng(0).uniform(size=128) < 0.3
    oj = JG.zero_opt_rows(jstate.g_opt, jnp.asarray(touched), 128)
    ot = TG.zero_opt_rows(tstate.g_opt, torch.from_numpy(touched), 128)
    assert_same(ot, oj, "g_opt")
    assert float(ot.mu.scaling[touched].abs().max()) == 0.0
    assert float(ot.mu.scaling[~touched].abs().min()) > 0.0
    assert int(ot.count) == int(tstate.g_opt.count)


def assert_states_same(tstate, jstate):
    for name in ("params", "gstate", "g_opt", "sim_params", "sim_opt"):
        assert_same(getattr(tstate, name), getattr(jstate, name), name)
    assert int(tstate.step) == int(jstate.step)


@pytest.mark.parametrize("capacity,n_dead", [(512, 0), (124, 3)])
def test_trainer_densify_prune_reset_match_jax(capacity, n_dead):
    """The three jitted programs of the JAX trainer against the port's, with
    the overflow count; 124 slots overflow."""
    jtr, ttr = trainers()
    jstate, tstate = train_states(jtr, capacity, 5, n_dead)
    key = jax.random.PRNGKey(9)
    eps = torch.from_numpy(np.asarray(
        jax.random.normal(key, (2,) + jstate.params.scaling.shape)))
    js, ovf_j = jtr._densify(jstate, 2e-4, key)
    ts, ovf_t = ttr._densify(tstate, 2e-4, eps)
    assert int(ovf_t) == int(ovf_j)
    assert (int(ovf_t) > 0) == (capacity == 124)
    assert_split_bary_close(ts.params.face_bary.numpy(), js.params.face_bary,
                            js.gstate.face_ids)
    same_bary = js.params._replace(face_bary=jnp.asarray(ts.params.face_bary.numpy()))
    assert_states_same(ts, js._replace(params=same_bary))
    assert float(ts.gstate.grad_accum.abs().max()) == 0.0

    for use_size in (False, True):
        assert_states_same(ttr._prune(tstate, 0.05, use_size),
                           jtr._prune(jstate, 0.05, use_size))
    tr, jr = ttr._reset_opacity(tstate), jtr._reset_opacity(jstate)
    assert_states_same(tr, jr)
    assert float(tr.g_opt.mu.opacity.abs().max()) == 0.0
    assert float(tr.g_opt.mu.scaling.abs().max()) > 0.0


def test_grow_capacity_matches_jax(capsys):
    jtr, ttr = trainers()
    jstate, tstate = train_states(jtr, 124, 6, 3)
    jg, tg = jtr.grow_capacity(jstate), ttr.grow_capacity(tstate)
    assert tg.params.face_bary.shape[0] == jg.params.face_bary.shape[0] == 512
    assert_states_same(tg, jg)
    new = tg.params.rotation[124:]
    np.testing.assert_array_equal(new.numpy(), np.tile([1.0, 0, 0, 0], (388, 1)))
    assert not bool(tg.gstate.alive[124:].any())
    assert "124 -> 512" in capsys.readouterr().out
    # a grown state converts like any other
    again = convert.train_state(tree_arrays(jg), "cpu")
    assert_states_same(again, jg)


def test_cleanup_barycentric_host_matches_jax():
    params, gstate = field(128, 7, 3)
    rng = np.random.default_rng(8)
    bary = np.asarray(params.face_bary).copy()
    hit = rng.choice(115, size=30, replace=False)
    bary[hit, rng.integers(0, 3, 30)] = -rng.uniform(0.01, 0.2, 30).astype(np.float32)
    bary[hit[:4], 1] = -0.05                      # two negatives in one row
    params = params._replace(face_bary=jnp.asarray(bary))
    jm, tm = meshes()
    tp, tg = both(params, gstate)
    pj, gj = jstep.cleanup_barycentric_host(params, gstate, jm)
    pt, gt = tstep.cleanup_barycentric_host(tp, tg, tm)
    assert_same(pt, pj, "params")
    assert_same(gt, gj, "gstate")
    moved = int((gt.face_ids != tg.face_ids).sum())
    nudged = int(((pt.face_bary != tp.face_bary).any(1)
                  & (gt.face_ids == tg.face_ids)).sum())
    assert moved > 0 and nudged > 0               # interior and boundary edges
    # nothing to clean: the state comes back as it was
    p2, g2 = tstep.cleanup_barycentric_host(tp._replace(face_bary=tp.face_bary.abs()),
                                            tg, tm)
    assert torch.equal(g2.face_ids, tg.face_ids)


SCHEDULE = dict(densify_from_iter=20, densification_interval=10,
                densify_until_iter=90, pruning_from_iter=30, pruning_interval=15,
                opacity_reset_interval=40, opacity_threshold_fine_init=0.01,
                opacity_threshold_fine_after=0.002,
                densify_grad_threshold_fine_init=4e-4,
                densify_grad_threshold_after=1e-4)


@pytest.mark.parametrize("white_background", [True, False])
def test_density_schedule_matches_jax(white_background):
    """``density_control_due`` and the threshold schedule over a range of
    iterations; the thresholds are read back through the JAX trainer's own
    ``density_control`` by recording what it hands its programs."""
    jtr, ttr = trainers(SCHEDULE)
    jtr.cfg.model.white_background = ttr.cfg.model.white_background = white_background
    seen = {}
    jtr._densify = lambda s, thr, key: (seen.__setitem__("densify", thr) or s, 0)
    jtr._prune = lambda s, thr, use: seen.__setitem__("prune", (thr, use)) or s
    jtr._reset_opacity = lambda s: seen.__setitem__("reset", True) or s
    due_any = 0
    for it in range(1, 110):
        due_j = jstep.Trainer.density_control_due(jtr.cfg, it)
        assert tstep.Trainer.density_control_due(ttr.cfg, it) == due_j, it
        due_any += due_j
        seen.clear()
        jtr.density_control("state", it, None)
        assert bool(seen) == due_j, it
        opacity, densify = ttr.density_thresholds(it)
        if "densify" in seen:
            assert densify == seen["densify"], it
        if "prune" in seen:
            assert (opacity, it > 40) == seen["prune"], it
    assert 0 < due_any < 60


@pytest.mark.parametrize("three,regime,n_times",
                         [(True, "interior", 5), (True, "balanced", 5),
                          (True, "interior", 2), (False, "interior", 5)])
def test_sample_time_ids_matches_jax(three, regime, n_times):
    rj, rt = np.random.default_rng([7, 1]), np.random.default_rng([7, 1])
    seen = set()
    for _ in range(200):
        ids_j = jloop.sample_time_ids(rj, n_times, three, regime)
        ids_t = tloop.sample_time_ids(rt, n_times, three, regime)
        assert ids_t == ids_j
        seen.update(ids_t)
    assert seen == set(range(n_times))


def test_step_banked_equals_step_on_gathered_cameras():
    """The banked step against JAX's, and against the port's own ``step`` on
    the cameras and images it gathers; the carry is the 0.4 / 0.6 average."""
    jtr, ttr = trainers()
    jstate, tstate = train_states(jtr, 128, 10)
    jstate = jstate._replace(g_opt=jtr.g_tx.init(jstate.params))
    tstate = convert.train_state(tree_arrays(jstate), "cpu")
    size, n_views, n_times = 32, 2, 3
    rows = [[jcamera_arrays(Camera.create(
        R=np.eye(3), t=np.asarray([0.1 * v, 0.0, 3.0]), fovx=FOV, fovy=FOV,
        width=size, height=size, time=float(t)))
        for t in np.linspace(0, 1, n_times)] for v in range(n_views)]
    jbank = JCameraArrays(*[jnp.stack([jnp.stack([getattr(c, f) for c in row])
                                       for row in rows])
                            for f in JCameraArrays._fields])
    tbank = TCameraArrays(*(torch.from_numpy(np.asarray(x)) for x in jbank))
    gts = np.random.default_rng(11).integers(0, 256, (n_views, n_times, 3, size, size)
                                             ).astype(np.uint8)
    vi, t_ids = 1, [0, 1, 2]

    jnew, jm, jc = jtr.step_banked(jstate, jbank, jnp.asarray(gts), None, vi, t_ids,
                                   sh_degree=1, static=False,
                                   carry=jstep.StepCarry.zeros())
    carry0 = tstep.StepCarry(torch.tensor(0.5), torch.tensor(20.0),
                             torch.tensor(3, dtype=torch.int32))
    tnew, tm, tc = ttr.step_banked(tstate, tbank, torch.from_numpy(gts), None, vi,
                                   t_ids, sh_degree=1, static=False, carry=carry0)
    cams = TCameraArrays(*(f[vi, t_ids] for f in tbank))
    snew, sm = ttr.step(tstate, cams, torch.from_numpy(gts[vi, t_ids]).float() / 255.0,
                        None, 1, False)
    for a, b in zip(tnew.params, snew.params):
        assert torch.equal(a, b)
    assert float(tm.loss) == float(sm.loss)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
    np.testing.assert_allclose(float(tm.psnr), float(jm.psnr), rtol=1e-5)
    np.testing.assert_allclose(float(tc.ema_loss), 0.4 * float(tm.loss) + 0.6 * 0.5,
                               rtol=1e-6)
    np.testing.assert_allclose(float(tc.ema_psnr), 0.4 * float(tm.psnr) + 0.6 * 20.0,
                               rtol=1e-6)
    assert int(tc.drop_accum) == 3 and int(jc.drop_accum) == 0
    np.testing.assert_allclose(float(jc.ema_loss), 0.4 * float(jm.loss), rtol=1e-6)
    # without a carry the banked step returns two values
    assert len(ttr.step_banked(tstate, tbank, torch.from_numpy(gts), None, vi,
                               [1], sh_degree=1, static=True)) == 2
