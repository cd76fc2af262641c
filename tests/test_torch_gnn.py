"""PyTorch port vs the JAX package: the GNN dynamics (slices 6b-6d), on the
CPU, on one dataset of 3 simulated trajectories (8x8 cloth, 14 steps) that
the JAX collector writes, at small widths (latent 16-32, 2-3 layers).

  - bit for bit: the three graph builders of ``data/meshing.py``,
    ``process_trajectory``, ``ClothSampleDataset`` (samples, batches, the
    rollout item), ``data/realworld.py`` and a model built from one seed;
  - within stated tolerances: the Encode-Process-Decode forward with and
    without an edge mask and its gradients, the normalizers,
    ``update_prediction``, ``edge_length_refine``, 10-step rollouts (real
    world on and off), the time simulator, ``MeshnetTrainer`` steps at
    unroll lengths 1 and 3 (no noise, then JAX's noise), and
    ``train_meshnet`` over 3 curriculum epochs;
  - checkpoints both ways (``convert``), ``generate_gnn_predictions``'s files,
    ``mesh_viz``, every GNN entry point in process, and the package's
    deterministic switch.
"""

import glob
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloth_splatting_tpu.data import meshing as jmesh
from cloth_splatting_tpu.data import predictions as jpred
from cloth_splatting_tpu.data import realworld as jrw
from cloth_splatting_tpu.data import trajectories as jtraj
from cloth_splatting_tpu.manipulation.collect import collect_dataset
from cloth_splatting_tpu.models import cloth_simulator as jcs
from cloth_splatting_tpu.models import meshnet as jm
from cloth_splatting_tpu.models import time_simulator as jts
from cloth_splatting_tpu.train import meshnet_train as jtrain

import cloth_splatting_tpu_torch
from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data import meshing as tmesh
from cloth_splatting_tpu_torch.data import predictions as tpred
from cloth_splatting_tpu_torch.data import realworld as trw
from cloth_splatting_tpu_torch.data import trajectories as ttraj
from cloth_splatting_tpu_torch.models import cloth_simulator as tcs
from cloth_splatting_tpu_torch.models import meshnet as tm
from cloth_splatting_tpu_torch.models import time_simulator as tts
from cloth_splatting_tpu_torch.train import meshnet_train as ttrain

torch.set_num_threads(1)

# the forward: float32 matmuls and sums in another order than XLA's
TOL_FWD = 1e-5
# gradients, relative to each parameter's largest gradient magnitude
TOL_GRAD = 1e-5
# one training step's loss (relative) and new parameters (relative to each
# field's largest magnitude); rollouts (absolute, positions of ~0.3 m)
TOL_STEP = 1e-5
TOL_ROLLOUT = 1e-5
# the slice as a whole: 3 curriculum epochs of training
TOL_EPOCH_LOSS = 1e-4
TOL_TRAINED = 1e-4

SMALL = dict(input_sequence_length=2, n_message_passing=3, latent=32)


def jnp_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tree_pairs(j, t, prefix=""):
    """(path, JAX array, port tensor) for each leaf of the JAX tree ``j`` and
    the port's tree ``t`` of the same layout."""
    if hasattr(j, "_asdict"):
        j = j._asdict()
    if hasattr(t, "_asdict"):
        t = t._asdict()
    if isinstance(j, dict):
        for k in j:
            yield from tree_pairs(j[k], t[k], f"{prefix}{k}/")
    elif isinstance(j, (list, tuple)):
        for i, (a, b) in enumerate(zip(j, t)):
            yield from tree_pairs(a, b, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(j), t


def rel_err(j, t) -> float:
    """Largest |port - JAX| over the JAX array's largest magnitude."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def within(name: str, value: float, limit: float) -> None:
    """Assert ``value <= limit`` and print the reading (``pytest -s``)."""
    print(f"measured {name}: {value:.3g} (limit {limit:g})")
    assert value <= limit, (name, value, limit)


def to_t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("simdata")
    return collect_dataset(str(root), n_trajectories=3, nx=8, ny=8, n_steps=14,
                           seed=0)


@pytest.fixture(scope="module")
def datasets(sim_dataset):
    """The JAX and the port datasets of the same files (future 1, 48 nodes)."""
    return (jtraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48),
            ttraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48))


def models(seed=0, **kw):
    kw = {**SMALL, **kw}
    return (jcs.init_cloth_simulator(np.random.default_rng(seed), **kw),
            tcs.init_cloth_simulator(np.random.default_rng(seed), device="cpu", **kw))


# ---------------------------------------------------------------- 6b. graph

def test_graph_builders_bit_equal():
    rng = np.random.default_rng(0)
    pts = rng.random((60, 3)).astype(np.float32)
    for thr in (0.3, None):
        je, jf = jmesh.delaunay_edges(pts, norm_threshold=thr)
        te, tf = tmesh.delaunay_edges(pts, norm_threshold=thr)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tf, jf)
        assert te.dtype == je.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tmesh.knn_edges(pts, 4), jmesh.knn_edges(pts, 4))
    for seed in (0, 3):
        np.testing.assert_array_equal(tmesh.farthest_point_sampling(pts, 20, seed),
                                      jmesh.farthest_point_sampling(pts, 20, seed))


# ------------------------------------------------------------- 6c. datasets

def test_process_trajectory_and_dataset_bit_equal(sim_dataset, datasets):
    jd, td = datasets
    dirs = jtraj.env_trajectory_dirs(sim_dataset)
    assert ttraj.env_trajectory_dirs(sim_dataset) == dirs
    raw_j, raw_t = jtraj.load_sim_trajectory(dirs[0]), ttraj.load_sim_trajectory(dirs[0])
    assert sorted(raw_j) == sorted(raw_t)
    for k in raw_j:
        np.testing.assert_array_equal(raw_t[k], raw_j[k])
    for kw in ({}, {"use_delaunay": False, "knn": 4}, {"subsample": False},
               {"num_samples": 30, "seed": 2}):
        pj = jtraj.process_trajectory(raw_j, **kw)
        pt = ttraj.process_trajectory(raw_t, **kw)
        assert sorted(pj) == sorted(pt)
        for k in pj:
            np.testing.assert_array_equal(np.asarray(pt[k]), np.asarray(pj[k]), err_msg=k)
    for steps in (2, 3):
        a = ttraj.load_sim_trajectory(dirs[1], action_steps=steps)
        b = jtraj.load_sim_trajectory(dirs[1], action_steps=steps)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])

    for future in (1, 3):
        jd.set_future_seq_len(future)
        td.set_future_seq_len(future)
        assert len(td) == len(jd) and td.e_max == jd.e_max
        for i in (0, 5, len(jd) - 1):
            js, ts = jd.sample(i), td.sample(i)
            for k in js:
                np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
                assert ts[k].dtype == js[k].dtype
        jb = jd.batch(np.random.default_rng(4), 5)
        tb = td.batch(np.random.default_rng(4), 5)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    for i in range(len(jd.trajs)):
        jr, tr = jd.rollout_item(i), td.rollout_item(i)
        for k in jr:
            np.testing.assert_array_equal(np.asarray(tr[k]), np.asarray(jr[k]))
    jd.set_future_seq_len(1)
    td.set_future_seq_len(1)


def rw_capture(t=6, nx=9, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 0.4, nx), np.linspace(0, 0.4, nx))
    base = np.stack([xs.ravel(), ys.ravel(), np.zeros(nx * nx)], 1)
    gripper = np.zeros((t, 3), np.float32)
    pos = np.zeros((t, nx * nx, 3), np.float32)
    for i in range(t):
        shift = np.asarray([0.02 * i, 0.01 * i, 0.0])
        gripper[i] = base[0] + shift
        pos[i] = base + shift * np.linspace(1.0, 0.2, nx * nx)[:, None]
        pos[i] += rng.normal(0, 0.003, pos[i].shape)
        pos[i, :, 2] = rng.normal(0, 0.01, nx * nx)
    return {"pos": pos, "gripper_pos": gripper, "pick": base[0].astype(np.float32),
            "place": (base[0] + [0.2, 0.2, 0]).astype(np.float32)}


def test_realworld_bit_equal():
    raw = rw_capture()
    np.testing.assert_array_equal(trw.gaussian_smoothing(raw["pos"][0], k=10, sigma=0.05),
                                  jrw.gaussian_smoothing(raw["pos"][0], k=10, sigma=0.05))
    j = jrw.preprocess_rw_trajectory(raw, num_samples=50)
    t = trw.preprocess_rw_trajectory(raw, num_samples=50)
    assert sorted(j) == sorted(t)
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)


# --------------------------------------------------------------- 6b. models

def test_model_from_one_seed_bit_equal():
    j, t = models(seed=7)
    pairs = list(tree_pairs(j, t))
    assert len(pairs) == len(jax.tree_util.tree_leaves(j)) == 2 * 8 + 3 * 2 * 8 + 6 + 2 * 4
    for path, a, b in pairs:
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
    jt = jts.init_time_simulator(np.random.default_rng(1), 2, latent=16)
    tt = tts.init_time_simulator(np.random.default_rng(1), 2, latent=16, device="cpu")
    for path, a, b in tree_pairs(jt, tt):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)


def graph(v=12, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.random((v, 3)).astype(np.float32)
    e = [(i, (i + 1) % v) for i in range(v)] + [(i, (i + 3) % v) for i in range(v)]
    e = np.asarray(e + [(b, a) for a, b in e], np.int32).T
    return pos, e


@pytest.mark.parametrize("masked", [False, True])
def test_encode_process_decode_and_grads_match_jax(masked):
    pos, e = graph()
    rng = np.random.default_rng(3)
    jp = jm.init_encode_process_decode(np.random.default_rng(2), 8, 3, 4, latent=32,
                                       n_message_passing=3)
    tp = tm.init_encode_process_decode(np.random.default_rng(2), 8, 3, 4, latent=32,
                                       n_message_passing=3, device="cpu")
    feats = rng.random((12, 8)).astype(np.float32)
    mask = np.arange(e.shape[1]) < e.shape[1] - 6 if masked else None
    cot = rng.normal(size=(12, 3)).astype(np.float32)
    jef = jcs.edge_features_from_positions(jnp.asarray(pos), jnp.asarray(e))
    tef = tcs.edge_features_from_positions(to_t(pos), to_t(e, np.int64))
    assert rel_err(np.asarray(jef), tef) <= 1e-6

    def jloss(params):
        out = jm.apply_encode_process_decode(params, jnp.asarray(feats), jnp.asarray(e),
                                             jef, None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    flat = tm.flat_params(tp)
    leaves = {k: v.clone().requires_grad_() for k, v in flat.items()}
    tout = tm.apply_encode_process_decode(
        tm.unflat_params(tp, leaves), to_t(feats), to_t(e, np.int64), tef,
        None if mask is None else torch.from_numpy(mask))
    tgrad = dict(zip(leaves, torch.autograd.grad((tout * to_t(cot)).sum(),
                                                 list(leaves.values()))))
    within(f"EPD forward (mask {masked})",
           float(np.abs(tout.detach().numpy() - np.asarray(jout)).max()), TOL_FWD)
    errs = {path: rel_err(a, tgrad[path]) for path, a, _ in tree_pairs(jgrad, tp)}
    within(f"EPD gradients (mask {masked}), of each leaf's largest", max(errs.values()),
           TOL_GRAD)
    if masked:
        keep = e[:, mask]
        trunc = tm.apply_encode_process_decode(
            tp, to_t(feats), to_t(keep, np.int64),
            tcs.edge_features_from_positions(to_t(pos), to_t(keep, np.int64)))
        within("masked vs dropped edges", float((trunc - tout).abs().max()), TOL_FWD)


def test_normalizers_match_jax():
    rng = np.random.default_rng(8)
    js, ts = jm.init_normalizer(3), tm.init_normalizer(3, "cpu")
    for i in range(3):
        data = rng.normal(2.0, 3.0, (500, 3)).astype(np.float32)
        jn, js = jm.normalizer_apply(js, jnp.asarray(data), accumulate=True)
        tn, ts = tm.normalizer_apply(ts, torch.from_numpy(data), accumulate=True)
        within("normalized data, relative", rel_err(np.asarray(jn), tn), 1e-6)
    within("normalizer state, relative",
           max(rel_err(a, b) for _, a, b in tree_pairs(js, ts)), 1e-6)
    jn, _ = jm.normalizer_apply(js, jnp.asarray(data), accumulate=False)
    tn, ts2 = tm.normalizer_apply(ts, torch.from_numpy(data), accumulate=False)
    assert ts2 is ts and rel_err(np.asarray(jn), tn) <= 1e-6
    assert rel_err(np.asarray(jm.normalizer_inverse(js, jn)),
                   tm.normalizer_inverse(ts, tn)) <= 1e-6
    # accumulation stops at MAX_ACCUMULATIONS
    full = ts._replace(num_accumulations=torch.tensor(tm.MAX_ACCUMULATIONS))
    _, after = tm.normalizer_apply(full, torch.from_numpy(data), accumulate=True)
    assert torch.equal(after.acc_sum, full.acc_sum)


def test_update_prediction_matches_jax(datasets):
    jd, _ = datasets
    s = jd.sample(4)
    rng = np.random.default_rng(0)
    acc = rng.normal(0, 0.01, (jd.n_nodes, 3)).astype(np.float32)
    e = s["edge_index"][:, s["edge_mask"]]
    pa = np.zeros((jd.n_nodes, 2, 3), np.float32)
    pa[int(s["grasped"])] = [[0.01, 0.0, 0.02], [0.0, 0.01, 0.01]]
    j = jcs.update_prediction(jnp.asarray(s["velocity"]), jnp.asarray(acc),
                              jnp.asarray(s["positions"]), jnp.asarray(e),
                              jnp.asarray(pa[:, 0]), jnp.asarray(pa[:, 1]))
    t = tcs.update_prediction(to_t(s["velocity"]), to_t(acc), to_t(s["positions"]),
                              to_t(e, np.int64), to_t(pa[:, 0]), to_t(pa[:, 1]))
    for name, a, b in zip(("velocity", "edge features", "position"), j, t):
        within(f"update_prediction {name}", float(np.abs(b.numpy() - np.asarray(a)).max()),
               1e-6)


def test_edge_length_refine_matches_jax(datasets):
    jd, _ = datasets
    item = jd.rollout_item(0)
    pos, e, g = item["pos"][3], item["edge_index"], int(item["grasped"])
    rng = np.random.default_rng(1)
    vel = rng.normal(0, 0.01, pos.shape).astype(np.float32)
    d0 = item["pos"][0][e[0]] - item["pos"][0][e[1]]
    rest = np.sqrt((d0 * d0).sum(-1) + 1e-20).astype(np.float32)
    mask = np.arange(e.shape[1]) % 7 != 0
    for m in (None, mask):
        j = jcs.edge_length_refine(jnp.asarray(vel), jnp.asarray(pos), jnp.asarray(e),
                                   jnp.asarray(rest), jnp.asarray(g),
                                   edge_mask=None if m is None else jnp.asarray(m))
        t = tcs.edge_length_refine(to_t(vel), to_t(pos), to_t(e, np.int64), to_t(rest),
                                   g, edge_mask=None if m is None else torch.from_numpy(m))
        within(f"edge_length_refine (mask {m is not None})",
               float(np.abs(t.numpy() - np.asarray(j)).max()), 1e-6)
        assert float(np.abs(t.numpy() - vel).max()) > 1e-4        # it moved


def rollouts(jstate, tstate, item, real_world, n=10):
    args = (item["pos"][0], item["init_velocity"], item["node_type"],
            item["edge_index"], item["actions"])
    j, jv = jcs.rollout(jstate, *(jnp.asarray(a) for a in args),
                        jnp.asarray(item["grasped"]), n_steps=n, real_world=real_world)
    t, tv = tcs.rollout(tstate, to_t(args[0]), to_t(args[1]), to_t(args[2], np.int64),
                        to_t(args[3], np.int64), to_t(args[4]), int(item["grasped"]),
                        n_steps=n, real_world=real_world)
    return (np.asarray(j), np.asarray(jv)), (t.numpy(), tv.numpy())


@pytest.mark.parametrize("real_world", [False, True])
def test_rollout_matches_jax(datasets, real_world):
    """10 steps. Without refinement, free-running within TOL_ROLLOUT. With
    it, each step from JAX's state within TOL_ROLLOUT (teacher-forced): the
    refinement's Adam turns the rounding-level gradients of the flat
    cloth's out-of-plane components into steps of about its learning rate,
    so free-running rollouts of the two packages part by ~1e-3 within 10
    steps; that rollout is checked for its grasp and finite values."""
    jd, _ = datasets
    jstate, tstate = models(seed=4, n_message_passing=2)
    # normalizers with statistics, so that they act
    feats = np.random.default_rng(2).normal(0, 0.01, (100, 8)).astype(np.float32)
    out = np.random.default_rng(3).normal(0, 0.001, (100, 3)).astype(np.float32)
    _, jstate["node_norm"] = jm.normalizer_apply(jstate["node_norm"], jnp.asarray(feats), True)
    _, jstate["out_norm"] = jm.normalizer_apply(jstate["out_norm"], jnp.asarray(out), True)
    tstate = convert.cloth_simulator_state(jnp_tree(jstate), "cpu")
    item = jd.rollout_item(1)
    (j, jv), (t, tv) = rollouts(jstate, tstate, item, real_world)
    assert t.shape == j.shape == (11, jd.n_nodes, 3) and np.isfinite(t).all()
    g = int(item["grasped"])
    np.testing.assert_allclose(t[1:, g], item["pos"][0][g] + np.cumsum(item["actions"][:10], 0),
                               atol=1e-5)
    if not real_world:
        within("10-step rollout positions", float(np.abs(t - j).max()), TOL_ROLLOUT)
        within("10-step rollout velocities", float(np.abs(tv - jv).max()), TOL_ROLLOUT)
        return
    print(f"measured free-running real-world rollout positions (not held): "
          f"{float(np.abs(t - j).max()):.3g}")
    e = item["edge_index"]
    d0 = item["pos"][0][e[0]] - item["pos"][0][e[1]]
    rest = to_t(np.sqrt((d0 * d0).sum(-1) + 1e-20))
    hist = [item["init_velocity"][0], item["init_velocity"][1]] + list(jv)
    err = 0.0
    for k in range(10):
        tk, tvk = tcs.rollout(tstate, to_t(j[k]), to_t(np.stack(hist[k:k + 2])),
                              to_t(item["node_type"], np.int64), to_t(e, np.int64),
                              to_t(item["actions"][k:k + 1]), g, n_steps=1,
                              real_world=True, rest_lengths=rest)
        err = max(err, float(np.abs(tk[1].numpy() - j[k + 1]).max()),
                  float(np.abs(tvk[0].numpy() - jv[k]).max()))
    within("real-world rollout, each step from JAX's state", err, TOL_ROLLOUT)


def test_time_simulator_matches_jax():
    pos, e = graph(v=10, seed=5)
    rng = np.random.default_rng(6)
    js = jts.init_time_simulator(np.random.default_rng(0), 2, latent=16)
    ts = tts.init_time_simulator(np.random.default_rng(0), 2, latent=16, device="cpu")
    tvec = np.full((10,), 0.25, np.float32)
    nz = rng.normal(0, 0.01, pos.shape).astype(np.float32)
    target = (pos + 0.01).astype(np.float32)
    jef = jcs.edge_features_from_positions(jnp.asarray(pos), jnp.asarray(e))
    tef = tcs.edge_features_from_positions(to_t(pos), to_t(e, np.int64))
    jn = jnp.zeros(10, jnp.int32)
    tn = torch.zeros(10, dtype=torch.int64)
    jp, jt, jst = jts.predict_displacement(js, jnp.asarray(pos), jnp.asarray(tvec), jn,
                                           jnp.asarray(e), jef, jnp.asarray(target),
                                           jnp.asarray(nz), training=True)
    tp, tt, tst = tts.predict_displacement(ts, to_t(pos), to_t(tvec), tn, to_t(e, np.int64),
                                           tef, to_t(target), to_t(nz), training=True)
    within("time simulator prediction, relative", rel_err(np.asarray(jp), tp), TOL_FWD)
    within("time simulator target, relative", rel_err(np.asarray(jt), tt), TOL_FWD)
    for path, a, b in tree_pairs({k: jst[k] for k in ("node_norm", "out_norm")},
                                 {k: tst[k] for k in ("node_norm", "out_norm")}):
        assert rel_err(a, b) <= 1e-6, path
    j = jts.predict_position(jst, jnp.asarray(pos), jnp.asarray(tvec), jn, jnp.asarray(e), jef)
    t = tts.predict_position(tst, to_t(pos), to_t(tvec), tn, to_t(e, np.int64), tef)
    within("time simulator predict_position", float(np.abs(t.numpy() - np.asarray(j)).max()),
           TOL_FWD)


# ----------------------------------------------------------- 6c. training

def assert_states_close(jstate, tstate, tol, what):
    errs = {path: rel_err(a, b) for path, a, b in tree_pairs(jstate, tstate)}
    assert max(errs.values()) <= tol, (what, sorted(errs.items(), key=lambda kv: -kv[1])[:5])


def assert_step_close(j, t):
    """One Adam step from zero moments, JAX's (state, opt, loss) against the
    port's: the loss within TOL_STEP relative; the normalizers within 1e-6;
    each gradient (read back from the first moment, mu = 0.1 g) within
    TOL_GRAD of the leaf's largest, nu (g^2) within 2 TOL_GRAD; the new
    parameters where |g| > 1e-3 of the leaf's largest: Adam's first step
    moves every element by +-lr whatever the gradient's size, so a gradient
    at the level of rounding may take either sign."""
    (jstate, jopt, jl), (tstate, topt, tl) = j, t
    within("step loss, relative", abs(float(tl) - float(jl)) / abs(float(jl)), TOL_STEP)
    assert int(topt.count) == int(jopt.count) == 1
    for key in ("node_norm", "out_norm"):
        for path, a, b in tree_pairs(jstate[key], tstate[key]):
            assert rel_err(a, b) <= 1e-6, (key, path)
    jnu = {path: a for path, a, _ in tree_pairs(jopt.nu, jstate["gnn"])}
    errs = {}
    for path, mu, p_new in tree_pairs(jopt.mu, jstate["gnn"]):
        g = mu / 0.1
        errs[path] = rel_err(g, topt.mu[path] / 0.1)
        assert rel_err(jnu[path], topt.nu[path]) <= 2 * TOL_GRAD, path
    for path, p_new, t_new in tree_pairs(jstate["gnn"], tstate["gnn"]):
        g = dict((q, a) for q, a, _ in tree_pairs(jopt.mu, jstate["gnn"]))[path] / 0.1
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t_new.numpy()[sure], p_new[sure], rtol=1e-5,
                                   atol=1e-7, err_msg=path)
    within("step gradients, of each leaf's largest", max(errs.values()), TOL_GRAD)


@pytest.mark.parametrize("future,noise_std", [(1, 0.0), (3, 0.0), (1, 1e-3), (3, 1e-3)])
def test_meshnet_trainer_step_matches_jax(datasets, future, noise_std):
    jd, td = datasets
    jd.set_future_seq_len(future)
    td.set_future_seq_len(future)
    batch = jd.batch(np.random.default_rng(11), 4)
    jstate, tstate = models(seed=5)
    jtr = jtrain.MeshnetTrainer(lr_init=1e-3, noise_std=noise_std)
    ttr = ttrain.MeshnetTrainer(lr_init=1e-3, noise_std=noise_std, device="cpu")
    key = jax.random.PRNGKey(3)
    noise = (jax.random.normal(key, batch["velocity"].shape) * noise_std
             if noise_std > 0 else jnp.zeros(batch["velocity"].shape))
    j = jtr.train_step(jstate, jtr.init_opt(jstate), batch, key, epoch=2, future=future)
    t = ttr.train_step(tstate, ttr.init_opt(tstate), batch, epoch=2, future=future,
                       noise=to_t(noise))
    assert_step_close(j, t)
    jd.set_future_seq_len(1)
    td.set_future_seq_len(1)


# one step at the root defaults' depth and width (15 layers of latent 128):
# rounding flips ReLU units near their kink, and single gradient elements of
# the two packages part by up to ~1e-3 of their leaf's largest, so the step
# is held by norms: all gradients together within TOL_DEEP_GRAD_ALL of their
# norm, each parameter's within TOL_DEEP_GRAD_LEAF of its norm (chip_smoke.py
# holds the card's step to the CPU's at the same limits)
TOL_DEEP_GRAD_ALL = 5e-4
TOL_DEEP_GRAD_LEAF = 2e-3


@pytest.mark.parametrize("future", [1, 3])
def test_meshnet_trainer_step_matches_jax_at_full_depth(datasets, future):
    jd, _ = datasets
    jd.set_future_seq_len(future)
    batch = jd.batch(np.random.default_rng(11), 8)
    jd.set_future_seq_len(1)
    jstate, tstate = models(seed=0, n_message_passing=15, latent=128)
    jtr = jtrain.MeshnetTrainer(lr_init=1e-3, noise_std=0.0)
    ttr = ttrain.MeshnetTrainer(lr_init=1e-3, noise_std=0.0, device="cpu")
    _, jopt, jl = jtr.train_step(jstate, jtr.init_opt(jstate), batch, jax.random.PRNGKey(0),
                                 epoch=0, future=future)
    _, topt, tl = ttr.train_step(tstate, ttr.init_opt(tstate), batch, 0, future)
    within("full-depth step loss, relative", abs(float(tl) - float(jl)) / abs(float(jl)),
           TOL_STEP)
    # one step from zero moments leaves mu = 0.1 g
    pairs = [(path, np.float64(mu), topt.mu[path].double().numpy())
             for path, mu, _ in tree_pairs(jopt.mu, jstate["gnn"])]
    all_rel = (np.sqrt(sum(((b - a) ** 2).sum() for _, a, b in pairs))
               / np.sqrt(sum((a ** 2).sum() for _, a, _ in pairs)))
    leaf = max(np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30) for _, a, b in pairs)
    print(f"measured full-depth step gradients, largest element error of a leaf's "
          f"largest (not held): {max(rel_err(a, b) for _, a, b in pairs):.3g}")
    within("full-depth step gradients, all, relative", float(all_rel), TOL_DEEP_GRAD_ALL)
    within("full-depth step gradients, worst leaf, relative", float(leaf), TOL_DEEP_GRAD_LEAF)


def test_flattened_batch_drops_padded_edges():
    """Samples with fewer edges than the batch's widest: their padding is
    dropped from the one graph, and the step equals the masked JAX step."""
    pos, e = graph(v=12, seed=9)
    n_e = e.shape[1]
    batch = {"velocity": np.zeros((2, 12, 6), np.float32),
             "node_type": np.zeros((2, 12), np.int32),
             "positions": np.stack([pos, pos + 0.1]).astype(np.float32),
             "edge_index": np.stack([e, np.concatenate([e[:, :n_e - 8],
                                                        np.zeros((2, 8), np.int32)], 1)]),
             "edge_mask": np.stack([np.ones(n_e, bool), np.arange(n_e) < n_e - 8]),
             "target_vel": np.random.default_rng(0).normal(0, 0.01, (2, 12, 1, 3)).astype(np.float32),
             "particle_actions": np.zeros((2, 12, 1, 3), np.float32)}
    g = ttrain.flatten_batch(batch, torch.device("cpu"))
    assert g["edge_index"].shape == (2, 2 * n_e - 8)
    assert int(g["edge_index"][:, n_e:].min()) >= 12
    jstate, tstate = models(seed=2)
    jtr, ttr = jtrain.MeshnetTrainer(lr_init=1e-3), ttrain.MeshnetTrainer(lr_init=1e-3, device="cpu")
    j = jtr.train_step(jstate, jtr.init_opt(jstate), batch, jax.random.PRNGKey(0), 0, 1)
    t = ttr.train_step(tstate, ttr.init_opt(tstate), batch, 0, 1)
    assert_step_close(j, t)


def test_train_meshnet_matches_jax_over_curriculum(sim_dataset, tmp_path):
    """The slice as a whole: 3 curriculum epochs (unroll 1, 2, 3) from one
    seed, checkpoints and the validation rollout."""
    kw = dict(n_epochs=3, batch_size=4, curriculum=True, steps_per_epoch=3,
              seed=1, save_every=1)
    jd = jtraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48)
    td = ttraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48)
    jstate, tstate = models(seed=6)
    jstate, jl = jtrain.train_meshnet(jtrain.MeshnetTrainer(lr_init=1e-3), jstate, jd,
                                      jd, model_dir=str(tmp_path / "j"), **kw)
    ttr = ttrain.MeshnetTrainer(lr_init=1e-3, device="cpu")
    tstate, tl = ttrain.train_meshnet(ttr, tstate, td, td,
                                      model_dir=str(tmp_path / "t"), **kw)
    assert td.future_seq_len == jd.future_seq_len == 3
    within("epoch losses, relative", float(np.max(np.abs(np.subtract(tl, jl)) / np.abs(jl))),
           TOL_EPOCH_LOSS)
    within("trained parameters, of each field's largest",
           max(rel_err(a, b) for _, a, b in tree_pairs(jstate, tstate)), TOL_TRAINED)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        with np.load(tmp_path / "j" / name) as a, np.load(tmp_path / "t" / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (name, k)
    # the port's checkpoint of the last epoch restores the trained state
    back = ttr.load(str(tmp_path / "t"), tstate)
    for _, a, b in tree_pairs(jnp_tree(back), tstate):
        np.testing.assert_array_equal(b.numpy(), a)
    jv = jtrain.MeshnetTrainer().validate_rollout(jstate, jd.rollout_item(2), 6)
    tv = ttr.validate_rollout(tstate, td.rollout_item(2), 6)
    assert float(np.abs(tv["predicted_positions"] - jv["predicted_positions"]).max()) <= 1e-4
    np.testing.assert_allclose(tv["per_step_mse"], jv["per_step_mse"], rtol=1e-3)
    # data parallelism runs inside a process group (tests/test_torch_gnn_dp.py)
    with pytest.raises(RuntimeError, match="initialized torch.distributed group"):
        ttrain.train_meshnet(ttr, tstate, td, data_parallel=True)


@pytest.fixture(scope="module")
def jax_trained(sim_dataset, tmp_path_factory):
    """A JAX-trained GNN (2 epochs), its dataset and its checkpoint
    directory."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    jd = jtraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48)
    jstate = jcs.init_cloth_simulator(np.random.default_rng(5), 2,
                                      n_message_passing=2, latent=32)
    jtr = jtrain.MeshnetTrainer(lr_init=1e-3)
    jstate, _ = jtrain.train_meshnet(jtr, jstate, jd, n_epochs=2, batch_size=3,
                                     curriculum=False, model_dir=str(ckpt),
                                     save_every=1, steps_per_epoch=2)
    return jd, jstate, ckpt


def test_jax_checkpoint_loads_and_rolls_out_like_jax(sim_dataset, jax_trained):
    jd, jstate, tmp_path = jax_trained
    td = ttraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48)
    path = str(tmp_path / "model-2.npz")
    for tstate in (convert.cloth_simulator_state(path, "cpu"),
                   convert.cloth_simulator_state(jnp_tree(jstate), "cpu"),
                   ttrain.MeshnetTrainer(device="cpu").load(
                       str(tmp_path), tcs.init_cloth_simulator(
                           np.random.default_rng(0), 2, n_message_passing=2,
                           latent=32, device="cpu"))):
        for p, a, b in tree_pairs(jstate, tstate):
            np.testing.assert_array_equal(b.numpy(), a, err_msg=p)
        (j, _), (t, _) = rollouts(jstate, tstate, jd.rollout_item(0), False)
        assert float(np.abs(t - j).max()) <= TOL_ROLLOUT
    topt = convert.meshnet_adam_state(str(tmp_path / "train_state-2.npz"), "cpu")
    with np.load(tmp_path / "train_state-2.npz") as z:
        assert int(topt.count) == int(z["opt/count"])
        for k, v in topt.mu.items():
            np.testing.assert_array_equal(v.numpy(), z[f"opt/mu/{k}"])
            np.testing.assert_array_equal(topt.nu[k].numpy(), z[f"opt/nu/{k}"])
    assert sorted(topt.mu) == sorted(tm.flat_params(tstate["gnn"]))
    # a step from the loaded moments (keyed in the file's order) equals a
    # step from the same moments in the parameters' order, bit for bit
    ttr = ttrain.MeshnetTrainer(lr_init=1e-3, device="cpu")
    batch = jd.batch(np.random.default_rng(0), 3)
    ordered = topt._replace(**{f: {k: getattr(topt, f)[k] for k in tm.flat_params(tstate["gnn"])}
                               for f in ("mu", "nu")})
    assert list(ordered.mu) != list(topt.mu)
    a = ttr.train_step(tstate, topt, batch, 2, 1)
    b = ttr.train_step(tstate, ordered, batch, 2, 1)
    for _, x, y in tree_pairs(jnp_tree(a[0]), b[0]):
        np.testing.assert_array_equal(y.numpy(), x)


def test_real_world_refinement_from_clean_start_as_jax(sim_dataset, jax_trained):
    """chip_smoke's real-world rollout from the clean start (5 steps, the
    rest lengths of the start, 10 Adam steps at lr 1e-3 a step) in both
    packages, with the JAX-trained GNN: the mean |edge length - rest| with
    and without refinement, within 1e-3 relative of JAX's (Adam's lr-sized
    steps part the refined rollouts by ~1e-4 of it). In both packages the
    refinement lengthens the edges of a prediction that is already close to
    its rest lengths, and so it does on the simulated truth itself: the
    reference's own behaviour on a cloth that barely stretches."""
    jd, jstate, _ = jax_trained
    tstate = convert.cloth_simulator_state(jnp_tree(jstate), "cpu")
    item = jd.rollout_item(0)
    e, g = item["edge_index"], int(item["grasped"])
    d0 = item["pos"][0][e[0]] - item["pos"][0][e[1]]
    rest = np.sqrt((d0 * d0).sum(-1) + 1e-20).astype(np.float32)
    free = (e[0] != g) & (e[1] != g)
    n = 5

    def deviation(traj):
        traj = np.asarray(traj)
        lengths = np.linalg.norm(traj[1:, e[0][free]] - traj[1:, e[1][free]], axis=-1)
        return float(np.abs(lengths - rest[free]).mean())

    devs = {}
    for refine in (False, True):
        j, _ = jcs.rollout(jstate, jnp.asarray(item["pos"][0]),
                           jnp.asarray(item["init_velocity"]), jnp.asarray(item["node_type"]),
                           jnp.asarray(e), jnp.asarray(item["actions"]), jnp.asarray(g),
                           n_steps=n, real_world=refine, rest_lengths=jnp.asarray(rest))
        t, _ = tcs.rollout(tstate, to_t(item["pos"][0]), to_t(item["init_velocity"]),
                           to_t(item["node_type"], np.int64), to_t(e, np.int64),
                           to_t(item["actions"]), g, n_steps=n, real_world=refine,
                           rest_lengths=to_t(rest))
        devs[refine] = deviation(j), deviation(t.numpy())
    # the truth's own steps, refined from each true position
    truth = {"jax": [item["pos"][0]], "port": [item["pos"][0]]}
    for k in range(n):
        vel = (item["pos"][k + 1] - item["pos"][k]).astype(np.float32)
        truth["jax"].append(item["pos"][k] + np.asarray(jcs.edge_length_refine(
            jnp.asarray(vel), jnp.asarray(item["pos"][k]), jnp.asarray(e),
            jnp.asarray(rest), jnp.asarray(g))))
        truth["port"].append(item["pos"][k] + tcs.edge_length_refine(
            to_t(vel), to_t(item["pos"][k]), to_t(e, np.int64), to_t(rest), g).numpy())
    gt, gt_j, gt_t = (deviation(item["pos"][:n + 1]), deviation(np.stack(truth["jax"])),
                      deviation(np.stack(truth["port"])))
    print(f"measured clean-start edge-length deviation (m), JAX / port: plain "
          f"{devs[False][0]:.4g} / {devs[False][1]:.4g}, refined {devs[True][0]:.4g} / "
          f"{devs[True][1]:.4g}; the truth {gt:.4g}, refined {gt_j:.4g} / {gt_t:.4g}")
    for name, (a, b) in (("plain", devs[False]), ("refined", devs[True]),
                         ("truth refined", (gt_j, gt_t))):
        within(f"clean-start deviation, {name}, relative", abs(b - a) / a, 1e-3)
    assert devs[True][0] > devs[False][0] and devs[True][1] > devs[False][1]
    assert gt_j > gt and gt_t > gt


def test_generate_gnn_predictions_writes_jax_files(sim_dataset, jax_trained, tmp_path):
    jd, jstate, _ = jax_trained
    td = ttraj.ClothSampleDataset(sim_dataset, 2, 1, num_samples=48)
    tstate = convert.cloth_simulator_state(jnp_tree(jstate), "cpu")
    j = jpred.generate_gnn_predictions(str(tmp_path / "jax"), jstate, jd, traj_idx=1)
    t = tpred.generate_gnn_predictions(str(tmp_path / "torch"), tstate, td, traj_idx=1)
    assert t.shape == j.shape and float(np.abs(t - j).max()) <= TOL_ROLLOUT
    names = ["init_mesh.hdf5"] + [f"mesh_predictions/mesh_{i:03d}.hdf5"
                                  for i in range(t.shape[0])]
    for name in names:
        with h5py.File(tmp_path / "jax" / name) as a, h5py.File(tmp_path / "torch" / name) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                if k in ("face", "edge_index"):
                    np.testing.assert_array_equal(b[k][()], a[k][()])
                else:
                    np.testing.assert_allclose(b[k][()], a[k][()], atol=TOL_ROLLOUT)


def test_mesh_viz_frames_and_gif(tmp_path):
    from cloth_splatting_tpu_torch.eval import mesh_viz

    rng = np.random.default_rng(0)
    pts = rng.normal(0, 0.1, size=(16, 3)).astype(np.float32)
    edges = np.stack([np.arange(15), np.arange(1, 16)])
    img = mesh_viz.plot_mesh(pts, edges, save_path=str(tmp_path / "m.png"))
    assert img.ndim == 3 and img.shape[2] == 3 and os.path.getsize(tmp_path / "m.png") > 0
    gt = np.stack([pts + 0.01 * t for t in range(3)])
    pred = gt + rng.normal(0, 0.005, gt.shape).astype(np.float32)
    assert mesh_viz.plot_mesh_predictions(gt[0], pred[0], edges).shape == img.shape
    paths = mesh_viz.rollout_frames(gt, pred, edges, str(tmp_path / "frames"))
    assert [os.path.basename(p) for p in paths] == [f"rollout_{t:04d}.png" for t in range(3)]
    gif = mesh_viz.create_gif(paths, str(tmp_path / "rollout.gif"))
    assert os.path.getsize(gif) > 0


# --------------------------------------------------------- 6d. entry points

def test_train_meshnet_sim_entry_point(sim_dataset, tmp_path):
    from cloth_splatting_tpu_torch import train_meshnet_sim as cli

    env = os.path.join(sim_dataset, "TOWEL")
    common = ["--data_path", sim_dataset, "--model_path", str(tmp_path / "m"),
              "--message_passing", "2", "--num_samples", "24", "--device", "cpu"]
    losses = cli.main(common + ["--data_val_path", sim_dataset, "--ntraining_steps", "3",
                                "--batch_size", "3", "--steps_per_epoch", "2",
                                "--nsave_steps", "2", "--curriculum", "1",
                                "--noise_std", "1e-4", "--viz_dir", str(tmp_path / "viz"),
                                "--viz_every", "2"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    exp = os.path.join(tmp_path / "m", "cloth-splatting-SIM-curr1-astep1-propagation2-"
                                       "noise0.0001-nodes24")
    assert sorted(os.listdir(exp)) == ["model-0.npz", "model-2.npz", "model-3.npz",
                                       "train_state-0.npz", "train_state-2.npz",
                                       "train_state-3.npz"]
    assert glob.glob(str(tmp_path / "viz" / "epoch_00000" / "rollout.gif"))
    # rollout mode with the port's checkpoint
    results = cli.main(common + ["--mode", "rollout", "--curriculum", "1",
                                 "--noise_std", "1e-4",
                                 "--output_path", str(tmp_path / "out")])
    assert len(results) == len(glob.glob(os.path.join(env, "traj_*")))
    assert os.path.exists(tmp_path / "out" / "rollout.pkl")
    # --data_parallel 1 on the CPU: a world of one gloo rank
    dp = cli.main(common[:3] + [str(tmp_path / "dp")] + common[4:]
                  + ["--ntraining_steps", "1", "--batch_size", "3",
                     "--steps_per_epoch", "1", "--data_parallel", "1"])
    assert len(dp) == 1 and np.isfinite(dp).all()
    assert glob.glob(str(tmp_path / "dp" / "*" / "model-1.npz"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--data_path", sim_dataset])


def test_dynamics_evaluation_and_legacy_trainer_entry_points(sim_dataset, jax_trained,
                                                            tmp_path):
    from cloth_splatting_tpu_torch import dynamics_evaluation, train_meshnet

    out = dynamics_evaluation.main(["--data_path", sim_dataset, "--meshnet_dir",
                                    str(jax_trained[2]), "--message_passing", "2",
                                    "--num_samples", "48", "--out",
                                    str(tmp_path / "eval.json"), "--device", "cpu"])
    assert len(out["trajectories"]) == 3 and np.isfinite(out["mean_mse"])
    # the legacy time-conditioned trainer on one npz trajectory
    raw = ttraj.load_sim_trajectory(jtraj.env_trajectory_dirs(sim_dataset)[0])
    traj = ttraj.process_trajectory(raw, subsample=False)["pos"]      # cloth plane xy
    np.savez(tmp_path / "traj.npz", traj=traj)
    common = ["--data_path", str(tmp_path / "traj.npz"), "--model_path",
              str(tmp_path / "legacy"), "--message_passing", "2", "--device", "cpu"]
    losses = train_meshnet.main(common + ["--ntraining_steps", "3", "--batch_size", "2",
                                          "--noise_std", "1e-3"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    mse = train_meshnet.main(common + ["--mode", "rollout",
                                       "--output_path", str(tmp_path / "ro")])
    assert np.isfinite(mse) and os.path.exists(tmp_path / "ro" / "rollout.pkl")


def test_legacy_train_step_matches_jax():
    """One step of the legacy trainer against the JAX trainer's step, on the
    same time indices and noise (the JAX step lives inside the root CLI, so
    its body is repeated here from ``train_meshnet.py``)."""
    from cloth_splatting_tpu_torch.train.step import adam_init
    from cloth_splatting_tpu_torch.train_meshnet import train_step
    import optax

    pos, e = graph(v=10, seed=1)
    rng = np.random.default_rng(2)
    traj = (pos[None] + np.cumsum(rng.normal(0, 0.01, (5, 10, 3)), 0)).astype(np.float32)
    times = np.arange(5, dtype=np.float32)
    t_ids = np.asarray([1, 3, 0])
    noise = rng.normal(0, 1e-3, (3, 10, 3)).astype(np.float32)
    js = jts.init_time_simulator(np.random.default_rng(0), 2, latent=16)
    ts = tts.init_time_simulator(np.random.default_rng(0), 2, latent=16, device="cpu")
    tx = optax.scale_by_adam()
    jopt = tx.init(js["gnn"])
    jt, je, jn = jnp.asarray(traj), jnp.asarray(e), jnp.zeros(10, jnp.int32)

    def sample_loss(gnn, t_id, nz):
        st = {**js, "gnn": gnn}
        p = jt[t_id]
        ef = jcs.edge_features_from_positions(p + nz, je)
        pred, target, _ = jts.predict_displacement(
            st, p, jnp.full((10, 1), times[t_id]), jn, je, ef,
            target_positions=jt[t_id + 1], position_noise=nz)
        return jnp.mean((pred - target) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(lambda g: jnp.mean(jnp.stack(
        [sample_loss(g, int(i), jnp.asarray(n)) for i, n in zip(t_ids, noise)]))))(js["gnn"])
    feats0 = jnp.concatenate([jt[t_ids[0]] + noise[0], jnp.full((10, 1), times[t_ids[0]]),
                              jnp.ones((10, 1))], -1)
    _, node_norm = jm.normalizer_apply(js["node_norm"], feats0, True)
    _, out_norm = jm.normalizer_apply(js["out_norm"], jt[t_ids[0] + 1] - (jt[t_ids[0]] + noise[0]), True)
    updates, _ = tx.update(grads, jopt, js["gnn"])
    jnew = {"gnn": jax.tree_util.tree_map(lambda p, u: p - 1e-3 * u, js["gnn"], updates),
            "node_norm": node_norm, "out_norm": out_norm}
    tnew, _, tl = train_step(ts, adam_init(tm.flat_params(ts["gnn"])), to_t(traj),
                             to_t(times), to_t(e, np.int64), torch.zeros(10, dtype=torch.int64),
                             torch.from_numpy(t_ids), to_t(noise), 1e-3)
    within("legacy step loss, relative", abs(float(tl) - float(loss)) / abs(float(loss)),
           TOL_STEP)
    assert_states_close(jnew, tnew, TOL_STEP, "legacy step")


def test_generate_rw_predictions_entry_point(jax_trained, tmp_path):
    from cloth_splatting_tpu_torch import generate_rw_predictions as cli

    np.savez(tmp_path / "capture.npz", **rw_capture())
    common = ["--data_path", str(tmp_path / "capture.npz"), "--model_file",
              str(jax_trained[2] / "model-2.npz"), "--num_samples", "50",
              "--latent", "32", "--message_passing", "2", "--device", "cpu"]
    refined = cli.main(common + ["--output_path", str(tmp_path / "scene")])
    plain = cli.main(common + ["--output_path", str(tmp_path / "scene2"), "--no_refine"])
    assert refined.shape == plain.shape == (6, 50, 3)
    assert not np.array_equal(refined, plain)
    assert os.path.exists(tmp_path / "scene" / "init_mesh.hdf5")
    assert len(glob.glob(str(tmp_path / "scene" / "mesh_predictions" / "*.hdf5"))) == 6


def test_the_port_is_deterministic_after_import():
    assert cloth_splatting_tpu_torch is not None
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert not torch.utils.deterministic.fill_uninitialized_memory
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") in (":4096:8", ":16:8")


def test_adam_step_equals_adam_per_leaf():
    """The GNN's Adam over all parameters as one vector gives the bits of
    ``train.step.adam_update`` leaf by leaf, and keeps the moments keyed by
    path (views into one buffer)."""
    from cloth_splatting_tpu_torch.train.step import adam_init, adam_update

    _, tstate = models(seed=3, n_message_passing=2)
    params = tm.flat_params(tstate["gnn"])
    rng = np.random.default_rng(0)
    opt = adam_init(params)
    ref_params, ref_opt = dict(params), opt
    for _ in range(3):
        grads = {k: to_t(rng.normal(size=v.shape)) for k, v in params.items()}
        params, opt = ttrain.adam_step(params, grads, opt, 1e-3)
        upd, ref_opt = adam_update(grads, ref_opt, 0.9, 0.999, 1e-8)
        ref_params = {k: p - np.float32(1e-3) * upd[k] for k, p in ref_params.items()}
    assert list(opt.mu) == list(params) and int(opt.count) == 3
    for k in params:
        assert params[k].shape == ref_params[k].shape
        np.testing.assert_array_equal(params[k].numpy(), ref_params[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(opt.mu[k].numpy(), ref_opt.mu[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(opt.nu[k].numpy(), ref_opt.nu[k].numpy(), err_msg=k)
