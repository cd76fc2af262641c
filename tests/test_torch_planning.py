"""PyTorch port vs the JAX package: the perception half of the closed
manipulation loop (``mpc-cs``), on the CPU at a small size (an 8x8 cloth's
36-sample estimation mesh, 3 views of 32x32).

  - ``ObservationSynthesizer``: the frames each package writes for the same
    states through the dense tier, within 1 of 255 (they read identical);
    the port's in-memory scene bit-equal to its directory read back, and
    the JAX loader reads the port's directory;
  - ``SingleStepOptimizer``: 4 static and 3 refine steps in each package
    through the dense tier (``raster_backend="tiled"`` in both), the split
    jitter of density control drawn from JAX's key chain and passed to the
    port; then one refine step of JAX's Pallas tier (interpret mode) against
    the port's K2/K3 plain versions from the same state; and
    ``refined_positions``;
  - a port-only ``mpc-cs`` episode through files and in memory: the same
    costs, history and refiner state, in the JAX package's file layout.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from cloth_splatting_tpu.data import scene as jscene
from cloth_splatting_tpu.manipulation.observation import ObservationSynthesizer as JSynth
from cloth_splatting_tpu.train.config import Config as JConfig
from cloth_splatting_tpu.train.single_step import SingleStepOptimizer as JSSO
from cloth_splatting_tpu.train.step import Trainer as JTrainer

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.data.trajectories import process_trajectory
from cloth_splatting_tpu_torch.manipulation.env import ClothEnv
from cloth_splatting_tpu_torch.manipulation.observation import ObservationSynthesizer as TSynth
from cloth_splatting_tpu_torch.manipulation.planning import (
    PlanningConfig,
    closed_loop_planning,
)
from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
from cloth_splatting_tpu_torch.train.config import Config as TConfig
from cloth_splatting_tpu_torch.train.single_step import SingleStepOptimizer as TSSO
from cloth_splatting_tpu_torch.train.single_step import load_scene_data
from cloth_splatting_tpu_torch.train.step import Trainer as TTrainer

torch.set_num_threads(1)

VIEWS, SIZE, N_TIMES_MAX = 3, 32, 4
# uint8 frames of the two packages' dense tiers
TOL_FRAME = 1
# the refiner: Adam moves an element whose gradient is round-off by +-lr
# whatever its sign, so parameters are held to 2.5 lr of their leaf (one
# flip); moments to 2e-4 of the leaf's largest magnitude (the fit's
# teacher-forced tolerance, tests/test_torch_fit.py); the refined vertices
# (m) absolutely. Readings (``pytest -s``): frames identical; parameters
# <= 2.2e-5 (rotation, lr 1e-3), moments <= 2.9e-5 relative, refined
# vertices 1.2e-7; the Pallas step's moments <= 2.1e-7 relative.
TOL_MOMENT = 2e-4
TOL_REFINED = 1e-5
STATIC, REFINE = 4, 3
# density control on every iteration of the short run (as tests/test_torch_fit.py)
SCHEDULE = dict(
    densify_from_iter=1, densification_interval=2, pruning_from_iter=2,
    pruning_interval=3, opacity_reset_interval=100000, bary_cleanup=3,
    percent_dense=0.012, densify_grad_threshold_fine_init=2e-5,
    densify_grad_threshold_after=2e-5, opacity_threshold_fine_init=0.09,
    opacity_threshold_fine_after=0.09, raster_k_cap=128, raster_k_chunk=16)


def tree(x):
    if hasattr(x, "_asdict"):
        return {k: tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: tree(v) for k, v in x.items()}
    return np.asarray(x)


def within(name: str, value: float, limit: float) -> None:
    print(f"measured {name}: {value:.3g} (limit {limit:g})")
    assert value <= limit, (name, value, limit)


@pytest.fixture(scope="module")
def states():
    """(faces, two estimation-mesh states [V, 3]): the 36-sample mesh of a
    settled 8x8 cloth, and the same state moved by 1 cm noise."""
    env = ClothEnv(nx=8, ny=8, seed=0, device="cpu")
    p0 = env.reset()
    proc = process_trajectory({"pos": np.stack([p0, p0]),
                               "actions": np.zeros((1, 3), np.float32),
                               "pick": p0[0], "place": p0[-1]},
                              num_samples=36, norm_threshold=0.2)
    h0 = proc["pos"][0]
    h1 = h0 + np.random.default_rng(0).normal(0, 0.01, h0.shape).astype(np.float32)
    return proc["faces"], h0, h1


def synthesize(cls, scene_dir, faces, h0, h1, **kw):
    synth = cls(scene_dir, faces, h0, n_views=VIEWS, image_size=SIZE,
                n_times_max=N_TIMES_MAX, **kw)
    synth.render_state(h0, 0)
    synth.write_mesh_predictions(h0[None])
    synth.render_state(h1, 1)
    synth.write_mesh_predictions(np.stack([h0, h1]))
    return synth


@pytest.fixture(scope="module")
def jax_scene(states, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_scene"))
    synthesize(JSynth, path, *states)
    return path


def test_observation_frames_match_jax(states, jax_scene, tmp_path):
    import imageio.v2 as imageio

    port_dir = str(tmp_path / "port")
    synth = synthesize(TSynth, port_dir, *states, device="cpu")
    names = sorted(f for split in ("train", "test")
                   for f in os.listdir(os.path.join(jax_scene, split)))
    assert names == sorted(f for split in ("train", "test")
                           for f in os.listdir(os.path.join(port_dir, split)))
    assert len(names) == 2 * VIEWS
    worst = 0
    for split in ("train", "test"):
        for name in os.listdir(os.path.join(jax_scene, split)):
            a, b = (imageio.imread(os.path.join(d, split, name)).astype(int)
                    for d in (jax_scene, port_dir))
            assert a.shape == (SIZE, SIZE, 4) and a[..., 3].max() > 0
            worst = max(worst, int(np.abs(a - b).max()))
    within("frame |port - JAX| (of 255)", worst, TOL_FRAME)

    # the in-memory scene is the directory read back, bit for bit
    disk = load_scene_data(port_dir, True, "cpu")
    memory = synth.scene_data()
    for f in ("gt_bank", "n_views", "n_times", "radius"):
        a, b = getattr(disk, f), getattr(memory, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), f
    for name, a, b in zip(disk.cam_bank._fields, disk.cam_bank, memory.cam_bank):
        assert torch.equal(a, b), name
    for name, a, b in zip(disk.initial_mesh._fields, disk.initial_mesh,
                          memory.initial_mesh):
        assert torch.equal(a, b), name
    np.testing.assert_array_equal(disk.mesh_predictions, memory.mesh_predictions)
    assert memory.mask_bank is None and disk.mask_bank is None

    # the JAX loader reads the port's directory as its own
    js = jscene.load_cloth_scene(port_dir, True, eval_split=False)
    assert (js.train.n_views, js.train.n_times) == (VIEWS, 2)
    np.testing.assert_array_equal(js.mesh_predictions, memory.mesh_predictions)
    assert js.radius == memory.radius


def optimizers(jax_scene):
    jc, tc = JConfig(), TConfig()
    for cfg in (jc, tc):
        cfg.model.white_background = True
        for key, value in SCHEDULE.items():
            setattr(cfg.opt, key, value)
        cfg.opt.raster_backend = "tiled"
    return (JSSO(jc, jax_scene, n_times_max=N_TIMES_MAX, seed=0),
            TSSO(tc, jax_scene, n_times_max=N_TIMES_MAX, seed=0, device="cpu"))


def test_single_step_optimizer_matches_jax(jax_scene, monkeypatch):
    jo, to = optimizers(jax_scene)
    # the JAX refiner splits its key once an iteration and draws the split
    # jitter from the subkey; the port's density control is handed the same
    key, subs = jax.random.PRNGKey(0), {}
    for it in range(1, STATIC + 1):
        key, subs[it] = jax.random.split(key)
    density_control = TTrainer.density_control

    def with_jax_jitter(self, state, it, generator=None, eps=None):
        shape = (2,) + tuple(state.params.scaling.shape)
        return density_control(self, state, it, eps=torch.from_numpy(
            np.array(jax.random.normal(subs[it], shape))))

    monkeypatch.setattr(TTrainer, "density_control", with_jax_jitter)

    # the scene holds 2 times; initialize reads them all, as JAX's does
    jo.initialize()
    to.initialize()
    alive0 = int(to.state.gstate.alive.sum())
    jo.static_reconstruction(STATIC)
    to.static_reconstruction(STATIC)
    assert int(to.state.gstate.alive.sum()) != alive0    # densify and prune acted
    for o in (jo, to):
        o.update_data(n_times=2)
        o.update_mesh_predictions(REFINE)
    assert to.n_times == jo.n_times == 2 and to.last_iters == STATIC + REFINE

    js = convert.train_state(tree(jo.state), "cpu")
    ts = to.state
    for f in ("alive", "face_ids", "denom"):
        assert torch.equal(getattr(js.gstate, f), getattr(ts.gstate, f)), f
    assert int(js.step) == int(ts.step) == STATIC + REFINE
    lrs = to.trainer._lr_tree(ts.step - 1)
    for f, a, b in zip(js.params._fields, js.params, ts.params):
        within(f"param {f}", float((a - b).abs().max()), 2.5 * float(getattr(lrs, f)) + 1e-7)
    for tag, mj, mt in (("mu", js.g_opt.mu, ts.g_opt.mu), ("nu", js.g_opt.nu, ts.g_opt.nu)):
        for f, a, b in zip(mj._fields, mj, mt):
            within(f"{tag}.{f} (rel)", float((a - b).abs().max())
                   / (float(a.abs().max()) + 1e-30), TOL_MOMENT)
    sim_lr = to.cfg.meshnet.lr_init
    for k in js.sim_params:
        within(f"sim {k}", float((js.sim_params[k] - ts.sim_params[k]).abs().max()),
               2.5 * sim_lr)
    within("refined positions", float(np.abs(jo.refined_positions()
                                             - to.refined_positions()).max()),
           TOL_REFINED)

    # one refine step of JAX's Pallas tier (interpret mode) against the
    # port's K2/K3 (plain versions on the CPU) from the same state
    jcfg = copy.deepcopy(jo.cfg)
    jcfg.opt.raster_backend = "pallas"
    jt = jo.trainer
    jtr = JTrainer(jcfg, jt.mesh, jt.mesh_predictions, jt.width, jt.height,
                   jt.tanfovx, jt.tanfovy, jo.scene.radius)
    tcfg = copy.deepcopy(to.cfg)
    tcfg.opt.raster_backend = "auto"
    tt = to.trainer
    ttr = TTrainer(tcfg, tt.mesh, tt.mesh_predictions, tt.width, tt.height,
                   tt.tanfovx, tt.tanfovy, to.scene.radius)
    assert ttr.backend == "tiled_train"
    jnext, jm = jtr.step_banked(jo.state, jo.cam_bank, jo.gt_bank, jo.mask_bank,
                                1, [0, 1], sh_degree=0, static=False)
    sd = to.scene
    tnext, tm = ttr.step_banked(js, sd.cam_bank, sd.gt_bank, sd.mask_bank, 1,
                                [0, 1], sh_degree=0, static=False)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
    assert not torch.equal(tnext.g_opt.mu.face_bary, js.g_opt.mu.face_bary)
    jn = convert.train_state(tree(jnext), "cpu")
    for f, a, b in zip(jn.g_opt.mu._fields, jn.g_opt.mu, tnext.g_opt.mu):
        within(f"pallas step mu.{f} (rel)", float((a - b).abs().max())
               / (float(a.abs().max()) + 1e-30), TOL_MOMENT)
    for k in jn.sim_opt.mu:
        a, b = jn.sim_opt.mu[k], tnext.sim_opt.mu[k]
        within(f"pallas step sim mu.{k} (rel)", float((a - b).abs().max())
               / (float(a.abs().max()) + 1e-30), TOL_MOMENT)


def test_mpc_cs_episode_files_and_memory(tmp_path):
    """One planning step (5 static, 3 refine steps) through a scene
    directory and in memory: the same costs, history and refiner state; the
    directory in the JAX package's layout."""
    sim_state = init_cloth_simulator(np.random.default_rng(3), 2, n_message_passing=2,
                                     latent=32, device="cpu")
    runs = {}
    for in_memory in (False, True):
        cfg = PlanningConfig(modality="mpc-cs", max_steps=1, traj_len=4,
                             n_candidates=2, horizon=2, num_samples=36,
                             refine_steps=3, static_steps=5, n_views=VIEWS,
                             image_size=SIZE, seed=0, in_memory=in_memory)
        episode = {}
        out = str(tmp_path / str(in_memory))
        runs[in_memory] = (closed_loop_planning(sim_state, cfg, out, device="cpu",
                                                episode=episode), episode, out)
    (res_f, ep_f, out_f), (res_m, ep_m, out_m) = runs[False], runs[True]
    assert res_f == res_m and len(res_m["costs"]) == 1
    assert np.isfinite(res_m["final_cost"])
    np.testing.assert_array_equal(ep_f["history"], ep_m["history"])
    assert ep_m["history"].shape == (2, 36, 3)
    for name in ("params", "gstate", "g_opt"):
        for a, b in zip(*(leaves(getattr(e["refiner"].state, name))
                          for e in (ep_f, ep_m))):
            assert torch.equal(a, b), name
    for k, v in ep_f["refiner"].state.sim_params.items():
        assert torch.equal(v, ep_m["refiner"].state.sim_params[k]), k

    # the file layout: the scene the JAX loader reads, the refiner's model
    scene = os.path.join(out_f, "cs_scene")
    assert sorted(os.listdir(scene)) == ["init_mesh.hdf5", "mesh_predictions", "test",
                                         "train", "transforms_test.json",
                                         "transforms_train.json"]
    assert sorted(os.listdir(os.path.join(scene, "mesh_predictions"))) == \
        ["mesh_000.hdf5", "mesh_001.hdf5"]
    js = jscene.load_cloth_scene(scene, True, eval_split=False)
    assert (js.train.n_views, js.train.n_times) == (VIEWS, 2)
    model = os.path.join(out_f, "cs_model")
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_8",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(model, "meshnet", "model-8.npz"))
    # in memory, only the result record
    assert os.listdir(out_m) == ["result_mpc-cs.json"]
    assert os.listdir(out_f) and "result_mpc-cs.json" in os.listdir(out_f)


def leaves(tree_) -> list[torch.Tensor]:
    out = []
    for v in tree_:
        out.extend(leaves(v) if hasattr(v, "_fields") else [v])
    return out
