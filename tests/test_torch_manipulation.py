"""PyTorch port vs the JAX package: the closed-loop manipulation layer (its
planning half, the action tools, demos and deformed meshes) and its entry
points, on the CPU at a small size (8x8 cloths, 36-sample estimation
meshes, a GNN of latent 32 and 2 message-passing layers built from one seed
in both packages).

  - ``ClothEnv`` (reset, picks, steps with repetitions, ``trajectory_dict``)
    and ``goal_fold``;
  - the batched candidate rollout against JAX's ``jax.vmap`` of ``rollout``
    and against A single rollouts of the port;
  - ``MPC``: the candidates bit for bit, ``model_rollout``,
    ``compute_cost`` and ``best_action`` (after asserting that the best
    cost leads the second by more than the costs' tolerance);
  - ``closed_loop_planning`` episodes of ``fixed``, ``random``,
    ``mpc-oracle`` and ``mpc-ol``; the MPC episodes only after each step's
    margin has been asserted in both packages;
  - ``action_space``, ``imitation`` and ``deform_mesh`` on the contracts of
    tests/test_action_space.py, test_imitation.py and test_deform_mesh.py;
  - the five entry points at a tiny size with ``--device cpu``.
"""

import json
import os

import numpy as np
import pytest
import torch

from cloth_splatting_tpu.manipulation import action_space as JA
from cloth_splatting_tpu.manipulation import deform_mesh as JD
from cloth_splatting_tpu.manipulation import imitation as JI
from cloth_splatting_tpu.manipulation import planning as JP
from cloth_splatting_tpu.manipulation.env import ClothEnv as JEnv
from cloth_splatting_tpu.manipulation.env import goal_fold as jgoal_fold
from cloth_splatting_tpu.manipulation.mpc import MPC as JMPC
from cloth_splatting_tpu.models import cloth_simulator as jcs

from cloth_splatting_tpu_torch import collect_demos as t_collect_demos
from cloth_splatting_tpu_torch import deform_mesh as t_deform_mesh_cli
from cloth_splatting_tpu_torch import imitation as t_imitation_cli
from cloth_splatting_tpu_torch import planning as t_planning_cli
from cloth_splatting_tpu_torch import scripted_datacollection as t_scripted
from cloth_splatting_tpu_torch.manipulation import action_space as TA
from cloth_splatting_tpu_torch.manipulation import deform_mesh as TD
from cloth_splatting_tpu_torch.manipulation import imitation as TI
from cloth_splatting_tpu_torch.manipulation import planning as TP
from cloth_splatting_tpu_torch.manipulation.env import ClothEnv as TEnv
from cloth_splatting_tpu_torch.manipulation.env import goal_fold as tgoal_fold
from cloth_splatting_tpu_torch.manipulation.mpc import MPC as TMPC
from cloth_splatting_tpu_torch.models import cloth_simulator as tcs

torch.set_num_threads(1)

# the PBD simulator over a run of steps (m; tests/test_torch_pbd.py's
# TOL_RUN) and the GNN's rollouts (m; tests/test_torch_gnn.py's
# TOL_ROLLOUT); a cost (a mean of squared distances) is held to what that
# moves it by (``cost_tolerance``)
TOL_RUN = 1e-5
# a deformed-mesh sample: a drop, a fold and a settle, up to ~500 steps with
# ground contact and friction (reading 1.3e-5 for the ARTF sample)
TOL_LONG_RUN = 1e-4
TOL_ROLLOUT = 1e-5
# the covered area stamps particle disks on a 100x100 grid, so a particle
# moved by round-off can take or leave a cell: relative
TOL_COVERAGE_REL = 1e-2
SMALL = dict(input_sequence_length=2, n_message_passing=2, latent=32)


def within(name: str, value: float, limit: float) -> None:
    print(f"measured {name}: {value:.3g} (limit {limit:g})")
    assert value <= limit, (name, value, limit)


def models(seed: int = 2):
    return (jcs.init_cloth_simulator(np.random.default_rng(seed), **SMALL),
            tcs.init_cloth_simulator(np.random.default_rng(seed), device="cpu", **SMALL))


# --------------------------------------------------------------------- env

def test_env_and_goal_fold_match_jax():
    je, te = JEnv(nx=8, ny=8, seed=0), TEnv(nx=8, ny=8, seed=0, device="cpu")
    within("reset", float(np.abs(je.reset() - te.reset()).max()), TOL_RUN)
    assert te.corner_ids == je.corner_ids and te.keypoint_ids() == je.keypoint_ids()
    assert len(set(te.keypoint_ids())) == 9
    (ji, jpick, jplace), (ti, tpick, tplace) = je.sample_pick_place(), te.sample_pick_place()
    assert ti == ji
    within("pick/place", float(max(np.abs(tpick - jpick).max(),
                                    np.abs(tplace - jplace).max())), TOL_RUN)
    for env in (je, te):
        env.grasp_particle(ji)
        env.step(np.asarray([0.02, 0.01, 0.0]))
        env.step(np.asarray([0.01, 0.02, -0.01]), repetitions=2)
    jd, td = je.trajectory_dict(), te.trajectory_dict()
    assert sorted(td) == sorted(jd)
    for k in jd:
        assert np.shape(td[k]) == np.shape(jd[k]), k
        within(f"trajectory_dict {k}", float(np.abs(td[k] - jd[k]).max()), TOL_RUN)
    assert td["pos"].shape == (3, 64, 3) and td["actions"].shape == (2, 3)
    assert np.linalg.norm(td["pos"][1, ji] - td["pos"][0, ji]) > 0.005
    te.release()
    with pytest.raises(RuntimeError):
        te.step(np.zeros(3))

    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3))
    pick, place = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_array_equal(tgoal_fold(pts, pick, place),
                                  jgoal_fold(pts, pick, place))


# ------------------------------------------------------------------ rollout

def rollout_inputs(rng, v=20, a=4, steps=3):
    return {
        "pos0": rng.random((v, 3)).astype(np.float32),
        "velocity_history": rng.normal(0, 0.01, (2, v, 3)).astype(np.float32),
        "node_type": np.eye(1, v, 3).ravel().astype(np.int32),
        "edge_index": np.asarray([[i, (i + 1) % v] for i in range(v)]
                                 + [[(i + 1) % v, i] for i in range(v)]).T,
        "grasped": 3,
    }, rng.normal(0, 0.02, (a, steps, 3)).astype(np.float32)


def test_batched_rollout_matches_vmap_and_single_rollouts():
    jstate, tstate = models()
    feats, actions = rollout_inputs(np.random.default_rng(0))
    jm, tm = JMPC(jstate, n_candidates=4, horizon=3), TMPC(tstate, n_candidates=4, horizon=3)
    args = (feats["pos0"], feats["velocity_history"], feats["node_type"],
            feats["edge_index"], actions, feats["grasped"])
    jtraj = np.asarray(jm._batched_rollout(jstate, *args, n_steps=3))
    ttraj = tm._batched_rollout(tstate, *args, 3)
    assert ttraj.shape == (4, 4, 20, 3)
    within("batched rollout vs JAX vmap", float(np.abs(ttraj.numpy() - jtraj).max()),
           TOL_ROLLOUT)

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype))

    singles = torch.stack([tcs.rollout(
        tstate, t(feats["pos0"], np.float32), t(feats["velocity_history"], np.float32),
        t(feats["node_type"], np.int64), t(feats["edge_index"], np.int64),
        t(actions[i], np.float32), 3, n_steps=3)[0] for i in range(4)])
    within("batched rollout vs single rollouts",
           float((ttraj - singles).abs().max()), TOL_ROLLOUT)
    # only each copy's grasped node takes that copy's action
    np.testing.assert_allclose(ttraj[:, 1:, 3].numpy(),
                               feats["pos0"][3] + np.cumsum(actions, axis=1), atol=1e-6)


def mpc_features(rng, v=36):
    pos = rng.random((v, 3)).astype(np.float32) * 0.3
    return {"pos0": pos,
            "velocity_history": rng.normal(0, 0.005, (2, v, 3)).astype(np.float32),
            "node_type": np.eye(1, v, 5).ravel().astype(np.int32),
            "edge_index": np.asarray([[i, j] for i in range(v) for j in range(v)
                                      if i != j and abs(i - j) <= 3]).T,
            "grasped": 5}


def cost_tolerance(cost: float) -> float:
    """How far a cost (the mean of squared distances) can move when every
    coordinate moves by up to TOL_ROLLOUT: 2 sqrt(cost) e + e^2."""
    return 2.0 * float(np.sqrt(cost)) * TOL_ROLLOUT + TOL_ROLLOUT ** 2


def assert_margin(costs: np.ndarray, label: str) -> None:
    """The best cost leads the second best by more than the costs'
    tolerance, so argmin cannot part the two packages."""
    best, second = np.sort(costs)[:2]
    within(f"{label}: cost tolerance / margin to the second best",
           cost_tolerance(best) / (second - best), 1.0)


def test_mpc_rollout_costs_and_best_action_match_jax():
    jstate, tstate = models()
    jm, tm = (cls(s, n_candidates=6, horizon=3, seed=4)
              for cls, s in ((JMPC, jstate), (TMPC, tstate)))
    pick, goal = np.asarray([0.0, 0.0, 0.05]), np.asarray([0.2, 0.0, 0.25])
    for m in (jm, tm):
        m.init_sampler(1.0, 1, pick, goal, 6)
    np.testing.assert_array_equal(tm.candidates, jm.candidates)
    assert tm.candidates.shape == (6, 6, 3)
    feats = mpc_features(np.random.default_rng(5))
    jroll, troll = jm.model_rollout(feats), tm.model_rollout(feats)
    assert troll.shape == (6, 4, 36, 3)
    within("model_rollout", float(np.abs(troll - jroll).max()), TOL_ROLLOUT)
    # a goal at candidate 4's predicted final state, moved 1 mm: a clear
    # best candidate, whatever the rollouts' rounding
    goal_particles = jroll[4, -1] + np.random.default_rng(6).normal(
        0, 1e-3, jroll.shape[2:]).astype(np.float32)
    jc, tc = jm.compute_cost(jroll, goal_particles), tm.compute_cost(troll, goal_particles)
    within("compute_cost", float(np.abs(tc - jc).max()), cost_tolerance(jc.max()))
    assert_margin(jc, "jax")
    assert_margin(tc, "port")
    (jb, ja), (tb, ta) = (m.best_action(r, goal_particles)
                          for m, r in ((jm, jroll), (tm, troll)))
    assert tb == jb == 4
    np.testing.assert_array_equal(ta, ja)
    for m in (jm, tm):
        m.update_candidates(np.asarray([0.01, 0.02, 0.06]))
    np.testing.assert_array_equal(tm.candidates, jm.candidates)
    assert tm.candidates.shape == (6, 5, 3) and tm.step_idx == 1


# ----------------------------------------------------------------- episodes

@pytest.mark.parametrize("modality", ["fixed", "random"])
def test_model_free_episodes_match_jax(modality, tmp_path):
    cfg = dict(modality=modality, max_steps=6, traj_len=6, num_samples=36, seed=0)
    jr = JP.closed_loop_planning(None, JP.PlanningConfig(**cfg))
    tr = TP.closed_loop_planning(None, TP.PlanningConfig(**cfg), str(tmp_path),
                                 device="cpu")
    assert sorted(tr) == sorted(jr) == ["costs", "final_cost", "initial_cost", "modality"]
    assert tr["modality"] == modality and len(tr["costs"]) == 6
    within(f"{modality} costs: difference / tolerance", max(
        abs(t - j) / cost_tolerance(j) for t, j in zip(tr["costs"], jr["costs"])), 1.0)
    with open(tmp_path / f"result_{modality}.json") as f:
        assert json.load(f) == tr
    if modality == "fixed":
        # the scripted fold makes real progress toward the goal
        assert tr["final_cost"] < tr["initial_cost"] * 0.8


@pytest.mark.parametrize("modality", ["mpc-oracle", "mpc-ol"])
def test_mpc_episodes_match_jax(modality, monkeypatch):
    """Each package's episode records its candidates' costs at every step;
    the episodes are compared only after every step's margin is asserted
    in both (an argmin within rounding would part them)."""
    jstate, tstate = models()
    recorded = {"jax": [], "port": []}
    for name, cls in (("jax", JMPC), ("port", TMPC)):
        best_action = cls.best_action

        def recording(self, rollouts, goal, _orig=best_action, _name=name):
            recorded[_name].append(self.compute_cost(rollouts, goal))
            return _orig(self, rollouts, goal)

        monkeypatch.setattr(cls, "best_action", recording)
    cfg = dict(modality=modality, max_steps=3, traj_len=5, n_candidates=4,
               horizon=2, num_samples=36, seed=0)
    jr = JP.closed_loop_planning(jstate, JP.PlanningConfig(**cfg))
    tr = TP.closed_loop_planning(tstate, TP.PlanningConfig(**cfg), device="cpu")
    assert len(recorded["jax"]) == len(recorded["port"]) == 3
    for step, (jc, tc) in enumerate(zip(recorded["jax"], recorded["port"])):
        assert_margin(jc, f"{modality} step {step} jax")
        assert_margin(tc, f"{modality} step {step} port")
        assert int(np.argmin(tc)) == int(np.argmin(jc))
    within(f"{modality} costs: difference / tolerance", max(
        abs(t - j) / cost_tolerance(j) for t, j in zip(tr["costs"], jr["costs"])), 1.0)
    assert np.isfinite(tr["final_cost"])


# ------------------------------------------------------------- action space

def scenes():
    return (JA.PBDScene(nx=8, ny=8, size=0.3, height=0.0, settle_steps=5),
            TA.PBDScene(nx=8, ny=8, size=0.3, height=0.0, settle_steps=5, device="cpu"))


def test_pickers_match_jax():
    js, ts = scenes()
    within("settled scene", float(np.abs(ts.positions - js.positions).max()), TOL_RUN)
    # Picker: ring reset, pick of particle 0, a lift, an over-stretch the
    # spring guard reverts, the boundary clamp, a release
    kw = dict(num_picker=2, picker_threshold=0.05, picker_low=(-1, 0, -1),
              picker_high=(1, 1, 1), init_particle_pos=js.positions)
    jp, tp = JA.Picker(js, **kw), TA.Picker(ts, **kw)
    for p in (jp, tp):
        p.reset(np.array([0.1, 0.05, -0.1]))
    np.testing.assert_array_equal(tp.get_picker_pos(), jp.get_picker_pos())
    start = np.stack([js.positions[0], js.positions[63]]).astype(np.float64)
    for p in (jp, tp):
        p.picker_pos = start.copy()
    for action in ([0.0, 0.05, 0.0, 1.0, 0.0, 0.05, 0.0, 1.0],
                   [-0.4, 0.0, 0.0, 1.0, 0.4, 0.0, 0.0, 1.0],
                   [5.0, 5.0, 5.0, 1.0, 0.0, 0.0, 0.0, 0.0]):
        jp.step(np.array(action))
        tp.step(np.array(action))
        assert tp.picked_particles == jp.picked_particles
        np.testing.assert_allclose(tp.picker_pos, jp.picker_pos, atol=TOL_RUN)
        within("picker scene", float(np.abs(ts.positions - js.positions).max()), TOL_RUN)
        jp.step_sim()
        tp.step_sim()
        within("picker step_sim", float(np.abs(ts.positions - js.positions).max()),
               TOL_RUN)
    assert tp.picked_particles == [0, None]

    # PickerPickPlace: increments with a physics step each, the model's
    # actions without touching the scene
    js, ts = scenes()
    kw = dict(picker_threshold=0.05, delta_move=0.02)
    jpp, tpp = JA.PickerPickPlace(js, **kw), TA.PickerPickPlace(ts, **kw)
    target = np.array([0.1, 0.1, 0.1, 1.0])
    cur = js.positions[0][None].astype(np.float64)
    jacts, jend = jpp.get_model_action(target, cur)
    tacts, tend = tpp.get_model_action(target, cur)
    np.testing.assert_array_equal(np.asarray(tacts), np.asarray(jacts))
    np.testing.assert_array_equal(tend, jend)
    for p in (jpp, tpp):
        p.picker_pos = cur.copy()
    assert tpp.step(target) == jpp.step(target) > 1
    within("pick-place", float(np.abs(ts.positions - js.positions).max()), TOL_RUN)

    # PickerQPG: back-projection to y = particle_radius, then the full
    # hover, grasp, move, drop and settle
    js, ts = scenes()
    kw = dict(image_size=(64, 64), cam_pos=np.array([0.0, 0.8, 0.0]),
              cam_angle=np.array([0.0, -np.pi / 2, 0.0]), picker_threshold=0.05,
              particle_radius=0.01, delta_move=0.05)
    jq, tq = JA.PickerQPG(js, **kw), TA.PickerQPG(ts, **kw)
    world = tq._get_world_coor_from_image(20.0, 40.0)
    np.testing.assert_array_equal(world, jq._get_world_coor_from_image(20.0, 40.0))
    assert world[1] == pytest.approx(0.01)
    action = np.array([0.0, 0.0, 0.05, 0.0, 0.0])
    for q in (jq, tq):
        q.reset(np.zeros(3))
    assert tq.step(action) == jq.step(action) > 20
    within("qpg", float(np.abs(ts.positions - js.positions).max()), TOL_RUN)
    box = TA.Box(np.zeros(2), np.ones(2))
    assert box.contains(box.sample(np.random.default_rng(0))) and not box.contains([2, 0])


# ---------------------------------------------------------- demos, meshes

def test_imitation_matches_jax(tmp_path):
    cfg = dict(height=0.1, n_steps=6)
    jdemo = JI.record_demo(JEnv(nx=8, ny=8, seed=0), JI.HalfFoldConfig(**cfg),
                           num_graph_samples=20)
    path = str(tmp_path / "demo" / "data.h5")
    tdemo = TI.record_demo(TEnv(nx=8, ny=8, seed=0, device="cpu"),
                           TI.HalfFoldConfig(**cfg), num_graph_samples=20, out_path=path)
    assert sorted(tdemo) == sorted(jdemo)
    for k in ("graph_ids", "edge_index", "keypoints_ids", "graph_keypoints_ids"):
        np.testing.assert_array_equal(tdemo[k], jdemo[k], err_msg=k)
    for k in ("pos", "graph", "actions"):
        within(f"demo {k}", float(np.abs(tdemo[k] - jdemo[k]).max()), TOL_RUN)
    within("demo coverage (rel)", float(np.max(np.abs(tdemo["coverage"] - jdemo["coverage"])
                                              / jdemo["coverage"])), TOL_COVERAGE_REL)
    assert tdemo["coverage"][-1] < tdemo["coverage"][0]      # the fold covers less
    # the port's file reads back in both packages
    for load in (TI.load_demo, JI.load_demo):
        back = load(path)
        np.testing.assert_array_equal(back["pos"], tdemo["pos"])
    jres = JI.imitate_demo(JI.load_demo(path), JEnv(nx=8, ny=8, seed=1), **cfg)
    tres = TI.imitate_demo(TI.load_demo(path), TEnv(nx=8, ny=8, seed=1, device="cpu"),
                           **cfg)
    assert sorted(tres) == sorted(jres)
    within("imitation graph_error", abs(tres["graph_error"] - jres["graph_error"]),
           TOL_RUN)
    for k in ("coverage", "demo_coverage", "coverage_ratio"):
        within(f"imitation {k} (rel)", abs(tres[k] - jres[k]) / jres[k], TOL_COVERAGE_REL)
    pts = np.random.default_rng(0).random((40, 3))
    assert TI.covered_area(pts, 0.02) == JI.covered_area(pts, 0.02)


@pytest.mark.parametrize("config", ["artf", "clothfunnels"])
def test_deform_mesh_matches_jax(config, tmp_path):
    cls = {"artf": "ARTFDeformationConfig",
           "clothfunnels": "ClothFunnelsDeformationConfig"}[config]
    kw = dict(nx=6, ny=6, fold_steps=6, image_size=32)
    jres = JD.deform_mesh(getattr(JD, cls)(), None, str(tmp_path / "j"),
                          rng=np.random.default_rng(0), **kw)
    tres = TD.deform_mesh(getattr(TD, cls)(), None, str(tmp_path / "t"),
                          rng=np.random.default_rng(0), device="cpu", **kw)
    assert tres["grasp_idx"] == jres["grasp_idx"] and tres["keypoints"] == jres["keypoints"]
    np.testing.assert_array_equal(tres["faces"], jres["faces"])
    assert tres["particles"].shape == jres["particles"].shape
    within(f"{config} particles", float(np.abs(tres["particles"]
                                               - jres["particles"]).max()), TOL_LONG_RUN)
    files = {d: sorted(os.listdir(tmp_path / "t" / d))
             for d in ("meshes", "cam_params", "images")}
    assert files == {d: sorted(os.listdir(tmp_path / "j" / d)) for d in files}
    assert files["images"] == ["cloth_observations.h5"]
    v, f = TD.load_obj(str(tmp_path / "t" / "meshes" / files["meshes"][-1]))
    np.testing.assert_allclose(v, tres["particles"][-1], atol=1e-5)
    np.testing.assert_array_equal(f, tres["faces"])
    rig = TD.camera_rig(32)
    assert rig == JD.camera_rig(32)
    for cam in rig.values():
        for a, b in zip(TD.render_point_splat(tres["particles"][-1], cam),
                        JD.render_point_splat(tres["particles"][-1], cam)):
            np.testing.assert_array_equal(a, b)
    assert TD.grid_keypoints(6, 6) == JD.grid_keypoints(6, 6)


# ------------------------------------------------------------- entry points

def test_planning_entry_point(tmp_path, capsys):
    rows = t_planning_cli.main(["--modality", "fixed", "--max_steps", "3",
                                "--traj_len", "3", "--num_samples", "36",
                                "--out_dir", str(tmp_path / "f"), "--device", "cpu"])
    assert len(rows) == 1 and np.isfinite(rows[0]["final_cost"])
    assert os.path.exists(tmp_path / "f" / "exp_0" / "result_fixed.json")
    rows = t_planning_cli.main([
        "--modality", "mpc-cs", "--in_memory", "--max_steps", "1", "--traj_len", "3",
        "-A", "2", "-H", "1", "--num_samples", "36", "--refine_steps", "2",
        "--static_steps", "2", "--message_passing", "2", "--n_experiments", "2",
        "--out_dir", str(tmp_path / "cs"), "--device", "cpu"])
    assert [len(r["costs"]) for r in rows] == [1, 1]
    assert sorted(os.listdir(tmp_path / "cs" / "exp_1")) == ["result_mpc-cs.json"]
    assert "UNTRAINED" in capsys.readouterr().out


def test_demo_and_mesh_entry_points(tmp_path):
    demo = str(tmp_path / "demo" / "data.h5")
    res = t_imitation_cli.main(["--demo", demo, "--nx", "6", "--ny", "6",
                                "--num_samples", "12", "--n_steps", "4",
                                "--device", "cpu"])
    assert os.path.exists(demo) and res["coverage"] > 0
    out = t_collect_demos.main(["--out", str(tmp_path / "demos"), "--n_demos", "2",
                                "--nx", "6", "--ny", "6", "--n_steps", "4",
                                "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["demo_0000", "demo_0001"]
    dirs = t_scripted.main(["--dataset_path", str(tmp_path / "sd"), "--n_meshes", "1",
                            "--n_trajs", "2", "--nx", "6", "--ny", "6",
                            "--velocity", "20", "--device", "cpu"])
    import h5py

    with h5py.File(os.path.join(dirs[0], "data.h5"), "r") as f:
        assert f["pos"].shape[1:] == (36, 3) and bool(f["done"][-1])
    dirs = t_deform_mesh_cli.main(["--out", str(tmp_path / "dm"), "--n_samples", "1",
                                   "--nx", "5", "--ny", "5", "--fold_steps", "3",
                                   "--image_size", "16", "--device", "cpu"])
    assert os.path.exists(os.path.join(dirs[0], "images", "cloth_observations.h5"))
