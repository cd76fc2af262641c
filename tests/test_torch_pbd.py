"""PyTorch port vs the JAX package: the PBD cloth simulator, the action
generators and the data collection (GNN slice 6a), on the CPU.

  - ``make_cloth``, ``constraints_from_mesh`` and ``trajectory_gen``: the
    same arrays, bit for bit;
  - one ``cloth_step_multi`` within 1e-6 of JAX's, a settle and a 14-step
    ``run_pick_place`` within 1e-5; two active handles on one particle (the
    last wins, as JAX's drop-mode scatter gives) and an inactive handle;
  - ``collect_trajectories`` against JAX's ``collect_dataset`` files: the
    same draws (pick, place, actions within 1e-5), the h5 layout of
    ``collect_dataset`` equal to JAX's;
  - the ``datacollection`` and ``keypoint_inspection`` entry points in
    process on the CPU; both raise without a card unless ``--device cpu``.
"""

import glob
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloth_splatting_tpu.manipulation import collect as jcollect
from cloth_splatting_tpu.manipulation import sim as jsim
from cloth_splatting_tpu.manipulation import trajectory_gen as jgen

from cloth_splatting_tpu_torch.manipulation import collect as tcollect
from cloth_splatting_tpu_torch.manipulation import sim as tsim
from cloth_splatting_tpu_torch.manipulation import trajectory_gen as tgen

torch.set_num_threads(1)

# one control step: 4 substeps x 12 Jacobi iterations; the sums of the
# constraint corrections run in another order than XLA's scatter
TOL_STEP = 1e-6
# settles and 14-step pick-and-place runs: the step's rounding compounds
TOL_RUN = 1e-5


def within(name: str, value: float, limit: float) -> None:
    """Assert ``value <= limit`` and print the reading (``pytest -s``)."""
    print(f"measured {name}: {value:.3g} (limit {limit:g})")
    assert value <= limit, (name, value, limit)


def np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def t_state(state):
    return {k: v.numpy() for k, v in state._asdict().items()}


def test_make_cloth_bit_equal():
    for nx, ny, size, height in ((8, 8, 0.3, 0.25), (5, 7, 0.5, 0.0)):
        js, jc, jshape = jsim.make_cloth(nx, ny, size, height)
        ts, tc, tshape = tsim.make_cloth(nx, ny, size, height, device="cpu")
        assert jshape == tshape
        for k, v in np_state(js).items():
            np.testing.assert_array_equal(t_state(ts)[k], v, err_msg=k)
        for k in jc._fields:
            np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                          np.asarray(getattr(jc, k)), err_msg=k)
        assert tc.edges.dtype == torch.int64 and ts.pos.dtype == torch.float32


def test_constraints_from_mesh_bit_equal():
    from cloth_splatting_tpu.data.meshing import grid_cloth_mesh

    mesh = grid_cloth_mesh(6, 5, size=0.4)
    verts, faces = np.asarray(mesh.pos), np.asarray(mesh.faces)
    js, jc = jsim.constraints_from_mesh(verts, faces)
    ts, tc = tsim.constraints_from_mesh(verts, faces, device="cpu")
    for k in jc._fields:
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert (jc.stiff == 0.35).any()                    # bending constraints


def test_trajectory_gen_bit_equal():
    pick = np.asarray([0.1, 0.0, -0.05])
    place = np.asarray([-0.12, 0.0, 0.1])
    np.testing.assert_array_equal(tgen.bezier_path(pick, place, 0.1, 9),
                                  jgen.bezier_path(pick, place, 0.1, 9))
    np.testing.assert_array_equal(tgen.bezier_actions(pick, place, 0.1, 9),
                                  jgen.bezier_actions(pick, place, 0.1, 9))
    np.testing.assert_array_equal(tgen.circular_actions(pick, place, 7, 0.9 * np.pi),
                                  jgen.circular_actions(pick, place, 7, 0.9 * np.pi))
    a = tgen.sample_candidate_actions(np.random.default_rng(3), pick, place, 5, 6)
    b = jgen.sample_candidate_actions(np.random.default_rng(3), pick, place, 5, 6)
    np.testing.assert_array_equal(a, b)


def random_state(nx=8, ny=8, seed=0):
    """A cloth in a disturbed pose with velocities: every constraint and the
    ground are active."""
    rng = np.random.default_rng(seed)
    js, jc, _ = jsim.make_cloth(nx, ny, 0.3, height=0.02)
    pos = np.asarray(js.pos) + rng.normal(0, 0.01, (nx * ny, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (nx * ny, 3)).astype(np.float32)
    jstate = jsim.ClothState(jnp.asarray(pos), jnp.asarray(vel))
    _, tc, _ = tsim.make_cloth(nx, ny, 0.3, height=0.02, device="cpu")
    tstate = tsim.ClothState(torch.from_numpy(pos), torch.from_numpy(vel))
    return jstate, jc, tstate, tc


def test_cloth_step_multi_matches_jax():
    jstate, jc, tstate, tc = random_state()
    idx = np.asarray([0, 63], np.int32)
    target = np.asarray([[0.0, 0.1, 0.0], [0.1, 0.05, 0.1]], np.float32)
    active = np.asarray([True, True])
    j = jsim.cloth_step_multi(jstate, jc, jnp.asarray(idx), jnp.asarray(target),
                              jnp.asarray(active))
    t = tsim.cloth_step_multi(tstate, tc, idx, torch.from_numpy(target), active)
    err = {k: float(np.abs(t_state(t)[k] - v).max()) for k, v in np_state(j).items()}
    within("cloth_step_multi pos", err["pos"], TOL_STEP)
    within("cloth_step_multi vel", err["vel"], TOL_STEP / jsim.ClothParams().dt)
    # pinned to start + (target - start) * 1 at the last substep, as in JAX
    np.testing.assert_array_equal(t.pos.numpy()[idx], np.asarray(j.pos)[idx])
    np.testing.assert_allclose(t.pos.numpy()[idx], target, atol=1e-7)


@pytest.mark.parametrize("case", ["duplicate", "inactive"])
def test_grasp_handles_last_active_wins(case):
    """Two active handles on one particle: the last one's target wins, as
    JAX's scatter with duplicates gives on the CPU; an inactive handle on a
    held particle changes nothing."""
    jstate, jc, tstate, tc = random_state()
    if case == "duplicate":
        idx = np.asarray([5, 5, 9], np.int32)
        active = np.asarray([True, True, True])
    else:
        idx = np.asarray([5, 9, 5], np.int32)
        active = np.asarray([True, True, False])
    target = np.asarray([[0.0, 0.1, 0.0], [0.05, 0.2, -0.05], [0.1, 0.0, 0.1]],
                        np.float32)
    j = jsim.cloth_step_multi(jstate, jc, jnp.asarray(idx), jnp.asarray(target),
                              jnp.asarray(active))
    t = tsim.cloth_step_multi(tstate, tc, torch.from_numpy(idx),
                              torch.from_numpy(target), torch.from_numpy(active))
    within(f"{case} handles pos", float(np.abs(t.pos.numpy() - np.asarray(j.pos)).max()),
           TOL_STEP)
    winner = 1 if case == "duplicate" else 0
    np.testing.assert_array_equal(t.pos.numpy()[5], np.asarray(j.pos)[5])
    np.testing.assert_allclose(t.pos.numpy()[5], target[winner], atol=1e-7)


def test_settle_and_pick_place_match_jax():
    js, jc, _ = jsim.make_cloth(8, 8, 0.3, height=0.0)
    ts, tc, _ = tsim.make_cloth(8, 8, 0.3, height=0.0, device="cpu")
    js = jsim.settle(js, jc, n_steps=10)
    ts = tsim.settle(ts, tc, n_steps=10)
    within("settle pos", float(np.abs(ts.pos.numpy() - np.asarray(js.pos)).max()), TOL_RUN)
    pick = np.asarray(js.pos[7])
    actions = jgen.bezier_actions(pick, pick + np.asarray([-0.2, 0.0, 0.15]), 0.1, 14)
    jp, jv, jg, _ = jcollect.run_pick_place(js, jc, 7, actions)
    tp, tv, tg, final = tcollect.run_pick_place(ts, tc, 7, actions)
    assert tp.shape == jp.shape == (15, 64, 3) and tg.shape == jg.shape == (15, 3)
    err = {"pos": float(np.abs(tp - jp).max()), "vel": float(np.abs(tv - jv).max()),
           "gripper": float(np.abs(tg - jg).max())}
    within("run_pick_place pos", err["pos"], TOL_RUN)
    within("run_pick_place gripper", err["gripper"], TOL_RUN)
    within("run_pick_place vel", err["vel"], TOL_RUN / jsim.ClothParams().dt)
    np.testing.assert_array_equal(final.pos.numpy(), tp[-1])


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_pbd")
    return jcollect.collect_dataset(str(root), n_trajectories=3, nx=8, ny=8,
                                    n_steps=14, seed=0)


def h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def test_collect_matches_jax(jax_dataset, tmp_path):
    trajs = tcollect.collect_trajectories(3, 8, 8, 0.3, 14, seed=0, device="cpu")
    jfiles = sorted(glob.glob(os.path.join(jax_dataset, "TOWEL", "*", "trajectory.h5")))
    assert len(trajs) == len(jfiles) == 3
    for t, jf in zip(trajs, jfiles):
        j = h5(jf)
        for k in ("pos", "vel", "actions", "gripper_pos", "pick", "place"):
            assert t[k].shape == j[k].shape, k
        for k, tol in (("pos", TOL_RUN), ("gripper_pos", TOL_RUN), ("pick", TOL_RUN),
                       ("place", TOL_RUN), ("actions", TOL_RUN),
                       ("vel", TOL_RUN / jsim.ClothParams().dt)):
            within(f"collect {k}", float(np.abs(np.asarray(t[k], np.float32) - j[k]).max()),
                   tol)
    out = tcollect.collect_dataset(str(tmp_path / "t"), 3, 8, 8, 0.3, 14, seed=0,
                                   device="cpu")
    tfiles = sorted(glob.glob(os.path.join(out, "TOWEL", "*", "trajectory.h5")))
    assert [os.path.relpath(f, out) for f in tfiles] == \
        [os.path.relpath(f, jax_dataset) for f in jfiles]
    for tf, jf in zip(tfiles, jfiles):
        t, j = h5(tf), h5(jf)
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t["trajectory_params"], j["trajectory_params"])


def test_datacollection_entry_point(tmp_path):
    from cloth_splatting_tpu_torch import datacollection

    out = datacollection.main(["--out", str(tmp_path / "ds"), "--n_trajectories", "2",
                               "--nx", "6", "--ny", "6", "--n_steps", "5",
                               "--device", "cpu"])
    files = sorted(glob.glob(os.path.join(out, "TOWEL", "*", "trajectory.h5")))
    assert len(files) == 2 and h5(files[0])["pos"].shape == (6, 36, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            datacollection.main(["--out", str(tmp_path / "x")])


def test_keypoint_inspection_entry_point(jax_dataset, tmp_path):
    from cloth_splatting_tpu_torch import keypoint_inspection as tk

    written = tk.main(["--dataset", jax_dataset, "--out", str(tmp_path / "figs"),
                       "--device", "cpu"])
    assert written == [str(tmp_path / "figs" / "TOWEL" / "00000" / "img_0.png")]
    assert os.path.getsize(written[0]) > 0
    assert tk._grid_keypoints(64) == [0, 7, 56, 63, 4, 60, 32, 39, 36]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tk.main(["--dataset", jax_dataset])


def test_batched_runs_equal_single_runs():
    """``collect_trajectories`` runs every trajectory in one particle
    system: each copy's result equals ``run_pick_place`` on it alone, bit
    for bit (the copies share no constraint; each particle's corrections
    are summed in the same order)."""
    trajs = tcollect.collect_trajectories(4, 7, 6, 0.3, 9, seed=2, device="cpu")
    state, cons, _ = tsim.make_cloth(7, 6, 0.3, height=0.0, device="cpu")
    state = tsim.settle(state, cons, n_steps=10)
    assert len({int(np.argmin(np.linalg.norm(t["pos"][0] - t["pick"], axis=1)))
                for t in trajs}) > 1                        # different corners
    for t in trajs:
        g = int(np.argmin(np.linalg.norm(t["pos"][0] - t["pick"], axis=1)))
        pos, vel, gripper, _ = tcollect.run_pick_place(state, cons, g, t["actions"])
        np.testing.assert_array_equal(pos, t["pos"])
        np.testing.assert_array_equal(vel, t["vel"])
        np.testing.assert_array_equal(gripper, t["gripper_pos"])
