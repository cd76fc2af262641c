"""The MPC's candidate rollout as a captured CUDA graph
(``manipulation.mpc.RolloutGraphs``).

On the CPU (tier 1): the cache key is equal for the same shapes and the same
state leaves (an in-place update included) and differs for each thing a
graph bakes in; the cache keeps its bound and drops the least recently used
key; on a CUDA state a key runs eagerly on its first call, is captured on
its second and replayed after (with a stand-in for the capture); a CPU
state runs eagerly and counts eager calls only.

On the card (marker ``card``, skipped without CUDA; this file imports no
JAX, so it runs without the suite's conftest:
``python -m pytest tests/test_torch_rollout_graph.py -m card --noconftest``),
at the benchmark's rollout shapes (16 candidates x 64 particles, 4 steps, a
MeshGraphNet of 15 blocks of 128): replays give the eager
``rollout_batched``'s bits; one eager call, one capture, then replays; a
replaced parameter leaf, a replaced normalizer or another horizon runs
eagerly and captures anew and an in-place update is read by the next replay,
each giving the eager answer of its state; a returned array is the caller's
own.
"""

import numpy as np
import pytest
import torch

from cloth_splatting_tpu_torch.manipulation import mpc as mpc_module
from cloth_splatting_tpu_torch.manipulation.mpc import (
    GRAPHS_KEPT,
    MPC,
    RolloutGraphs,
    rollout_key,
)
from cloth_splatting_tpu_torch.models.cloth_simulator import (
    init_cloth_simulator,
    rollout_batched,
)
from cloth_splatting_tpu_torch.models.meshnet import normalizer_apply

# graph replays against eager calls of the same state and inputs (m): the
# same kernels in the same order, so the same bits
TOL_REPLAY = 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_rollout_graph.py -m card --noconftest)")
    return torch.device("cuda")


def host_inputs(rng, a=3, v=6, e=5, h=2, hist=2, grasped=0):
    """(pos0, velocity history, node type, edge index, actions, grasped) as
    ``MPC._batched_rollout`` hands them to ``RolloutGraphs``."""
    src = rng.integers(0, v, e)
    return (rng.normal(0, 0.1, (v, 3)).astype(np.float32),
            rng.normal(0, 1e-3, (hist, v, 3)).astype(np.float32),
            (np.arange(v) == grasped).astype(np.int64),
            np.stack([src, (src + 1) % v]).astype(np.int64),
            rng.normal(0, 0.01, (a, h, 3)).astype(np.float32),
            np.asarray(grasped, np.int64))


def tiny_state(device="cpu"):
    return init_cloth_simulator(np.random.default_rng(0), n_message_passing=2, latent=8,
                                device=device)


def test_rollout_key_is_equal_for_the_same_shapes_and_leaves():
    state = tiny_state()
    key = rollout_key(state, host_inputs(np.random.default_rng(1)), 2, True)
    # other values of the same shapes, and the same leaves updated in place
    state["gnn"]["decoder"]["layers"][0]["w"].mul_(2.0)
    state["node_norm"].acc_sum.add_(1.0)
    assert rollout_key(state, host_inputs(np.random.default_rng(2)), 2, True) == key


@pytest.mark.parametrize("change", ["leaf", "normalizer", "h", "A", "V", "E", "normalize"])
def test_rollout_key_differs_for_what_a_graph_bakes_in(change):
    state = tiny_state()
    key = rollout_key(state, host_inputs(np.random.default_rng(1)), 2, True)
    shapes = {"h": {"h": 1}, "A": {"a": 4}, "V": {"v": 7}, "E": {"e": 6}}.get(change, {})
    host = host_inputs(np.random.default_rng(1), **shapes)
    n_steps, normalize = shapes.get("h", 2), change != "normalize"
    if change == "leaf":
        layer = state["gnn"]["processor"][1]["edge"]["layers"][0]
        layer["w"] = layer["w"].clone()
    if change == "normalizer":
        state = {**state, "out_norm": normalizer_apply(state["out_norm"], torch.ones(4, 3),
                                                       accumulate=True)[1]}
    assert rollout_key(state, host, n_steps, normalize) != key


def test_the_cache_keeps_its_bound_and_drops_the_least_recently_used_key():
    assert GRAPHS_KEPT == 4
    graphs = RolloutGraphs()
    for k in range(4):
        graphs.insert(k, f"graph {k}")
    graphs.insert(0, "graph 0")                   # 0 is now the most recent
    graphs.insert(4, "graph 4")
    assert list(graphs.graphs) == [2, 3, 0, 4]    # 1 dropped, not 0
    graphs.insert(5, None)
    assert list(graphs.graphs) == [3, 0, 4, 5]
    assert (graphs.captures, graphs.replays, graphs.eager) == (0, 0, 0)


class StandInCapture:
    """Counts what ``RolloutGraphs`` asks of a captured rollout."""

    made = 0

    def __init__(self, sim_state, host, n_steps, normalize):
        StandInCapture.made += 1
        self.n_steps = n_steps

    def replay(self, host):
        return ("replay", self.n_steps)


def test_a_key_runs_eagerly_first_is_captured_second_and_replayed_after(monkeypatch):
    """The planner's keys: its candidates at h 4, 2 and 1 and its one-step
    prediction, in a default episode's order (12-step plans, horizon 4)."""
    monkeypatch.setattr(mpc_module, "state_device", lambda state: torch.device("cuda"))
    monkeypatch.setattr(mpc_module, "CapturedRollout", StandInCapture)
    monkeypatch.setattr(mpc_module, "eager_rollout",
                        lambda state, host, n_steps, normalize: ("eager", n_steps))
    StandInCapture.made = 0
    state, graphs = tiny_state(), RolloutGraphs()
    rng = np.random.default_rng(4)
    calls = []
    for h in [4] * 4 + [2] + [1] * 15:
        for a, n in ((16, h), (1, 1)):
            calls.append((graphs(state, host_inputs(rng, a=a, h=n), n, True), (a, n)))
    kinds = {}
    for (kind, n), key in calls:
        kinds.setdefault(key, []).append(kind)
        assert n == key[1]
    assert kinds[(16, 4)] == ["eager", "replay", "replay", "replay"]
    assert kinds[(16, 2)] == ["eager"]
    assert kinds[(16, 1)] == ["eager"] + ["replay"] * 14
    assert kinds[(1, 1)] == ["eager"] + ["replay"] * 19
    # a replay's tuple comes from the capturing call as well as later ones
    assert StandInCapture.made == graphs.captures == 3
    assert (graphs.eager, graphs.replays) == (4, 40 - 4 - 3)
    assert len(graphs.graphs) == 4
    # a fifth key drops the least recently used one, (16, 4): seen anew,
    # it runs eagerly again
    graphs(state, host_inputs(rng, a=2, h=3), 3, True)
    assert graphs(state, host_inputs(rng, a=16, h=4), 4, True) == ("eager", 4)
    assert graphs.captures == 3 and graphs.eager == 6


def test_a_cpu_state_runs_eagerly_and_counts_eager_calls_only():
    state = tiny_state()
    rng = np.random.default_rng(3)
    mpc = MPC(state, n_candidates=3, horizon=2)
    outs = []
    for _ in range(3):
        pos0, vel, types, edges, acts, grasped = host_inputs(rng)
        mpc.candidates = acts
        feats = {"pos0": pos0, "velocity_history": vel, "node_type": types,
                 "edge_index": edges, "grasped": int(grasped)}
        outs.append((mpc.model_rollout(feats), rollout_batched(
            state, *(torch.from_numpy(x) for x in (pos0, vel, types, edges, acts)),
            int(grasped), 2).numpy()))
    g = mpc.rollouts
    assert (g.captures, g.replays, g.eager) == (0, 0, 3)
    assert not g.graphs
    for got, want in outs:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ the card

A, SIDE, H, HIST = 16, 8, 4, 2    # the rollout cell: 16 candidates x 64 particles, 4 steps


def grid_graph(rng):
    """An 8 x 8 cloth of 5 cm spacing, edges to the 8 neighbours both ways."""
    ij = np.stack(np.meshgrid(np.arange(SIDE), np.arange(SIDE), indexing="ij"), -1)
    ij = ij.reshape(-1, 2)
    pos = np.concatenate([ij * 0.05, np.zeros((SIDE * SIDE, 1))], 1)
    d = np.abs(ij[:, None] - ij[None]).max(-1)
    edges = np.stack(np.nonzero(d == 1)).astype(np.int64)
    return (pos + rng.normal(0, 1e-3, pos.shape)).astype(np.float32), edges


def card_state(device, seed=0):
    rng = np.random.default_rng(seed)
    state = init_cloth_simulator(rng, input_sequence_length=HIST, n_message_passing=15,
                                 latent=128, device=device)
    feats = torch.as_tensor(rng.normal(0, 1e-3, (512, 2 + 3 * HIST)), dtype=torch.float32,
                            device=device)
    acc = torch.as_tensor(rng.normal(0, 1e-4, (512, 3)), dtype=torch.float32, device=device)
    return {**state, "node_norm": normalizer_apply(state["node_norm"], feats, True)[1],
            "out_norm": normalizer_apply(state["out_norm"], acc, True)[1]}


def card_request(rng, edges, pos, h=H, grasped=5):
    feats = {"pos0": pos + rng.normal(0, 1e-3, pos.shape).astype(np.float32),
             "velocity_history": rng.normal(0, 2e-3, (HIST,) + pos.shape).astype(np.float32),
             "node_type": (np.arange(pos.shape[0]) == grasped).astype(np.int64),
             "edge_index": edges, "grasped": grasped}
    return feats, rng.normal(0, 0.01, (A, h, 3)).astype(np.float32)


def eager(state, feats, acts, device):
    def t(x):
        return torch.as_tensor(x, device=device)

    return rollout_batched(state, t(feats["pos0"]), t(feats["velocity_history"]),
                           t(feats["node_type"]), t(feats["edge_index"]), t(acts),
                           feats["grasped"], acts.shape[1]).cpu().numpy()


def serve(mpc, feats, acts):
    mpc.candidates = acts
    return mpc.model_rollout(feats, horizon=acts.shape[1])


@pytest.mark.card
def test_replays_give_the_eager_rollouts_bits(card):
    rng = np.random.default_rng(11)
    pos, edges = grid_graph(rng)
    state = card_state(card)
    mpc = MPC(state, A, H, HIST)
    reqs = [card_request(rng, edges, pos, grasped=g) for g in (5, 5, 9, 0, 63)]
    outs = [serve(mpc, *r) for r in reqs]
    first = outs[0].copy()
    g = mpc.rollouts
    assert (g.eager, g.captures, g.replays) == (1, 1, len(reqs) - 2)
    # each call returned its own answer, and a later call left the first alone
    np.testing.assert_array_equal(outs[0], first)
    assert all(np.abs(outs[i] - outs[i + 1]).max() > 1e-6 for i in range(len(outs) - 1))
    for out, (feats, acts) in zip(outs, reqs):
        assert out.shape == (A, H + 1, SIDE * SIDE, 3)
        gap = float(np.abs(out - eager(state, feats, acts, card)).max())
        assert gap <= TOL_REPLAY, gap


@pytest.mark.card
@pytest.mark.parametrize("change", ["leaf", "normalizer", "horizon", "in_place"])
def test_a_new_state_or_horizon_captures_anew_and_an_in_place_update_replays(card, change):
    rng = np.random.default_rng(12)
    pos, edges = grid_graph(rng)
    state = card_state(card)
    mpc = MPC(state, A, H, HIST)
    feats, acts = card_request(rng, edges, pos)
    # eager, captured, replayed
    before = [serve(mpc, feats, acts) for _ in range(3)]
    h = H
    if change == "leaf":
        layer = state["gnn"]["processor"][7]["node"]["layers"][1]
        layer["w"] = layer["w"] * 1.5
    elif change == "normalizer":
        state["out_norm"] = normalizer_apply(
            state["out_norm"], torch.full((64, 3), 3e-4, device=card), True)[1]
    elif change == "horizon":
        h = H - 1
    else:
        state["gnn"]["decoder"]["layers"][2]["w"].mul_(1.5)
    after = [serve(mpc, feats, acts[:, :h]) for _ in range(3)]
    g = mpc.rollouts
    assert (g.eager, g.captures, g.replays) == \
        ((1, 1, 4) if change == "in_place" else (2, 2, 2))
    assert sum(entry is not None for entry in g.graphs.values()) == g.captures
    want = eager(state, feats, acts[:, :h], card)
    for out in after:
        assert out.shape == (A, h + 1, SIDE * SIDE, 3)
        gap = float(np.abs(out - want).max())
        assert gap <= TOL_REPLAY, gap
    if change != "horizon":
        assert np.abs(after[-1] - before[-1]).max() > 1e-6
