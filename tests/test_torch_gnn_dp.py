"""PyTorch port: data-parallel GNN training over ``torch.distributed``.

A gloo world of 4 ranks on the CPU is spawned once for the module
(``parallel.launch.launch`` running ``torch_mesh_cases.gnn_world``):
``train_meshnet(data_parallel=True)`` at batch 8 (2 samples a rank), 2
epochs of 2 steps with velocity noise, on the JAX sharded test's data
(tests/test_sharded_training.py: 2 trajectories of a 6x6 cloth, 8 steps,
30 sampled nodes; written by the JAX package's ``collect_dataset``), against
the single-process run of the same cut: the losses and the parameters
within 1e-6 (JAX's limit: rtol 1e-4, tests/test_sharded_training.py:367),
the normalizer statistics equal (every
rank accumulates them on the whole batch), every rank's state identical;
the batch-divisibility refusal; ``train_meshnet_sim --data_parallel 1``'s
rank path inside the world writes its checkpoints. The same world's run
without noise is held to the JAX package's ``train_meshnet(data_parallel=
True)`` on 4 of the 8 virtual host devices, from the same initial weights
and batches: losses, parameters and normalizers (``TOL_JAX_*``).
"""

import functools
import glob

import numpy as np
import pytest
import torch

from cloth_splatting_tpu.manipulation.collect import collect_dataset

import torch_mesh_cases as cases
from cloth_splatting_tpu_torch.data.trajectories import ClothSampleDataset
from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
from cloth_splatting_tpu_torch.parallel.launch import launch
from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer, train_meshnet

torch.set_num_threads(1)

CPU = torch.device("cpu")
RUN = dict(num_samples=30, batch_size=8, noise_std=1e-3)
# JAX's limit is rtol 1e-4; the runs read 5e-8 apart (losses), 1.2e-7
# (parameters): the sums over the ranks run in another order
TOL_LOSS = 1e-6
TOL_PARAMS = 1e-6
# the port's 4 gloo ranks against JAX's 4 host devices, tighter than JAX's
# own limit (rtol 1e-4) and tests/test_torch_gnn.py's port-vs-JAX training
# limit (1e-4 of each leaf's largest); read: losses 1.0e-7 relative,
# parameters 1.8e-6 and normalizers 6.4e-8 of their leaf's largest
TOL_JAX_LOSS = 1e-6
TOL_JAX_TRAINED = 1e-5
TOL_JAX_NORM = 1e-6


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_data"))
    collect_dataset(root, n_trajectories=2, nx=6, ny=6, n_steps=8, seed=0)
    return root


@pytest.fixture(scope="module")
def world(data_root, tmp_path_factory):
    model_root = str(tmp_path_factory.mktemp("dp_ckpt"))
    return launch(cases.gnn_world, 4, CPU, args=(data_root, model_root, RUN))[0], model_root


@pytest.fixture(scope="module")
def single(data_root):
    """The single-process run of the same cut."""
    ds = ClothSampleDataset(data_root, input_seq_len=2, future_seq_len=1,
                            num_samples=RUN["num_samples"])
    state = init_cloth_simulator(np.random.default_rng(0), input_sequence_length=2,
                                 n_message_passing=2, latent=16, device=CPU)
    trainer = MeshnetTrainer(lr_init=1e-3, normalize=True, noise_std=RUN["noise_std"],
                             device=CPU)
    return train_meshnet(trainer, state, ds, None, n_epochs=2,
                         batch_size=RUN["batch_size"], curriculum=False, save_every=100,
                         model_dir=None, seed=0, steps_per_epoch=2)


@pytest.fixture(scope="module")
def jax_dp(data_root):
    """The JAX package's ``train_meshnet(data_parallel=True)`` on the same
    cut without noise (JAX's default), its mesh cut to 4 of the 8 virtual
    host devices, as the port's world has 4 ranks."""
    from cloth_splatting_tpu.data.trajectories import ClothSampleDataset as JaxDataset
    from cloth_splatting_tpu.models.cloth_simulator import (
        init_cloth_simulator as jax_init,
    )
    from cloth_splatting_tpu.parallel import mesh as jax_mesh
    from cloth_splatting_tpu.train import meshnet_train as jax_train

    ds = JaxDataset(data_root, input_seq_len=2, future_seq_len=1,
                    num_samples=RUN["num_samples"])
    state = jax_init(np.random.default_rng(0), input_sequence_length=2,
                     n_message_passing=2, latent=16)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_mesh, "make_mesh", functools.partial(jax_mesh.make_mesh, 4))
        return jax_train.train_meshnet(
            jax_train.MeshnetTrainer(lr_init=1e-3, normalize=True), state, ds, None,
            n_epochs=2, batch_size=RUN["batch_size"], curriculum=False, save_every=100,
            model_dir=None, seed=0, steps_per_epoch=2, data_parallel=True)


def jax_pairs(j, t, prefix=""):
    """(path, JAX array, port array) for each leaf of the JAX tree ``j``
    and the port's numpy tree ``t`` (``torch_mesh_cases.arrays``)."""
    if hasattr(j, "_asdict"):
        j = j._asdict()
    if isinstance(j, dict):
        for k in j:
            yield from jax_pairs(j[k], t[k], f"{prefix}{k}/")
    elif isinstance(j, (list, tuple)):
        for i, (a, b) in enumerate(zip(j, t)):
            yield from jax_pairs(a, b, f"{prefix}{i}/")
    else:
        yield prefix, np.asarray(j), t


def test_data_parallel_matches_jax_data_parallel(world, jax_dp):
    """The port's 4 gloo ranks against JAX's data-parallel step on 4 host
    devices: the epoch losses, every GNN parameter and both normalizers."""
    got = world[0]["noiseless"]
    jstate, jlosses = jax_dp
    loss_rel = float(np.max(np.abs(np.subtract(got["losses"], jlosses)) / np.abs(jlosses)))
    rel = {path: float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))
           for path, a, b in jax_pairs(jstate, got["state"])}
    trained = max(v for k, v in rel.items() if k.startswith("gnn/"))
    norms = max(v for k, v in rel.items() if not k.startswith("gnn/"))
    print(f"port 4 ranks vs JAX 4 devices: losses {loss_rel:.3g} relative, "
          f"parameters {trained:.3g}, normalizers {norms:.3g} of each leaf's largest")
    assert len(rel) > 10 and any(k.startswith("node_norm/") for k in rel)
    assert loss_rel <= TOL_JAX_LOSS
    assert trained <= TOL_JAX_TRAINED
    assert norms <= TOL_JAX_NORM


def test_data_parallel_losses_match_single_process(world, single):
    res, _ = world
    _, losses = single
    np.testing.assert_allclose(res["losses"], losses, rtol=TOL_LOSS)
    print(f"data-parallel vs single losses: {res['losses']} / {losses}")


@pytest.mark.parametrize("norm", ["node_norm", "out_norm"])
def test_normalizer_statistics_equal(world, single, norm):
    got, ref = world[0]["state"][norm], cases.arrays(single[0][norm])
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_parameters_match_single_process(world, single):
    """The GNN's parameters after 4 steps."""
    got, ref = world[0]["state"]["gnn"], cases.arrays(single[0]["gnn"])

    def leaves(tree, prefix=""):
        if isinstance(tree, (dict, list)):
            for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    diffs = {name: float(np.abs(a - b).max())
             for (name, a), (_, b) in zip(leaves(got), leaves(ref))}
    print(f"largest parameter differences: {max(diffs.values()):.3g}")
    assert max(diffs.values()) <= TOL_PARAMS


def test_every_rank_keeps_the_same_state(world):
    assert world[0]["ranks_identical"]


def test_batch_divisibility_refusal(world):
    assert world[0]["refusal"] == (
        "--data_parallel needs batch_size (6) divisible by the device count (4)")


def test_command_line_data_parallel_writes_checkpoints(world):
    res, model_root = world
    assert len(res["cli_losses"]) == 1 and np.isfinite(res["cli_losses"]).all()
    assert glob.glob(model_root + "/*/model-*.npz")
    assert glob.glob(model_root + "/*/train_state-*.npz")


def test_sharded_meshnet_step_is_the_data_parallel_step(world):
    """``parallel.mesh.make_sharded_meshnet_step`` (the JAX package's front
    door) gives ``train_step(group=)``'s bits."""
    assert world[0]["front_door"]
