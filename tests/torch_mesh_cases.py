"""The rank side of tests/test_torch_mesh.py and tests/test_torch_gnn_dp.py.

``parallel.launch.launch`` runs these functions in spawned processes, one a
rank of a gloo world on the CPU; a spawned process imports the module of
the function it runs, so this module imports neither JAX nor pytest. Each
function runs every case of its world and returns, from rank 0, a dict of
numpy results that the test module asserts case by case.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from cloth_splatting_tpu_torch import convert
from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.parallel import mesh as PM
from cloth_splatting_tpu_torch.parallel.trainer import ShardedTrainer
from cloth_splatting_tpu_torch.render import CameraArrays
from cloth_splatting_tpu_torch.train.config import Config
from cloth_splatting_tpu_torch.train.losses import KnnState
from cloth_splatting_tpu_torch.train.step import StepCarry, Trainer


def arrays(tree):
    """Every tensor of a state or metrics tree as numpy, nested dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return {k: arrays(v) for k, v in tree._asdict().items()}
    return [arrays(v) for v in tree]


def splat_config(inputs: dict, backend: str, **opt) -> Config:
    cfg = Config()
    for key, value in {**inputs["opt"], "raster_backend": backend, **opt}.items():
        setattr(cfg.opt, key, value)
    return cfg


def splat_trainer(inputs: dict, cfg: Config, dev) -> Trainer:
    c = inputs["camera"]
    return Trainer(cfg, convert.mesh(inputs["mesh"], dev),
                   torch.from_numpy(inputs["preds"]).to(dev), c["width"],
                   c["height"], c["tanfovx"], c["tanfovy"], c["spatial_lr_scale"])


def banks(inputs: dict, dev):
    cam_bank = CameraArrays(*(torch.from_numpy(inputs["cam_bank"][f]).to(dev)
                              for f in CameraArrays._fields))
    return (cam_bank, torch.from_numpy(inputs["gt_bank"]).to(dev),
            torch.from_numpy(inputs["mask_bank"]).to(dev))


def sharded_step(inputs, dev, shape, backend, time_ids, *, static=False,
                 sh_degree=1, masks=True, knn=True, **opt):
    """One ``ShardedTrainer.step_banked`` on a mesh of ``shape`` from the
    inputs' state; (the full new state, metrics, carry) as numpy."""
    cfg = splat_config(inputs, backend, **opt)
    trainer = splat_trainer(inputs, cfg, dev)
    runner = ShardedTrainer(trainer, PM.make_mesh(data=shape[0]))
    state = convert.train_state(inputs["state"], dev)
    cam_bank, gt_bank, mask_bank = banks(inputs, dev)
    sstate = runner.place_state(state)
    knn_state = None
    if knn and "knn" in inputs:
        # the neighbourhoods the JAX package found (its top-k breaks the toy
        # scene's ties otherwise)
        knn_state = KnnState(*(torch.from_numpy(inputs["knn"][f]).to(dev)
                               for f in KnnState._fields))
        knn_state = knn_state._replace(idx=knn_state.idx.long())
    elif knn:
        knn_state = runner.compute_knn_state(sstate)
    new, metrics, carry = runner.step_banked(
        sstate, cam_bank, gt_bank, mask_bank if masks else None, 1, time_ids,
        sh_degree=sh_degree, static=static, knn_state=knn_state,
        carry=StepCarry.zeros(dev))
    return {"state": arrays(runner.host_state(new)), "metrics": arrays(metrics),
            "carry": arrays(carry)}


def density_case(inputs, dev) -> dict:
    """Density control (densify with a 1e-12 threshold, prune), the
    barycentric cleanup and the capacity rounding on a 2x2 mesh's sharded
    state against the same calls on the full state."""
    cfg = splat_config(inputs, "tiled", densify_from_iter=0, densification_interval=1,
                       pruning_from_iter=0, pruning_interval=1,
                       densify_until_iter=100, densify_grad_threshold_fine_init=1e-12,
                       densify_grad_threshold_after=1e-12)
    trainer = splat_trainer(inputs, cfg, dev)
    runner = ShardedTrainer(trainer, PM.make_mesh(data=2))
    cam_bank, gt_bank, _ = banks(inputs, dev)
    state = convert.train_state(inputs["state"], dev)
    sstate, _, _ = runner.step_banked(runner.place_state(state), cam_bank, gt_bank,
                                      None, 0, [0, 1, 2], sh_degree=1, static=False,
                                      carry=StepCarry.zeros(dev))
    full = runner.host_state(sstate)
    gen_a, gen_b = torch.Generator(), torch.Generator()
    gen_a.manual_seed(5)
    gen_b.manual_seed(5)
    sharded, s_ovf = runner.density_control(sstate, 1, gen_a)
    sharded = runner.cleanup_barycentric(sharded)
    ref, r_ovf = trainer.density_control(full, 1, gen_b)
    ref = trainer.cleanup_barycentric(ref)
    # a state of 130 slots on the 2x2 mesh: rounded to 512, 256 rows a rank
    small = state._replace(
        params=G.GaussianParams(*(p[:130] for p in state.params)),
        gstate=G.GaussianState(*(g[:130] for g in state.gstate)),
        g_opt=state.g_opt._replace(mu=G.GaussianParams(*(m[:130] for m in state.g_opt.mu)),
                                   nu=G.GaussianParams(*(m[:130] for m in state.g_opt.nu))))
    placed = runner.place_state(small)
    return {"sharded": arrays(runner.host_state(sharded)), "ref": arrays(ref),
            "overflow": (s_ovf, r_ovf), "n_alive_before": int(full.gstate.alive.sum()),
            "rounded": [runner._mesh_capacity(n) for n in (513, 130, 1024)],
            "placed_rows": int(placed.params.face_bary.shape[0]),
            "placed_full": arrays(runner.host_state(placed))}


def splat_step_case(inputs, dev) -> dict:
    """``make_sharded_splat_step`` (a camera batch every rank holds) on a
    2x2 mesh: view 1's three cameras, no masks, no kNN."""
    cfg = splat_config(inputs, "auto")
    trainer = splat_trainer(inputs, cfg, dev)
    mesh = PM.make_mesh(data=2)
    runner = ShardedTrainer(trainer, mesh)
    cam_bank, gt_bank, _ = banks(inputs, dev)
    cams = CameraArrays(*(f[1] for f in cam_bank))
    step = PM.make_sharded_splat_step(trainer, mesh, sh_degree=1, static=False)
    new, metrics = step(runner.place_state(convert.train_state(inputs["state"], dev)),
                        cams, gt_bank[1].to(torch.float32) / 255.0)
    return {"state": arrays(runner.host_state(new)), "metrics": arrays(metrics)}


def gathered_render_case(inputs, dev) -> dict:
    """Camera 0 of view 1 rendered on a 1x4 mesh's model axis (this rank's
    block of the capacity, the bundle gathered) against the whole state
    rendered alone, through K2's plain version."""
    from cloth_splatting_tpu_torch.models.deform import simulator_from_params
    from cloth_splatting_tpu_torch.render import TRAIN_BACKEND, render

    trainer = splat_trainer(inputs, splat_config(inputs, "auto"), dev)
    axes = PM.mesh_axes(PM.make_mesh(data=1))
    state = convert.train_state(inputs["state"], dev)
    local = PM.shard_splat_state(state, axes.model)
    cam = CameraArrays(*(f[1, 0] for f in banks(inputs, dev)[0]))

    def image(st, group):
        return render(cam, trainer.width, trainer.height, trainer.tanfovx,
                      trainer.tanfovy, st.params, st.gstate, trainer.mesh,
                      simulator_from_params(st.sim_params), trainer.mesh_predictions,
                      trainer.bg, 1, backend=TRAIN_BACKEND, device=dev,
                      gather_group=group).rgb.detach()

    whole, gathered = image(state, None), image(local, axes.model)
    return {"bit_equal": torch.equal(whole, gathered),
            "max_abs": float((whole - gathered).abs().max())}


def collectives_case(inputs, dev) -> dict:
    """The collectives of one 2x2 step with the kNN terms on, counted by
    ``parallel.mesh.COUNTS``."""
    cfg = splat_config(inputs, "auto")
    trainer = splat_trainer(inputs, cfg, dev)
    runner = ShardedTrainer(trainer, PM.make_mesh(data=2))
    state = runner.place_state(convert.train_state(inputs["state"], dev))
    knn_state = runner.compute_knn_state(state)
    cam_bank, gt_bank, mask_bank = banks(inputs, dev)
    PM.COUNTS.clear()
    runner.step_banked(state, cam_bank, gt_bank, mask_bank, 1, [0, 1, 2],
                       sh_degree=1, static=False, knn_state=knn_state,
                       carry=StepCarry.zeros(dev))
    return dict(PM.COUNTS)


def scene_runs(dev, scene_dir: str, out_root: str, run_cfg: dict) -> dict:
    """``train_scene_rank`` (``train_scene`` on a 2x2 mesh) through a densify
    event, a checkpoint it saved resumed on the mesh, and the train command
    line's rank path (``--mesh 2x2 --device cpu`` inside this world)."""
    from cloth_splatting_tpu_torch.data.scene import load_cloth_scene
    from cloth_splatting_tpu_torch.train.__main__ import main as train_main
    from cloth_splatting_tpu_torch.train.loop import train_scene_rank

    scene = load_cloth_scene(scene_dir, device="cpu")
    cfg = Config()
    cfg.model.white_background = True
    for key, value in run_cfg["opt"].items():
        setattr(cfg.opt, key, value)
    out = os.path.join(out_root, "sharded")
    state = train_scene_rank(dev, (2, 2), copy.deepcopy(cfg), scene, out,
                             run_cfg["kwargs"])
    ckpt = os.path.join(out, f"chkpnt{run_cfg['checkpoint']}.npz")
    resumed = train_scene_rank(dev, (2, 2), copy.deepcopy(cfg), scene,
                               os.path.join(out_root, "resumed"),
                               {"start_checkpoint": ckpt, "progress_every": 1000,
                                "seed": run_cfg["kwargs"]["seed"]})
    cli_out = os.path.join(out_root, "cli")
    train_main(["-s", scene_dir, "-m", cli_out, "--iterations", "4",
                "--static_reconst", "--static_reconst_iteration", "2",
                "--test_iterations", "4", "--save_iterations", "4",
                "--checkpoint_iterations", "4", "--port", "0", "--mesh", "2x2",
                "--device", str(dev)])
    if dist.get_rank():
        return None
    return {"state": arrays(state), "resumed_step": int(resumed.step)}


def splat_world(dev: torch.device, inputs: dict, scene_dir: str, out_root: str,
                run_cfg: dict) -> dict | None:
    """Every splat case of the 4-rank world; rank 0 returns the results."""
    torch.set_num_threads(1)
    out = {"mesh_shapes": {}}
    for d in (1, 2, 4):
        m = PM.make_mesh(data=d)
        out["mesh_shapes"][d] = (tuple(m.shape), tuple(m.mesh_dim_names),
                                 tuple(m.get_coordinate()))
    for backend in ("auto", "tiled"):
        for shape in ((2, 2), (4, 1), (1, 4)):
            out[f"step {shape} {backend}"] = sharded_step(inputs, dev, shape, backend,
                                                          [0, 1, 2])
    out["static 4x1"] = sharded_step(inputs, dev, (4, 1), "auto", [0], static=True,
                                     sh_degree=0, masks=False, knn=False)
    for shape in ((2, 2), (4, 1)):
        out[f"dropped {shape}"] = sharded_step(
            inputs, dev, shape, "tiled", [0, 1, 2], masks=False, knn=False,
            raster_k_cap=8, raster_k_chunk=8)["metrics"]["n_dropped"]
    out["splat_step"] = splat_step_case(inputs, dev)
    out["gathered_render"] = gathered_render_case(inputs, dev)
    out["density"] = density_case(inputs, dev)
    out["collectives"] = collectives_case(inputs, dev)
    out["scene"] = scene_runs(dev, scene_dir, out_root, run_cfg)
    return out if dist.get_rank() == 0 else None


def pair_world(dev: torch.device, inputs: dict) -> dict | None:
    """The 2-rank world: the 2x1 step on the dense tier without the anchor,
    for the comparison with the JAX package's ``ShardedTrainer``."""
    torch.set_num_threads(1)
    res = sharded_step(inputs, dev, (2, 1), "tiled", [0, 1, 2], lambda_anchor=0.0)
    return res if dist.get_rank() == 0 else None


# --------------------------------------------------------------- GNN ranks

def gnn_world(dev: torch.device, data_root: str, model_root: str, run: dict) -> dict:
    """``train_meshnet(data_parallel=True)`` on every rank of the world
    (with the run's noise, and without noise for the comparison with the
    JAX package), the batch-divisibility refusal, and ``train_meshnet_sim
    --data_parallel 1``'s rank path inside this world."""
    from cloth_splatting_tpu_torch import train_meshnet_sim
    from cloth_splatting_tpu_torch.data.trajectories import ClothSampleDataset
    from cloth_splatting_tpu_torch.models.cloth_simulator import init_cloth_simulator
    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer, train_meshnet

    torch.set_num_threads(1)
    ds = ClothSampleDataset(data_root, input_seq_len=2, future_seq_len=1,
                            num_samples=run["num_samples"])
    state = init_cloth_simulator(np.random.default_rng(0), input_sequence_length=2,
                                 n_message_passing=2, latent=16, device=dev)
    trainer = MeshnetTrainer(lr_init=1e-3, normalize=True, noise_std=run["noise_std"],
                             device=dev)
    final, losses = train_meshnet(trainer, state, ds, None, n_epochs=2,
                                  batch_size=run["batch_size"], curriculum=False,
                                  save_every=100, model_dir=None, seed=0,
                                  steps_per_epoch=2, data_parallel=True)
    # the same cut without noise, for the JAX package's data-parallel run
    quiet = MeshnetTrainer(lr_init=1e-3, normalize=True, device=dev)
    quiet_final, quiet_losses = train_meshnet(
        quiet, state, ds, None, n_epochs=2, batch_size=run["batch_size"],
        curriculum=False, save_every=100, model_dir=None, seed=0, steps_per_epoch=2,
        data_parallel=True)
    try:
        train_meshnet(trainer, state, ds, None, n_epochs=1, batch_size=6,
                      steps_per_epoch=1, data_parallel=True)
        refusal = None
    except ValueError as exc:
        refusal = str(exc)
    # the JAX package's front door: one step through make_sharded_meshnet_step
    # equals train_step over the world
    step, place = PM.make_sharded_meshnet_step(trainer, PM.make_mesh(), future=1)
    batch = ds.batch(np.random.default_rng(5), run["batch_size"])
    opt = trainer.init_opt(state)
    trainer.generator.manual_seed(3)
    a = step(state, opt, place(batch), 0)
    trainer.generator.manual_seed(3)
    b = trainer.train_step(state, opt, batch, 0, 1, group=dist.group.WORLD)
    leaves_a, leaves_b = [], []
    G.map_tensors(leaves_a.append, a)
    G.map_tensors(leaves_b.append, b)
    front_door = all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))
    cli = train_meshnet_sim.main([
        "--mode", "train", "--data_path", data_root, "--data_val_path", "/nonexistent",
        "--batch_size", "8", "--ntraining_steps", "1", "--steps_per_epoch", "1",
        "--message_passing", "2", "--num_samples", str(run["num_samples"]),
        "--data_parallel", "1", "--model_path", model_root, "--device", str(dev)])
    # every rank's state, to show they stayed identical
    leaves = []
    G.map_tensors(leaves.append, final)
    mine = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    result = {"losses": losses, "refusal": refusal, "cli_losses": cli,
              "front_door": front_door,
              "ranks_identical": all(torch.equal(e, every[0]) for e in every),
              "state": {k: arrays(v) for k, v in final.items()},
              "noiseless": {"losses": quiet_losses,
                            "state": {k: arrays(v) for k, v in quiet_final.items()}}}
    return result if dist.get_rank() == 0 else None
