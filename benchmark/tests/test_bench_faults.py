"""A run with the timed path broken underneath comes out not correct.

Each cell's faults, planted in the program at a tiny size on the CPU (the
harness's look for a card skipped): a step that returns its state
unchanged and half of the batch left out (the training cells), the host
events left out (the fit), and an answer altered where it is produced
(the serving cells). No cell runs across chips, so none leaves out an
exchange between them."""

import numpy as np
import pytest
import torch

from benchmark.tests import tiny


def unchanged_fit(monkeypatch):
    from cloth_splatting_tpu_torch.train.step import Trainer

    step = Trainer.step

    def broken(self, state, *a, **k):
        _, metrics = step(self, state, *a, **k)
        return state, metrics

    monkeypatch.setattr(Trainer, "step", broken)


def half_batch_fit(monkeypatch):
    from cloth_splatting_tpu_torch.train.step import Trainer

    banked = Trainer.step_banked

    def broken(self, state, cam_bank, gt_bank, mask_bank, view_idx, time_ids, *a, **k):
        return banked(self, state, cam_bank, gt_bank, mask_bank, view_idx,
                      list(time_ids)[:2], *a, **k)

    monkeypatch.setattr(Trainer, "step_banked", broken)


def no_events_fit(monkeypatch):
    from cloth_splatting_tpu_torch.train.step import Trainer

    monkeypatch.setattr(Trainer, "density_control", lambda self, state, *a, **k: (state, 0))
    monkeypatch.setattr(Trainer, "cleanup_barycentric", lambda self, state: state)


def unchanged_gnn(monkeypatch):
    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer

    step = MeshnetTrainer.train_step

    def broken(self, state, opt, batch, *a, **k):
        _, new_opt, loss = step(self, state, opt, batch, *a, **k)
        return state, new_opt, loss

    monkeypatch.setattr(MeshnetTrainer, "train_step", broken)


def half_batch_gnn(monkeypatch):
    from cloth_splatting_tpu_torch.train.meshnet_train import MeshnetTrainer

    step = MeshnetTrainer.train_step

    def broken(self, state, opt, batch, *a, **k):
        half = batch["velocity"].shape[0] // 2
        return step(self, state, opt, {key: v[:half] for key, v in batch.items()}, *a, **k)

    monkeypatch.setattr(MeshnetTrainer, "train_step", broken)


def altered_frame(monkeypatch):
    import cloth_splatting_tpu_torch.render as R

    render = R.render

    def broken(*a, **k):
        out = render(*a, **k)
        return out._replace(rgb=out.rgb * 0.99)

    monkeypatch.setattr(R, "render", broken)


def altered_rollout(monkeypatch):
    from cloth_splatting_tpu_torch.manipulation.mpc import MPC

    rollout = MPC.model_rollout

    def broken(self, *a, **k):
        out = rollout(self, *a, **k)
        out[0, -1] += np.float32(1e-3)
        return out

    monkeypatch.setattr(MPC, "model_rollout", broken)


FAULTS = [("fit-cs65k", unchanged_fit), ("fit-cs65k", half_batch_fit),
          ("fit-cs65k", no_events_fit),
          ("gnn-train-mgn15", unchanged_gnn), ("gnn-train-mgn15", half_batch_gnn),
          ("render-cs65k", altered_frame), ("rollout-mpc16", altered_rollout)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    fault(monkeypatch)
    r = tiny.run_cpu(cell)
    assert not r["correct"], r["checks"]
