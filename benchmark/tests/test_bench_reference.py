"""The plain references against the program at tiny sizes on the CPU, and
their independence from the program and from JAX."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import graphs
from benchmark.reference import mgn, splat
from benchmark.tests import tiny


def random_proj(n, size, gen):
    def rand(*shape):
        return torch.rand(*shape, generator=gen)

    a = 0.05 + 0.2 * rand(n)
    c = 0.05 + 0.2 * rand(n)
    b = (rand(n) - 0.5) * 0.5 * torch.sqrt(a * c)
    return {"xy": rand(n, 2) * size, "depth": 1 + rand(n), "conic": torch.stack([a, b, c], 1),
            "radius": torch.full((n,), 12.0), "color": rand(n, 3), "opacity": 0.2 + 0.7 * rand(n),
            "valid": torch.ones(n, dtype=torch.bool), "power_cut": torch.full((n,), -4.5)}


def test_compositor_matches_the_programs_oracle():
    from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference

    gen = torch.Generator().manual_seed(0)
    p = random_proj(60, 40, gen)
    bg = torch.tensor([1.0, 1.0, 1.0])
    rgb, depth, alpha, _ = splat.composite(p, 40, 40, bg)
    oracle = rasterize_reference(ProjectedGaussians(**p), 40, 40, bg)
    assert torch.allclose(rgb, oracle[0], atol=1e-5)
    assert torch.allclose(depth, oracle[1][0], atol=1e-5)
    assert torch.allclose(alpha, oracle[2][0], atol=1e-5)


def test_compositor_backward_matches_autograd_of_the_oracle():
    from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
    from cloth_splatting_tpu_torch.ops.rasterize.reference import rasterize_reference

    gen = torch.Generator().manual_seed(1)
    p = random_proj(40, 32, gen)
    bg = torch.tensor([1.0, 1.0, 1.0])
    g = torch.rand(3, 32, 32, generator=gen)
    names = ("xy", "conic", "color", "opacity")
    leaves = {k: p[k].clone().requires_grad_() for k in names}
    splat.composite({**p, **leaves}, 32, 32, bg, grad_rgb=g)
    ref = {k: p[k].clone().requires_grad_() for k in names}
    out = rasterize_reference(ProjectedGaussians(**{**p, **ref}), 32, 32, bg)[0]
    (out * g).sum().backward()
    for k in names:
        assert torch.allclose(leaves[k].grad, ref[k].grad, atol=1e-5, rtol=1e-4), k


def test_gnn_forward_matches_the_program():
    from cloth_splatting_tpu_torch.models.meshnet import apply_encode_process_decode

    cfg = tiny.mgn_config()["network"]
    w = graphs.weights(cfg, torch.Generator().manual_seed(2), torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    nodes = torch.randn(2, 7, 8, generator=gen)
    edges = torch.randn(2, 12, 4, generator=gen)
    ei = torch.randint(0, 7, (2, 2, 12), generator=gen)
    n_layers = cfg["mlp_hidden_layers"] + 1
    ref = mgn.gnn(w, nodes, edges, ei[:, 0], ei[:, 1], n_layers,
                  cfg["message_passing_steps"])
    flat_ei = torch.cat([ei[0], ei[1] + 7], 1)
    prog = apply_encode_process_decode(graphs.tree(w), nodes.reshape(14, 8), flat_ei,
                                       edges.reshape(24, 4))
    assert torch.allclose(ref.reshape(14, 3), prog, atol=1e-5)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cell_agrees_with_its_reference(cell):
    """The whole run of each cell at a tiny size: every compared number well
    inside its limit (the program's plain versions on the CPU)."""
    torch.set_num_threads(2)
    r = tiny.run_cpu(cell)
    assert r["correct"], r["checks"]
    for name, rec in r["checks"].items():
        assert rec["value"] <= rec["limit"] / 10, (name, rec)


def test_references_load_neither_the_program_nor_jax():
    code = ("import sys, json; import benchmark.reference.splat, benchmark.reference.mgn; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(tiny.ROOT)).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & {"cloth_splatting_tpu_torch", "cloth_splatting_tpu", "jax", "jaxlib"}


def test_forbidden_modules_compares_whole_top_level_names(tmp_path):
    for name in ("jax", "jaxlib_extra"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text("")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchmark import run; "
            "import cloth_splatting_tpu_torch, jaxlib_extra; print(run.forbidden_modules()); "
            "import jax; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True, cwd=str(tiny.ROOT)).stdout.splitlines()
    assert out[-2:] == ["[]", "['jax']"]


def test_batches_have_the_programs_layout():
    cfg = tiny.mgn_config()
    rng = np.random.default_rng(0)
    raw = {"pos": np.random.default_rng(1).random((6, 30, 3)).astype(np.float32),
           "actions": np.full((5, 3), 0.01, np.float32),
           "pick": np.zeros(3, np.float32)}
    traj = graphs.process(raw, 12, 2.0, rng)
    b = graphs.sample_batch([traj], rng, 4, 2, cfg["network"]["input_sequence_length"])
    assert b["velocity"].shape == (4, 12, 6) and b["target_vel"].shape == (4, 12, 2, 3)
    assert b["edge_index"].shape[:2] == (4, 2) and b["edge_mask"].dtype == bool
    g = traj["grasped"]
    assert np.allclose(b["particle_actions"][:, g], 0.01)


def test_density_event_matches_the_program():
    """The reference's host events (clone, split, prune, barycentric
    cleanup) against the program's ``density_control`` and
    ``cleanup_barycentric`` on one state with work for each, the same
    split jitter on both sides."""
    from cloth_splatting_tpu_torch.train.config import Config, apply_overrides
    from cloth_splatting_tpu_torch.train.step import SplatTrainState, Trainer, adam_init

    from benchmark.drivers import splat_common as common
    from benchmark.harness import scene as scene_mod

    cfg = tiny.cs_config()
    dev = torch.device("cpu")
    sc = scene_mod.make_scene(cfg, 5, dev)
    ref = dict(sc["ref"], spatial_scale=2.0)
    gen = torch.Generator().manual_seed(6)
    field = {k: v.clone() for k, v in sc["target"].items()}
    alive, cap = sc["alive"], sc["alive"].shape[0]
    n = int(alive.sum())
    field["scaling"][:10] = torch.log(torch.tensor(0.005))   # small: cloned when hot
    field["opacity"][40:44] = -7.0                           # faint: pruned
    field["face_bary"][50:53] = torch.tensor([-0.1, 0.6, 0.5])  # cleaned
    field["face_bary"][60] = torch.tensor([0.5, -0.2, 0.7])
    hot = torch.zeros(cap)
    hot[:6] = 2e-3
    hot[20:27] = 3e-3
    hot[30] = 9e-4
    params, gstate = common.program_field(field, sc["face_ids"], alive)
    gstate = gstate._replace(grad_accum=hot * 2, denom=torch.full((cap,), 2.0),
                             max_radii2d=torch.rand(cap, generator=gen) * 30)
    opt = adam_init(params)
    opt = opt._replace(mu=type(params)(*(torch.rand(p.shape, generator=gen) for p in params)),
                       nu=type(params)(*(torch.rand(p.shape, generator=gen) for p in params)))
    sim = {k: v.clone() for k, v in sc["sim"].items()}
    state = SplatTrainState(params, gstate, opt, sim, adam_init(sim),
                            torch.tensor(3199, dtype=torch.int32))
    pcfg = apply_overrides(Config(), cfg["program_config"])
    trainer = Trainer(pcfg, common.program_mesh(sc["mesh"]), sc["predictions"],
                      ref["width"], ref["height"], ref["tan_fov"], ref["tan_fov"],
                      ref["spatial_scale"])
    eps = torch.randn((2, cap, 3), generator=gen)
    out, overflow = trainer.density_control(state, 3200, eps=eps)
    out = trainer.cleanup_barycentric(out)

    st = {"field": {k: v.clone() for k, v in field.items()}, "alive": alive.clone(),
          "face_ids": sc["face_ids"].clone(), "grad_accum": hot * 2,
          "denom": torch.full((cap,), 2.0), "max_radii": gstate.max_radii2d.clone(),
          "m": dict(opt.mu._asdict()), "v": dict(opt.nu._asdict())}
    o = cfg["program_config"]["OptimizationParams"]
    new = splat.density_event(st, ref, o, 3200, eps, True)

    assert int(overflow) == 0
    added = out.gstate.alive & ~alive
    assert int(added.sum()) == 6 + 7 and int((alive & ~out.gstate.alive).sum()) >= 4
    assert torch.equal(new["alive"], out.gstate.alive)
    assert torch.equal(new["face_ids"], out.gstate.face_ids)
    assert int((new["face_ids"] != sc["face_ids"])[:n].sum()) >= 4
    live = new["alive"]
    for k, v in out.params._asdict().items():
        assert torch.allclose(new["field"][k][live], v[live], atol=1e-6), k
        assert torch.equal(new["m"][k], out.g_opt.mu._asdict()[k]), k
        assert torch.equal(new["v"][k], out.g_opt.nu._asdict()[k]), k
    for a, b in ((new["grad_accum"], out.gstate.grad_accum), (new["denom"], out.gstate.denom),
                 (new["max_radii"], out.gstate.max_radii2d)):
        assert torch.equal(a, b)
