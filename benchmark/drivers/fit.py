"""The scene fit: ``train.loop.fit_banks`` in consecutive segments.

Set-up builds the scene of a ``cs`` configuration from the seed, renders
its ground truth with the reference, builds one ``Trainer`` and one train
state at iteration ``first_iteration - 1`` (the target field moved off by
noise, a share of it enlarged and a share faded, so that the density
control has work; fresh optimizer moments) and drives that state through
the first ``check_steps`` iterations, one ``fit_banks`` call each (the
window's own call), the host events of a density iteration among them,
keeping what the check compares. The window goes on from there in
segments of ``segment`` iterations (the last ends at a multiple of it),
each one call of ``fit_banks`` with its own seed, and ends at the first
segment boundary after the window's seconds: every iteration and host
event of the window counts, over the window's whole time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.counts import compositor_backward, compositor_forward, front_end
from benchmark.drivers import splat_common as common
from benchmark.harness import checks, scene as scene_mod
from benchmark.reference import splat


def segment_seed(seed: int, first: int) -> int:
    return (int(seed) + first) % (1 << 31)


def draws(seg_seed: int, first: int, last: int, n_views: int, n_times: int) -> list:
    """The (view, three times) of each iteration of a ``fit_banks`` call
    seeded ``seg_seed``: its stream ``default_rng([seed, 1])`` draws a view,
    then a middle time in [1, T - 2]."""
    rng = np.random.default_rng([seg_seed, 1])
    out = []
    for _ in range(first, last + 1):
        v = int(rng.integers(n_views))
        mid = int(rng.integers(1, n_times - 1))
        out.append((v, [mid - 1, mid, mid + 1]))
    return out


# a split parent's scales fall by log(1.6) = 0.47 at once; three Adam steps
# at the scaling's learning rate move them by 0.05 at most
SPLIT_DROP = -0.2


def population(before: tuple, after: tuple) -> tuple[int, int, int]:
    """What a host event did, from (alive, face ids) before and after it:
    Gaussians added, Gaussians removed, and Gaussians kept that moved to
    another face."""
    (alive0, face0), (alive1, face1) = before, after
    grown = alive1.shape[0] - alive0.shape[0]     # a densify overflow grew the capacity
    alive0 = torch.cat([alive0, alive0.new_zeros(grown)])
    face0 = torch.cat([face0, face0.new_zeros(grown)])
    return (int((alive1 & ~alive0).sum()), int((alive0 & ~alive1).sum()),
            int((alive0 & alive1 & (face0 != face1)).sum()))


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, int(seed), device

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from cloth_splatting_tpu_torch.render import CameraArrays
        from cloth_splatting_tpu_torch.train.config import Config, apply_overrides
        from cloth_splatting_tpu_torch.train.step import SplatTrainState, Trainer, adam_init

        cfg, tr, dev = self.cfg, self.tr, self.dev
        sc = scene_mod.make_scene(cfg, self.seed, dev)
        self.sc = sc
        ref = sc["ref"]
        cams = scene_mod.train_cameras(cfg, dev)
        self.cams = cams
        ref["spatial_scale"] = scene_mod.nerfpp_radius([row[0] for row in cams])
        n_v, n_t = cfg["views"], cfg["times"]
        self._sync()
        t_ref = time.perf_counter()
        gt = torch.empty((n_v, n_t, 3, ref["height"], ref["width"]), dtype=torch.uint8,
                         device=dev)
        for v in range(n_v):
            for t in range(n_t):
                img, _ = splat.render(sc["target"], sc["alive"], ref, sc["truth"][t],
                                      cams[v][t], cfg["sh_degree"])
                gt[v, t] = torch.round(torch.clamp(img, 0, 1) * 255).to(torch.uint8)
        self.gt = gt
        self._sync()
        self.reference_s = time.perf_counter() - t_ref
        self.cam_bank = CameraArrays(*(
            torch.stack([torch.stack([c[f] for c in row]) for row in cams])
            for f in ("world_view", "full_proj", "center", "time")))

        pcfg = apply_overrides(Config(), cfg["program_config"])
        self.pcfg = pcfg
        self.trainer = Trainer(pcfg, common.program_mesh(sc["mesh"]), sc["predictions"],
                               ref["width"], ref["height"], ref["tan_fov"], ref["tan_fov"],
                               ref["spatial_scale"])
        start = scene_mod.perturb(sc["target"], tr["perturbation"], sc["gen"])
        start = scene_mod.unsettle(start, sc["alive"], tr["enlarged"], tr["faded"], sc["gen"])
        self.start = {k: v.clone() for k, v in start.items()}
        self.start_sim = {k: v.clone() for k, v in sc["sim"].items()}
        params, gstate = common.program_field(start, sc["face_ids"], sc["alive"])
        sim = {k: v.clone() for k, v in sc["sim"].items()}
        self.first = tr["first_iteration"]
        state = SplatTrainState(params, gstate, adam_init(params), sim, adam_init(sim),
                                torch.tensor(self.first - 1, dtype=torch.int32, device=dev))

        # the check's steps, one ``fit_banks`` call each (the window's own
        # call), with the host events of the iterations that have them
        losses, counts, grad1 = [], [], None
        first = self.first
        last = first + tr["check_steps"] - 1
        for it in range(first, last + 1):
            before = (state.gstate.alive.clone(), state.gstate.face_ids.clone())
            state = self._segment(state, it, it, losses.append)
            if it == first:
                grad1 = {k: v / 0.1 for k, v in state.g_opt.mu._asdict().items()}
                grad1.update({k: v / 0.1 for k, v in state.sim_opt.mu.items()})
                grad1 = {k: v.clone() for k, v in grad1.items()}
            if self.events_due(it):
                counts.append(population(before, (state.gstate.alive, state.gstate.face_ids)))
        self.prog = {"losses": losses, "grad1": grad1, "events": counts,
                     "end": {k: v.clone() for k, v in
                             {**state.params._asdict(), **state.sim_params}.items()},
                     "grad_accum": state.gstate.grad_accum.clone(),
                     "alive": state.gstate.alive.clone(),
                     "face_ids": state.gstate.face_ids.clone()}
        self.check_draws = [(it, *draws(segment_seed(self.seed, it), it, it, n_v, n_t)[0])
                            for it in range(first, last + 1)]
        self._sync()
        self.state = state
        self.next = last + 1

    def events_due(self, it: int) -> bool:
        return any(splat.density_due(self.opt(), it, self.white()).values())

    def opt(self) -> dict:
        pc = self.cfg["program_config"]
        return dict(pc["OptimizationParams"], sim_lr=pc["MeshnetParams"]["lr_init"])

    def white(self) -> bool:
        return bool(self.cfg["program_config"]["ModelParams"]["white_background"])

    def _segment(self, state, first: int, last: int, on_loss=None):
        from cloth_splatting_tpu_torch.train.loop import fit_banks

        self.pcfg.opt.iterations = last
        hook = None if on_loss is None else (lambda it, m: on_loss(m["loss"]))
        return fit_banks(self.trainer, state, self.cam_bank, self.gt, None,
                         first_iter=first, seed=segment_seed(self.seed, first),
                         progress_every=self.tr["progress_every"], on_iteration=hook)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # -------------------------------------------------------------- window

    def window(self, seconds: float) -> dict:
        seg = self.tr["segment"]
        iters = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            last = (self.next - 1) // seg * seg + seg
            self.state = self._segment(self.state, self.next, last)
            iters += last - self.next + 1
            self.next = last + 1
            self._sync()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"metrics": {"fit_it_per_s": iters / elapsed}, "attempted": iters,
                "failed": 0, "elapsed_s": elapsed}

    # --------------------------------------------------------------- trace

    def trace(self, profile) -> tuple[dict, dict]:
        n = self.tr["trace_iterations"]
        first, last = self.next, self.next + n - 1
        start = self.state
        holder = {}

        def run():
            holder["state"] = self._segment(start, first, last)

        tr = profile(run, n, "fit_banks")
        self.state, self.next = holder["state"], last + 1
        # the work of those iterations, counted on the state they started from
        field = {k: v.detach() for k, v in start.params._asdict().items()}
        sim = {k: v.detach() for k, v in start.sim_params.items()}
        ref = dict(self.sc["ref"], face_ids=start.gstate.face_ids)
        alive = start.gstate.alive
        n_v, n_t = self.cfg["views"], self.cfg["times"]
        fwd, bwd, flops = [], [], 0.0
        for v, t_ids in draws(segment_seed(self.seed, first), first, last, n_v, n_t):
            for t in t_ids:
                cam = self.cams[v][t]
                with torch.no_grad():
                    verts = splat.simulate(sim, ref["predictions"], cam["time"])
                item = common.count_item(field, alive, ref, verts, cam,
                                         self.cfg["sh_degree"])
                fwd.append(item)
                bwd.append(item)
                flops += (compositor_forward.flops(item) + compositor_backward.flops(item)
                          + 3 * front_end.flops(int(alive.sum()), verts.shape[0]))
        return tr, {"raster_forward": fwd, "raster_backward": bwd, "flops": flops}

    # --------------------------------------------------------------- check

    def release(self) -> None:
        self.state = None
        self.trainer = None

    def faults(self) -> dict:
        """The numbers of the reference put in the program's place with a
        fault planted: half of each step's batch left out (the last of its
        three cameras; the mean over the rest), and the host events left
        out."""
        ref = self.reference_run()
        return {"half_batch": self.compare(self.reference_run(cameras=2), ref),
                "no_events": self.compare(self.reference_run(events=False), ref)}

    def split_jitter(self, it: int) -> torch.Tensor:
        """The split's standard-normal jitter at ``it``: the draw of the
        ``fit_banks`` call seeded as that iteration's, whose generator is
        seeded with the call's seed and draws only for densification."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(segment_seed(self.seed, it))
        cap = self.sc["alive"].shape[0]
        return torch.randn((2, cap, 3), generator=gen, device=self.dev)

    def reference_run(self, cameras: int | None = None, events: bool = True) -> dict:
        """The reference's steps from the same start on the same cameras
        (the first ``cameras`` of each step's), with the host events of the
        iterations that have them (``events``)."""
        sc, ref, cfg = self.sc, dict(self.sc["ref"]), self.cfg
        dev = self.dev
        opt = self.opt()
        keys = list(splat.FIELD_KEYS) + list(splat.SIM_KEYS)
        cap = sc["alive"].shape[0]
        st = {"field": {k: v.clone() for k, v in self.start.items()},
              "sim": {k: v.clone() for k, v in self.start_sim.items()},
              "count": 0, "step": self.first - 1, "alive": sc["alive"].clone(),
              "face_ids": sc["face_ids"].clone(),
              "grad_accum": torch.zeros(cap, device=dev),
              "denom": torch.zeros(cap, device=dev),
              "max_radii": torch.zeros(cap, device=dev)}
        st["m"] = {k: torch.zeros_like((st["field"] | st["sim"])[k]) for k in keys}
        st["v"] = {k: torch.zeros_like(st["m"][k]) for k in keys}
        losses, grad1, counts = [], None, []
        for i, (it, v, t_ids) in enumerate(self.check_draws):
            t_ids = t_ids[:cameras]
            cams = [self.cams[v][t] for t in t_ids]
            gts = self.gt[v, t_ids].float() / 255.0
            st, loss = splat.train_step(st, ref, cams, gts, opt, cfg["sh_degree"])
            losses.append(loss)
            if i == 0:
                grad1 = {k: st["m"][k] / 0.1 for k in keys}
            if self.events_due(it):
                before = (st["alive"], st["face_ids"])
                if events:
                    eps = (self.split_jitter(it)
                           if splat.density_due(opt, it, self.white())["densify"] else None)
                    st = splat.density_event(st, ref, opt, it, eps, self.white())
                counts.append(population(before, (st["alive"], st["face_ids"])))
        return {"losses": losses, "grad1": grad1, "events": counts,
                "end": {**st["field"], **st["sim"]}, "grad_accum": st["grad_accum"],
                "alive": st["alive"], "face_ids": st["face_ids"]}

    def compare(self, prog: dict, ref: dict) -> dict:
        """The training numbers, with the parameters' change taken over the
        rows that only the optimizer moved on both sides; the rows the host
        events added or split are compared by their norms, leaf by leaf
        (``event_rows``), and what the events did by their counts
        (``population``). A Gaussian at the densification threshold may be
        picked on one side alone by rounding: it adds one row, which would
        swamp a leaf's change, and one count."""
        if prog["end"]["face_bary"].shape != ref["end"]["face_bary"].shape:
            inf = float("inf")
            return {"loss_step1": inf, "grad": inf, "change": inf, "stats": inf,
                    "population": inf, "event_rows": inf, "_details": {"capacity": [
                        prog["end"]["face_bary"].shape[0], ref["end"]["face_bary"].shape[0]]}}
        start = {**self.start, **self.start_sim}
        alive0 = self.sc["alive"]
        touched = []
        for side in (prog, ref):
            split = alive0 & side["alive"] & (
                (side["end"]["scaling"] - start["scaling"]).amax(1) < SPLIT_DROP)
            touched.append((side["alive"] & ~alive0) | split)
        kept = (alive0 & prog["alive"] & ref["alive"] & ~touched[0] & ~touched[1]
                & (prog["face_ids"] == ref["face_ids"]))

        def rows(side, mask):
            return {k: (v[mask] if k in splat.FIELD_KEYS else v) for k, v in side.items()}

        nums = checks.training_numbers(
            dict(prog, start=rows(start, kept), end=rows(prog["end"], kept)),
            dict(ref, start=rows(start, kept), end=rows(ref["end"], kept)))
        field = [k for k in checks.counted_leaves(ref["grad1"]) if k in splat.FIELD_KEYS]
        gap, leaf = checks.leaf_gaps({k: prog["end"][k][touched[0]] for k in field},
                                     {k: ref["end"][k][touched[1]] for k in field}, field)
        nums["event_rows"] = gap
        a = float(torch.linalg.vector_norm(prog["grad_accum"].double()))
        b = float(torch.linalg.vector_norm(ref["grad_accum"].double()))
        nums["stats"] = abs(a - b) / max(b, 1e-30)
        diff = sum(abs(p - r) for pe, re_ in zip(prog["events"], ref["events"])
                   for p, r in zip(pe, re_))
        nums["population"] = diff / max(1, sum(sum(re_) for re_ in ref["events"]))
        nums["_details"].update(events_program=prog["events"], events_reference=ref["events"],
                                event_rows=leaf, kept_rows=int(kept.sum()),
                                touched=[int(t.sum()) for t in touched])
        return nums

    def check(self) -> dict:
        return self.compare(self.prog, self.reference_run())

    def control(self) -> dict:
        """The numbers of the reference run in TF32 in the program's place."""
        with checks.tf32():
            low = self.reference_run()
        return self.compare(low, self.reference_run())
