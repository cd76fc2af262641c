"""The fit of a plain 3D Gaussian Splatting scene: the port's point trainer
(``train.points``) on its training rasterizer, from an iteration of the
published schedule, in consecutive segments.

Set-up draws the training views from the seed on the mix's orbit, takes
the scene's extent by the published ``getNerfppNorm`` rule over them,
draws the target field of a ``gs`` configuration from the seed
(``render_points.make_field``: the same field as the render cell) settled
as the schedule holds a field at its first iteration (``settle``: no
Gaussian larger than the configuration's ``settled_scale_of_extent`` x the
extent, under the world-size prune's tenth, which every density event since
the first opacity reset has applied), and renders the ground truth with
the reference (its time is the reference's, not set-up's). The start is
the target moved off by noise, with a share of Gaussians enlarged (for the
split) and a share faded (for the prune), settled again, at the
configuration's capacity, with fresh Adam moments at iteration
``first_iteration - 1``: so the density event among the checked steps
prunes the faded share, and the window trains about the configuration's
``gaussians``.
One ``fit_points`` call a check step runs the first ``check_steps``
iterations, a density event among them, keeping what the check compares.
The window goes on in segments of ``segment`` iterations (the last ends at
a multiple of it), each one ``fit_points`` call with its own seed, and ends
at the first segment boundary after its seconds. Each iteration draws its
view as the published ``train.py`` does: popped at random from a stack of
every view, refilled when empty, from one stream of the run's seed.

``_details`` carries what no reader takes yet: the host milliseconds an
iteration of the window's spans, the live Gaussians when the window starts
and what each of its density events did.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.counts import (
    compositor_backward,
    compositor_forward,
    point_front_backward,
    point_front_end,
)
from benchmark.drivers.render_points import camera, make_field
from benchmark.harness import checks, scene as scene_mod
from benchmark.reference import points, points_fit

# a split parent's log-scales fall by log(1.6) = 0.47 at once; a few Adam
# steps at the scaling's rate move them by 0.02 at most
SPLIT_DROP = -0.2
SPANS = ("forward", "points.project_view", "raster.sort_pack", "backward", "update",
         "points.host_events")


def segment_seed(seed: int, first: int) -> int:
    return (int(seed) + first) % (1 << 31)


def view_draws(n_views: int, seed: int, n: int) -> list:
    """The first ``n`` views of ``train.py``'s draw seeded ``seed``: popped
    at a uniform index off a stack of every view, refilled when empty
    (``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    stack, out = [], []
    for _ in range(n):
        if not stack:
            stack = list(range(n_views))
        out.append(stack.pop(int(rng.integers(len(stack)))))
    return out


def settle(scaling: torch.Tensor, largest: float) -> torch.Tensor:
    """Log-scales [N, 3] with each Gaussian shrunk, its three axes alike,
    so that its largest scale is at most ``largest``."""
    over = torch.clamp_min(scaling.amax(1, keepdim=True) - math.log(largest), 0.0)
    return scaling - over


def population(before: torch.Tensor, after: torch.Tensor) -> tuple[int, int]:
    """(Gaussians added, Gaussians removed) by a host event."""
    return int((after & ~before).sum()), int((before & ~after).sum())


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, int(seed), device
        img = cfg["image"]
        self.width, self.height = img["width"], img["height"]
        self.tan_x = img["tan_half_fov_x"]
        self.tan_y = self.tan_x * self.height / self.width
        self.bg = tuple(float(c) for c in img["background"])
        self.view_seed = [self.seed, 4]

    # ------------------------------------------------------------- set-up

    def _views(self) -> list:
        rng = np.random.default_rng([self.seed, 5])
        tr = self.tr
        return [(float(rng.uniform(*tr["azimuth"])), float(rng.uniform(*tr["elevation"])),
                 float(rng.uniform(*tr["radius"]))) for _ in range(self.cfg["views"])]

    def target_field(self) -> dict:
        """The configuration's field (``make_field``), settled."""
        f = make_field(self.cfg, self.seed, self.dev)
        f["scaling"] = settle(f["scaling"], self.largest)
        return f

    def start_field(self, target: dict, gen: torch.Generator) -> tuple[dict, torch.Tensor]:
        """The start at the configuration's capacity: each live Gaussian's
        mean moved by N(0, (2 p s)^2) per axis (s its mean scale, p the mix's
        ``perturbation``), its colour, SH, log-scales, quaternion and opacity
        logit by noise of p times 2, 0.5, 1, 1 and 5 (``scene.perturb``'s
        shares), then ``scene.unsettle``'s shares enlarged (all three axes)
        and faded, and the log-scales settled; free slots zero with an
        identity quaternion."""
        tr, n, cap = self.tr, self.cfg["gaussians"], self.cfg["capacity"]
        dev = self.dev
        p = tr["perturbation"]

        def noise(x, s):
            return s * p * torch.randn(x.shape, generator=gen, device=dev)

        size = torch.exp(target["scaling"]).mean(1, keepdim=True)
        f = {"xyz": target["xyz"] + 2.0 * size * noise(target["xyz"], 1.0),
             "features_dc": target["features_dc"] + noise(target["features_dc"], 2.0),
             "features_rest": target["features_rest"] + noise(target["features_rest"], 0.5),
             "scaling": target["scaling"] + noise(target["scaling"], 1.0),
             "rotation": target["rotation"] + noise(target["rotation"], 1.0),
             "opacity": target["opacity"] + noise(target["opacity"], 5.0)}
        u = torch.rand(n, generator=gen, device=dev)
        big = u < tr["enlarged"]["share"]
        faint = (u >= tr["enlarged"]["share"]) & (
            u < tr["enlarged"]["share"] + tr["faded"]["share"])
        f["scaling"][big] += math.log(tr["enlarged"]["factor"])
        f["scaling"] = settle(f["scaling"], self.largest)
        o = tr["faded"]["opacity"]
        f["opacity"][faint] = math.log(o / (1.0 - o))
        out = {}
        for k, v in f.items():
            pad = torch.zeros((cap - n,) + tuple(v.shape[1:]), device=dev)
            if k == "rotation":
                pad[:, 0] = 1.0
            out[k] = torch.cat([v, pad]).contiguous()
        alive = torch.zeros(cap, dtype=torch.bool, device=dev)
        alive[:n] = True
        return out, alive

    def setup(self) -> None:
        from cloth_splatting_tpu_torch.models.point_gaussians import (
            PointGaussianParams,
            PointGaussianState,
        )
        from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd
        from cloth_splatting_tpu_torch.render import CameraArrays
        from cloth_splatting_tpu_torch.train.points import (
            PointOptimization,
            PointTrainer,
            PointTrainState,
            ViewStack,
        )
        from cloth_splatting_tpu_torch.train.step import adam_init

        cfg, tr, dev = self.cfg, self.tr, self.dev
        if cfg["raster_pack_order"] != "exact" or cfg["max_splat_radius"] is not None:
            raise ValueError("the point trainer packs in exact order with uncapped splats")
        tile = tiled_fwd.tile_size_for(self.width, self.height)
        if tile != cfg["instance_tile"]:
            raise ValueError(f"the program bins on {tile} px tiles, the check counts on "
                             f"{cfg['instance_tile']} px")
        self.counts = tiled_fwd.COUNTS
        self.cams = [camera(v, self.tan_x, self.tan_y, dev) for v in self._views()]
        self.extent = scene_mod.nerfpp_radius(self.cams)
        self.largest = cfg["settled_scale_of_extent"] * self.extent
        target = self.target_field()
        self.scene = {"width": self.width, "height": self.height, "tan_x": self.tan_x,
                      "tan_y": self.tan_y, "sh_degree": cfg["sh_degree"],
                      "extent": self.extent,
                      "bg": torch.tensor(self.bg, dtype=torch.float32, device=dev)}
        self._sync()
        t_ref = time.perf_counter()
        gt = torch.empty((len(self.cams), 3, self.height, self.width), dtype=torch.uint8,
                         device=dev)
        for v, cam in enumerate(self.cams):
            img, _, _ = points.render(target, cam, self.width, self.height, self.tan_x,
                                      self.tan_y, cfg["sh_degree"], self.scene["bg"])
            gt[v] = torch.round(torch.clamp(img, 0, 1) * 255).to(torch.uint8)
        self.gt = gt
        del target
        self._sync()
        self.reference_s = time.perf_counter() - t_ref

        gen = scene_mod.generator(self.seed, 2, dev)
        self.start, self.alive0 = self.start_field(self.target_field(), gen)
        self.cam_arrays = [CameraArrays(world_view=c["world_view"], full_proj=c["full_proj"],
                                        camera_center=c["center"],
                                        time=torch.zeros((), device=dev))
                           for c in self.cams]
        self.trainer = PointTrainer(PointOptimization(**cfg["optimization"]), self.width,
                                    self.height, self.tan_x, self.tan_y, self.bg,
                                    cfg["sh_degree"], self.extent)
        cap = cfg["capacity"]
        params = PointGaussianParams(**{k: v.clone() for k, v in self.start.items()})
        gstate = PointGaussianState(alive=self.alive0.clone(),
                                    max_radii2d=torch.zeros(cap, device=dev),
                                    grad_accum=torch.zeros(cap, device=dev),
                                    denom=torch.zeros(cap, device=dev))
        state = PointTrainState(params, gstate, adam_init(params))
        self.views = ViewStack(len(self.cams), self.view_seed)

        # the check's steps, one ``fit_points`` call each (the window's own call)
        first = tr["first_iteration"]
        last = first + tr["check_steps"] - 1
        losses, events, emitted, grad1 = [], [], [], None
        for it in range(first, last + 1):
            before = state.gstate.alive.clone()
            n0 = self.counts["instances"]
            state = self._segment(state, it, it, lambda i, loss: losses.append(float(loss)))
            emitted.append(self.counts["instances"] - n0)
            if it == first:
                grad1 = {k: v / 0.1 for k, v in state.opt.mu._asdict().items()}
            if self.events_due(it):
                events.append(population(before, state.gstate.alive))
        self.prog = {"losses": losses, "grad1": grad1, "events": events,
                     "emitted": emitted,
                     "end": {k: v.clone() for k, v in state.params._asdict().items()},
                     "grad_accum": state.gstate.grad_accum.clone(),
                     "alive": state.gstate.alive.clone()}
        self.check_draws = list(zip(range(first, last + 1),
                                    view_draws(len(self.cams), self.view_seed,
                                               tr["check_steps"])))
        self._sync()
        self.state = state
        self.next = last + 1
        self.drawn = tr["check_steps"]

    def events_due(self, it: int) -> bool:
        due = points_fit.events_due(it, self.cfg["optimization"])
        return due["densify"] or due["reset"]

    def _segment(self, state, first: int, last: int, on_iteration=None):
        from cloth_splatting_tpu_torch.train.points import fit_points

        return fit_points(self.trainer, state, self.cam_arrays, self.gt, first, last,
                          self.views, segment_seed(self.seed, first), on_iteration)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # -------------------------------------------------------------- window

    def window(self, seconds: float) -> dict:
        from cloth_splatting_tpu_torch.models import point_gaussians as PG
        from cloth_splatting_tpu_torch.utils import profiling

        seg = self.tr["segment"]
        iters = 0
        host = dict.fromkeys(SPANS, 0.0)
        events = []
        alive = int(self.state.gstate.alive.sum())
        profiling.take_spans()
        profiling.enable_spans(True)
        self._sync()
        t0 = time.perf_counter()
        try:
            while True:
                last = (self.next - 1) // seg * seg + seg
                before = {k: PG.COUNTS[k] for k in ("cloned", "split", "pruned",
                                                    "overflow", "events")}
                self.state = self._segment(self.state, self.next, last)
                iters += last - self.next + 1
                self.drawn += last - self.next + 1
                self.next = last + 1
                for rec in profiling.take_spans():
                    if rec.name in host and rec.end_ns is not None:
                        host[rec.name] += (rec.end_ns - rec.start_ns) / 1e6
                if PG.COUNTS["events"] > before["events"]:
                    events.append(dict({k: PG.COUNTS[k] - v for k, v in before.items()
                                        if k != "events"}, iteration=last,
                                       alive=int(self.state.gstate.alive.sum())))
                self._sync()
                if time.perf_counter() - t0 >= seconds:
                    break
        finally:
            profiling.enable_spans(False)
            profiling.take_spans()
        elapsed = time.perf_counter() - t0
        self.window_details = {"host_ms_per_it": {k: v / max(iters, 1)
                                                  for k, v in host.items()},
                               "alive_at_window_start": alive, "window_events": events}
        return {"metrics": {"fit_it_per_s": iters / elapsed}, "attempted": iters,
                "failed": 0, "elapsed_s": elapsed}

    # --------------------------------------------------------------- trace

    def trace(self, profile) -> tuple[dict, dict]:
        n = self.tr["trace_iterations"]
        first, last = self.next, self.next + n - 1
        start = self.state
        views = view_draws(len(self.cams), self.view_seed, self.drawn + n)[self.drawn:]
        holder = {}

        def run():
            holder["state"] = self._segment(start, first, last)

        tr = profile(run, n, "fit_points")
        self.state, self.next = holder["state"], last + 1
        self.drawn += n
        # the work of those iterations, counted on the state they started from
        field = {k: v.detach() for k, v in start.params._asdict().items()}
        alive = start.gstate.alive
        n_alive = int(alive.sum())
        fwd, bwd, flops = [], [], 0.0
        for v in views:
            item = self.count_item(field, alive, self.cams[v])
            fwd.append(item)
            bwd.append(item)
            flops += (compositor_forward.flops(item) + compositor_backward.flops(item)
                      + point_front_end.flops(n_alive) + point_front_backward.flops(n_alive))
        return tr, {"raster_forward": fwd, "raster_backward": bwd, "flops": flops}

    def count_item(self, field: dict, alive, cam: dict) -> dict:
        """The compositor's work on one camera as the counts take it: live
        pairs before T_EXIT, valid Gaussians, pixels."""
        with torch.no_grad():
            proj = points_fit.project_view(field, alive, cam, self.width, self.height,
                                           self.tan_x, self.tan_y, self.cfg["sh_degree"])
            _, _, pairs = points.composite(proj, self.width, self.height, self.scene["bg"])
        return {"pairs": int(pairs), "gaussians": int(proj["valid"].sum()),
                "pixels": self.width * self.height}

    # --------------------------------------------------------------- check

    def release(self) -> None:
        self.state = None
        self.trainer = None

    def split_jitter(self, it: int) -> torch.Tensor:
        """The split's standard-normal jitter at ``it``: the first draw of the
        ``fit_points`` call seeded as that iteration's."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(segment_seed(self.seed, it))
        return torch.randn((2, self.cfg["capacity"], 3), generator=gen, device=self.dev)

    def reference_run(self, max_radius: float | None = None, events: bool = True) -> dict:
        """The reference's steps from the same start on the same views, with
        the host events of the iterations that have them (``events``), and
        each step's (tile, Gaussian) pairs on the program's tiles."""
        opt = self.cfg["optimization"]
        cap = self.cfg["capacity"]
        dev = self.dev
        st = {"field": {k: v.clone() for k, v in self.start.items()}, "count": 0,
              "alive": self.alive0.clone(), "grad_accum": torch.zeros(cap, device=dev),
              "denom": torch.zeros(cap, device=dev), "max_radii": torch.zeros(cap, device=dev)}
        st["m"] = {k: torch.zeros_like(v) for k, v in st["field"].items()}
        st["v"] = {k: torch.zeros_like(v) for k, v in st["field"].items()}
        losses, grad1, events_seen, pairs = [], None, [], []
        for i, (it, v) in enumerate(self.check_draws):
            gt = self.gt[v].float() / 255.0
            st, loss, proj = points_fit.train_step(st, self.scene, self.cams[v], gt, opt, it,
                                                   max_radius)
            losses.append(loss)
            with torch.no_grad():
                pairs.append(points.tile_pairs(proj, self.width, self.height,
                                               self.cfg["instance_tile"]))
            if i == 0:
                grad1 = {k: st["m"][k] / 0.1 for k in points_fit.FIELD_KEYS}
            if self.events_due(it):
                before = st["alive"]
                if events:
                    densify = points_fit.events_due(it, opt)["densify"]
                    st = points_fit.density_event(st, self.scene, opt, it,
                                                  self.split_jitter(it) if densify else None)
                events_seen.append(population(before, st["alive"]))
        return {"losses": losses, "grad1": grad1, "events": events_seen, "pairs": pairs,
                "end": st["field"], "grad_accum": st["grad_accum"], "alive": st["alive"]}

    def compare(self, prog: dict, ref: dict) -> dict:
        """``fit.Driver.compare``'s numbers over the free-xyz leaves: the
        parameters' change, leaf by leaf, over the rows that only Adam moved
        and that the reference's first gradient reaches; the rows the events
        added or split by their norms leaf by leaf; what the events did by
        their counts; and the instances the first step's pack emitted against
        the reference's tile pairs (later steps' are in the details: the two
        sides' states part by rounding from the first update on).

        The rows ``change`` leaves out: K2 walks a tile until every pixel of
        it is done, so a pixel whose T fell below 1e-4 early goes on
        compositing the tile's later chunks, and the Gaussians behind it
        take gradients of the order of that T; the reference, as the
        published rasterizer, stops each pixel, and gives them none. Adam's
        first steps move every element whose gradient is not zero by about a
        learning rate, whatever its size (ROADMAP, queue 1), so those rows,
        moved by the program alone, would swamp the change of the rest.
        ``change`` takes, leaf by leaf, every kept row whose first reference
        gradient is not zero, however small; ``grad`` takes every row; the
        details count the rows compared and those the program alone
        moved."""
        start, alive0 = self.start, self.alive0
        touched, moved = [], []
        for side in (prog, ref):
            split = alive0 & side["alive"] & (
                (side["end"]["scaling"] - start["scaling"]).amax(1) < SPLIT_DROP)
            touched.append((side["alive"] & ~alive0) | split)
            moved.append(torch.stack([(side["end"][k] != start[k]).reshape(
                alive0.shape[0], -1).any(1) for k in points_fit.FIELD_KEYS]).any(0))
        kept = alive0 & prog["alive"] & ref["alive"] & ~touched[0] & ~touched[1]

        def rows(side, mask):
            return {k: v[mask] for k, v in side.items()}

        nums = checks.training_numbers(
            dict(prog, start=rows(start, kept), end=rows(prog["end"], kept)),
            dict(ref, start=rows(start, kept), end=rows(ref["end"], kept)))
        field = checks.counted_leaves(ref["grad1"])
        dp, dr, compared = {}, {}, {}
        for k in field:
            reached = kept & (ref["grad1"][k].reshape(kept.shape[0], -1) != 0).any(1)
            dp[k] = prog["end"][k][reached] - start[k][reached]
            dr[k] = ref["end"][k][reached] - start[k][reached]
            compared[k] = int(reached.sum())
        nums["change"], nums["_details"]["change"] = checks.leaf_gaps(dp, dr, field)
        gap, leaf = checks.leaf_gaps({k: prog["end"][k][touched[0]] for k in field},
                                     {k: ref["end"][k][touched[1]] for k in field}, field)
        nums["event_rows"] = gap
        a = float(torch.linalg.vector_norm(prog["grad_accum"].double()))
        b = float(torch.linalg.vector_norm(ref["grad_accum"].double()))
        nums["stats"] = abs(a - b) / max(b, 1e-30)
        diff = sum(abs(p - r) for pe, re_ in zip(prog["events"], ref["events"])
                   for p, r in zip(pe, re_))
        nums["population"] = diff / max(1, sum(sum(re_) for re_ in ref["events"]))
        e, p = prog["emitted"][0], ref["pairs"][0]
        nums["instances_rel_gap"] = abs(e - p) / max(p, 1)
        nums["_details"].update(
            events_program=prog["events"], events_reference=ref["events"],
            event_rows=leaf, kept_rows=int(kept.sum()), change_rows=compared,
            moved_by_program_alone=int((kept & moved[0] & ~moved[1]).sum()),
            touched=[int(t.sum()) for t in touched],
            instances_emitted=prog["emitted"], reference_tile_pairs=ref["pairs"],
            **getattr(self, "window_details", {}))
        return nums

    def check(self) -> dict:
        return self.compare(self.prog, self.reference_run())

    def control(self) -> dict:
        """The numbers of the reference run in TF32 in the program's place."""
        with checks.tf32():
            low = self.reference_run()
        return self.compare(dict(low, emitted=low["pairs"]), self.reference_run())

    def faults(self) -> dict:
        """The numbers of the reference put in the program's place with a
        fault planted: splats capped at the cloth field's 24 px, and the host
        events left out."""
        ref = self.reference_run()
        capped = self.reference_run(max_radius=24.0)
        no_events = self.reference_run(events=False)
        return {"capped_24px": self.compare(dict(capped, emitted=capped["pairs"]), ref),
                "no_events": self.compare(dict(no_events, emitted=no_events["pairs"]), ref)}
