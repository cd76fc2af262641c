"""Finds where the port's fit stops giving the same bits twice on one card,
shows that ``cloth_splatting_tpu_torch.set_deterministic`` closes it, and
names the kernels the switch adds.

    python3 scripts/determinism_probe.py      # needs a CUDA card and nvcc

For each of three settings in one process (SETTINGS: the switch off, what
the port ran before it was on by default; on with PyTorch's fill of fresh
memory, ``torch.utils.deterministic.fill_uninitialized_memory``; on without
it, the port's default):
  1. whether a floating-point ``torch.cumsum`` on the card raises, and if
     not whether it gives the same bits twice;
  2. ``Trainer.step`` on the benchmark's 65k training configuration (3
     cameras, 800x800) under a dispatch mode that runs every PyTorch
     operation of the step, forward and backward, a second time on copies of
     the same inputs and compares the two results bit for bit: the
     operations whose results differ, with how many of their calls did;
  3. the same step taken twice from one state: the tensors of the new state
     that differ, with their largest difference;
  4. in a fresh process of the setting's own (``--census NAME``): the
     device kernels of one such step and of one 65k serving frame
     (``render``, the first of 8 orbit views) under torch.profiler, counted
     by name, and ms per step and per frame;
  5. ``chip_smoke.py``'s parity cut (the arm ``parity_iso_zeronoise_ema`` at
     full width, 300 iterations) fitted twice with every iteration's loss
     kept: the first iteration whose loss differs between the two fits, the
     tensors of the final states that differ, the alive counts and the
     held-out PSNRs.
Prints one JSON line per setting, then one line of the kernels each "on"
setting adds to or drops from a step and a frame against "off", by name,
and last the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# operations whose two runs may differ by design: fresh memory and draws
# from a generator (a second draw would also move the generator)
SKIP = ("empty", "new_empty", "rand", "normal", "uniform", "bernoulli",
        "multinomial", "exponential", "geometric", "cauchy", "log_normal",
        "random_", "dropout", "set_", "resize_")


def bits(t):
    import torch

    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def same(a, b) -> bool:
    import torch

    from torch.utils._pytree import tree_leaves

    la = [x for x in tree_leaves(a) if isinstance(x, torch.Tensor)]
    lb = [x for x in tree_leaves(b) if isinstance(x, torch.Tensor)]
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def repeat_check():
    """A dispatch mode that runs each operation twice more on copies of its
    inputs and counts, per operation, the calls whose two results differ."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    def copies(args, kwargs):
        def c(x):
            return x.clone() if isinstance(x, torch.Tensor) else x
        return tree_map(c, args), tree_map(c, kwargs)

    class RepeatCheck(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.differ = Counter(), Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.__name__
            if not name.startswith(SKIP):
                self.calls[name] += 1
                runs = []
                for _ in range(2):
                    a, k = copies(args, kwargs)
                    out = func(*a, **k)
                    # a mutating operation's result is its mutated inputs
                    runs.append((out, a, k) if func._schema.is_mutable else out)
                if not same(*runs):
                    self.differ[name] += 1
            return func(*args, **kwargs)

    return RepeatCheck()


def step_probe() -> dict:
    import torch

    import chip_smoke as cs
    from cloth_splatting_tpu_torch.bench import train_setup

    trainer, state, cams, gts = train_setup(cs.WIDTH, cs.HEIGHT, cs.MESH_RES,
                                            cs.TRAIN_CAPACITY, torch.device("cuda"))

    def step(s):
        return trainer.step(s, cams, gts, None, sh_degree=1, static=False)

    state, _ = step(state)                      # warm-up; a state with moments
    mode = repeat_check()
    with mode:
        step(state)
    torch.cuda.synchronize()
    a = cs.state_tensors(step(state)[0])
    b = cs.state_tensors(step(state)[0])
    differ = {k: float((a[k].double() - b[k].double()).abs().max())
              for k in a if not torch.equal(bits(a[k]), bits(b[k]))}
    return {"ops_checked": sum(mode.calls.values()), "calls": dict(mode.calls),
            "ops_that_differ": {k: f"{v} of {mode.calls[k]} calls"
                                for k, v in mode.differ.most_common()},
            "state_tensors_that_differ": differ}


# (name, the package's switch, PyTorch's fill of fresh memory under it)
SETTINGS = (("off", False, True), ("on, fill", True, True), ("on, no fill", True, False))


def apply_setting(on: bool, fill: bool) -> None:
    import torch

    from cloth_splatting_tpu_torch import set_deterministic

    set_deterministic(on)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def float_cumsum() -> dict:
    """A floating-point ``torch.cumsum`` on the card, at K3's plain version's
    shape and as one device-wide scan: the error it raises, or whether two
    calls give the same bits."""
    import torch

    out = {}
    for shape, dim in (((625, 1024, 128), 2), ((1 << 24,), 0)):
        x = torch.rand(shape, device="cuda")
        try:
            same = torch.equal(bits(torch.cumsum(x, dim)), bits(torch.cumsum(x, dim)))
            out[str(shape)] = {"raises": None, "same_bits_twice": same}
        except RuntimeError as e:
            out[str(shape)] = {"raises": str(e).splitlines()[0][:240]}
    return out


def kernel_names(fn) -> Counter:
    """Device kernels of one ``fn()`` under torch.profiler, counted by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter({e.key[:120]: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})


def device_ms(fn, args) -> float:
    """Device ms per call of ``fn(a)`` for each ``a``, one after another
    (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args:
        fn(a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(args)


def census(name: str) -> dict:
    """The kernels of one 65k ``Trainer.step`` and one 65k serving frame by
    name, and their ms (CUDA events; 5 steps, 8 frames after a warm-up),
    under the setting ``name`` of a fresh process."""
    import torch

    import chip_smoke as cs
    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.bench import BG, train_setup
    from cloth_splatting_tpu_torch.render import render

    apply_setting(*next((on, fill) for n, on, fill in SETTINGS if n == name))
    kernels.build_all()
    dev = torch.device("cuda")
    sc = cs.build_scenes(dev)
    trainer, state, cams, gts = train_setup(cs.WIDTH, cs.HEIGHT, cs.MESH_RES,
                                            cs.TRAIN_CAPACITY, dev)

    def step(_=None):
        return trainer.step(state, cams, gts, None, sh_degree=1, static=False)

    def frame(cam=sc.cams[0]):
        return render(cam, cs.WIDTH, cs.HEIGHT, sc.tan, sc.tan, sc.params, sc.state,
                      sc.mesh, sc.simulator, sc.preds, BG, 3, device=dev)

    step(), frame()
    return {"census": name, "gpu": cs.gpu_line(),
            "ms_per_step": device_ms(step, range(5)),
            "ms_per_frame": device_ms(frame, sc.cams),
            "step": kernel_names(step), "frame": kernel_names(frame)}


def added_kernels(base: Counter, other: Counter, top: int = 25) -> dict:
    """The kernels whose count differs from ``base``'s, largest change first."""
    diff = {k: other[k] - base[k] for k in set(base) | set(other) if other[k] != base[k]}
    return {"total": [sum(base.values()), sum(other.values())],
            "by_name": dict(sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:top])}


def fit_probe() -> dict:
    import chip_smoke as cs
    from cloth_splatting_tpu_torch import parity_bench

    args = parity_bench.build_parser().parse_args(cs.PARITY_ARGV)
    fits = []
    for _ in range(2):
        losses = []
        t0 = time.time()
        run = parity_bench.run_in_memory(
            args, on_iteration=lambda it, m: losses.append((it, m["loss"])))
        fits.append((losses, run, time.time() - t0))
    (la, ra, _), (lb, rb, _) = fits
    first = next((it for (it, x), (_, y) in zip(la, lb) if x != y), None)
    a, b = cs.state_tensors(ra["state"]), cs.state_tensors(rb["state"])
    differ = {k: float((a[k].double() - b[k].double()).abs().max())
              for k in a if not (a[k].shape == b[k].shape and same(a[k], b[k]))}
    return {"iterations": len(la), "first_iteration_whose_loss_differs": first,
            "losses_at_first_difference": (
                None if first is None else [la[first - 1][1], lb[first - 1][1]]),
            "final_state_tensors_that_differ": differ,
            "n_gaussians": [ra["n_gaussians"], rb["n_gaussians"]],
            "test_psnr": [ra["line"]["value"], rb["line"]["value"]],
            "seconds": [f[2] for f in fits]}


def main() -> int:
    import subprocess

    import torch

    import chip_smoke as cs
    from cloth_splatting_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("determinism_probe: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--census"]:
        print(json.dumps(census(sys.argv[2])), flush=True)
        return 0
    kernels.build_all()
    gpu = cs.gpu_line()
    counts = {}
    for name, on, fill in SETTINGS:
        # each census in a process of its own: nothing run before it moves it
        run = subprocess.run([sys.executable, __file__, "--census", name],
                             capture_output=True, text=True, check=True)
        counts[name] = json.loads(run.stdout.strip().splitlines()[-1])
        apply_setting(on, fill)
        record = {"setting": name, "deterministic": on, "fill_uninitialized_memory": fill,
                  "float_cumsum": float_cumsum(),
                  "census_ms_per_step": counts[name]["ms_per_step"],
                  "census_ms_per_frame": counts[name]["ms_per_frame"],
                  "kernels_per_step": sum(counts[name]["step"].values()),
                  "kernels_per_frame": sum(counts[name]["frame"].values()),
                  "step": step_probe(), "fit": fit_probe(), "gpu": gpu}
        print(json.dumps(record), flush=True)
    apply_setting(True, False)
    print(json.dumps({"kernels_against_off": {
        name: {what: added_kernels(Counter(counts["off"][what]), Counter(counts[name][what]))
               for what in ("step", "frame")}
        for name, on, _ in SETTINGS if on}}), flush=True)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
