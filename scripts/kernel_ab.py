"""Times the port's six tile kernels built from two source trees, in one
process on one card, in the order A, B, B, A.

    python3 scripts/kernel_ab.py A_CSRC B_CSRC    # needs a CUDA card and nvcc

``A_CSRC`` and ``B_CSRC`` are ``cloth_splatting_tpu_torch/csrc`` directories
(for example the parent commit's, unpacked with ``git archive`` into a
git-ignored directory, and this checkout's); both are driven through this
checkout's wrappers, so their launch interfaces must agree. For each tree it
builds ``tiled_fwd.cu`` and ``tiled_train.cu`` (one ``nvcc`` each, started
together), prints the kernels' registers, shared memory and spills, and holds
every kernel against its plain version as ``chip_smoke.py`` does (K3 and K4
also against a second launch, bit for bit) on chip_smoke's 65k packs: K1 and
K1-span on the serving pack of orbit view 0, K2, K2-span, K3 and K4 on the
training pack of camera 0 (the three span forms at ``tpp=5``,
``span_cap=41``, a window both trees launch), and holds each of B's kernels
against A's on the same inputs: bit for bit (K2 and K2-span: ``out`` and
the boundaries over the laid rows; one JSON line, ``bit_identical_to_A``),
except K4, whose reduction order may differ between trees: each of its
gradient fields within chip_smoke's TOL_K3 of A's field's largest magnitude
(``k4_vs_A_rel``). With the parent's tree as A, ``bit_identical_to_A`` is
the yardstick of a changed walk: the parent's outputs, not a second walk
kept in the tree. Then it times each kernel in four turns, A, B, B, A:
  - ``ms``, the wrapper call: CUDA events over ITERS back-to-back calls after
    a warm-up (``time_ms``). Once the wrapper's host work takes
    longer than its kernels, this is host time;
  - ``host_ms``, the wrapper's host time per call: a host clock over ITERS
    calls issued without a sync (the card's queue holds them);
  - ``graph_ms``, the wrapper's kernels without its host time: one call
    captured in a CUDA graph, replayed ITERS times back to back (CUDA events);
  - ``kernel_ms``, the kernel alone: torch.profiler's records of its
    launches, without the wrapper's own small kernels (``kernel_records``:
    how many of its 20 launches the profiler kept).
Prints one JSON line per turn and a summary: per kernel and measure the mean
of the A turns, of the B turns, and B / A; exits non-zero when B's kernels
do not give A's results. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ITERS = 50
ORDER = ("A", "B", "B", "A")


def use_tree(csrc: Path) -> dict:
    """Points the port's kernel loader at ``csrc``, builds it, drops the
    loaded libraries and launchers of the other tree; returns the build's
    ptxas usage (empty when it was built before)."""
    import chip_smoke as cs
    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops.rasterize import tiled_fwd, tiled_train

    kernels.CSRC = csrc
    kernels.SOURCES = {name: csrc / path.name for name, path in kernels.SOURCES.items()}
    kernels._loaded.clear()
    tiled_fwd._launchers.cache_clear()
    tiled_train._launchers.cache_clear()
    usage = {}
    for text in kernels.build_all().values():
        usage.update(cs.ptxas_usage(text or ""))
    return usage


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Host time of one call of ``fn`` over ``iters`` calls issued without a
    sync, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn`` captured in a CUDA graph: the
    wrapper's kernels without its host time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the span launchers set a kernel attribute, which global
    # capture mode refuses
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return time_ms(graph.replay, iters)


def main() -> int:
    import torch

    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import (
        chunk_span,
        raster_forward_tiles,
        sorted_pack,
    )
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_train import (
        raster_forward_train,
        run_backward,
    )

    trees = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    gpu = cs.gpu_line()
    dev = torch.device("cuda")
    sc = cs.build_scenes(dev)
    w, h, tile = cs.WIDTH, cs.HEIGHT, sc.tile
    serve = sorted_pack(sc.project(sc.cams[0]), w // tile, h // tile, tile,
                        order="fused")
    train = sc.train_pack
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    n_laid = int(chunk_span(train)[3].sum())
    gimg = tb = None
    outputs = {}
    for label, csrc in trees.items():
        usage = use_tree(csrc)
        print(json.dumps({"tree": label, "csrc": str(csrc), "ptxas": usage}), flush=True)
        cs.compare_k1(serve, w, h, tile, f"{label} 65k view 0")
        cs.compare_k1(serve, w, h, tile, f"{label} 65k view 0", cs.SPAN_32)
        _, _, out, tb_k = cs.compare_k2(train, w, h, tile, f"{label} 65k train cam 0")
        cs.compare_k2(train, w, h, tile, f"{label} 65k train cam 0", cs.SPAN_32)
        if gimg is None:      # both trees get the same cotangent and boundaries
            gimg, tb = cs.cotangent_tiles(out, w, h, tile, gen), tb_k
        cs.compare_k3(train, gimg, tb, w, h, tile, f"{label} 65k train cam 0")
        cs.compare_k3(train, gimg, tb, w, h, tile, f"{label} 65k train cam 0",
                      cs.SPAN_32)
        # what each kernel gives on the same inputs, to hold B's against A's
        fwd_train = [raster_forward_train(train, w, h, tile, cs.BG, *span)
                     for span in ((), cs.SPAN_32)]
        outputs[label] = {
            "K1": (raster_forward_tiles(serve, w, h, tile, cs.BG),),
            "K1-span": (raster_forward_tiles(serve, w, h, tile, cs.BG, *cs.SPAN_32),),
            "K2": (fwd_train[0][0], fwd_train[0][1][:n_laid]),
            "K2-span": (fwd_train[1][0], fwd_train[1][1][:n_laid]),
            "K3": (run_backward(train, gimg, tb, w, h, tile, cs.BG),),
            "K4": (run_backward(train, gimg, tb, w, h, tile, cs.BG, *cs.SPAN_32),),
        }
    identical = {k: all(torch.equal(a, b) for a, b in zip(outputs["A"][k],
                                                          outputs["B"][k]))
                 for k in outputs["A"] if k != "K4"}
    k4_rel = cs.field_errors(outputs["B"]["K4"][0], outputs["A"]["K4"][0],
                             "K4 B vs A", "65k train cam 0")[1]
    agrees = all(identical.values()) and max(k4_rel.values()) <= cs.TOL_K3
    print(json.dumps({"bit_identical_to_A": identical, "k4_vs_A_rel": k4_rel,
                      "k4_tol": cs.TOL_K3, "agrees_with_A": agrees}), flush=True)

    calls = {
        "K1": lambda: raster_forward_tiles(serve, w, h, tile, cs.BG),
        "K1-span": lambda: raster_forward_tiles(serve, w, h, tile, cs.BG, *cs.SPAN_32),
        "K2": lambda: raster_forward_train(train, w, h, tile, cs.BG),
        "K2-span": lambda: raster_forward_train(train, w, h, tile, cs.BG, *cs.SPAN_32),
        "K3": lambda: run_backward(train, gimg, tb, w, h, tile, cs.BG),
        "K4": lambda: run_backward(train, gimg, tb, w, h, tile, cs.BG, *cs.SPAN_32),
    }
    measures = ("ms", "host_ms", "graph_ms", "kernel_ms")
    got = {m: {label: {k: [] for k in calls} for label in trees} for m in measures}
    for turn, label in enumerate(ORDER):
        use_tree(trees[label])
        rows = {m: {} for m in measures}
        records = {}
        for k, fn in calls.items():
            rows["ms"][k] = time_ms(fn, ITERS)
            rows["host_ms"][k] = host_ms(fn, ITERS)
            rows["graph_ms"][k] = graph_ms(fn, ITERS)
            rows["kernel_ms"][k], records[k] = cs.kernel_alone_ms(fn, k)
        for m in measures:
            for k in calls:
                got[m][label][k].append(rows[m][k])
        print(json.dumps({"turn": turn, "tree": label, **rows,
                          "kernel_records": records, "gpu": gpu}), flush=True)

    def stats(d):
        return {k: {"A_ms": sum(d["A"][k]) / 2, "B_ms": sum(d["B"][k]) / 2,
                    "B_over_A": sum(d["B"][k]) / sum(d["A"][k]),
                    "A_turns": d["A"][k], "B_turns": d["B"][k]} for k in calls}

    summary = {"wrapper_call": stats(got["ms"]), "host": stats(got["host_ms"]),
               "graph": stats(got["graph_ms"]),
               "kernel_alone": stats(got["kernel_ms"])}
    print(json.dumps({"summary": summary, "bit_identical_to_A": identical,
                      "k4_vs_A_rel": k4_rel, "agrees_with_A": agrees,
                      "order": "".join(ORDER), "iters": ITERS, "gpu": gpu}))
    return 0 if agrees else 1


if __name__ == "__main__":
    sys.exit(main())
