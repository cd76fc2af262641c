"""Run one cell of the benchmark once, on the card it is started on.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file it reads, and a traffic mix, ``traffic/<mix>.json``, which names its
driver (``drivers/<driver>.py``) and that driver's parameters. A run sets
the cell up from the seed (the kernels load from the program's build
directory in the checkout), measures for ``--seconds`` and, with
``--trace 1``, profiles a short slice of the same work and reads each
per-layer metric through its reader, ``metrics/<metric>.py`` or the
reader of its kind, ``metrics/<kind>.py``. Once the
window has closed and the peak memory is read, the program's state is
freed and the reference checks what the timed path produced. The last
line of standard output is the result; the last lines of standard error
are the compared numbers beside their limits.

Exit codes: 2 without a usable card (no result), 3 when a JAX module was
loaded (no result), 4 when the program cannot be imported (no result).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cloth_splatting_tpu")
# One H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): fp32
# outside the tensor cores, TF32 on them, HBM3 bandwidth.
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


def set_cache_dirs(root: Path) -> None:
    """Every compiler cache inside the checkout, at fixed paths."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def steady_host() -> None:
    """Load from one process with few threads: BLAS, OpenMP and PyTorch's
    pools at one thread each, and the process held to the same two of the
    cores it may use, so that the host's dispatch does not move between
    cores or wait on idle pool threads. Called before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """A module loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(root: Path, name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py`` where that
    file exists, else the reader of its kind, ``metrics/<kind>.py`` (the
    name up to its first dot: ``idle_share`` of ``idle_share.fit``)."""
    own = root / "benchmark" / "metrics" / f"{name}.py"
    return own if own.is_file() else root / "benchmark" / "metrics" / \
        f"{name.split('.')[0]}.py"


def cell_entries(manifest: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, its configuration entry, its traffic mix) by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return cell, config, load_json(ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_names(manifest: dict, cell: str) -> list:
    return [m["name"] for m in manifest["end_to_end"] if applies(m, cell)]


def per_layer_names(manifest: dict, cell: str) -> list:
    """Per-layer metrics of a cell: those listing it, and those without a
    list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(manifest, cell))
    return [m["name"] for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def run_loaded(manifest: dict, cell_name: str, cfg: dict, traffic: dict, seed: int,
               seconds: float, trace: bool, device, t0: float) -> dict:
    """The result of one run of a cell whose configuration and traffic are
    loaded; ``device`` may be the CPU for the harness's own tests."""
    import torch

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}") \
        .Driver(cfg, traffic, seed, device)
    if device.type == "cuda":
        from cloth_splatting_tpu_torch import kernels

        kernels.build_all()
    driver.setup()
    sync(device)
    # the ground truth the reference renders at set-up is the reference's
    # time, not the program's set-up
    setup_s = time.perf_counter() - t0 - getattr(driver, "reference_s", 0.0)
    # set-up's objects out of the collector's way: the window's collections
    # see the program's garbage alone
    gc.collect()
    gc.freeze()
    win = driver.window(seconds)
    tr = work = None
    if trace:
        from benchmark.harness.trace import profile_slice

        tr, work = driver.trace(profile_slice)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    found = forbidden_modules()
    gc.unfreeze()
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from benchmark.harness.checks import judge

    numbers = driver.check()
    correct, table = judge(numbers, traffic["limits"])
    metrics = {}
    if not trace:
        units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
        values = dict(win["metrics"], setup_s=setup_s)
        for name in end_to_end_names(manifest, cell_name):
            metrics[name] = {"value": values[name], "unit": units[name]}
    else:
        tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
        # the untraced window's seconds a unit of work, for the readers
        # that set device time against the time a unit takes
        unit_s = win["elapsed_s"] / win["attempted"] if win["attempted"] else None
        ctx = {"trace": tr, "work": work, "window": win, "unit_s": unit_s, "tf32": tf32,
               "peak_flops": PEAK_FLOPS["tf32" if tf32 else "fp32"],
               "peak_bytes": PEAK_BYTES}
        units = {m["name"]: m["unit"] for m in manifest["per_layer"]}
        for name in per_layer_names(manifest, cell_name):
            value = load_file(reader_path(ROOT, name)).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["wall_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = table
    result["_forbidden"] = found + [m for m in forbidden_modules() if m not in found]
    result["_details"] = numbers.get("_details")
    return result


def gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    steady_host()
    set_cache_dirs(ROOT)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = cell_entries(manifest, args.workload)
    cfg = load_json(ROOT / config["file"])

    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        importlib.import_module("cloth_splatting_tpu_torch")
    except ImportError as exc:
        print(f"benchmark: the program cannot be imported: {exc!r}", file=sys.stderr)
        return 4
    print(f"benchmark: {args.workload} seed {args.seed} [{gpu_line()}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}]", file=sys.stderr)
    result = run_loaded(manifest, args.workload, cfg, traffic, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda"), T0)
    found = result.pop("_forbidden")
    details = result.pop("_details")
    if found:
        print(f"benchmark: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    if details:
        print(f"benchmark: details of the compared numbers: {json.dumps(details)}",
              file=sys.stderr)
    sys.stderr.flush()
    for name, rec in result["checks"].items():
        print(f"check {name} {rec['value']!r} limit {rec['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
