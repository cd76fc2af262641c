"""Start the ranks of a multi-device run: one process per device.

The JAX package needs nothing like this: one process owns every device.
The port's ``parallel/mesh.py`` is SPMD over ``torch.distributed``, so a
run of D x M devices is D x M processes. ``launch`` builds every kernel
first (once, in the calling process), spawns the workers (start method
``spawn``), joins them into a process group through a file store in a
fresh temporary directory (no port to collide with), runs ``fn`` on each,
destroys the group and returns each rank's result. A worker's exception
or a worker that dies fails the launch: the others are terminated and
``launch`` raises with the rank's traceback. Ranks other than 0 write
nothing to standard output.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch

# how long a collective waits for a rank before it fails the run
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=1800)


def rank_devices(world_size: int, device: str | torch.device) -> list[str]:
    """Rank r's device: ``cuda:r`` for a card (one card a rank), the CPU
    for every rank of a CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [f"cuda:{r}" for r in range(world_size)]
    return ["cpu"] * world_size


def _indexed(device) -> str:
    """``device`` by name, a card with its index (an index-less ``cuda`` is
    a fresh process's current card, ``cuda:0``)."""
    dev = torch.device(device)
    return "cuda:0" if dev.type == "cuda" and dev.index is None else str(dev)


def _worker(rank: int, world_size: int, backend: str, devices: list[str],
            init_file: str, queue, fn, args) -> None:
    try:
        import torch.distributed as dist

        import cloth_splatting_tpu_torch  # noqa: F401  (the deterministic switch)

        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        if rank:
            sys.stdout = open(os.devnull, "w")
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size, timeout=COLLECTIVE_TIMEOUT)
        try:
            result = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, pickle.dumps(result)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world_size: int, device: str | torch.device = "cuda",
           args: Sequence[Any] = (), backend: str | None = None,
           devices: Sequence[str] | None = None) -> list[Any]:
    """``fn(device, *args)`` on ``world_size`` ranks, each its own process
    in one ``torch.distributed`` group; returns the results by rank (each
    must pickle; return CPU tensors or numpy). ``backend`` defaults to
    ``nccl`` on a card and ``gloo`` on the CPU; ``devices`` (default
    ``rank_devices``) names each rank's device, e.g. two gloo ranks sharing
    ``cuda:0``. ``fn`` must live in a module a fresh process can import."""
    import torch.multiprocessing as mp

    devices = [_indexed(d) for d in (devices or rank_devices(world_size, device))]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    on_card = any(torch.device(d).type == "cuda" for d in devices)
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card:
        from cloth_splatting_tpu_torch import kernels

        kernels.build_all()
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    results: dict[int, Any] = {}
    errors: dict[int, str] = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker, args=(
            r, world_size, backend, devices, os.path.join(tmp, "store"), queue, fn,
            tuple(args))) for r in range(world_size)]
        for p in procs:
            p.start()

        def drain():
            while not queue.empty():
                rank, ok, payload = queue.get()
                if ok:
                    results[rank] = pickle.loads(payload)
                else:
                    errors[rank] = payload

        try:
            running = set(range(world_size))
            while running and not errors:
                drain()
                for r in [r for r in running if not procs[r].is_alive()]:
                    running.discard(r)
                    drain()
                    if procs[r].exitcode and r not in errors:
                        errors[r] = f"exited with code {procs[r].exitcode}"
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{errors[rank]}")
    missing = [r for r in range(world_size) if r not in results]
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [results[r] for r in range(world_size)]


def main_rank(device: torch.device, module: str, argv: Sequence[str]):
    """One rank of a command line: ``module``'s ``main(argv)`` with this
    rank's ``--device``; ``main`` sees the initialized group and runs its
    rank's share."""
    import importlib

    return importlib.import_module(module).main(
        list(argv) + ["--device", str(device)])
