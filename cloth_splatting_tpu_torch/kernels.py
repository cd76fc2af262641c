"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Builds happen at first use, from the sources in the checkout,
into ``_build/`` beside this file (git-ignored); a library's file name
carries a hash of its source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header is rebuilt. Nothing is built or
loaded at import time.

Every launch goes through ``launch``, which counts it in ``LAUNCHES`` by
the kernel's name: "K1", "K1-span", "K2", "K2-span", "K3", "K4", "front"
(the point front end), "cloth_front" (the cloth field's front end, the
other pass of the same source) and "front_bwd" (the point front end's
backward).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = {"tiled_fwd": CSRC / "tiled_fwd.cu",
           "tiled_train": CSRC / "tiled_train.cu",
           "point_front": CSRC / "point_front.cu",
           "point_front_bwd": CSRC / "point_front_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
# successful launches by kernel name, since the process started or the
# caller last cleared it
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, str | None]:
    """Compile the kernels ``names`` (default: all) that are not built yet,
    one ``nvcc`` process each, all started together. Returns each name's
    compiler log (register and shared-memory use from ``-Xptxas -v``), or
    None where it was built already; raises with the log if ``nvcc`` fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs: dict[str, str | None] = {name: None for name in names}
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} "
                          f"(rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
        logs[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def launch(name: str, fn, dev, *args) -> None:
    """Call the ctypes launcher ``fn(*args, stream)`` of kernel ``name`` on
    ``dev``'s current stream; raise RuntimeError if it returns a CUDA error,
    else count one launch in ``LAUNCHES[name]``."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
