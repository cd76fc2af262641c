"""Checks how the port's tile kernels (K1, K2, K3 and the span forms
K1-span, K2-span, K4) come out of ptxas.

Builds ``cloth_splatting_tpu_torch/csrc`` at ptxas -O0, -O1 and -O3 (the
default), once from the sources as they are and once with one rewrite of
both of ``composite.cuh``'s tile walks (``composite_tile_patched``, K1's and
K2's, and ``composite_tile``, the span forms') that is the same C++ function:
the chunk loop's own index carried past the loop (``++ci; break;``) instead
of the separate ``walked`` counter. Each build's K1, K2 and K3 are held
against their plain versions on chip_smoke's deep synthetic packs at 32 px
and 16 px tiles (K3, with its warp patches, footprint cull and
reduce-scatter, also against a second launch, bit for bit), and so are
K1-span, K2-span and K4 with a window most programs fit and with a window of
one chunk (mostly the overflow walk), in programs of 2 tiles and of 8 (the
cluster program of K2-span and K4 in clusters of 2 and of 8 CTAs, the
largest portable size); K1-span and K2-span are also held bit-identical to
K1 and K2, and K4 to its plain version and to K3. Before that it compares
the PTX of every kernel between the two forms.

    python3 scripts/ptxas_check.py      # needs a CUDA card and nvcc

Prints one JSON line per PTX comparison and per (form, level, pack, kernel)
check, then a summary line; exits non-zero when the sources as they are
fail at -O3. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LEVELS = (0, 1, 3)
FORMS = ("as-is", "loop-index")
PACKS = ((32, 256, 20000), (16, 128, 6000), (16, 128, 300))
SPANS = ((2, 41), (2, 1), (8, 41))   # (tiles_per_program, span_cap)
# each line of the rewrite, once in each of the two walks
WALKS = 2
_WALKED = (
    ("  int walked = n_chunks;\n  for (int ci = 0; ci < n_chunks; ++ci) {",
     "  int ci = 0;\n  for (; ci < n_chunks; ++ci) {"),
    ("      walked = ci + 1;\n      break;", "      ++ci;\n      break;"),
    ("    for (int ci = walked; ci < n_chunks; ++ci) {",
     "    for (; ci < n_chunks; ++ci) {"),
)


def csrc_of(form: str) -> Path:
    """The source directory of ``form``; the rewrite goes to a copy under
    the git-ignored build directory."""
    from cloth_splatting_tpu_torch import kernels

    if form == "as-is":
        return kernels.CSRC
    out = kernels.BUILD_DIR / f"csrc-{form}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(kernels.CSRC, out)
    header = out / "composite.cuh"
    text = header.read_text()
    for old, new in _WALKED:
        if text.count(old) != WALKS:
            raise RuntimeError(f"composite.cuh no longer holds {old!r} once "
                               f"in each of its {WALKS} walks")
        text = text.replace(old, new)
    header.write_text(text)
    return out


def ptx_entries(cu: Path) -> dict[str, str]:
    """Each entry function's PTX body, the anonymous namespace's hash removed."""
    from cloth_splatting_tpu_torch import kernels

    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                         "-fPIC", "-Xptxas", "-v")]
    out = kernels.BUILD_DIR / f"{cu.parent.name}-{cu.stem}.ptx"
    subprocess.run([kernels._nvcc(), *flags, "-ptx", "-o", str(out), str(cu)],
                   check=True)
    ptx = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", out.read_text())
    entries = {}
    for block in ptx.split(".entry ")[1:]:
        name = re.search(r"([a-z_]+_kernel)ILi(\d+)E", block.split("(")[0])
        entries[f"{name.group(1)}<{name.group(2)}>"] = block
    return entries


def check(form: str, level: int) -> bool:
    """Builds ``form`` at ptxas -O``level`` and holds its kernels against the
    plain versions; True when all agree."""
    import torch

    import chip_smoke as cs
    from cloth_splatting_tpu_torch import kernels
    from cloth_splatting_tpu_torch.ops.rasterize.tiled_fwd import sorted_pack

    src = csrc_of(form)
    kernels.CSRC = src
    kernels.SOURCES = {name: src / path.name for name, path in kernels.SOURCES.items()}
    kernels.NVCC_FLAGS = kernels.NVCC_FLAGS + ["-Xptxas", f"-O{level}"]
    kernels.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    ok = True
    for ts, size, n in PACKS:
        packed = sorted_pack(cs.deep_proj(n, size, size, gen, dev), size // ts,
                             size // ts, ts, 3 if ts == 32 else 5, order="exact")
        label = f"{size}px/{ts}px n={n}"
        results = {}
        for span in (None, *SPANS):
            k1, k2, k3 = (("K1", "K2", "K3") if span is None else
                          tuple(f"{k} {span[0]}/{span[1]}"
                                for k in ("K1-span", "K2-span", "K4")))
            try:
                stats = cs.compare_k1(packed, size, size, ts, label, span)[1]
                results[k1] = None
                if span is not None and not stats["bit_identical_to_k1"]:
                    results[k1] = "not bit-identical to K1"
            except RuntimeError as e:
                results[k1] = str(e)
            try:
                _, stats, out_k, tb_k = cs.compare_k2(packed, size, size, ts,
                                                      label, span)
                results[k2] = None
                if span is not None and not stats["bit_identical_to_k2"]:
                    results[k2] = "not bit-identical to K2"
                cs.compare_k3(packed,
                              cs.cotangent_tiles(out_k, size, size, ts, gen),
                              tb_k, size, size, ts, label, span)
                results[k3] = None
            except RuntimeError as e:
                # K2's failure, or K3's after K2 ran
                results[k3] = str(e) if k2 in results else "not run"
                results.setdefault(k2, str(e))
        for kernel, err in results.items():
            ok = ok and err is None
            print(json.dumps({"form": form, "ptxas": f"-O{level}", "pack": label,
                              "kernel": kernel, "ok": err is None, "error": err}),
                  flush=True)
    return ok


def main() -> int:
    if len(sys.argv) == 3:
        return 0 if check(sys.argv[1], int(sys.argv[2])) else 1

    import torch

    if not torch.cuda.is_available():
        print("ptxas_check: CUDA is not available", file=sys.stderr)
        return 1
    from cloth_splatting_tpu_torch import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, path in kernels.SOURCES.items():
        a = ptx_entries(path)
        b = ptx_entries(csrc_of("loop-index") / path.name)
        print(json.dumps({"ptx_same_in_both_forms": {k: a[k] == b.get(k) for k in a},
                          "source": name}), flush=True)
    summary = {}
    for form in FORMS:
        for level in LEVELS:
            rc = subprocess.run([sys.executable, __file__, form, str(level)],
                                cwd=ROOT).returncode
            summary[f"{form} -O{level}"] = "agrees" if rc == 0 else "DISAGREES"
    print(json.dumps({"summary": summary}))
    return 0 if summary["as-is -O3"] == "agrees" else 1


if __name__ == "__main__":
    sys.exit(main())
