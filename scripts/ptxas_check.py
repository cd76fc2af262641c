"""Checks how the port's tile kernels (K1, K2, K3 and the span forms
K1-span, K2-span, K4) and its point front end come out of ptxas.

Builds ``cloth_splatting_tpu_torch/csrc`` at ptxas -O0, -O1 and -O3 (the
default), once from the sources as they are and once with one rewrite of
``composite.cuh``'s one forward tile walk (``composite_tile_patched``: K1,
K2, K1-span and K2-span) that is the same C++ function: the chunk loop's own
index carried past the loop (``++ci; break;``) instead of the separate
``walked`` counter. Each build's K1, K2 and K3 are held against their plain
versions on chip_smoke's deep synthetic packs at 32 px and 16 px tiles (K3,
with its warp patches, footprint cull and reduce-scatter, also against a
second launch, bit for bit), and so are K1-span, K2-span and K4 with a
window most programs fit and with a window of one chunk (mostly the
overflow walk), in programs of 2 tiles and of 8 (the cluster program of the
three span kernels in clusters of 2 and of 8 CTAs, the largest portable
size); K1-span and K2-span are also held bit-identical to K1 and K2, and K4
to its plain version and to K3. Each build's point and cloth front ends
(``csrc/point_front.cu``) and the point front end's backward
(``csrc/point_front_bwd.cu``; both include ``front.cuh``, not the tile
header the rewrite edits) must spill nothing at any SH degree (at -O3 the
point front end may use no more registers than POINT_FRONT_REGISTERS);
the point front end's outputs on a 50,000-Gaussian field drawn as the
benchmark's gs-360-3m must equal the PyTorch ops' bit for bit at degrees
0-3, uncapped and capped at 24 px; its backward's gradients on the same
field stored at degree 4, from cotangents laid as the training rasterizer
hands them over (views of [C, 16] rows, a third of the rows zero), must
lie within FRONT_BWD_TOL of ``project_points_backward_plain``'s norm, leaf
by leaf, with exact zeros on the rows without a cotangent and in the SH
coefficients above the degree, at degrees 0-4; and the cloth front end's (``render.project_view``'s four outputs)
on the benchmark's cs-field-65k scene cut to a 64 x 64 grid (15,876
Gaussians) must equal ``render.project_view_eager``'s at degrees 0-3,
with the simulator and static. Before that it compares the PTX of every
kernel between the two forms.

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
FRONT_GAUSSIANS = 50_000
# the most registers the point front end may use at SH degrees 0-4 under
# ptxas -O3: its counts when it was the source's only pass (the cloth pass
# beside it must not cost it any)
POINT_FRONT_REGISTERS = {0: 55, 1: 55, 2: 80, 3: 56, 4: 80}
FRONT_BWD_TOL = 1e-5
CLOTH_GRID = 64
# each line of the rewrite, found once in the walk
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
        if text.count(old) != 1:
            raise RuntimeError(f"composite.cuh holds {old!r} "
                               f"{text.count(old)} times, not once in its walk")
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
    logs = kernels.build_all()
    dev = torch.device("cuda")
    usage = cs.ptxas_usage(logs["point_front"] or "")
    ok = check_front(usage, form, level, dev)
    ok = check_front_bwd(cs.ptxas_usage(logs["point_front_bwd"] or ""), form, level,
                         dev) and ok
    ok = check_cloth(usage, form, level, dev) and ok
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    for ts, size, n in PACKS:
        packed = sorted_pack(cs.deep_proj(n, size, size, gen, dev), size // ts,
                             size // ts, ts, order="exact")
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


def check_front(usage: dict, form: str, level: int, dev) -> bool:
    """The point front end of this build: its registers and spills at each
    SH degree (``usage``, from the build's log), and its outputs against
    the PyTorch ops' on a gs-360-3m field of FRONT_GAUSSIANS Gaussians;
    True when nothing spills and every output is bit-identical."""
    import torch

    import chip_smoke as cs
    from benchmark.drivers.render_points import camera, make_field
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops.point_front import project_points_fused
    from cloth_splatting_tpu_torch.render import CameraArrays

    entries = {k: v for k, v in usage.items() if k.startswith("point_front_kernel<")}
    ok = len(entries) == 5 and not any(v.get("spill_stores") or v.get("spill_loads")
                                       for v in entries.values())
    if level == 3:
        ok = ok and all(entries[f"point_front_kernel<{deg}>"].get("registers", 256)
                        <= regs for deg, regs in POINT_FRONT_REGISTERS.items())
    print(json.dumps({"form": form, "ptxas": f"-O{level}", "kernel": "front",
                      "usage": entries, "ok": ok}), flush=True)
    cfg = json.loads((ROOT / "benchmark" / "configs" / "gs-360-3m.json").read_text())
    params = PG.PointGaussianParams(**make_field({**cfg, "gaussians": FRONT_GAUSSIANS},
                                                 1, dev))
    alive = torch.rand(FRONT_GAUSSIANS, device=dev) > 0.1
    img = cfg["image"]
    w, h, tan_x = img["width"], img["height"], img["tan_half_fov_x"]
    tan_y = tan_x * h / w
    cam = camera((0.7, 0.25, 3.6), tan_x, tan_y, dev)
    cam = CameraArrays(cam["world_view"], cam["full_proj"], cam["center"],
                       torch.zeros((), device=dev))
    for deg in range(4):
        for cap in (None, 24.0):
            args = (params, alive, cam, w, h, tan_x, tan_y, deg, cap)
            got, want = project_points_fused(*args), PG.project_points_eager(*args)
            differ = cs.bits_differ(got, want)
            agree = not any(differ.values())
            ok = ok and agree
            print(json.dumps({"form": form, "ptxas": f"-O{level}",
                              "kernel": f"front degree {deg} max_radius {cap}",
                              "ok": agree, "error": None if agree else differ}),
                  flush=True)
    return ok


def check_front_bwd(usage: dict, form: str, level: int, dev) -> bool:
    """The point front end's backward of this build: its registers and
    spills at each SH degree (``usage``, from the build's log), and its
    gradients against ``project_points_backward_plain``'s on a gs-360-3m
    field of FRONT_GAUSSIANS Gaussians stored at degree 4; True when nothing
    spills and every leaf agrees."""
    import torch

    from benchmark.drivers.render_points import camera, make_field
    from cloth_splatting_tpu_torch.models import point_gaussians as PG
    from cloth_splatting_tpu_torch.ops import point_front as PF
    from cloth_splatting_tpu_torch.render import CameraArrays

    entries = {k: v for k, v in usage.items() if k.startswith("point_front_bwd_kernel<")}
    ok = len(entries) == 5 and not any(v.get("spill_stores") or v.get("spill_loads")
                                       for v in entries.values())
    print(json.dumps({"form": form, "ptxas": f"-O{level}", "kernel": "front_bwd",
                      "usage": entries, "ok": ok}), flush=True)
    cfg = json.loads((ROOT / "benchmark" / "configs" / "gs-360-3m.json").read_text())
    n = FRONT_GAUSSIANS
    params = PG.PointGaussianParams(**make_field({**cfg, "gaussians": n, "sh_degree": 4},
                                                 1, dev))
    gen = torch.Generator(device=dev).manual_seed(2)
    alive = torch.rand(n, generator=gen, device=dev) > 0.1
    img = cfg["image"]
    w, h, tan_x = img["width"], img["height"], img["tan_half_fov_x"]
    tan_y = tan_x * h / w
    cam = camera((0.7, 0.25, 3.6), tan_x, tan_y, dev)
    cam = CameraArrays(cam["world_view"], cam["full_proj"], cam["center"],
                       torch.zeros((), device=dev))
    rows = torch.randn((n, 16), generator=gen, device=dev)
    unreached = torch.rand(n, generator=gen, device=dev) < 1 / 3
    rows[unreached] = 0.0
    cots = (rows[:, 0:2], rows[:, 9], rows[:, 2:5], rows[:, 5:8], rows[:, 8])
    for deg in range(5):
        for cap in (None, 24.0):
            valid = PF.project_points_fused(params, alive, cam, w, h, tan_x, tan_y, deg,
                                            cap).valid
            args = (params, valid, cam, w, h, tan_x, tan_y, deg, *cots)
            got = PF.project_points_backward_fused(*args)
            want = PF.project_points_backward_plain(*args)
            gaps = {k: float((a - b).norm() / b.norm().clamp_min(1e-30))
                    for k, a, b in zip(params._fields, got, want)}
            zeros = (all(bool((g.reshape(n, -1)[unreached] == 0).all()) for g in got)
                     and bool((got.features_rest[:, (deg + 1) ** 2 - 1:] == 0).all()))
            agree = all(rel <= FRONT_BWD_TOL for rel in gaps.values()) and zeros
            ok = ok and agree
            print(json.dumps({"form": form, "ptxas": f"-O{level}",
                              "kernel": f"front_bwd degree {deg} max_radius {cap}",
                              "ok": agree, "gaps": gaps, "zeros": zeros}), flush=True)
    return ok


def check_cloth(usage: dict, form: str, level: int, dev) -> bool:
    """The cloth front end of this build: its registers and spills at each
    SH degree (``usage``, from the build's log), and ``project_view``'s
    outputs on the kernel against ``project_view_eager``'s on the
    cs-field-65k scene cut to CLOTH_GRID vertices a side; True when nothing
    spills and every output is bit-identical."""
    import math

    import torch

    import chip_smoke as cs
    from benchmark.drivers import splat_common
    from benchmark.harness import scene as scene_mod
    from cloth_splatting_tpu_torch import render as R
    from cloth_splatting_tpu_torch.models.deform import simulator_from_params

    entries = {k: v for k, v in usage.items() if k.startswith("cloth_front_kernel<")}
    ok = len(entries) == 5 and not any(v.get("spill_stores") or v.get("spill_loads")
                                       for v in entries.values())
    print(json.dumps({"form": form, "ptxas": f"-O{level}", "kernel": "cloth_front",
                      "usage": entries, "ok": ok}), flush=True)
    cfg = json.loads((ROOT / "benchmark" / "configs" / "cs-field-65k.json").read_text())
    cfg["mesh"]["vertices_per_side"] = CLOTH_GRID
    cfg["capacity"] = 16384
    sc = scene_mod.make_scene(cfg, 1, dev)
    params, state = splat_common.program_field(sc["target"], sc["face_ids"], sc["alive"])
    mesh = splat_common.program_mesh(sc["mesh"])
    sim = simulator_from_params(sc["sim"])
    img = cfg["image"]
    cam = splat_common.camera_arrays(scene_mod.look_at(
        0.5, 0.4, 3.0, img["fov"], img["width"], img["height"], 0.6, dev))
    tan = math.tan(img["fov"] / 2)
    for deg in range(4):
        for static in (False, True):
            args = (cam, img["width"], img["height"], tan, tan, params, state, mesh,
                    sim, sc["predictions"], deg)
            with torch.no_grad():
                got = R.project_view(*args, render_static=static)
                want = R.project_view_eager(*args, render_static=static)
            differ = cs.bits_differ(got[0], want[0])
            differ.update({name: int((a.view(torch.int32) != b.view(torch.int32)).sum())
                           for name, a, b in zip(("vertices", "means3d", "rotations"),
                                                 got[1:], want[1:])})
            agree = not any(differ.values())
            ok = ok and agree
            print(json.dumps({"form": form, "ptxas": f"-O{level}",
                              "kernel": f"cloth_front degree {deg} static {static}",
                              "ok": agree, "error": None if agree else differ}),
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
