"""Minimal binary-little-endian PLY writer and reader for Gaussian point
clouds; the port's copy of ``cloth_splatting_tpu/data/ply_io.py`` (numpy
only). Per-vertex float32 properties
``x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_* b1 b2 b3 o id``, the
3DGS save format with the mesh extension (``id`` is the face index stored
as f4), so the reference's viewers and tools can open the checkpoints.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, columns: dict[str, np.ndarray]) -> None:
    """Write named float32 columns (each [N] or [N, 1]) as one vertex element."""
    names = list(columns.keys())
    arrays = [np.asarray(columns[n], dtype=np.float32).reshape(-1) for n in names]
    n = arrays[0].shape[0]
    for name, a in zip(names, arrays):
        if a.shape[0] != n:
            raise ValueError(f"column {name} has length {a.shape[0]} != {n}")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]

    rec = np.rec.fromarrays(arrays, names=names, formats=["<f4"] * len(names))
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a binary-little-endian PLY with a single float vertex element."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    names: list[str] = []
    n = 0
    fmt_binary = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt_binary = parts[1] == "binary_little_endian"
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property":
            if parts[1] not in ("float", "float32"):
                raise ValueError(f"unsupported property type: {line}")
            names.append(parts[2])
    if not fmt_binary:
        raise ValueError("only binary_little_endian PLY supported")
    body = np.frombuffer(data[end:], dtype="<f4", count=n * len(names))
    body = body.reshape(n, len(names))
    return {name: body[:, i].copy() for i, name in enumerate(names)}


def gaussian_ply_columns(xyz, f_dc, f_rest, opacity, scaling, rotation,
                         face_bary=None, face_offset=None, face_ids=None):
    """Assemble the 3DGS (+ mesh extension) column dict in reference order
    from numpy arrays. ``f_dc`` [N, 1, 3] and ``f_rest`` [N, K-1, 3] are
    stored channel-major: all coefficients of channel R, then G, then B."""
    n = xyz.shape[0]
    cols: dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        cols[name] = xyz[:, i]
    for i, name in enumerate(["nx", "ny", "nz"]):
        cols[name] = np.zeros(n, np.float32)
    dc = np.asarray(f_dc).transpose(0, 2, 1).reshape(n, -1)      # [N, 3*1]
    for i in range(dc.shape[1]):
        cols[f"f_dc_{i}"] = dc[:, i]
    rest = np.asarray(f_rest).transpose(0, 2, 1).reshape(n, -1)  # [N, 3*(K-1)]
    for i in range(rest.shape[1]):
        cols[f"f_rest_{i}"] = rest[:, i]
    cols["opacity"] = np.asarray(opacity).reshape(-1)
    for i in range(scaling.shape[1]):
        cols[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        cols[f"rot_{i}"] = rotation[:, i]
    if face_bary is not None:
        for i, name in enumerate(["b1", "b2", "b3"]):
            cols[name] = face_bary[:, i]
        cols["o"] = np.asarray(face_offset).reshape(-1)
        cols["id"] = np.asarray(face_ids).astype(np.float32)
    return cols
