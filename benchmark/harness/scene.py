"""Inputs of the splatting configurations, made from a seed on the device.

A ``cs`` configuration file names the cloth mesh (a square grid), the field
on it (Gaussians per face, capacity), the images (size, field of view,
background), the camera orbit and the deformation of the cloth over time.
``make_scene`` builds from it, with one ``torch.Generator`` on the device:
the mesh, the true vertex trajectory, a textured target field, the
simulator's weights and the predicted trajectory it corrects. The
reference renders the ground truth from the target field; the program
never sees the target. Everything here is plain torch; the program's types
are filled in by the drivers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import splat


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return g


def grid_mesh(n: int, size: float, device) -> dict:
    """A square n x n vertex grid in the z = 0 plane, two triangles a cell:
    rest positions, faces, both directions of every edge and their rest
    lengths."""
    xs = torch.linspace(-size / 2, size / 2, n, device=device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    rest = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.zeros(n * n, device=device)], 1)
    i = torch.arange(n - 1, device=device)
    r, c = torch.meshgrid(i, i, indexing="ij")
    v00 = (r * n + c).reshape(-1)
    v01, v10, v11 = v00 + 1, v00 + n, v00 + n + 1
    faces = torch.cat([torch.stack([v00, v01, v11], 1), torch.stack([v00, v11, v10], 1)])
    e = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = torch.unique(torch.sort(e, 1).values, dim=0)
    edges = torch.cat([e.T, e.T.flip(0)], 1)
    edge_len = torch.linalg.norm(rest[edges[1]] - rest[edges[0]], dim=-1, keepdim=True)
    return {"rest": rest, "faces": faces, "edges": edges, "edge_len": edge_len}


def wave(rest: torch.Tensor, t: float, amp: float) -> torch.Tensor:
    """The cloth at time t in [0, 1]: a travelling bend along x out of its
    plane and a drift along y."""
    x, y = rest[:, 0], rest[:, 1]
    out = rest.clone()
    out[:, 1] = y + 0.1 * t
    out[:, 2] = amp * t * torch.sin(4.0 * x + 6.0 * t)
    return out


def look_at(azimuth: float, elevation: float, radius: float, fov: float, width: int,
            height: int, time: float, device) -> dict:
    """A camera on a sphere around the origin looking at it (y up; azimuth
    0 looks along +z), as row-vector world-view and full projection
    matrices (z mapped into [0, 1], znear 0.01, zfar 100)."""
    pos = np.array([radius * math.cos(elevation) * math.sin(azimuth),
                    radius * math.sin(elevation),
                    -radius * math.cos(elevation) * math.cos(azimuth)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    w2c = np.eye(4)
    w2c[:3, :3] = np.stack([right, up, fwd])
    w2c[:3, 3] = -w2c[:3, :3] @ pos
    znear, zfar = 0.01, 100.0
    tan = math.tan(fov / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = proj[1, 1] = 1.0 / tan
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -zfar * znear / (zfar - znear)
    proj[3, 2] = 1.0
    wv = w2c.T
    full = wv @ proj.T

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"world_view": t(wv), "full_proj": t(full), "center": t(pos),
            "time": t(time)}


def field_on_mesh(mesh: dict, per_face: int, capacity: int, sh_degree: int,
                  gen: torch.Generator) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """A textured field of ``per_face`` Gaussians a face at ``capacity``:
    (leaves by the program's names, face ids, alive)."""
    dev = mesh["rest"].device
    n_faces = mesh["faces"].shape[0]
    n = per_face * n_faces
    if n > capacity:
        raise ValueError(f"{n} Gaussians exceed the capacity {capacity}")
    k = (sh_degree + 1) ** 2
    bary = torch.full((capacity, 3), 1.0 / 3.0, device=dev)
    bary[:n] = torch.clamp(1.0 / 3.0 + 0.05 * torch.randn(n, 3, generator=gen, device=dev),
                           0.02, 1.0)
    bary[:n] /= bary[:n].sum(1, keepdim=True)
    face_ids = torch.zeros(capacity, dtype=torch.long, device=dev)
    face_ids[:n] = torch.arange(n_faces, device=dev).repeat_interleave(per_face)
    tri = mesh["rest"][mesh["faces"][face_ids]]
    xyz = (bary[:, :, None] * tri).sum(1)
    colors = torch.stack([0.55 + 0.4 * torch.sin(6 * xyz[:, 0]) * torch.cos(4 * xyz[:, 1]),
                          0.5 + 0.35 * torch.cos(8 * xyz[:, 0]),
                          0.45 + 0.3 * torch.sin(5 * xyz[:, 1])], 1).clamp(0.05, 0.95)
    spacing = (mesh["rest"][1, 0] - mesh["rest"][0, 0]).abs()
    scaling = torch.log(spacing * 0.55) + 0.15 * torch.randn(capacity, 3, generator=gen,
                                                              device=dev)
    scaling[:, 2] -= 1.0                   # flat along the face normal
    rot = torch.cat([torch.ones(capacity, 1, device=dev),
                     0.2 * torch.randn(capacity, 3, generator=gen, device=dev)], 1)
    field = {
        "face_bary": bary,
        "face_offset": torch.zeros(capacity, 1, device=dev),
        "features_dc": ((colors - 0.5) / splat.SH_C0)[:, None, :],
        "features_rest": 0.03 * torch.randn(capacity, k - 1, 3, generator=gen, device=dev),
        "scaling": scaling,
        "rotation": rot,
        "opacity": torch.full((capacity, 1), math.log(0.9 / 0.1), device=dev),
    }
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[:n] = True
    return field, face_ids, alive


def perturb(field: dict, scale: float, gen: torch.Generator) -> dict:
    """The field moved off the target by noise of relative size ``scale``:
    the state of a fit part of the way to it."""
    def noise(x):
        return scale * torch.randn(x.shape, generator=gen, device=x.device)

    out = dict(field)
    out["face_bary"] = torch.clamp(field["face_bary"] + 0.2 * noise(field["face_bary"]),
                                   0.01, 1.0)
    out["features_dc"] = field["features_dc"] + 2.0 * noise(field["features_dc"])
    out["features_rest"] = field["features_rest"] + 0.5 * noise(field["features_rest"])
    out["scaling"] = field["scaling"] + noise(field["scaling"])
    out["rotation"] = field["rotation"] + noise(field["rotation"])
    out["opacity"] = field["opacity"] + 5.0 * noise(field["opacity"])
    return out


def unsettle(field: dict, alive: torch.Tensor, enlarged: dict, faded: dict,
             gen: torch.Generator) -> dict:
    """A start with work for the density control: of the live Gaussians, a
    share ``enlarged["share"]`` drawn from ``gen`` grows by
    ``enlarged["factor"]`` in the face's plane (coarse Gaussians that
    densification splits), and another share ``faded["share"]`` takes the
    opacity ``faded["opacity"]`` (Gaussians that pruning removes)."""
    u = torch.rand(alive.shape[0], generator=gen, device=alive.device)
    big = alive & (u < enlarged["share"])
    faint = alive & (u >= enlarged["share"]) & (u < enlarged["share"] + faded["share"])
    out = dict(field)
    out["scaling"] = field["scaling"].clone()
    out["scaling"][big, :2] += math.log(enlarged["factor"])
    out["opacity"] = field["opacity"].clone()
    out["opacity"][faint] = math.log(faded["opacity"] / (1.0 - faded["opacity"]))
    return out


def simulator(n_vertices: int, out_std: float, gen: torch.Generator, device) -> dict:
    """Residual MLP weights 13 -> 256 -> 256 -> 3V: U(+-1/sqrt(in)) hidden
    layers, N(0, out_std) output layer, zero output bias."""
    def uniform(*shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(*shape, generator=gen, device=device) * 2 - 1) * b

    return {"w_in": uniform(13, 256, fan_in=13), "b_in": uniform(256, fan_in=13),
            "w_h": uniform(256, 256, fan_in=256), "b_h": uniform(256, fan_in=256),
            "w_out": out_std * torch.randn(256, 3 * n_vertices, generator=gen, device=device),
            "b_out": torch.zeros(3 * n_vertices, device=device)}


def make_scene(cfg: dict, seed: int, device) -> dict:
    """Mesh, trajectories, target field and simulator of a ``cs``
    configuration for one seed; and the reference's view of the scene."""
    gen = generator(seed, 1, device)
    m = cfg["mesh"]
    mesh = grid_mesh(m["vertices_per_side"], m["size"], device)
    times = torch.linspace(0.0, 1.0, cfg["times"]).tolist()
    truth = torch.stack([wave(mesh["rest"], t, m["wave_amplitude"]) for t in times])
    # the predicted trajectory the simulator corrects: the truth plus a
    # smooth error, as a dynamics model's rollout errs
    centers = mesh["rest"][torch.randint(0, mesh["rest"].shape[0], (4,), generator=gen,
                                         device=device)]
    bumps = torch.exp(-((mesh["rest"][:, None] - centers[None]) ** 2).sum(-1) / 0.5)
    coef = torch.randn(cfg["times"], 4, 3, generator=gen, device=device)
    err = torch.einsum("vm,tmc->tvc", bumps, coef)
    err = err * (m["prediction_error_rms"] / err.pow(2).mean().sqrt())
    target, face_ids, alive = field_on_mesh(mesh, cfg["gaussians_per_face"],
                                            cfg["capacity"], cfg["sh_degree"], gen)
    img = cfg["image"]
    return {
        "mesh": mesh, "truth": truth, "predictions": truth + err,
        "target": target, "face_ids": face_ids, "alive": alive,
        "sim": simulator(mesh["rest"].shape[0], cfg["simulator_out_std"], gen, device),
        "gen": gen,
        "ref": {"faces": mesh["faces"], "rest": mesh["rest"], "face_ids": face_ids,
                "width": img["width"], "height": img["height"],
                "tan_fov": math.tan(img["fov"] / 2),
                "bg": torch.tensor(img["background"], dtype=torch.float32, device=device),
                "edges": mesh["edges"], "edge_len": mesh["edge_len"][:, 0],
                "predictions": truth + err},
    }


def train_cameras(cfg: dict, device) -> list[list[dict]]:
    """The fit's cameras [view][time]: ``views`` azimuths spread over the
    orbit's arc at its elevation and radius, one camera a time."""
    o, img = cfg["orbit"], cfg["image"]
    lo, hi = o["azimuth"]
    az = [lo + (hi - lo) * (v + 0.5) / cfg["views"] for v in range(cfg["views"])]
    times = torch.linspace(0.0, 1.0, cfg["times"]).tolist()
    return [[look_at(a, o["elevation"], o["radius"], img["fov"], img["width"],
                     img["height"], t, device) for t in times] for a in az]


def nerfpp_radius(cams: list[dict]) -> float:
    """1.1 x the largest distance of a camera centre from their mean."""
    c = torch.stack([cam["center"] for cam in cams])
    return float(torch.linalg.norm(c - c.mean(0), dim=1).max()) * 1.1
