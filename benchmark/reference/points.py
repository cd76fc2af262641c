"""Plain PyTorch reference of 3D Gaussian Splatting's forward render
(Kerbl et al., SIGGRAPH 2023): free-xyz Gaussians, the model of the
published ``gaussian-splatting`` code.

Per Gaussian: the covariance R S S^T R^T from its log-scales and WXYZ
quaternion (normalized); SH colour up to degree 3, clamped at 0 after
adding 0.5, seen from the camera centre; the EWA projection with the
Jacobian's 1.3 tan(fov) clamp and a 0.3 px low-pass on the 2D covariance;
an uncapped 3-sigma screen radius from the larger eigenvalue; a near cull
at z <= 0.2. Per pixel, front to back in exact depth order:
alpha = min(0.99, o exp(power)), a pair skipped where alpha < 1/255, and
the pixel done once its transmittance T has fallen below 1e-4; the
background adds T times its colour.

Where it departs from the published rasterizer, each as the port does:
- a pair is dead where power < -4.5, the 3-sigma ellipse (the published
  code composites the whole Gaussian inside its tile rect);
- a pair is dead where power > 0, and a Gaussian whose 2D determinant is
  not positive is dropped (the published code drops only a zero one; with
  the low-pass a positive covariance never reaches either);
- the pair that takes a pixel's T below 1e-4 is composited, and the pixel
  stops after it (the published code leaves that pair out);
- a Gaussian's tile rect is [floor((x - r) / 32), floor((x + r) / 32)]
  clamped to the grid, so a rect that ends exactly on a tile boundary
  also touches the next tile (``tile_pairs``).

Nothing is tiled the way a kernel tiles: pixels are composited in square
blocks, only to bound memory, each block walking every Gaussian whose rect
reaches it, sorted by (block, depth, index), a chunk of them at a time,
until every pixel of the block is done. A field is a dict of the program's
``PointGaussianParams`` names; a camera a dict ``world_view``,
``full_proj`` (row-vector [4, 4] transforms) and ``center`` [3]. Imports
torch and numpy only (the SH basis and the quaternion from ``splat``), and
sets TF32 off for matmuls and convolutions: float32 is the configuration's
precision.
"""

from __future__ import annotations

import torch

from benchmark.reference.splat import (
    ALPHA_MAX,
    ALPHA_MIN,
    NEAR_Z,
    POWER_CUTOFF,
    T_EXIT,
    quat_matrix,
    sh_colors,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELD_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
BLOCK = 16              # pixel block side of the compositing
CHUNK = 128             # sorted Gaussians a block walks at once
BATCH_ELEMS = 1 << 27   # (block pixel, Gaussian) pairs composited at once


def covariances(field: dict) -> torch.Tensor:
    """[N, 3, 3] world covariances R diag(exp(s))^2 R^T."""
    rot = quat_matrix(field["rotation"])
    scale2 = torch.exp(field["scaling"]) ** 2
    return (rot * scale2[:, None, :]) @ rot.transpose(1, 2)


def project(means: torch.Tensor, cov: torch.Tensor, cam: dict, width: int, height: int,
            tan_x: float, tan_y: float) -> dict:
    """EWA projection: pixel means, depth, conic, uncapped radius and
    validity of Gaussians (means [N, 3], covariances [N, 3, 3])."""
    hom = torch.cat([means, torch.ones_like(means[:, :1])], 1)
    t_cam = hom @ cam["world_view"]
    p_hom = hom @ cam["full_proj"]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    xy = torch.stack([(p_hom[:, 0] * p_w + 1.0) * width * 0.5 - 0.5,
                      (p_hom[:, 1] * p_w + 1.0) * height * 0.5 - 0.5], -1)
    fx, fy = width / (2.0 * tan_x), height / (2.0 * tan_y)
    tz = t_cam[:, 2]
    tz = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    tx = torch.clamp(t_cam[:, 0] / tz, -1.3 * tan_x, 1.3 * tan_x) * tz
    ty = torch.clamp(t_cam[:, 1] / tz, -1.3 * tan_y, 1.3 * tan_y) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                       torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    a = jac @ cam["world_view"][:3, :3].T                          # [N, 2, 3]
    cov2 = a @ cov @ a.transpose(1, 2)
    c00, c01, c11 = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    conic = torch.stack([c11, -c01, c00], -1) / det_safe[:, None]
    mid = 0.5 * (c00 + c11)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp_min(mid * mid - det,
                                                                           0.1))))
    valid = ((t_cam[:, 2] > NEAR_Z) & (det > 0)
             & (xy[:, 0] + radius > 0) & (xy[:, 0] - radius < width)
             & (xy[:, 1] + radius > 0) & (xy[:, 1] - radius < height))
    return {"xy": xy, "depth": t_cam[:, 2], "conic": conic,
            "radius": torch.where(valid, radius, torch.zeros_like(radius)), "valid": valid}


def project_view(field: dict, cam: dict, width: int, height: int, tan_x: float,
                 tan_y: float, sh_degree: int) -> dict:
    """Projected Gaussians of one camera, with colour and opacity."""
    means = field["xyz"]
    proj = project(means, covariances(field), cam, width, height, tan_x, tan_y)
    dirs = means - cam["center"][None]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
    feats = torch.cat([field["features_dc"], field["features_rest"]], 1)
    proj["color"] = sh_colors(feats, dirs, sh_degree)
    proj["opacity"] = torch.sigmoid(field["opacity"][:, 0])
    return proj


def rects(proj: dict, width: int, height: int, side: int):
    """Per valid Gaussian (ids) the cells [x0, x1) x [y0, y1) of a grid of
    ``side`` px that its rect mean +- radius touches."""
    nx, ny = -(-width // side), -(-height // side)
    ids = torch.nonzero(proj["valid"]).squeeze(1)
    xy, r = proj["xy"][ids], proj["radius"][ids]
    x0 = torch.clamp(torch.floor((xy[:, 0] - r) / side), 0, nx).long()
    x1 = torch.clamp(torch.floor((xy[:, 0] + r) / side) + 1, 0, nx).long()
    y0 = torch.clamp(torch.floor((xy[:, 1] - r) / side), 0, ny).long()
    y1 = torch.clamp(torch.floor((xy[:, 1] + r) / side) + 1, 0, ny).long()
    return ids, x0, x1, y0, y1


def tile_pairs(proj: dict, width: int, height: int, tile: int = 32) -> int:
    """(tile, Gaussian) pairs of a grid of ``tile`` px: the instances an
    exact binning emits."""
    _, x0, x1, y0, y1 = rects(proj, width, height, tile)
    return int(((x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)).sum())


def bin_blocks(proj: dict, width: int, height: int):
    """(starts, counts) per pixel block and the Gaussian ids of every
    (block, Gaussian) pair whose block the Gaussian's rect reaches, sorted by
    block, then depth, then index."""
    dev = proj["xy"].device
    nbx = -(-width // BLOCK)
    nby = -(-height // BLOCK)
    ids, x0, x1, y0, y1 = rects(proj, width, height, BLOCK)
    nx, ny = (x1 - x0).clamp_min(0), (y1 - y0).clamp_min(0)
    per = nx * ny
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), per)
    k = torch.arange(owner.numel(), device=dev) - (torch.cumsum(per, 0) - per)[owner]
    block = (y0[owner] + k // nx[owner]) * nbx + x0[owner] + k % nx[owner]
    gid = ids[owner]
    n = proj["depth"].numel()
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[torch.argsort(proj["depth"], stable=True)] = torch.arange(n, device=dev)
    order = torch.argsort(block * n + rank[gid])
    gid = gid[order]
    counts = torch.bincount(block, minlength=nbx * nby)
    return torch.cumsum(counts, 0) - counts, counts, gid


def composite(proj: dict, width: int, height: int, bg: torch.Tensor):
    """(rgb [3, H, W], alpha [H, W], live pairs): each pixel composited front
    to back until its T falls below T_EXIT; the live pairs are those a pixel
    composites (alpha >= 1/255, T before the pair above T_EXIT)."""
    dev = proj["xy"].device
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    nb, pp = nbx * nby, BLOCK * BLOCK
    starts, counts, gid = bin_blocks(proj, width, height)
    p = torch.arange(pp, device=dev)
    blocks = torch.arange(nb, device=dev)
    px = ((blocks % nbx) * BLOCK)[:, None] + (p % BLOCK)[None, :]
    py = ((blocks // nbx) * BLOCK)[:, None] + (p // BLOCK)[None, :]
    trans = ((px < width) & (py < height)).float()        # pixels off the frame: done
    acc = torch.zeros((nb, pp, 4), device=dev)             # rgb and sum w
    attrs = torch.cat([proj["xy"], proj["conic"], proj["opacity"][:, None],
                       proj["color"]], 1)                  # [N, 9]
    walked = torch.zeros(nb, dtype=torch.long, device=dev)
    pairs = 0
    last = max(gid.numel() - 1, 0)
    per_batch = max(1, BATCH_ELEMS // (pp * CHUNK))
    while True:
        live_blocks = torch.nonzero((walked < counts)
                                    & (trans.amax(1) >= T_EXIT)).squeeze(1)
        if live_blocks.numel() == 0:
            break
        for b in live_blocks.split(per_batch):
            slot = walked[b][:, None] + torch.arange(CHUNK, device=dev)[None, :]
            in_list = slot < counts[b][:, None]
            idx = gid[torch.clamp(starts[b][:, None] + slot, max=last)] if gid.numel() \
                else torch.zeros_like(slot)
            g = attrs[idx]                                 # [nb, C, 9]
            dx = px[b][:, :, None].float() - g[:, None, :, 0]
            dy = py[b][:, :, None].float() - g[:, None, :, 1]
            power = (-0.5 * (g[:, None, :, 2] * dx * dx + g[:, None, :, 4] * dy * dy)
                     - g[:, None, :, 3] * dx * dy)
            ok = (power <= 0) & (power >= POWER_CUTOFF) & in_list[:, None, :]
            power = torch.where(ok, power, torch.full_like(power, -30.0))
            alpha = torch.clamp_max(g[:, None, :, 5] * torch.exp(power), ALPHA_MAX)
            alpha = torch.where(ok & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
            t0 = trans[b][:, :, None]
            before = t0 * torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                                   1.0 - alpha[..., :-1]], -1), -1)
            # T falls monotonically, so the pairs a pixel keeps come first
            alpha = torch.where(before >= T_EXIT, alpha, torch.zeros_like(alpha))
            w = alpha * before                             # [nb, p, C]
            acc[b] += torch.cat([torch.bmm(w, g[:, :, 6:9]), w.sum(-1, keepdim=True)], -1)
            trans[b] = t0[..., 0] * torch.prod(1.0 - alpha, -1)
            pairs += int((alpha > 0).sum())
            walked[b] += CHUNK
    img = acc[..., :3] + trans[..., None] * bg
    rgb = img.reshape(nby, nbx, BLOCK, BLOCK, 3).permute(4, 0, 2, 1, 3) \
        .reshape(3, nby * BLOCK, nbx * BLOCK)[:, :height, :width]
    alpha = acc[..., 3].reshape(nby, nbx, BLOCK, BLOCK).permute(0, 2, 1, 3) \
        .reshape(nby * BLOCK, nbx * BLOCK)[:height, :width]
    return rgb, alpha, pairs


def render(field: dict, cam: dict, width: int, height: int, tan_x: float, tan_y: float,
           sh_degree: int, bg: torch.Tensor):
    """(rgb [3, H, W], live pairs, projected Gaussians) of one camera, no
    autograd."""
    with torch.no_grad():
        proj = project_view(field, cam, width, height, tan_x, tan_y, sh_degree)
        rgb, _, pairs = composite(proj, width, height, bg)
    return rgb, pairs, proj
