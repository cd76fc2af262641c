"""Plain PyTorch reference of the mesh-anchored Gaussian field.

It follows the published description of the method (3D Gaussian splatting
with EWA projection, front-to-back alpha compositing, Gaussians anchored by
barycentric coordinates on a mesh deformed by a residual MLP) and the
function the configuration states: alpha = min(0.99, o exp(power)), a pair
is dead where power > 0, power < power_cut or alpha < 1/255, a 3-sigma
screen radius capped at 24 px with the support ellipse shrunk to fit,
a near cull at z <= 0.2, and a 0.3 px low-pass.

Nothing here is tiled the way a kernel tiles: every pixel composites every
Gaussian whose support can reach it, sorted by exact depth, with no early
exit. Gaussians are binned into square pixel blocks only to bound memory;
a Gaussian's support lies inside its screen radius, so the binning drops
nothing. The backward pass is autograd, block by block, from the gradient
of the loss with respect to the image.

Tensors are plain: a field is a dict of leaves with the names of the
program's ``GaussianParams``; the simulator a dict ``w_in, b_in, w_h, b_h,
w_out, b_out`` ([in, out] weights); a camera a dict ``world_view,
full_proj`` (row-vector [4, 4] transforms), ``center`` [3], ``time``.
Imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
POWER_CUTOFF = -4.5
MAX_RADIUS = 24.0
NEAR_Z = 0.2
T_EXIT = 1e-4        # a pair after its pixel's T fell to this adds nothing seen
BLOCK = 16           # pixel block side of the memory binning
BATCH_PAIRS = 1 << 25  # (block pixel, slot) pairs composited at once

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

FIELD_KEYS = ("face_bary", "face_offset", "features_dc", "features_rest",
              "scaling", "rotation", "opacity")
SIM_KEYS = ("w_in", "b_in", "w_h", "b_h", "w_out", "b_out")


# ----------------------------------------------------------------- simulator

def time_id(t: torch.Tensor, n_times: int) -> torch.Tensor:
    dt = 1.0 if n_times == 1 else 1.0 / (n_times - 1)
    return torch.clamp(torch.round(t / dt).long(), 0, n_times - 1)


def simulate(sim: dict, predictions: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Vertices [V, 3] at time t: the prediction of the nearest frame plus
    the MLP's residual over [t, sin(2^k t), cos(2^k t)], k < 6."""
    freqs = 2.0 ** torch.arange(6, dtype=torch.float32, device=t.device)
    ang = t * freqs
    enc = torch.cat([t.reshape(1), torch.stack([torch.sin(ang), torch.cos(ang)],
                                               -1).reshape(-1)])
    h = torch.relu(enc @ sim["w_in"] + sim["b_in"])
    h = torch.relu(h @ sim["w_h"] + sim["b_h"])
    residual = (h @ sim["w_out"] + sim["b_out"]).reshape(-1, 3)
    return predictions[time_id(t, predictions.shape[0])] + residual


# --------------------------------------------------------------- front end

def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [N, 3, 3] of WXYZ quaternions (normalized here)."""
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def triangle_frames(tri: torch.Tensor) -> torch.Tensor:
    """Orthonormal frames [F, 3, 3] (columns: first edge, in-plane normal
    to it, face normal) of triangles [F, 3, 3]."""
    e1 = tri[:, 1] - tri[:, 0]
    n = torch.linalg.cross(e1, tri[:, 2] - tri[:, 0])
    e1 = e1 * torch.rsqrt((e1 * e1).sum(-1, keepdim=True) + 1e-12)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return torch.stack([e1, torch.linalg.cross(n, e1), n], -1)


def sh_colors(features: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """RGB [N, 3] = max(SH(dirs) . features + 0.5, 0), degree <= 3."""
    x, y, z = dirs.unbind(-1)
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.stack(basis, -1)                                     # [N, K]
    rgb = torch.einsum("nk,nkc->nc", b, features[:, :b.shape[1]])
    return torch.clamp_min(rgb + 0.5, 0.0)


def project(means: torch.Tensor, cov: torch.Tensor, cam: dict, width: int,
            height: int, tan_fov: float) -> dict:
    """EWA projection of Gaussians (means [N, 3], covariances [N, 3, 3]) into
    a camera: pixel means, depth, conic, radius, power cut and validity."""
    ones = torch.ones_like(means[:, :1])
    hom = torch.cat([means, ones], 1)
    t_cam = hom @ cam["world_view"]
    p_hom = hom @ cam["full_proj"]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    xy = torch.stack([(p_hom[:, 0] * p_w + 1.0) * width * 0.5 - 0.5,
                      (p_hom[:, 1] * p_w + 1.0) * height * 0.5 - 0.5], -1)
    fx = width / (2.0 * tan_fov)
    fy = height / (2.0 * tan_fov)
    tz = t_cam[:, 2]
    tz = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    lim = 1.3 * tan_fov
    tx = torch.clamp(t_cam[:, 0] / tz, -lim, lim) * tz
    ty = torch.clamp(t_cam[:, 1] / tz, -lim, lim) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                       torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    a = jac @ cam["world_view"][:3, :3].T                          # [N, 2, 3]
    cov2 = a @ cov @ a.transpose(1, 2)
    c00 = cov2[:, 0, 0] + 0.3
    c01 = cov2[:, 0, 1]
    c11 = cov2[:, 1, 1] + 0.3
    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    conic = torch.stack([c11, -c01, c00], -1) / det_safe[:, None]
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    r_raw = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    radius = torch.clamp_max(r_raw, MAX_RADIUS)
    power_cut = POWER_CUTOFF * (radius / torch.clamp_min(r_raw, 1.0)) ** 2
    valid = ((t_cam[:, 2] > NEAR_Z) & (det > 0)
             & (xy[:, 0] + radius > 0) & (xy[:, 0] - radius < width)
             & (xy[:, 1] + radius > 0) & (xy[:, 1] - radius < height)).detach()
    return {"xy": xy, "depth": t_cam[:, 2], "conic": conic,
            "radius": torch.where(valid, radius, torch.zeros_like(radius)),
            "power_cut": power_cut, "valid": valid}


def gaussians_world(field: dict, face_ids: torch.Tensor, faces: torch.Tensor,
                    rest: torch.Tensor, verts: torch.Tensor):
    """World means [N, 3] and covariances [N, 3, 3] of the field on the mesh
    deformed to ``verts``: barycentric means, and each Gaussian's rotation
    carried by its face's rigid rotation from the rest pose."""
    fidx = faces[face_ids]
    bary = field["face_bary"]
    s = bary.sum(1, keepdim=True)
    bary = bary / torch.where(s.abs() < 1e-8, torch.full_like(s, 1e-8), s)
    tri = verts[fidx]
    means = (bary[:, :, None] * tri).sum(1)
    face_rot = triangle_frames(verts[faces]) @ triangle_frames(rest[faces]).transpose(1, 2)
    rot = face_rot[face_ids] @ quat_matrix(field["rotation"])
    scale2 = torch.exp(field["scaling"]) ** 2
    cov = (rot * scale2[:, None, :]) @ rot.transpose(1, 2)
    return means, cov


def project_view(field: dict, alive: torch.Tensor, scene: dict, verts: torch.Tensor,
                 cam: dict, sh_degree: int) -> dict:
    """Projected Gaussians of one camera, with colour and opacity."""
    means, cov = gaussians_world(field, scene["face_ids"], scene["faces"],
                                 scene["rest"], verts)
    proj = project(means, cov, cam, scene["width"], scene["height"], scene["tan_fov"])
    dirs = means - cam["center"][None]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
    feats = torch.cat([field["features_dc"], field["features_rest"]], 1)
    proj["color"] = sh_colors(feats, dirs, sh_degree)
    proj["opacity"] = torch.sigmoid(field["opacity"][:, 0])
    proj["valid"] = proj["valid"] & alive
    proj["radius"] = torch.where(proj["valid"], proj["radius"],
                                 torch.zeros_like(proj["radius"]))
    return proj


# -------------------------------------------------------------- compositor

def bin_pairs(proj: dict, width: int, height: int):
    """(block id, Gaussian id) pairs of every valid Gaussian and every pixel
    block its radius box reaches, sorted by block, then exact depth, then
    index: (starts [n_blocks], counts [n_blocks], gaussian ids)."""
    dev = proj["xy"].device
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    xy = proj["xy"].detach()
    r = proj["radius"]
    ids = torch.nonzero(proj["valid"] & (r > 0)).squeeze(1)
    x0 = torch.clamp(torch.floor((xy[ids, 0] - r[ids]) / BLOCK), 0, nbx - 1).long()
    x1 = torch.clamp(torch.floor((xy[ids, 0] + r[ids]) / BLOCK), 0, nbx - 1).long()
    y0 = torch.clamp(torch.floor((xy[ids, 1] - r[ids]) / BLOCK), 0, nby - 1).long()
    y1 = torch.clamp(torch.floor((xy[ids, 1] + r[ids]) / BLOCK), 0, nby - 1).long()
    nx, ny = x1 - x0 + 1, y1 - y0 + 1
    per = nx * ny
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), per)
    first = torch.cumsum(per, 0) - per
    k = torch.arange(owner.numel(), device=dev) - first[owner]
    bx = x0[owner] + k % nx[owner]
    by = y0[owner] + k // nx[owner]
    block = by * nbx + bx
    gid = ids[owner]
    rank = torch.empty_like(proj["depth"], dtype=torch.long)
    rank[torch.argsort(proj["depth"].detach(), stable=True)] = torch.arange(
        rank.numel(), device=dev)
    order = torch.argsort(block * rank.numel() + rank[gid])
    block, gid = block[order], gid[order]
    counts = torch.bincount(block, minlength=nbx * nby)
    starts = torch.cumsum(counts, 0) - counts
    return starts, counts, gid


def _block_batches(counts: torch.Tensor):
    """Lists of block ids, each composited as one padded batch."""
    order = torch.argsort(counts, descending=True).tolist()
    c = counts.tolist()
    batches, cur, cur_k = [], [], 0
    for b in order:
        if c[b] == 0:
            break
        k = cur_k or c[b]
        if cur and (len(cur) + 1) * k * BLOCK * BLOCK > BATCH_PAIRS:
            batches.append((cur, cur_k))
            cur, cur_k = [], 0
            k = c[b]
        cur.append(b)
        cur_k = k
    if cur:
        batches.append((cur, cur_k))
    return batches


def _composite_blocks(attrs: dict, blocks: list, k: int, starts, counts, gid,
                      width: int):
    """Per-pixel compositing of ``blocks`` (padded to ``k`` slots): (rgb
    [nb, p, 3], depth [nb, p], alpha [nb, p], live pairs seen before the
    pixel's T fell to T_EXIT)."""
    dev = attrs["xy"].device
    nbx = -(-width // BLOCK)
    b = torch.tensor(blocks, device=dev)
    slot = torch.arange(k, device=dev)
    inside = slot[None, :] < counts[b][:, None]
    idx = torch.where(inside, gid[torch.clamp(starts[b][:, None] + slot[None, :],
                                              max=max(gid.numel() - 1, 0))],
                      torch.zeros_like(slot)[None, :])
    p = torch.arange(BLOCK * BLOCK, device=dev)
    px = ((b % nbx) * BLOCK)[:, None] + (p % BLOCK)[None, :]
    py = ((b // nbx) * BLOCK)[:, None] + (p // BLOCK)[None, :]
    xy, conic = attrs["xy"][idx], attrs["conic"][idx]            # [nb, k, ...]
    dx = px[:, :, None].float() - xy[:, None, :, 0]
    dy = py[:, :, None].float() - xy[:, None, :, 1]
    power = (-0.5 * (conic[:, None, :, 0] * dx * dx + conic[:, None, :, 2] * dy * dy)
             - conic[:, None, :, 1] * dx * dy)
    # outside the support the exponent is replaced before exp, so that no
    # masked pair can feed an inf into the backward pass
    ok = ((power <= 0) & (power >= attrs["power_cut"][idx][:, None, :])
          & inside[:, None, :])
    power = torch.where(ok, power, torch.full_like(power, -30.0))
    alpha = torch.clamp_max(attrs["opacity"][idx][:, None, :] * torch.exp(power),
                            ALPHA_MAX)
    live = ok & (alpha >= ALPHA_MIN)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha], -1), -1)
    w = alpha * trans[..., :-1]                                     # [nb, p, k]
    rgb = torch.bmm(w, attrs["color"][idx])
    depth = (w * attrs["depth"][idx][:, None, :]).sum(-1)
    acc = w.sum(-1)
    seen = (live & (trans[..., :-1] > T_EXIT)).sum()
    return rgb, depth, acc, trans[..., -1], seen


def composite(proj: dict, width: int, height: int, bg: torch.Tensor,
              grad_rgb: torch.Tensor | None = None):
    """Render [3, H, W] rgb, [H, W] depth and alpha; the number of live
    (pixel, Gaussian) pairs in front of T_EXIT. With ``grad_rgb`` [3, H, W]
    instead back-propagates it into the projected leaves' ``.grad`` (xy,
    conic, color, opacity, depth must then require grad) and returns None."""
    starts, counts, gid = bin_pairs(proj, width, height)
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    dev = proj["xy"].device
    pad_w, pad_h = nbx * BLOCK, nby * BLOCK
    rgb = bg[:, None].expand(3, pad_w * pad_h).reshape(3, nby, BLOCK, nbx, BLOCK).clone()
    depth = torch.zeros((nby, BLOCK, nbx, BLOCK), device=dev)
    alpha = torch.zeros_like(depth)
    seen_total = 0
    grad_blocks = None
    if grad_rgb is not None:
        g = F.pad(grad_rgb, (0, pad_w - width, 0, pad_h - height))
        grad_blocks = g.reshape(3, nby, BLOCK, nbx, BLOCK).permute(1, 3, 2, 4, 0) \
            .reshape(nby * nbx, BLOCK * BLOCK, 3)
    for blocks, k in _block_batches(counts):
        if grad_blocks is not None:
            with torch.enable_grad():
                c, _, _, t_fin, _ = _composite_blocks(proj, blocks, k, starts, counts,
                                                      gid, width)
                out = c + t_fin[..., None] * bg
                torch.autograd.backward(out, grad_blocks[torch.tensor(blocks, device=dev)])
            continue
        with torch.no_grad():
            c, d, a, t_fin, seen = _composite_blocks(proj, blocks, k, starts, counts,
                                                     gid, width)
        seen_total += int(seen)
        b = torch.tensor(blocks, device=dev)
        by, bx = b // nbx, b % nbx
        rgb[:, by, :, bx, :] = (c + t_fin[..., None] * bg).reshape(-1, BLOCK, BLOCK, 3) \
            .permute(0, 3, 1, 2)
        depth[by, :, bx, :] = d.reshape(-1, BLOCK, BLOCK)
        alpha[by, :, bx, :] = a.reshape(-1, BLOCK, BLOCK)
    if grad_blocks is not None:
        return None
    rgb = rgb.reshape(3, pad_h, pad_w)[:, :height, :width]
    depth = depth.reshape(pad_h, pad_w)[:height, :width]
    alpha = alpha.reshape(pad_h, pad_w)[:height, :width]
    return rgb, depth, alpha, seen_total


def render(field: dict, alive: torch.Tensor, scene: dict, verts: torch.Tensor,
           cam: dict, sh_degree: int):
    """(rgb [3, H, W], live pairs) of one camera, no autograd."""
    with torch.no_grad():
        proj = project_view(field, alive, scene, verts, cam, sh_degree)
        rgb, _, _, seen = composite(proj, scene["width"], scene["height"], scene["bg"])
    return rgb, seen


# ------------------------------------------------------------------- losses

def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [B, 3, H, W] images: 11x11 Gaussian window, sigma 1.5,
    zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    xs = torch.arange(11, dtype=torch.float32, device=a.device) - 5.0
    g = torch.exp(-xs * xs / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()

    def blur(x):
        return F.conv2d(x, win, padding=5, groups=3)

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1)
                                                  * (s11 + s22 + c2))
    return m.mean()


def mesh_regularizers(verts: torch.Tensor, edges: torch.Tensor, rest_len: torch.Tensor,
                      opt: dict) -> torch.Tensor:
    """Deformation magnitude, rigid edge lengths and momentum over the
    vertices [B, V, 3] of consecutive times (the first and the last need
    three times)."""
    def norm(x):
        return torch.sqrt((x * x).sum(-1) + 1e-12)

    loss = verts.new_zeros(())
    three = verts.shape[0] >= 3
    if opt["lambda_deform_mag"] > 0 and three:
        loss = loss + opt["lambda_deform_mag"] * 0.5 * (
            norm(verts[1] - verts[0]).mean() + norm(verts[2] - verts[1]).mean())
    if opt["lambda_rigid"] > 0:
        d = norm(verts[:, edges[1]] - verts[:, edges[0]])
        loss = loss + opt["lambda_rigid"] * (rest_len[None] - d).abs().mean()
    if opt["lambda_momentum"] > 0 and three:
        loss = loss + opt["lambda_momentum"] * (
            verts[2] - 2 * verts[1] + verts[0]).abs().sum(-1).mean()
    return loss


# ---------------------------------------------------------------- one step

def position_lr(step: int, opt: dict, scale: float) -> float:
    """Log-linear decay of the position learning rate (no delay)."""
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    a, b = opt["position_lr_init"] * scale, opt["position_lr_final"] * scale
    return math.exp(math.log(a) * (1 - t) + math.log(b) * t)


def adam(param, grad, m, v, count: int, lr: float, eps: float):
    """One Adam update (b1 0.9, b2 0.999) with bias correction at ``count``."""
    m = 0.9 * m + 0.1 * grad
    v = 0.999 * v + 0.001 * grad * grad
    upd = (m / (1 - 0.9 ** count)) / (torch.sqrt(v / (1 - 0.999 ** count)) + eps)
    return param - lr * upd, m, v


def train_step(st: dict, scene: dict, cams: list, gts: torch.Tensor, opt: dict,
               sh_degree: int) -> tuple[dict, float]:
    """One training step of the field and the simulator on the cameras
    ``cams`` (three consecutive times of one view) against ``gts`` [3, 3,
    H, W]: the loss L1 + lambda_dssim (1 - SSIM) + mesh regularizers, its
    gradient by autograd, the densification statistics, and Adam on both
    (field eps 1e-15, simulator eps 1e-8). ``st`` holds ``field``, ``sim``,
    their moments ``m``, ``v``, ``count``, ``step``, ``alive``,
    ``face_ids`` and the statistics ``grad_accum``, ``denom``,
    ``max_radii``. Returns (new state, loss)."""
    field = {k: st["field"][k].detach().requires_grad_() for k in FIELD_KEYS}
    sim = {k: st["sim"][k].detach().requires_grad_() for k in SIM_KEYS}
    scene = dict(scene, face_ids=st["face_ids"])
    w, h = scene["width"], scene["height"]
    offset = torch.zeros((field["face_bary"].shape[0], 2), device=gts.device,
                         requires_grad=True)
    scale_xy = torch.tensor([w / 2.0, h / 2.0], device=gts.device)
    projs, leaves, verts = [], [], []
    with torch.enable_grad():
        for cam in cams:
            v = simulate(sim, scene["predictions"], cam["time"])
            proj = project_view(field, st["alive"], scene, v, cam, sh_degree)
            proj["xy"] = proj["xy"] + offset * scale_xy
            projs.append(proj)
            verts.append(v)
        verts = torch.stack(verts)
    images = []
    for proj in projs:
        leaf = {k: proj[k].detach().requires_grad_() for k in
                ("xy", "conic", "color", "opacity", "depth")}
        leaf.update(radius=proj["radius"], valid=proj["valid"],
                    power_cut=proj["power_cut"].detach())
        leaves.append(leaf)
        images.append(composite(leaf, w, h, scene["bg"])[0])
    img = torch.stack(images).requires_grad_()
    with torch.enable_grad():
        photo = (img - gts).abs().mean() + opt["lambda_dssim"] * (1.0 - ssim(img, gts))
        reg = mesh_regularizers(verts, scene["edges"], scene["edge_len"], opt)
        loss = photo + reg
        g_img, = torch.autograd.grad(photo, img)
    for leaf, g in zip(leaves, g_img):
        composite(leaf, w, h, scene["bg"], grad_rgb=g)
    outs, grads = [reg], [None]
    for proj, leaf in zip(projs, leaves):
        for k in ("xy", "conic", "color", "opacity", "depth"):
            if leaf[k].grad is not None:
                outs.append(proj[k])
                grads.append(leaf[k].grad)
    keys = list(FIELD_KEYS) + list(SIM_KEYS)
    tensors = [field[k] for k in FIELD_KEYS] + [sim[k] for k in SIM_KEYS] + [offset]
    gs = torch.autograd.grad(outs, tensors, grads, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, gs)]
    grad = dict(zip(keys, gs[:-1]))
    xy_norm = torch.linalg.norm(gs[-1], dim=-1)

    with torch.no_grad():
        vis = torch.stack([p["radius"] > 0 for p in projs]).any(0)
        radii = torch.stack([p["radius"] for p in projs]).amax(0)
        new = dict(st)
        new["grad_accum"] = st["grad_accum"] + torch.where(vis, xy_norm,
                                                           torch.zeros_like(xy_norm))
        new["denom"] = st["denom"] + vis.float()
        new["max_radii"] = torch.where(vis, torch.maximum(st["max_radii"], radii),
                                       st["max_radii"])
        count = st["count"] + 1
        pos_lr = position_lr(st["step"], opt, scene["spatial_scale"])
        lrs = {"face_bary": pos_lr, "face_offset": pos_lr,
               "features_dc": opt["feature_lr"], "features_rest": opt["feature_lr"] / 20.0,
               "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
               "rotation": opt["rotation_lr"]}
        lrs.update({k: opt["sim_lr"] for k in SIM_KEYS})
        new["field"], new["sim"], new["m"], new["v"] = {}, {}, {}, {}
        for k in keys:
            src = st["field"] if k in FIELD_KEYS else st["sim"]
            dst = new["field"] if k in FIELD_KEYS else new["sim"]
            dst[k], new["m"][k], new["v"][k] = adam(
                src[k], grad[k], st["m"][k], st["v"][k], count, lrs[k],
                1e-15 if k in FIELD_KEYS else 1e-8)
        new["count"] = count
        new["step"] = st["step"] + 1
    return new, float(loss.detach())


# ---------------------------------------------------------- density control

def barycentric(points: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Coordinates [N, 3] of points [N, 3] in triangles [N, 3, 3] as the
    published method computes them for a split's children (its
    ``meshnet/data_utils.py``): solving p - a = s (b - a) + t (c - a) and
    returning (1 - s - t, t, s), the weights of a, c, b. Positions read
    them as the weights of a, b, c; the reference keeps that as published."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab, ac, ap = b - a, c - a, points - a
    gram = torch.stack([torch.stack([(ab * ab).sum(-1), (ab * ac).sum(-1)], -1),
                        torch.stack([(ab * ac).sum(-1), (ac * ac).sum(-1)], -1)], -2)
    rhs = torch.stack([(ab * ap).sum(-1), (ac * ap).sum(-1)], -1)
    det = gram[:, 0, 0] * gram[:, 1, 1] - gram[:, 0, 1] ** 2
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    s = (gram[:, 1, 1] * rhs[:, 0] - gram[:, 0, 1] * rhs[:, 1]) / det
    t = (gram[:, 0, 0] * rhs[:, 1] - gram[:, 0, 1] * rhs[:, 0]) / det
    return torch.stack([1.0 - s - t, t, s], -1)


def fill_free(src_mask: torch.Tensor, alive: torch.Tensor):
    """(sources, slots): the selected Gaussians in index order, each
    matched to a free slot in index order; sources beyond the free slots
    are dropped."""
    src = torch.nonzero(src_mask).squeeze(1)
    free = torch.nonzero(~alive).squeeze(1)
    n = min(src.numel(), free.numel())
    return src[:n], free[:n]


def density_due(opt: dict, iteration: int, white_background: bool) -> dict:
    """Which host events run after ``iteration``'s step."""
    live = iteration < opt["densify_until_iter"]
    return {
        "densify": live and iteration > opt["densify_from_iter"]
        and iteration % opt["densification_interval"] == 0,
        "prune": live and iteration > opt["pruning_from_iter"]
        and iteration % opt["pruning_interval"] == 0,
        "reset": live and (iteration % opt["opacity_reset_interval"] == 0
                           or (white_background and iteration == opt["densify_from_iter"])),
        "cleanup": iteration % opt["bary_cleanup"] == 0,
    }


def density_event(st: dict, scene: dict, opt: dict, iteration: int, eps: torch.Tensor | None,
                  white_background: bool) -> dict:
    """The host events after ``iteration``'s step, each when due, in order:
    densify (Gaussians whose mean view-space gradient reaches the threshold:
    the small cloned, the large split in two children jittered by ``eps``
    [2, C, 3] standard normals in their own frame, at scales / 1.6; new
    Gaussians take free slots, their moments and those of split parents
    start from zero, the statistics restart), prune (faint Gaussians, and
    after the first opacity reset those large on screen or in the world),
    opacity reset (opacities to at most 0.01, their moments zeroed) and the
    barycentric cleanup. Thresholds run linearly from their ``_init`` to
    their ``_after`` value at ``densify_until_iter``; the scene's extent is
    ``spatial_scale``."""
    due = density_due(opt, iteration, white_background)
    st = dict(st, field={k: v.clone() for k, v in st["field"].items()},
              m={k: v.clone() for k, v in st["m"].items()},
              v={k: v.clone() for k, v in st["v"].items()},
              alive=st["alive"].clone(), face_ids=st["face_ids"].clone())
    f, alive = st["field"], st["alive"]
    extent = scene["spatial_scale"]
    frac = iteration / opt["densify_until_iter"]
    op_min = opt["opacity_threshold_fine_init"] - frac * (
        opt["opacity_threshold_fine_init"] - opt["opacity_threshold_fine_after"])
    grad_min = opt["densify_grad_threshold_fine_init"] - frac * (
        opt["densify_grad_threshold_fine_init"] - opt["densify_grad_threshold_after"])
    if due["densify"]:
        grads = st["grad_accum"] / torch.clamp_min(st["denom"], 1e-12)
        grads = torch.nan_to_num(grads, nan=0.0)
        hot = grads >= grad_min
        touched = torch.zeros_like(alive)
        small = torch.exp(f["scaling"]).amax(1) <= opt["percent_dense"] * extent
        src, dst = fill_free(hot & small & alive, alive)
        for k in FIELD_KEYS:
            f[k][dst] = f[k][src]
        st["face_ids"][dst] = st["face_ids"][src]
        alive[dst] = True
        touched[dst] = True
        scale = torch.exp(f["scaling"])
        split = hot & (scale.amax(1) > opt["percent_dense"] * extent) & alive
        tri = scene["rest"][scene["faces"][st["face_ids"]]]
        bsum = f["face_bary"].sum(1, keepdim=True)
        bary = f["face_bary"] / torch.where(bsum.abs() < 1e-8, torch.full_like(bsum, 1e-8),
                                            bsum)
        xyz = (bary[:, :, None] * tri).sum(1)
        rot = quat_matrix(f["rotation"])
        kids = [barycentric(xyz + (rot @ (eps[i] * scale)[:, :, None])[:, :, 0], tri)
                for i in range(2)]
        shrunk = torch.log(scale / 1.6)
        f["face_bary"][split] = kids[0][split]
        f["scaling"][split] = shrunk[split]
        src, dst = fill_free(split, alive)
        for k in FIELD_KEYS:
            f[k][dst] = f[k][src]
        f["face_bary"][dst] = kids[1][src]
        f["scaling"][dst] = shrunk[src]
        st["face_ids"][dst] = st["face_ids"][src]
        alive[dst] = True
        touched |= split
        touched[dst] = True
        for k in FIELD_KEYS:
            st["m"][k][touched] = 0.0
            st["v"][k][touched] = 0.0
        st["grad_accum"] = torch.zeros_like(st["grad_accum"])
        st["denom"] = torch.zeros_like(st["denom"])
        st["max_radii"] = torch.zeros_like(st["max_radii"])
    if due["prune"]:
        faint = torch.sigmoid(f["opacity"][:, 0]) < op_min
        if iteration > opt["opacity_reset_interval"]:
            faint |= (st["max_radii"] > 20.0) | (
                torch.exp(f["scaling"]).amax(1) > 0.1 * extent)
        alive &= ~faint
    if due["reset"]:
        o = torch.clamp_max(torch.sigmoid(f["opacity"]), 0.01)
        f["opacity"] = torch.log(o / (1.0 - o))
        st["m"]["opacity"].zero_()
        st["v"]["opacity"].zero_()
    if due["cleanup"]:
        f["face_bary"], st["face_ids"] = cleanup_barycentric(
            f["face_bary"], st["face_ids"], alive, scene["faces"], scene["rest"])
    return st


def cleanup_barycentric(bary: torch.Tensor, face_ids: torch.Tensor, alive: torch.Tensor,
                        faces: torch.Tensor, rest: torch.Tensor):
    """Each (Gaussian, coordinate) that is negative for a live Gaussian, in
    index order as found before any is handled: the Gaussian moves to the
    face across the edge opposite that vertex, with coordinates its rest
    position's distances to the new face's vertices over their sum; at
    the mesh's border, where there is none, the coordinate becomes 0.005
    and the coordinates are renormalized. On the host."""
    b = bary.detach().cpu().numpy().copy()
    ids = face_ids.cpu().numpy().copy()
    tris = faces.cpu().numpy()
    pos = rest.cpu().numpy()
    hits = np.argwhere((b < 0) & alive.cpu().numpy()[:, None])
    if len(hits) == 0:
        return bary, face_ids
    by_edge: dict = {}
    for fi, tri in enumerate(tris.tolist()):
        for k in range(3):
            by_edge.setdefault(frozenset((tri[k], tri[(k + 1) % 3])), []).append(fi)
    xyz = np.einsum("ck,ckx->cx", b / np.maximum(b.sum(1, keepdims=True), 1e-8),
                    pos[tris[ids]])
    for g, k in hits.tolist():
        tri = tris[ids[g]].tolist()
        edge = frozenset(v for i, v in enumerate(tri) if i != k)
        across = [fi for fi in by_edge[edge] if fi != ids[g]]
        if across:
            ids[g] = across[0]
            d = np.linalg.norm(xyz[g][None] - pos[tris[across[0]]], axis=1)
            b[g] = d / d.sum()
        else:
            b[g, k] = 0.005
            b[g] = b[g] / b[g].sum()
    return (torch.from_numpy(b).to(bary.device),
            torch.from_numpy(ids).to(face_ids.device))
