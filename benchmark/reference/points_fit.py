"""Plain PyTorch reference of 3D Gaussian Splatting's training (Kerbl et
al., SIGGRAPH 2023) as the published ``gaussian-splatting`` code runs it
(``train.py``, ``arguments/__init__.py``): one step on one camera and the
density event of the free-xyz model.

The step: the render of ``points.py`` made differentiable, the published
loss (1 - ``lambda_dssim``) L1 + ``lambda_dssim`` (1 - SSIM), its gradient
by autograd, the
densification statistic on the published NDC scale (the gradient of the
loss with respect to each screen mean times W/2, H/2, as ``splat.py``
takes it), and Adam (b1 0.9, b2 0.999, eps 1e-15) with the published
groups: positions at ``splat.position_lr`` x the scene's extent, DC
features at ``feature_lr``, the higher SH at a twentieth of it, opacity,
scaling and rotation at their own; the SH degree is
min(degree, iteration // ``sh_increase_interval``).

The compositing is ``points.py``'s, with one pixel stopped once the pair
that takes its T below 1e-4 has composited. Its backward is autograd,
block by block, from the gradient of the loss with respect to the image
(the pattern of ``splat.composite``): a first walk finds how many sorted
Gaussians each 16 px block needs before all its pixels are done, and the
image and its backward composite those, so that the work follows the live
pairs and fits on the card beside nothing else.

The density event, after the step of every ``densification_interval``-th
iteration in (``densify_from_iter``, ``densify_until_iter``), in the
published order: clone (a Gaussian whose mean statistic reaches
``densify_grad_threshold`` and whose largest scale is at most
``percent_dense`` x extent is copied), split (one above that size: two
children at the parent's mean plus R (eps_i * scales), scales / 1.6, the
parent gone), the statistics restarted, then prune (opacity below
``min_opacity``; after the first opacity reset also a largest scale above
a tenth of the extent, or a screen radius above ``max_screen_size``, which
reads the restarted, zero, radii and so selects nothing, as published).
Slots are the program's: a capacity with an ``alive`` mask, a new Gaussian
taking the next free slot in index order (``splat.fill_free``), a split's
first child its parent's slot; new rows and split parents start from zero
Adam moments. The opacity reset (every ``opacity_reset_interval``-th
iteration) sets opacities to at most 0.01 and zeroes their moments. The
published code replaces the parameter tensors at an event, which skips
that iteration's Adam step; here, as in the port, Adam runs before the
event.

Imports torch and numpy only, through ``points.py`` and ``splat.py``;
float32 with TF32 off (``points.py`` sets it).
"""

from __future__ import annotations

import torch

from benchmark.reference import points
from benchmark.reference.splat import (
    ALPHA_MAX,
    ALPHA_MIN,
    POWER_CUTOFF,
    T_EXIT,
    _block_batches,
    adam,
    fill_free,
    position_lr,
    quat_matrix,
    ssim,
)

FIELD_KEYS = points.FIELD_KEYS
BLOCK = points.BLOCK
CHUNK = points.CHUNK


# ------------------------------------------------------------- projection

def project_view(field: dict, alive: torch.Tensor, cam: dict, width: int, height: int,
                 tan_x: float, tan_y: float, sh_degree: int,
                 max_radius: float | None = None) -> dict:
    """``points.project_view`` of the live Gaussians, differentiable, with
    each Gaussian's support cut (``power_cut``). With ``max_radius`` the
    screen radius is capped and the support ellipse shrunk to fit, as the
    cloth field's projection does (a fault for this model)."""
    proj = points.project_view(field, cam, width, height, tan_x, tan_y, sh_degree)
    radius = proj["radius"]
    cut = torch.full_like(radius, POWER_CUTOFF)
    if max_radius is not None:
        capped = torch.clamp_max(radius, max_radius)
        cut = POWER_CUTOFF * (capped / torch.clamp_min(radius, 1.0)) ** 2
        radius = capped
    xy = proj["xy"].detach()
    valid = (proj["valid"] & alive & (xy[:, 0] + radius > 0) & (xy[:, 0] - radius < width)
             & (xy[:, 1] + radius > 0) & (xy[:, 1] - radius < height))
    proj.update(valid=valid, power_cut=cut,
                radius=torch.where(valid, radius, torch.zeros_like(radius)))
    return proj


# ------------------------------------------------------------ compositing

def needed_slots(proj: dict, width: int, height: int) -> torch.Tensor:
    """Per 16 px block, the sorted Gaussians it walks, a chunk of 128 at a
    time, before every pixel of it is done (T below T_EXIT): ``points.
    composite``'s walk, without its sums."""
    dev = proj["xy"].device
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    pp = BLOCK * BLOCK
    starts, counts, gid = points.bin_blocks(proj, width, height)
    p = torch.arange(pp, device=dev)
    blocks = torch.arange(nbx * nby, device=dev)
    px = ((blocks % nbx) * BLOCK)[:, None] + (p % BLOCK)[None, :]
    py = ((blocks // nbx) * BLOCK)[:, None] + (p // BLOCK)[None, :]
    trans = ((px < width) & (py < height)).float()
    attrs = torch.cat([proj["xy"], proj["conic"], proj["opacity"][:, None],
                       proj["power_cut"][:, None]], 1).detach()
    walked = torch.zeros(nbx * nby, dtype=torch.long, device=dev)
    last = max(gid.numel() - 1, 0)
    per_batch = max(1, points.BATCH_ELEMS // (pp * CHUNK))
    with torch.no_grad():
        while True:
            live = torch.nonzero((walked < counts) & (trans.amax(1) >= T_EXIT)).squeeze(1)
            if live.numel() == 0:
                break
            for b in live.split(per_batch):
                slot = walked[b][:, None] + torch.arange(CHUNK, device=dev)[None, :]
                in_list = slot < counts[b][:, None]
                idx = gid[torch.clamp(starts[b][:, None] + slot, max=last)] if gid.numel() \
                    else torch.zeros_like(slot)
                g = attrs[idx]
                alpha = _alpha(px[b], py[b], g[..., 0], g[..., 1], g[..., 2], g[..., 3],
                               g[..., 4], g[..., 5], g[..., 6], in_list)
                trans[b] = trans[b] * torch.prod(1.0 - alpha, -1)
                walked[b] += CHUNK
    return torch.minimum(walked, counts), (starts, counts, gid)


def _alpha(px, py, x, y, ca, cb, cc, op, cut, in_list):
    """alpha [nb, p, k] of each (pixel, slot): 0 where the pair is dead."""
    dx = px[:, :, None].float() - x[:, None, :]
    dy = py[:, :, None].float() - y[:, None, :]
    power = -0.5 * (ca[:, None, :] * dx * dx + cc[:, None, :] * dy * dy) \
        - cb[:, None, :] * dx * dy
    ok = (power <= 0) & (power >= cut[:, None, :]) & in_list[:, None, :]
    power = torch.where(ok, power, torch.full_like(power, -30.0))
    alpha = torch.clamp_max(op[:, None, :] * torch.exp(power), ALPHA_MAX)
    return torch.where(ok & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))


def _blocks(proj: dict, blocks: list, k: int, starts, counts, gid, width: int,
            height: int, bg: torch.Tensor) -> torch.Tensor:
    """Colour [nb, p, 3] (the background included) of ``blocks``, each
    walking its first ``counts[b]`` sorted Gaussians (padded to ``k``), a
    pixel stopping once the pair that takes its T below T_EXIT has
    composited."""
    dev = proj["xy"].device
    nbx = -(-width // BLOCK)
    b = torch.tensor(blocks, device=dev)
    slot = torch.arange(k, device=dev)
    in_list = slot[None, :] < counts[b][:, None]
    idx = torch.where(in_list, gid[torch.clamp(starts[b][:, None] + slot[None, :],
                                               max=max(gid.numel() - 1, 0))],
                      torch.zeros_like(slot)[None, :])
    p = torch.arange(BLOCK * BLOCK, device=dev)
    px = ((b % nbx) * BLOCK)[:, None] + (p % BLOCK)[None, :]
    py = ((b // nbx) * BLOCK)[:, None] + (p // BLOCK)[None, :]
    t0 = ((px < width) & (py < height)).float()
    xy, conic = proj["xy"][idx], proj["conic"][idx]
    alpha = _alpha(px, py, xy[..., 0], xy[..., 1], conic[..., 0], conic[..., 1],
                   conic[..., 2], proj["opacity"][idx], proj["power_cut"][idx], in_list)
    before = t0[..., None] * torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1]], -1), -1)
    # T falls monotonically: the pairs a pixel keeps come first
    alpha = torch.where(before.detach() >= T_EXIT, alpha, torch.zeros_like(alpha))
    w = alpha * before
    rgb = torch.bmm(w, proj["color"][idx])
    return rgb + (t0 * torch.prod(1.0 - alpha, -1))[..., None] * bg


def composite(proj: dict, width: int, height: int, bg: torch.Tensor,
              grad_rgb: torch.Tensor | None = None):
    """The image [3, H, W]; with ``grad_rgb`` [3, H, W] instead
    back-propagates it into the ``.grad`` of the projected leaves that
    require it (xy, conic, color, opacity) and returns None."""
    need, (starts, _, gid) = needed_slots(proj, width, height)
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    pad_w, pad_h = nbx * BLOCK, nby * BLOCK
    dev = proj["xy"].device
    out = bg[None, :].expand(nbx * nby, 3)[:, None, :].repeat(1, BLOCK * BLOCK, 1)
    grad_blocks = None
    if grad_rgb is not None:
        g = torch.nn.functional.pad(grad_rgb, (0, pad_w - width, 0, pad_h - height))
        grad_blocks = g.reshape(3, nby, BLOCK, nbx, BLOCK).permute(1, 3, 2, 4, 0) \
            .reshape(nby * nbx, BLOCK * BLOCK, 3)
    for blocks, k in _block_batches(need):
        if grad_blocks is not None:
            with torch.enable_grad():
                c = _blocks(proj, blocks, k, starts, need, gid, width, height, bg)
                torch.autograd.backward(c, grad_blocks[torch.tensor(blocks, device=dev)])
            continue
        with torch.no_grad():
            out[torch.tensor(blocks, device=dev)] = _blocks(proj, blocks, k, starts, need,
                                                            gid, width, height, bg)
    if grad_blocks is not None:
        return None
    return out.reshape(nby, nbx, BLOCK, BLOCK, 3).permute(4, 0, 2, 1, 3) \
        .reshape(3, pad_h, pad_w)[:, :height, :width]


# ---------------------------------------------------------------- one step

def sh_degree_at(iteration: int, opt: dict, degree: int) -> int:
    return min(degree, iteration // opt["sh_increase_interval"])


def events_due(iteration: int, opt: dict) -> dict:
    """What ``train.py`` does after ``iteration``'s backward (black
    background)."""
    live = iteration < opt["densify_until_iter"]
    return {"stats": live,
            "densify": live and iteration > opt["densify_from_iter"]
            and iteration % opt["densification_interval"] == 0,
            "reset": live and iteration % opt["opacity_reset_interval"] == 0}


def train_step(st: dict, scene: dict, cam: dict, gt: torch.Tensor, opt: dict,
               iteration: int, max_radius: float | None = None) -> tuple[dict, float, dict]:
    """One step on camera ``cam`` against ``gt`` [3, H, W]. ``st`` holds
    ``field``, its moments ``m``, ``v``, ``count``, ``alive`` and the
    statistics ``grad_accum``, ``denom``, ``max_radii``; ``scene`` the
    frame (``width``, ``height``, ``tan_x``, ``tan_y``, ``bg``,
    ``sh_degree``) and ``extent``. Returns (new state, loss, projected
    Gaussians)."""
    w, h = scene["width"], scene["height"]
    field = {k: st["field"][k].detach().requires_grad_() for k in FIELD_KEYS}
    dev = gt.device
    offset = torch.zeros((field["xyz"].shape[0], 2), device=dev, requires_grad=True)
    with torch.enable_grad():
        proj = project_view(field, st["alive"], cam, w, h, scene["tan_x"], scene["tan_y"],
                            sh_degree_at(iteration, opt, scene["sh_degree"]), max_radius)
        proj["xy"] = proj["xy"] + offset * torch.tensor([w / 2.0, h / 2.0], device=dev)
    leaf = {k: proj[k].detach().requires_grad_() for k in ("xy", "conic", "color",
                                                           "opacity")}
    leaf.update(radius=proj["radius"].detach(), valid=proj["valid"],
                power_cut=proj["power_cut"].detach(), depth=proj["depth"].detach())
    img = composite(leaf, w, h, scene["bg"]).requires_grad_()
    with torch.enable_grad():
        lam = opt["lambda_dssim"]
        loss = (1.0 - lam) * (img - gt).abs().mean() + lam * (1.0 - ssim(img[None], gt[None]))
        g_img, = torch.autograd.grad(loss, img)
    composite(leaf, w, h, scene["bg"], grad_rgb=g_img)
    reached = [k for k in ("xy", "conic", "color", "opacity") if leaf[k].grad is not None]
    outs = [proj[k] for k in reached]
    grads = [leaf[k].grad for k in reached]
    tensors = [field[k] for k in FIELD_KEYS] + [offset]
    gs = torch.autograd.grad(outs, tensors, grads, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, gs)]
    grad = dict(zip(FIELD_KEYS, gs[:-1]))
    with torch.no_grad():
        new = dict(st)
        if events_due(iteration, opt)["stats"]:
            vis = proj["radius"] > 0
            xy_norm = torch.linalg.norm(gs[-1], dim=-1)
            new["grad_accum"] = st["grad_accum"] + torch.where(vis, xy_norm,
                                                               torch.zeros_like(xy_norm))
            new["denom"] = st["denom"] + vis.float()
            new["max_radii"] = torch.where(vis, torch.maximum(st["max_radii"],
                                                              proj["radius"]),
                                           st["max_radii"])
        count = st["count"] + 1
        lrs = {"xyz": position_lr(iteration, opt, scene["extent"]),
               "features_dc": opt["feature_lr"], "features_rest": opt["feature_lr"] / 20.0,
               "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
               "rotation": opt["rotation_lr"]}
        new["field"], new["m"], new["v"] = {}, {}, {}
        for k in FIELD_KEYS:
            new["field"][k], new["m"][k], new["v"][k] = adam(
                st["field"][k], grad[k], st["m"][k], st["v"][k], count, lrs[k], 1e-15)
        new["count"] = count
    return new, float(loss.detach()), proj


# ---------------------------------------------------------- density control

def density_event(st: dict, scene: dict, opt: dict, iteration: int,
                  eps: torch.Tensor | None) -> dict:
    """The host events after ``iteration``'s step, each when due (module
    docstring); ``eps`` [2, C, 3] is the split's standard-normal jitter."""
    due = events_due(iteration, opt)
    st = dict(st, field={k: v.clone() for k, v in st["field"].items()},
              m={k: v.clone() for k, v in st["m"].items()},
              v={k: v.clone() for k, v in st["v"].items()}, alive=st["alive"].clone())
    f, alive = st["field"], st["alive"]
    extent = scene["extent"]
    if due["densify"]:
        grads = torch.nan_to_num(st["grad_accum"] / st["denom"], nan=0.0)
        hot = grads >= opt["densify_grad_threshold"]
        touched = torch.zeros_like(alive)
        small = torch.exp(f["scaling"]).amax(1) <= opt["percent_dense"] * extent
        src, dst = fill_free(hot & small & alive, alive)
        for k in FIELD_KEYS:
            f[k][dst] = f[k][src]
        alive[dst] = True
        touched[dst] = True
        scale = torch.exp(f["scaling"])
        split = hot & (scale.amax(1) > opt["percent_dense"] * extent) & alive
        rot = quat_matrix(f["rotation"])
        kids = [f["xyz"] + (rot @ (eps[i] * scale)[:, :, None])[:, :, 0] for i in range(2)]
        shrunk = torch.log(scale / 1.6)
        src, dst = fill_free(split, alive)
        for k in FIELD_KEYS:
            f[k][dst] = f[k][src]
        f["xyz"][dst] = kids[1][src]
        f["scaling"][dst] = shrunk[src]
        f["xyz"][split] = kids[0][split]
        f["scaling"][split] = shrunk[split]
        alive[dst] = True
        touched |= split
        touched[dst] = True
        for k in FIELD_KEYS:
            st["m"][k][touched] = 0.0
            st["v"][k][touched] = 0.0
        st["grad_accum"] = torch.zeros_like(st["grad_accum"])
        st["denom"] = torch.zeros_like(st["denom"])
        st["max_radii"] = torch.zeros_like(st["max_radii"])
        faint = torch.sigmoid(f["opacity"][:, 0]) < opt["min_opacity"]
        if iteration > opt["opacity_reset_interval"]:
            faint |= (st["max_radii"] > opt["max_screen_size"]) | (
                torch.exp(f["scaling"]).amax(1) > 0.1 * extent)
        alive &= ~faint
    if due["reset"]:
        o = torch.clamp_max(torch.sigmoid(f["opacity"]), 0.01)
        f["opacity"] = torch.log(o / (1.0 - o))
        st["m"]["opacity"].zero_()
        st["v"]["opacity"].zero_()
    return st
