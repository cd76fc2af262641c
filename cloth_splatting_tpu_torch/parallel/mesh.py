"""Device-mesh parallelism of one scene's training and of GNN training;
counterpart of ``cloth_splatting_tpu/parallel/mesh.py``.

The JAX package is single-controller: one process owns every device, and a
``shard_map`` over a ``("data", "model")`` mesh spells out the collectives.
The port runs one process per device (``parallel/launch.py``), so this
layer is SPMD over ``torch.distributed``: every rank runs the same step on
its own share and meets the others in the collectives below.

  * ``data`` cuts the camera batch: a rank renders its rows of it;
  * ``model`` cuts the Gaussian capacity into contiguous blocks: a rank
    runs the per-Gaussian front end (simulator vertices, barycentric means,
    face rotations, SH, EWA) on its block, the projected bundle is gathered
    over ``model`` before the compositor (``gather_bundle``), and the
    gather's backward reduce-scatters the gradients back to their rows;
  * the images, vertices (and, for the kNN terms, means and rotations) are
    gathered over ``data``, so every rank forms the full batch's loss with
    the unsharded code (``Trainer.batch_loss``), scaled by ``1/(D*M)``: the
    gathers' backward sums the D*M shares into the true gradient;
  * Gaussian and screen-offset gradients are summed over ``data``, the
    simulator's gradients and the loss over every rank; radii and
    visibility take the maximum over ``data``.

Contiguous blocks keep the gathered bundle in the global row order, so the
compositor's stable sort breaks ties as the unsharded step does.

Each collective is counted in ``COUNTS`` under ``"<op>/<axis>"``, which is
how a test reads the collectives one step issues.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cloth_splatting_tpu_torch.models import gaussians as G
from cloth_splatting_tpu_torch.models.deform import simulator_from_params
from cloth_splatting_tpu_torch.ops.image import psnr
from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
from cloth_splatting_tpu_torch.render import CameraArrays, render
from cloth_splatting_tpu_torch.train.step import Forward, StepCarry, Trainer

# collectives issued by this process, "<op>/<axis name>" -> count
COUNTS: collections.Counter = collections.Counter()


class Axis(NamedTuple):
    """One axis of the mesh as this rank sees it."""

    name: str                       # "data", "model" or "world"
    group: dist.ProcessGroup
    size: int
    rank: int                       # this rank's index along the axis


class MeshAxes(NamedTuple):
    data: Axis
    model: Axis
    world: Axis


def mesh_shape(n: int, data: int | None = None) -> tuple[int, int]:
    """(D, M) of ``n`` devices: the JAX package's rule, ``data`` 3 if 3
    divides n, else 2 if 2 does, else 1."""
    if data is None:
        data = next((c for c in (3, 2) if n % c == 0), 1)
    if n % data:
        raise ValueError(f"data={data} does not divide {n} devices")
    return data, n // data


def make_mesh(n_devices: int | None = None, data: int | None = None):
    """A ``DeviceMesh`` named ("data", "model") over the initialized world
    (one rank a device), shaped by ``mesh_shape``. ``n_devices`` must be
    the world size: each rank is one device of the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, "
                         f"have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape(n, data),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> MeshAxes:
    d, m = mesh.get_coordinate()
    dsize, msize = mesh.shape
    return MeshAxes(
        data=Axis("data", mesh.get_group("data"), dsize, d),
        model=Axis("model", mesh.get_group("model"), msize, m),
        world=Axis("world", dist.group.WORLD, dist.get_world_size(),
                   dist.get_rank()))


# ----------------------------------------------------------------- collectives

def _gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis's ranks' ``x`` [n, ...] stacked in rank order [size * n, ...]."""
    COUNTS[f"all_gather/{axis.name}"] += 1
    x = x.contiguous()
    out = x.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return out


class _AllGatherRows(torch.autograd.Function):
    """``_gather`` forward; its transpose, a reduce-scatter (sum) of the
    cotangent, backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        COUNTS[f"reduce_scatter/{axis.name}"] += 1
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // axis.size,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=axis.group)
        return out, None


def all_gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rows of every rank of ``axis``, in rank order; differentiable (the
    backward sums each rank's cotangent of a row onto the row's owner)."""
    return _AllGatherRows.apply(x, axis)


@torch.no_grad()
def reduce_packed(tensors: list[torch.Tensor], axis: Axis,
                  op: str = "sum") -> list[torch.Tensor]:
    """``psum`` / ``pmax`` of several tensors in one collective: flattened
    into one float32 buffer (integer and boolean tensors exactly, below
    2^24), reduced over ``axis``, and returned in their own shapes and
    dtypes (booleans as ``> 0``)."""
    COUNTS[f"all_reduce_{op}/{axis.name}"] += 1
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=axis.group)
    out, k = [], 0
    for t in tensors:
        part = buf[k:k + t.numel()].reshape(t.shape)
        k += t.numel()
        out.append(part > 0 if t.dtype == torch.bool else part.to(t.dtype))
    return out


def agree(flag: bool, axis: Axis) -> bool:
    """True on every rank when ``flag`` is true on any: a host decision
    taken on one rank, made the same on all. The flag travels on this
    rank's card under NCCL (which reduces nothing on the CPU), else on the
    CPU."""
    dev = "cuda" if dist.get_backend(axis.group) == "nccl" else "cpu"
    return bool(reduce_packed([torch.tensor(float(flag), device=dev)], axis, "max")[0])


# ---------------------------------------------------- placement of the state

def block(n: int, axis: Axis) -> slice:
    """This rank's contiguous block of ``n`` rows along ``axis``."""
    per = n // axis.size
    return slice(axis.rank * per, (axis.rank + 1) * per)


def _capacity_trees(state) -> dict:
    """The capacity-leading parts of a SplatTrainState."""
    return {"params": state.params, "gstate": state.gstate,
            "mu": state.g_opt.mu, "nu": state.g_opt.nu}


def _with_capacity_trees(state, trees: dict):
    return state._replace(params=trees["params"], gstate=trees["gstate"],
                          g_opt=state.g_opt._replace(mu=trees["mu"], nu=trees["nu"]))


def shard_splat_state(state, axis: Axis):
    """This rank's block of every capacity-leading tensor (parameters,
    bookkeeping, Adam moments) of a full state; the rest is replicated.
    The capacity must divide by the axis size."""
    cap = state.params.face_bary.shape[0]
    if cap % axis.size:
        raise ValueError(f"capacity {cap} does not divide over {axis.size} ranks")
    rows = block(cap, axis)
    return _with_capacity_trees(state, {
        k: type(t)(*(x[rows].clone() for x in t)) for k, t in
        _capacity_trees(state).items()})


@torch.no_grad()
def gather_splat_state(state, axis: Axis):
    """The full state from every rank's block (``shard_splat_state``'s
    inverse), on every rank: the floating tensors in one gather, the
    integer and boolean ones in another."""
    trees = _capacity_trees(state)
    leaves = [x for t in trees.values() for x in t]
    n = leaves[0].shape[0]
    floats = [x for x in leaves if x.is_floating_point()]
    others = [x for x in leaves if not x.is_floating_point()]
    full_f = _gather(torch.cat([x.reshape(n, -1) for x in floats], 1), axis)
    full_i = _gather(torch.stack([x.to(torch.int64) for x in others], 1), axis)
    out, kf, ki = [], 0, 0
    for x in leaves:
        if x.is_floating_point():
            w = x[0].numel()
            out.append(full_f[:, kf:kf + w].reshape((-1,) + tuple(x.shape[1:])))
            kf += w
        else:
            out.append(full_i[:, ki].to(x.dtype))
            ki += 1
    it = iter(out)
    return _with_capacity_trees(state, {
        k: type(t)(*(next(it) for _ in t)) for k, t in trees.items()})


# ------------------------------------------------- the gathered bundle

_DIFF_FIELDS = ("xy", "depth", "conic", "color", "opacity")
_FIXED_FIELDS = ("radius", "power_cut", "valid")


def gather_bundle(proj: ProjectedGaussians, axis: Axis) -> ProjectedGaussians:
    """Every rank's projected Gaussians of ``axis``, in row order, through
    one collective: the fields packed as columns of one [n, 13] buffer.
    Gradients flow to the fields the compositors differentiate (xy,
    depth, conic, color, opacity); radius, power_cut and valid travel
    detached, as the compositors take them."""
    n = proj.xy.shape[0]
    cols = [getattr(proj, f).reshape(n, -1) for f in _DIFF_FIELDS]
    cols += [getattr(proj, f).detach().reshape(n, -1).to(torch.float32)
             for f in _FIXED_FIELDS]
    full = all_gather_rows(torch.cat(cols, 1), axis)
    out, k = {}, 0
    for f, c in zip(_DIFF_FIELDS + _FIXED_FIELDS, cols):
        w = c.shape[1]
        part = full[:, k:k + w]
        k += w
        ref = getattr(proj, f)
        out[f] = (part[:, 0] > 0.5 if ref.dtype == torch.bool
                  else part.reshape((-1,) + tuple(ref.shape[1:])))
    return ProjectedGaussians(**out)


# ------------------------------------------------------ the sharded steps

def _local_step(trainer, axes: MeshAxes, state, cams, gts, masks, sh_degree: int,
                static: bool, knn_state, n_cams: int):
    """One rank's share of a train step on the full batch ``cams`` (fields
    [n_cams + pad, ...], padded by modular repeat to a multiple of D),
    ``gts`` [n_cams, 3, H, W], ``masks`` or None. Returns (state, metrics)
    equal on every rank of a data row, the state this rank's block."""
    o = trainer.cfg.opt
    scale = float(axes.data.size * axes.model.size)
    c_local = cams.time.shape[0] // axes.data.size
    rows = block(cams.time.shape[0], axes.data)
    cap = state.params.face_bary.shape[0]
    params = G.GaussianParams(*(p.detach().requires_grad_() for p in state.params))
    simulator, sim = None, None
    if not static:
        simulator = simulator_from_params(state.sim_params)
        sim = dict(simulator.named_parameters())
    screen_offset = torch.zeros((cap, 2), dtype=torch.float32,
                                device=trainer.device, requires_grad=True)
    outs = []
    for b in range(rows.start, rows.stop):
        cam = CameraArrays(*(f[b] for f in cams))
        outs.append(render(
            cam, trainer.width, trainer.height, trainer.tanfovx, trainer.tanfovy,
            params, state.gstate, trainer.mesh, simulator,
            trainer.mesh_predictions, trainer.bg, sh_degree,
            screen_offset=screen_offset, render_static=static,
            k_cap=o.raster_k_cap, k_chunk=o.raster_k_chunk,
            backend=trainer.backend, pack_order=o.raster_pack_order,
            device=trainer.device, gather_group=axes.model))
    use_knn = knn_state is not None and not static
    # the full batch's frames: one gather over data of each camera's image,
    # vertices (and this rank's means and rotations), cut to n_cams
    shapes = [(3, trainer.height, trainer.width), tuple(outs[0].vertices.shape)]
    fields = [[out.rgb for out in outs], [out.vertices for out in outs]]
    if use_knn:
        shapes += [(cap, 3), (cap, 4)]
        fields += [[out.means3d for out in outs], [out.rotations for out in outs]]
    local = torch.cat([torch.stack(f).reshape(c_local, -1) for f in fields], 1)
    full = all_gather_rows(local, axes.data)[:n_cams]
    parts, k = [], 0
    for s in shapes:
        w = int(np.prod(s))
        parts.append(full[:, k:k + w].reshape((n_cams,) + s))
        k += w
    images, vertices = parts[0], parts[1]

    def means_rotations():
        # this rank's rows of every camera, gathered over model into the
        # capacity-global kNN neighbourhoods
        mr = torch.cat(parts[2:], 2).transpose(0, 1)            # [cap, B, 7]
        mr = all_gather_rows(mr, axes.model).transpose(0, 1)    # [B, C, 7]
        return mr[..., :3], mr[..., 3:]

    loss, ldict = trainer.batch_loss(images, gts, masks, vertices,
                                     cams.time[:n_cams], static,
                                     knn_state if use_knn else None,
                                     means_rotations)
    local_loss = loss / scale
    with torch.no_grad():
        real = torch.arange(rows.start, rows.stop, device=trainer.device) < n_cams
        fwd = Forward(
            loss=local_loss, params=params, sim=sim, screen_offset=screen_offset,
            psnr=psnr(images, gts).mean() / scale, l1=ldict["l1"].detach() / scale,
            radii=torch.stack([out.radii for out in outs]).amax(dim=0),
            visibility=torch.stack([out.visibility for out in outs]).any(dim=0),
            n_dropped=(torch.stack([out.n_dropped for out in outs])
                       * real.to(outs[0].n_dropped.dtype)).sum())
    g_grads, sim_grads, screen_grad = Trainer.backward(fwd)

    # the psums and pmaxes, each in one collective
    n_g = len(g_grads)
    summed = reduce_packed(list(g_grads) + [screen_grad, fwd.n_dropped], axes.data)
    g_grads = G.GaussianParams(*summed[:n_g])
    screen_grad, n_dropped = summed[n_g], summed[n_g + 1]
    sim_keys = [] if sim_grads is None else list(sim_grads)
    replicated = reduce_packed(
        [local_loss.detach(), fwd.psnr, fwd.l1] + [sim_grads[k] for k in sim_keys],
        axes.world)
    if sim_grads is not None:
        sim_grads = dict(zip(sim_keys, replicated[3:]))
    radii, visibility = reduce_packed([fwd.radii, fwd.visibility], axes.data, "max")
    fwd = fwd._replace(loss=replicated[0], psnr=replicated[1], l1=replicated[2],
                       radii=radii, visibility=visibility, n_dropped=n_dropped)
    new_state, metrics = trainer.update(state, fwd, (g_grads, sim_grads, screen_grad))
    (n_alive,) = reduce_packed([metrics.n_alive], axes.model)
    return new_state, metrics._replace(n_alive=n_alive)


def pad_cameras(cams, n_data: int):
    """The camera batch padded to a multiple of ``n_data`` by modular
    repeat (correct also where the pad exceeds the batch, as the B=1
    static stage on 3 or more data rows)."""
    n = cams.time.shape[0]
    idx = torch.arange(n + (-n) % n_data, device=cams.time.device) % n
    return type(cams)(*(f[idx] for f in cams))


def make_banked_sharded_step(trainer, mesh, sh_degree: int, static: bool,
                             n_cams: int, has_masks: bool, use_knn: bool):
    """The banked sharded train step that ``train_scene(device_mesh=...)``
    runs every iteration; the JAX package's function of the same name. It
    addresses the (view x time) banks every rank holds, pads the batch to a
    multiple of D, runs ``_local_step`` and threads the running-statistics
    carry outside the collectives. Returns ``step(state, cam_bank,
    gt_bank, mask_bank, view_idx, time_ids, knn_state, carry) -> (state,
    metrics, carry)``, the state this rank's block."""
    axes = mesh_axes(mesh)

    def step(state, cam_bank, gt_bank, mask_bank, view_idx, time_ids, knn_state,
             carry):
        t_ids = torch.as_tensor(time_ids, dtype=torch.int64, device=trainer.device)
        if len(time_ids) != n_cams:
            raise ValueError(f"step built for {n_cams} cameras, got {len(time_ids)}")
        cams = CameraArrays(*(f[view_idx, t_ids] for f in cam_bank))
        gts = gt_bank[view_idx, t_ids].to(torch.float32) / 255.0
        masks = mask_bank[view_idx, t_ids] if has_masks else None
        new_state, metrics = _local_step(
            trainer, axes, state, pad_cameras(cams, axes.data.size), gts, masks,
            sh_degree, static, knn_state if use_knn else None, n_cams)
        new_carry = StepCarry(
            ema_loss=0.4 * metrics.loss + 0.6 * carry.ema_loss,
            ema_psnr=0.4 * metrics.psnr + 0.6 * carry.ema_psnr,
            drop_accum=carry.drop_accum + metrics.n_dropped.to(torch.int32))
        return new_state, metrics, new_carry

    return step


def make_sharded_splat_step(trainer, mesh, sh_degree: int, static: bool):
    """The sharded step on a camera batch every rank holds (fields [B, ...],
    ground truth [B, 3, H, W]); the JAX package's GSPMD step. Returns
    ``step(state, cams, gt_images, masks=None) -> (state, metrics)``."""
    axes = mesh_axes(mesh)

    def step(state, cams, gt_images, masks=None):
        n = cams.time.shape[0]
        return _local_step(trainer, axes, state, pad_cameras(cams, axes.data.size),
                           gt_images, masks, sh_degree, static, None, n)

    return step


def make_sharded_meshnet_step(trainer, mesh, future: int):
    """GNN training with the sample batch split over every rank of the mesh
    (pure data parallelism). Returns ``(step, place_batch)``:
    ``place_batch`` is the identity (every rank draws the whole batch and
    ``MeshnetTrainer.train_step`` takes its rows), ``step(state, opt_state,
    batch, epoch)`` one step over the world."""
    group = mesh_axes(mesh).world.group

    def step(state, opt_state, batch, epoch):
        return trainer.train_step(state, opt_state, batch, epoch, future,
                                  group=group)

    return step, (lambda batch: batch)
