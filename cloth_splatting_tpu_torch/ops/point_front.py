"""The point front end as two kernels: SH colour, 3D covariance and EWA
projection of every free-xyz Gaussian from one camera in one launch of the
hand-written ``csrc/point_front.cu``, and its adjoint in one launch of
``csrc/point_front_bwd.cu``.

``project_points_fused`` reads the parameters of a
``models.point_gaussians.PointGaussianParams`` as stored (no cat, no basis
tensor) and gives the ``ProjectedGaussians`` of that module's
``project_points_eager`` (the PyTorch ops, its plain version) bit for bit,
without autograd. ``project_points_backward_fused`` gives the gradients of
the parameters from the cotangents of those outputs, recomputing what it
needs from the parameters; its plain version is
``project_points_backward_plain``, the same adjoint in PyTorch ops.
``project_points_autograd`` puts the two kernels behind one
``torch.autograd.Function``. None has a CPU path: ``project_points_view``
chooses them for CUDA tensors whose camera needs no gradient, the bare
forward when no leaf needs one, the function when one does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cloth_splatting_tpu_torch import kernels
from cloth_splatting_tpu_torch.ops.projection import ProjectedGaussians
from cloth_splatting_tpu_torch.ops.quaternion import quat_to_rotmat
from cloth_splatting_tpu_torch.ops.sh import sh_basis, sh_basis_grad
from cloth_splatting_tpu_torch.ops.smallmat import affine4_shared, sym33_from_rs

if TYPE_CHECKING:
    from cloth_splatting_tpu_torch.models.point_gaussians import PointGaussianParams


def check_front_inputs(params: PointGaussianParams, alive: torch.Tensor,
                       world_view: torch.Tensor, full_proj: torch.Tensor,
                       camera_center: torch.Tensor, sh_degree: int,
                       mask: str = "alive") -> None:
    """Raises ValueError unless the front-end kernels take these inputs:
    SH degree 0-4, float32 parameters of the shapes ``PointGaussianParams``
    states with at least the degree's coefficients, a bool mask [C] named
    ``mask`` (the forward's ``alive``, the backward's ``valid``), float32
    camera matrices [4, 4] and centre [3], all contiguous and on one CUDA
    device."""
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {sh_degree}")
    c = params.xyz.shape[0]
    rest = (sh_degree + 1) ** 2 - 1
    tensors = {**params._asdict(), mask: alive, "world_view": world_view,
               "full_proj": full_proj, "camera_center": camera_center}
    shapes = {"xyz": (c, 3), "features_dc": (c, 1, 3), "scaling": (c, 3),
              "rotation": (c, 4), "opacity": (c, 1), mask: (c,),
              "world_view": (4, 4), "full_proj": (4, 4), "camera_center": (3,)}
    for name, t in tensors.items():
        dtype = torch.bool if name == mask else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        shape = tuple(t.shape)
        if name == "features_rest":
            if len(shape) != 3 or shape[0] != c or shape[1] < rest or shape[2] != 3:
                raise ValueError(f"features_rest must be [{c}, >= {rest}, 3] at SH "
                                 f"degree {sh_degree}, got {list(shape)}")
        elif shape != shapes[name]:
            raise ValueError(f"{name} must be {list(shapes[name])}, got {list(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the front-end kernel takes tensors on one CUDA device, "
                         f"got {sorted(map(str, devices))}")


@functools.cache
def _launcher():
    fn = kernels.load("point_front").point_front_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 3 + [i32] + [ptr] * 7 + [ctypes.c_int64, i32, i32, i32]
                   + [f32] * 4 + [i32, f32] + [ptr] * 9)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = kernels.load("point_front_bwd").point_front_bwd_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 3 + [i32] + [ptr] * 7 + [ctypes.c_int64, i32, i32, i32]
                   + [f32] * 4 + [ptr, i32] * 5 + [ptr] * 7)
    fn.restype = ctypes.c_int
    return fn


def _camera(cam) -> list:
    """The camera's three tensors row-major (a transposed ``world_view`` is
    copied: 16 floats)."""
    return [t.contiguous() for t in (cam.world_view, cam.full_proj, cam.camera_center)]


def _scalars(width: int, height: int, tanfovx: float, tanfovy: float) -> list:
    """The PyTorch path's scalars: Python floats, rounded to float32 in the
    call (focal lengths, then the frustum limits)."""
    return [width / (2.0 * tanfovx), height / (2.0 * tanfovy), 1.3 * tanfovx,
            1.3 * tanfovy]


def project_points_fused(params: PointGaussianParams, alive: torch.Tensor, cam,
                         width: int, height: int, tanfovx: float, tanfovy: float,
                         sh_degree: int,
                         max_radius: float | None = None) -> ProjectedGaussians:
    """``project_points_eager``'s outputs from one launch of
    ``csrc/point_front.cu`` on the current stream; no autograd. The camera's
    tensors may have any layout; raises ValueError on other inputs it does
    not take (``check_front_inputs``), before any library is loaded, and
    RuntimeError if the launch fails. ``kernels.LAUNCHES["front"]`` counts
    the kernel's launches (none for zero Gaussians)."""
    camera = _camera(cam)
    check_front_inputs(params, alive, *camera, sh_degree)
    dev = params.xyz.device
    c = params.xyz.shape[0]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = ProjectedGaussians(xy=empty(c, 2), depth=empty(c), conic=empty(c, 3),
                             radius=empty(c), color=empty(c, 3), opacity=empty(c),
                             valid=empty(c, dtype=torch.bool), power_cut=empty(c))
    args = [params.xyz, params.features_dc, params.features_rest,
            params.features_rest.shape[1] * 3, params.scaling, params.rotation,
            params.opacity, alive, *camera, c, sh_degree, width, height,
            *_scalars(width, height, tanfovx, tanfovy), int(max_radius is not None),
            0.0 if max_radius is None else float(max_radius), *out]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if c > 0:
        kernels.launch("front", _launcher(), dev, *args)
    return out


def _cotangent_rows(name: str, t: torch.Tensor, shape: tuple, dev) -> tuple:
    """(tensor, row stride in floats) of a cotangent as the backward kernel
    reads it: float32 of ``shape`` on ``dev``, each row's floats adjacent
    (a view whose columns are not is copied); raises ValueError otherwise."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"the cotangent of {name} must be float32 {list(shape)} on "
                         f"{dev}, got {t.dtype} {list(t.shape)} on {t.device}")
    if len(shape) == 2 and shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def project_points_backward_fused(params: PointGaussianParams, valid: torch.Tensor,
                                  cam, width: int, height: int, tanfovx: float,
                                  tanfovy: float, sh_degree: int, g_xy: torch.Tensor,
                                  g_depth: torch.Tensor, g_conic: torch.Tensor,
                                  g_color: torch.Tensor,
                                  g_opacity: torch.Tensor) -> PointGaussianParams:
    """The gradients of ``params`` (a ``PointGaussianParams`` of new
    contiguous tensors shaped as the leaves) from the cotangents of the
    front end's xy [C, 2], depth [C], conic [C, 3], color [C, 3] and
    opacity [C], given the forward's ``valid`` [C], in one launch of
    ``csrc/point_front_bwd.cu`` on the current stream. The cotangents are
    read where they lie (strided views of one row buffer, as the training
    rasterizer hands them over, need no copy). Raises ValueError on inputs
    it does not take, before any library is loaded, and RuntimeError if
    the launch fails; ``kernels.LAUNCHES["front_bwd"]`` counts its
    launches (none for zero Gaussians). Its plain version is
    ``project_points_backward_plain``."""
    dev = params.xyz.device
    c = params.xyz.shape[0]
    cots = [_cotangent_rows(name, t, shape, dev) for name, t, shape in (
        ("xy", g_xy, (c, 2)), ("depth", g_depth, (c,)), ("conic", g_conic, (c, 3)),
        ("color", g_color, (c, 3)), ("opacity", g_opacity, (c,)))]
    camera = _camera(cam)
    check_front_inputs(params, valid, *camera, sh_degree, mask="valid")
    grads = type(params)(*(torch.empty(p.shape, dtype=torch.float32, device=dev)
                           for p in params))
    args = [params.xyz, params.features_dc, params.features_rest,
            params.features_rest.shape[1] * 3, params.scaling, params.rotation,
            params.opacity, valid, *camera, c, sh_degree, width, height,
            *_scalars(width, height, tanfovx, tanfovy),
            *(v for t, stride in cots for v in (t, stride)), *grads]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if c > 0:
        kernels.launch("front_bwd", _bwd_launcher(), dev, *args)
    return grads


def project_points_backward_plain(params: PointGaussianParams, valid: torch.Tensor,
                                  cam, width: int, height: int, tanfovx: float,
                                  tanfovy: float, sh_degree: int, g_xy: torch.Tensor,
                                  g_depth: torch.Tensor, g_conic: torch.Tensor,
                                  g_color: torch.Tensor,
                                  g_opacity: torch.Tensor) -> PointGaussianParams:
    """``project_points_backward_fused`` in PyTorch ops, on any device: the
    adjoint of ``project_points_eager`` written out. It recomputes the
    forward's intermediates from the parameters and applies the chain rule
    backwards through the EWA projection, the projected mean, the
    covariance, the quaternion's normalization, the SH colour (the basis's
    derivatives from ``sh_basis_grad``) and the view direction, following
    autograd at ties: a clamp passes the gradient at its bound,
    ``torch.where`` gives none to the side it did not select, ``ceil``
    none. A Gaussian whose cotangents are all zero (its depth's counted
    only where ``valid``) gets exact zeros, as do the SH coefficients above
    ``sh_degree``."""
    wv, fp, center = cam.world_view, cam.full_proj, cam.camera_center
    xyz = params.xyz
    g_depth = torch.where(valid, g_depth, torch.zeros_like(g_depth))
    reached = ((g_xy != 0).any(1) | (g_depth != 0) | (g_conic != 0).any(1)
               | (g_color != 0).any(1) | (g_opacity != 0))
    fx, fy, lim_x, lim_y = _scalars(width, height, tanfovx, tanfovy)

    # the forward, recomputed as project_points_eager computes it
    q = params.rotation
    inv = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    qn = q * inv
    r = quat_to_rotmat(q)
    s2 = torch.exp(params.scaling) ** 2
    cov = sym33_from_rs(r, s2)
    t = affine4_shared(xyz, wv)
    h = affine4_shared(xyz, fp)
    t0, t1, tz = t[:, 0], t[:, 1], t[:, 2]
    p_w = 1.0 / (h[:, 3] + 1e-7)
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    rx, ry = t0 / tz_safe, t1 / tz_safe
    txtz, tytz = torch.clamp(rx, -lim_x, lim_x), torch.clamp(ry, -lim_y, lim_y)
    tx, ty = txtz * tz_safe, tytz * tz_safe
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    a0 = j00[:, None] * wv[:3, 0] + j02[:, None] * wv[:3, 2]       # [C, 3]
    a1 = j11[:, None] * wv[:3, 1] + j12[:, None] * wv[:3, 2]
    sym = torch.stack([cov[:, [0, 1, 2]], cov[:, [1, 3, 4]], cov[:, [2, 4, 5]]], 1)
    ta = (sym @ a0[..., None])[..., 0]                              # cov a0
    ua = (sym @ a1[..., None])[..., 0]                              # cov a1
    c00 = (a0 * ta).sum(-1) + 0.3
    c01 = (a1 * ta).sum(-1)
    c11 = (a1 * ua).sum(-1) + 0.3
    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = 1.0 / det_safe

    # conic = (c11, -c01, c00) / det_safe
    gc = g_conic
    g_inv_det = gc[:, 0] * c11 - gc[:, 1] * c01 + gc[:, 2] * c00
    g_det = torch.where(det.abs() < 1e-12, torch.zeros_like(det),
                        -g_inv_det * inv_det * inv_det)
    g_c00 = gc[:, 2] * inv_det + g_det * c11
    g_c11 = gc[:, 0] * inv_det + g_det * c00
    g_c01 = -gc[:, 1] * inv_det - 2.0 * g_det * c01
    # c00 = a0 cov a0, c01 = a1 cov a0, c11 = a1 cov a1
    g_sym = (g_c00[:, None, None] * a0[:, :, None] * a0[:, None, :]
             + g_c01[:, None, None] * a1[:, :, None] * a0[:, None, :]
             + g_c11[:, None, None] * a1[:, :, None] * a1[:, None, :])
    g_cov = torch.stack([g_sym[:, 0, 0], g_sym[:, 0, 1] + g_sym[:, 1, 0],
                         g_sym[:, 0, 2] + g_sym[:, 2, 0], g_sym[:, 1, 1],
                         g_sym[:, 1, 2] + g_sym[:, 2, 1], g_sym[:, 2, 2]], -1)
    g_a0 = 2.0 * g_c00[:, None] * ta + g_c01[:, None] * ua
    g_a1 = g_c01[:, None] * ta + 2.0 * g_c11[:, None] * ua
    g_j00, g_j02 = g_a0 @ wv[:3, 0], g_a0 @ wv[:3, 2]
    g_j11, g_j12 = g_a1 @ wv[:3, 1], g_a1 @ wv[:3, 2]
    g_inv_z2 = -(g_j02 * tx * fx + g_j12 * ty * fy)
    g_inv_z = g_j00 * fx + g_j11 * fy + 2.0 * inv_z * g_inv_z2
    g_tx, g_ty = -g_j02 * fx * inv_z2, -g_j12 * fy * inv_z2
    g_tzs = -g_inv_z * inv_z * inv_z + g_tx * txtz + g_ty * tytz
    zero = torch.zeros_like(tz)
    g_rx = torch.where((rx >= -lim_x) & (rx <= lim_x), g_tx * tz_safe, zero)
    g_ry = torch.where((ry >= -lim_y) & (ry <= lim_y), g_ty * tz_safe, zero)
    g_t0, g_t1 = g_rx / tz_safe, g_ry / tz_safe
    g_tzs = g_tzs - (g_rx * rx + g_ry * ry) / tz_safe
    g_tz = torch.where(tz.abs() < 1e-6, zero, g_tzs) + g_depth
    # px = ((h0 p_w + 1) W) / 2 - 1/2, py alike
    g_h0 = g_xy[:, 0] * (0.5 * width) * p_w
    g_h1 = g_xy[:, 1] * (0.5 * height) * p_w
    g_pw = g_xy[:, 0] * (0.5 * width) * h[:, 0] + g_xy[:, 1] * (0.5 * height) * h[:, 1]
    g_h3 = -g_pw * p_w * p_w
    g_xyz = (torch.stack([g_t0, g_t1, g_tz], -1) @ wv[:3, :3].T
             + torch.stack([g_h0, g_h1, g_h3], -1) @ fp[:3, [0, 1, 3]].T)

    # cov = R diag(s2) R^T
    mm = torch.stack([torch.stack([2.0 * g_cov[:, 0], g_cov[:, 1], g_cov[:, 2]], -1),
                      torch.stack([g_cov[:, 1], 2.0 * g_cov[:, 3], g_cov[:, 4]], -1),
                      torch.stack([g_cov[:, 2], g_cov[:, 4], 2.0 * g_cov[:, 5]], -1)], 1)
    w = mm @ r                                                      # [C, 3, 3]
    g_r = w * s2[:, None, :]
    g_scaling = 2.0 * (0.5 * (r * w).sum(1)) * s2
    # quat_to_rotmat's partial derivatives, then the normalization
    qw, qx, qy, qz = qn.unbind(-1)
    g = g_r
    g_qn = 2.0 * torch.stack([
        -qz * g[:, 0, 1] + qy * g[:, 0, 2] + qz * g[:, 1, 0] - qx * g[:, 1, 2]
        - qy * g[:, 2, 0] + qx * g[:, 2, 1],
        qy * g[:, 0, 1] + qz * g[:, 0, 2] + qy * g[:, 1, 0] - 2.0 * qx * g[:, 1, 1]
        - qw * g[:, 1, 2] + qz * g[:, 2, 0] + qw * g[:, 2, 1] - 2.0 * qx * g[:, 2, 2],
        -2.0 * qy * g[:, 0, 0] + qx * g[:, 0, 1] + qw * g[:, 0, 2] + qx * g[:, 1, 0]
        + qz * g[:, 1, 2] - qw * g[:, 2, 0] + qz * g[:, 2, 1] - 2.0 * qy * g[:, 2, 2],
        -2.0 * qz * g[:, 0, 0] - qw * g[:, 0, 1] + qx * g[:, 0, 2] + qw * g[:, 1, 0]
        - 2.0 * qz * g[:, 1, 1] + qy * g[:, 1, 2] + qx * g[:, 2, 0] + qy * g[:, 2, 1],
    ], -1)
    g_rotation = inv * (g_qn - (g_qn * qn).sum(-1, keepdim=True) * qn)

    # SH colour: color = max(sum_k b_k sh_k + 0.5, 0), the clamp passing at 0
    d = xyz - center[None]
    length = torch.linalg.norm(d, dim=-1, keepdim=True)
    nrm = torch.clamp_min(length, 1e-8)
    u = d / nrm
    n_coef = (sh_degree + 1) ** 2
    feats = torch.cat([params.features_dc, params.features_rest], 1)[:, :n_coef]
    b = sh_basis(sh_degree, u)                                      # [C, K]
    v = (b[..., None] * feats).sum(1)                               # [C, 3]
    gv = torch.where(v + 0.5 >= 0.0, g_color, torch.zeros_like(g_color))
    g_feats = b[..., None] * gv[:, None, :]
    g_b = (feats * gv[:, None, :]).sum(-1)                          # [C, K]
    g_u = (g_b[..., None] * sh_basis_grad(sh_degree, u)).sum(1)     # [C, 3]
    # u = d / max(|d|, 1e-8), the clamp passing at 1e-8
    g_nrm = -(g_u * u).sum(-1, keepdim=True) / nrm
    through = length >= 1e-8
    g_xyz = g_xyz + g_u / nrm + torch.where(
        through, g_nrm * d / torch.where(through, length, torch.ones_like(length)),
        torch.zeros_like(d))

    op = torch.sigmoid(params.opacity[:, 0])
    g_opacity = (g_opacity * op * (1.0 - op))[:, None]
    g_rest = torch.zeros_like(params.features_rest)
    g_rest[:, :n_coef - 1] = g_feats[:, 1:]
    grads = (g_xyz, g_feats[:, :1], g_rest, g_scaling, g_rotation, g_opacity)
    return type(params)(*(torch.where(reached.view(-1, *[1] * (x.dim() - 1)), x,
                                      torch.zeros_like(x)) for x in grads))


class PointFront(torch.autograd.Function):
    """The point front end with a gradient: ``project_points_fused`` forward,
    ``project_points_backward_fused`` backward. Saves the leaves, the
    forward's ``valid`` and the camera; radius, valid and power_cut take no
    gradient."""

    @staticmethod
    def forward(ctx, alive, cam, geometry, kind, *leaves):
        out = project_points_fused(kind(*leaves), alive, cam, *geometry)
        ctx.save_for_backward(*leaves, out.valid)
        ctx.cam, ctx.geometry, ctx.kind = cam, geometry, kind
        ctx.mark_non_differentiable(out.radius, out.valid, out.power_cut)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_xy, g_depth, g_conic, g_radius, g_color, g_opacity, g_valid,
                 g_power_cut):
        *leaves, valid = ctx.saved_tensors
        grads = project_points_backward_fused(ctx.kind(*leaves), valid, ctx.cam,
                                              *ctx.geometry[:5], g_xy, g_depth, g_conic,
                                              g_color, g_opacity)
        return (None, None, None, None,
                *(g if need else None for g, need in zip(grads, ctx.needs_input_grad[4:])))


def project_points_autograd(params: PointGaussianParams, alive: torch.Tensor, cam,
                            width: int, height: int, tanfovx: float, tanfovy: float,
                            sh_degree: int,
                            max_radius: float | None = None) -> ProjectedGaussians:
    """``project_points_fused``'s outputs, differentiable in ``params``
    through ``PointFront``: two launches an iteration, the forward kernel now
    and the backward kernel when autograd reaches it."""
    geometry = (width, height, tanfovx, tanfovy, sh_degree, max_radius)
    return ProjectedGaussians(*PointFront.apply(alive, cam, geometry, type(params),
                                                *params))

