"""WXYZ quaternion / rotation utilities; counterpart of
``cloth_splatting_tpu/ops/quaternion.py``.

Gaussian rotations are stored WXYZ. Mesh-deformation rotations compose as
``R_total = R_rel @ R_static`` (the relative rotation is applied after the
static one)."""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions [..., 4] to unit length.

    rsqrt(sumsq + eps) keeps the gradient finite for zero (dead-slot)
    quaternions, where 1/max(norm, eps) would not."""
    ss = (q * q).sum(dim=-1, keepdim=True)
    return q * torch.rsqrt(ss + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """WXYZ quaternion [..., 4] -> rotation matrix [..., 3, 3] (normalizes first)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(m: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> WXYZ unit quaternion [..., 4].

    Branch-free: computes the four standard constructions and selects the
    one with the largest denominator."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, eps))

    sw = safe_sqrt(1.0 + tr)  # = 2w
    qw = torch.stack([0.5 * sw, (m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                      (m10 - m01) / (2 * sw)], -1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22)  # = 2x
    qx = torch.stack([(m21 - m12) / (2 * sx), 0.5 * sx, (m01 + m10) / (2 * sx),
                      (m02 + m20) / (2 * sx)], -1)
    sy = safe_sqrt(1.0 - m00 + m11 - m22)  # = 2y
    qy = torch.stack([(m02 - m20) / (2 * sy), (m01 + m10) / (2 * sy), 0.5 * sy,
                      (m12 + m21) / (2 * sy)], -1)
    sz = safe_sqrt(1.0 - m00 - m11 + m22)  # = 2z
    qz = torch.stack([(m10 - m01) / (2 * sz), (m02 + m20) / (2 * sz),
                      (m12 + m21) / (2 * sz), 0.5 * sz], -1)

    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, qw,
                    torch.where(cond_x, qx, torch.where(cond_y, qy, qz)))
    return quat_normalize(q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of WXYZ quaternions (rotation b applied first)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse (= conjugate) of a unit WXYZ quaternion."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis [..., 3] and angle [...] -> WXYZ quaternion [..., 4]."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
                     dim=-1)


def rotation_between_normals(na: torch.Tensor, nb: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """The smallest rotation taking each unit normal ``na`` [..., 3] to
    ``nb``, as a WXYZ quaternion; parallel normals (no axis) give the
    identity."""
    cross = torch.linalg.cross(na, nb)
    dot = (na * nb).sum(dim=-1)
    angle = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    norm = torch.linalg.norm(cross, dim=-1, keepdim=True)
    q = axis_angle_to_quat(cross / torch.clamp_min(norm, eps), angle)
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    return torch.where(norm > eps, q, ident)


def kabsch_rotation(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The least-squares rotation R [..., 3, 3] with
    ``dst ~ (src - mean(src)) @ R^T + mean(dst)`` for point sets
    [..., P, 3], from the SVD of their 3x3 cross-covariance. The reflection
    guard flips the last singular direction by det(V U^T), so R is a proper
    rotation."""
    src_c = src - src.mean(dim=-2, keepdim=True)
    dst_c = dst - dst.mean(dim=-2, keepdim=True)
    h = torch.einsum("...pi,...pj->...ij", src_c, dst_c)
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    flip = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return torch.einsum("...ji,...j,...jk->...ik", vt, flip, ut)
