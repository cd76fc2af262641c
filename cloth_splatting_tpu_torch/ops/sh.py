"""Real spherical-harmonics evaluation (degrees 0..4); counterpart of
``cloth_splatting_tpu/ops/sh.py`` (PlenOctree constants)."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis [..., (deg+1)**2] at unit directions [..., 3], such that
    ``color = sum_k basis[..., k] * sh[..., k, :]``."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg >= 3:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg >= 4:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def sh_basis_grad(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """The partial derivatives of ``sh_basis`` [..., (deg+1)**2, 3] with
    respect to the direction's (x, y, z), each term's written out."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    zero = torch.zeros_like(x)
    out = [(zero, zero, zero)]
    if deg >= 1:
        out += [(zero, zero - C1, zero), (zero, zero, zero + C1), (zero - C1, zero, zero)]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            (C2[0] * y, C2[0] * x, zero),
            (zero, C2[1] * z, C2[1] * y),
            (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
            (C2[3] * z, zero, C2[3] * x),
            (2.0 * C2[4] * x, -2.0 * C2[4] * y, zero),
        ]
    if deg >= 3:
        out += [
            (6.0 * C3[0] * x * y, C3[0] * (3 * xx - 3 * yy), zero),
            (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y),
            (-2.0 * C3[2] * x * y, C3[2] * (4 * zz - xx - 3 * yy), 8.0 * C3[2] * y * z),
            (-6.0 * C3[3] * x * z, -6.0 * C3[3] * y * z, C3[3] * (6 * zz - 3 * xx - 3 * yy)),
            (C3[4] * (4 * zz - 3 * xx - yy), -2.0 * C3[4] * x * y, 8.0 * C3[4] * x * z),
            (2.0 * C3[5] * x * z, -2.0 * C3[5] * y * z, C3[5] * (xx - yy)),
            (C3[6] * (3 * xx - 3 * yy), -6.0 * C3[6] * x * y, zero),
        ]
    if deg >= 4:
        out += [
            (C4[0] * y * (3 * xx - yy), C4[0] * x * (xx - 3 * yy), zero),
            (6.0 * C4[1] * x * y * z, C4[1] * z * (3 * xx - 3 * yy), C4[1] * y * (3 * xx - yy)),
            (C4[2] * y * (7 * zz - 1), C4[2] * x * (7 * zz - 1), 14.0 * C4[2] * x * y * z),
            (zero, C4[3] * z * (7 * zz - 3), C4[3] * y * (21 * zz - 3)),
            (zero, zero, C4[4] * z * (140 * zz - 60)),
            (C4[5] * z * (7 * zz - 3), zero, C4[5] * x * (21 * zz - 3)),
            (2.0 * C4[6] * x * (7 * zz - 1), -2.0 * C4[6] * y * (7 * zz - 1),
             14.0 * C4[6] * z * (xx - yy)),
            (C4[7] * z * (3 * xx - 3 * yy), -6.0 * C4[7] * x * y * z, C4[7] * x * (xx - 3 * yy)),
            (C4[8] * (4 * x * xx - 12 * x * yy), C4[8] * (4 * y * yy - 12 * xx * y), zero),
        ]
    return torch.stack([torch.stack(d, dim=-1) for d in out], dim=-2)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH values [..., C] from coefficients [..., K, C] (K >= (deg+1)**2; only
    the first (deg+1)**2 are used) at unit directions [..., 3]. Add 0.5 and
    clamp outside for RGB."""
    ncoef = (deg + 1) ** 2
    basis = sh_basis(deg, dirs)
    # summed term by term, in the JAX package's order
    out = basis[..., 0:1] * sh[..., 0, :]
    for k in range(1, ncoef):
        out = out + basis[..., k:k + 1] * sh[..., k, :]
    return out


def rgb_to_sh(rgb):
    """RGB albedo -> DC SH coefficient (tensor or numpy array)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    """DC SH coefficient -> RGB albedo (tensor or numpy array)."""
    return sh * C0 + 0.5
