"""Small-matrix algebra over [N]-batched 2x2 / 3x3 / 4x4 matrices;
counterpart of ``cloth_splatting_tpu/ops/smallmat.py``.

The JAX package expands these products into scalar component arithmetic
because XLA lowers batched tiny matmuls badly on a TPU. On the GPU that
reason is gone, but the expansions are kept: they are as cheap as a batched
``matmul`` here (all elementwise, memory-bound) and they sum in the same
order as the JAX package, which keeps derived integers such as the
``ceil``-ed screen radius identical between the two packages.

Batched matrices are [N, r, c]; a ``_shared`` operand is one unbatched matrix.
"""

from __future__ import annotations

import torch


def bmm33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,3,3] @ [N,3,3]."""
    rows = []
    for i in range(3):
        cols = [a[:, i, 0] * b[:, 0, j] + a[:, i, 1] * b[:, 1, j]
                + a[:, i, 2] * b[:, 2, j] for j in range(3)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def bmm33_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,3,3] @ [N,3,3]^T."""
    rows = []
    for i in range(3):
        cols = [a[:, i, 0] * b[:, j, 0] + a[:, i, 1] * b[:, j, 1]
                + a[:, i, 2] * b[:, j, 2] for j in range(3)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def bmv3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N,3,3] @ [N,3] -> [N,3]."""
    return torch.stack([m[:, i, 0] * v[:, 0] + m[:, i, 1] * v[:, 1]
                        + m[:, i, 2] * v[:, 2] for i in range(3)], dim=-1)


def affine4_shared(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-vector transform [N,3] -> [N,4]: [p, 1] @ M with one shared [4,4]."""
    cols = [points[:, 0] * m[0, j] + points[:, 1] * m[1, j]
            + points[:, 2] * m[2, j] + m[3, j] for j in range(4)]
    return torch.stack(cols, dim=-1)


def sym33_from_rs(r: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Covariance R diag(s^2) R^T packed as [N,6] (xx, xy, xz, yy, yz, zz).

    Args:
        r: [N, 3, 3] rotations; s2: [N, 3] squared scales.
    """
    out = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        out.append(s2[:, 0] * r[:, i, 0] * r[:, j, 0]
                   + s2[:, 1] * r[:, i, 1] * r[:, j, 1]
                   + s2[:, 2] * r[:, i, 2] * r[:, j, 2])
    return torch.stack(out, dim=-1)


def sym33_quadform2(a_rows: tuple, sym: torch.Tensor):
    """(c00, c01, c11) of A S A^T for A [N,2,3] given as two row tuples and a
    packed symmetric S [N,6]."""
    s00, s01, s02, s11, s12, s22 = sym.unbind(-1)

    def s_dot(q0, q1, q2):
        return (s00 * q0 + s01 * q1 + s02 * q2,
                s01 * q0 + s11 * q1 + s12 * q2,
                s02 * q0 + s12 * q1 + s22 * q2)

    (a0, a1, a2), (b0, b1, b2) = a_rows
    t0, t1, t2 = s_dot(a0, a1, a2)
    c00 = a0 * t0 + a1 * t1 + a2 * t2
    c01 = b0 * t0 + b1 * t1 + b2 * t2
    u0, u1, u2 = s_dot(b0, b1, b2)
    c11 = b0 * u0 + b1 * u1 + b2 * u2
    return c00, c01, c11
