"""Nearest-neighbour distances for Gaussian scale init; counterpart of
``cloth_splatting_tpu/ops/knn.py``.

Brute-force chunked pairwise distances in full float32 (the package turns
TF32 off; see its docstring)."""

from __future__ import annotations

import torch


def knn(points: torch.Tensor, k: int = 3, chunk: int = 4096):
    """k nearest neighbours of each point [N, 3], excluding itself.

    Returns (sq_dists [N, k], indices [N, k]) ascending by distance."""
    n = points.shape[0]
    # |q|^2 - 2 q.p + |p|^2 cancels catastrophically for a cloud far from the
    # origin; centring bounds the cross term by the cloud's extent.
    pts = points - points.mean(dim=0, keepdim=True)
    sq_norms = (pts * pts).sum(dim=-1)
    d2s, idxs = [], []
    for start in range(0, n, chunk):
        q = pts[start:start + chunk]
        d2 = (sq_norms[start:start + chunk, None] - 2.0 * (q @ pts.T)
              + sq_norms[None, :])
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + start] = torch.inf
        kk = min(k, n)
        top, idx = torch.topk(d2, kk, dim=1, largest=False)
        if kk < k:   # fewer points than neighbours: pad like the JAX package
            top = torch.cat([top, top.new_full((top.shape[0], k - kk),
                                               torch.inf)], dim=1)
            idx = torch.cat([idx, idx.new_full((idx.shape[0], k - kk), n)],
                            dim=1)
        d2s.append(top)
        idxs.append(idx)
    d2 = torch.cat(d2s)
    return torch.clamp_min(d2, 0.0), torch.cat(idxs)


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Per-point mean squared distance to the k nearest neighbours (the
    3DGS ``distCUDA2`` init at k=3)."""
    d2, _ = knn(points, k=k)
    finite = torch.isfinite(d2)
    d2 = torch.where(finite, d2, torch.zeros_like(d2))
    cnt = torch.clamp_min(finite.sum(dim=-1), 1)
    return d2.sum(dim=-1) / cnt
