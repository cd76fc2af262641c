"""Stable bucket ranks for small-integer keys; counterpart of
``cloth_splatting_tpu/ops/sort.py``.

The JAX package builds its stable counting sort from histograms and
within-chunk equality ranks because the TPU's sort is a deep bitonic
network; the result is the permutation of a stable sort of the keys, which
a stable ``torch.sort`` gives directly. ``quantize_depth`` computes the JAX
package's bucket ids bit for bit (same fp32 expression, same order): a
one-bucket flip reorders two Gaussians and moves pixels.
"""

from __future__ import annotations

import torch


def counting_rank(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Stable sorted positions of int keys in [0, n_buckets): element i
    belongs at ``positions[i]`` of the stable bucket-sorted order; equal keys
    keep their original order. ``n_buckets`` is the key range, as in the
    JAX package (whose counting sort sizes its histograms with it)."""
    order = torch.sort(keys, stable=True).indices
    pos = torch.empty_like(order, dtype=torch.int32)
    pos[order] = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return pos


def rank_permutation(values_bucketed: torch.Tensor, n_buckets: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank, inverse): ``rank[i]`` is i's position in sorted order,
    ``inverse[p]`` the element at position p."""
    rank = counting_rank(values_bucketed, n_buckets)
    inverse = torch.empty_like(rank)
    inverse[rank.long()] = torch.arange(rank.shape[0], dtype=torch.int32,
                                        device=rank.device)
    return rank, inverse


def quantize_depth(depth: torch.Tensor, valid: torch.Tensor,
                   n_buckets: int) -> torch.Tensor:
    """Positive depths quantized into [0, n_buckets - 1); invalid entries get
    the last (sentinel) bucket, so they land after every valid one."""
    inf = torch.full_like(depth, float("inf"))
    dmin = torch.where(valid, depth, inf).min()
    dmax = torch.where(valid, depth, -inf).max()
    span = torch.clamp_min(dmax - dmin, 1e-9)
    q = torch.floor((depth - dmin) / span * (n_buckets - 2))
    q = torch.where(valid, q, torch.zeros_like(q))    # no cast of an inf
    bucket = torch.clamp(q.to(torch.int32), 0, n_buckets - 2)
    return torch.where(valid, bucket, torch.full_like(bucket, n_buckets - 1))
