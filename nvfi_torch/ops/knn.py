"""Exact K-nearest-neighbour search (port of ``nvfi_tpu/ops/knn.py``).

Brute force over query blocks of ``chunk`` points: the squared distances of a
block to the whole set in JAX's own form, ``|q|^2 - 2 q.p + |p|^2`` (a
``torch.matmul``; ``torch.cdist`` rounds differently and would move
neighbours across the smooth loss's radius test), and the ``k`` smallest
through ``torch.topk``.  TF32 is left off, so the product is float32.

Among equal distances ``torch.topk`` does not promise ``lax.top_k``'s
lower-index-first order, so the indices of tied neighbours (duplicate points
above all) may differ from JAX's; the distances and the neighbour sets
modulo ties do not.
"""

from __future__ import annotations

import torch


def knn(points: torch.Tensor, k: int, chunk: int = 2048):
    """Exact KNN of each point to the whole set, self included.

    Args:
      points: (N, 3).
      k: neighbour count.
    Returns:
      (dists (N, k), idx (N, k) int64): squared distances, ascending.
    """
    sq = torch.sum(points**2, dim=-1)
    dists, idx = [], []
    # JAX pads the last block with zero queries; a query's row does not
    # depend on the others, so the unpadded block gives the same rows
    for start in range(0, points.shape[0], chunk):
        q = points[start:start + chunk]
        d = torch.sum(q**2, dim=-1)[:, None] - (2.0 * q) @ points.T + sq[None, :]
        dv, iv = torch.topk(d, k, dim=-1, largest=False)
        dists.append(dv)
        idx.append(iv)
    return torch.cat(dists), torch.cat(idx)
