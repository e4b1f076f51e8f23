"""Brute-force k-nearest-neighbour search (plain PyTorch).

Port of the exact XLA path of ``fusion4landslide_tpu.ops.knn``
(``_knn_xla``, ``pairwise_sqdist``): it serves the small brute-force
supervoxel graph (n <= 8192) and the per-pair ICP correspondence search.
Feature-space kNN through the third Pallas kernel (``knn_pallas``) is not
ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["pairwise_sqdist", "knn"]

_DIFF_DIM_MAX = 8
_QUERY_BLOCK = 4096  # query rows per distance slab


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between rows of a (..., n, d) and
    b (..., m, d): per-coordinate difference form for d <= 8, the matmul
    expansion (clamped at 0) above."""
    if a.shape[-1] <= _DIFF_DIM_MAX:
        out = None
        for d in range(a.shape[-1]):
            diff = a[..., :, None, d] - b[..., None, :, d]
            out = diff * diff if out is None else out + diff * diff
        return out
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)
    ab = a @ b.transpose(-1, -2)
    return torch.clamp(a2 - 2.0 * ab + b2[..., None, :], min=0.0)


def knn(query, ref, k: int, ref_mask=None, *, exclude_self: bool = False):
    """Exact k nearest neighbours ((n, k) squared distances ascending,
    (n, k) indices; masked/missing slots are +inf / 0). Ties go to the
    lower reference index, as ``lax.top_k`` resolves them. Leading batch
    dimensions of ``query``/``ref`` are supported for ``exclude_self``
    False."""
    n, m = query.shape[-2], ref.shape[-2]
    dev = query.device
    mask = (
        torch.ones(ref.shape[:-1], dtype=torch.bool, device=dev)
        if ref_mask is None
        else ref_mask.to(torch.bool)
    )
    kk = min(k, m)
    outs_d, outs_i = [], []
    for s in range(0, max(n, 1), _QUERY_BLOCK):
        q = query[..., s:s + _QUERY_BLOCK, :]
        dist = pairwise_sqdist(q, ref)
        bad = ~mask[..., None, :]
        if exclude_self:
            rows = torch.arange(s, s + q.shape[-2], device=dev)
            bad = bad | (rows[:, None] == torch.arange(m, device=dev)[None, :])
        dist = torch.where(bad, torch.inf, dist)
        if kk == 1:
            best_i = dist.argmin(dim=-1, keepdim=True)
            best_d = torch.gather(dist, -1, best_i)
        else:
            best_d, best_i = torch.sort(dist, dim=-1, stable=True)
            best_d, best_i = best_d[..., :kk], best_i[..., :kk]
        outs_d.append(best_d)
        outs_i.append(best_i)
    best_d = torch.cat(outs_d, dim=-2)
    best_i = torch.cat(outs_i, dim=-2)
    if kk < k:
        fill = best_d.shape[:-1] + (k - kk,)
        best_d = torch.cat([best_d, torch.full(fill, torch.inf, device=dev)], -1)
        best_i = torch.cat([best_i, torch.zeros(fill, dtype=best_i.dtype, device=dev)], -1)
    best_i = torch.where(torch.isfinite(best_d), best_i, 0)
    return best_d, best_i.to(torch.int32)
