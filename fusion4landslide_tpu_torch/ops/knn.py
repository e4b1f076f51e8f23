"""Brute-force k-nearest-neighbour search.

Port of ``fusion4landslide_tpu.ops.knn``. ``knn`` dispatches as the JAX
package does on an accelerator: feature-space inputs (D > 8, k <= 128) go
to kernel 3 (``ops.knn_cuda.knn_feature``: the CUDA kernel on the card,
its plain version on the CPU), which selects on the Pallas kernel's raw
score; everything else (the 3-d supervoxel graph for n <= 8192, the
per-pair ICP correspondence search) takes the exact XLA path
(``_knn_xla``, ``pairwise_sqdist``), ported as plain PyTorch.
``median_nn_distance`` is the host tiles' point-cloud resolution: the
grid loop above 4096 points, brute force below.
"""

from __future__ import annotations

import numpy as np
import torch

from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, hash_grid_knn
from fusion4landslide_tpu_torch.ops.hashgrid_cuda import xla_sqnorm
from fusion4landslide_tpu_torch.ops.knn_cuda import MAX_K, knn_feature
from fusion4landslide_tpu_torch.ops.segments import bucket_size

__all__ = ["pairwise_sqdist", "knn", "nn1", "nn1_xla_rounded", "median_nn_distance"]

_DIFF_DIM_MAX = 8
_QUERY_BLOCK = 4096  # query rows per distance slab, at most
_SLAB_ELEMS = 1 << 26  # distances per slab, at most (256 MB in float32)


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
    lower reference index, as ``lax.top_k`` resolves them. D > 8 and
    k <= 128: kernel 3 on (n, D) / (m, D) inputs. Otherwise leading batch
    dimensions of ``query``/``ref`` are supported for ``exclude_self``
    False."""
    if query.shape[-1] > _DIFF_DIM_MAX and k <= MAX_K:
        return knn_feature(query, ref, k, ref_mask, exclude_self=exclude_self)
    n, m = query.shape[-2], ref.shape[-2]
    dev = query.device
    mask = (
        torch.ones(ref.shape[:-1], dtype=torch.bool, device=dev)
        if ref_mask is None
        else ref_mask.to(torch.bool)
    )
    kk = min(k, m)
    outs_d, outs_i = [], []
    block = max(1, min(_QUERY_BLOCK, _SLAB_ELEMS // max(m, 1)))
    for s in range(0, max(n, 1), block):
        q = query[..., s:s + block, :]
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


def nn1(query, ref, ref_mask=None, **kw):
    """1-NN: ((n,) squared distances, (n,) indices)."""
    d, i = knn(query, ref, 1, ref_mask, **kw)
    return d[:, 0], i[:, 0]


def nn1_xla_rounded(query, ref, ref_mask=None, *, exclude_self: bool = False):
    """``nn1`` on 2-d or 3-d points with the selected squared distance
    recomputed in the rounding of the JAX package's CPU build
    (``xla_sqnorm``), so thresholds and medians over it agree with the JAX
    function's bit for bit (one ulp can move a point across a voxel
    boundary or a pixel threshold)."""
    sqd, idx = nn1(query, ref, ref_mask, exclude_self=exclude_self)
    sq = xla_sqnorm(query - ref[idx.long()])
    return torch.where(torch.isfinite(sqd), sq, sqd), idx


def _median_of_first(d_sorted: torch.Tensor, cnt) -> torch.Tensor:
    """Median of the first ``cnt`` entries of an ascending vector."""
    lo = max((int(cnt) - 1) // 2, 0)
    hi = max(int(cnt) // 2, 0)
    return 0.5 * (d_sorted[lo] + d_sorted[hi])


def median_nn_distance(points, mask=None):
    """Median distance to the closest *other* point (reference
    src/f2s3.py:481-507). Above 4096 points the radius-bounded grid
    search: the radius starts at 4 sqrt(area / n) of the bounding box and
    doubles until over half the points have an in-radius neighbour, when
    the median is exact. Brute force below (or if 8 doublings fail)."""
    n = points.shape[0]
    dev = points.device
    if n > 4096:
        valid = (
            torch.ones((n,), dtype=torch.bool, device=dev)
            if mask is None
            else mask.to(torch.bool)
        )
        lo = torch.where(valid[:, None], points, torch.inf).min(dim=0).values
        hi = torch.where(valid[:, None], points, -torch.inf).max(dim=0).values
        ext = (hi - lo).cpu().numpy()
        cnt = int(valid.sum())
        area = float(max(ext[0], 1e-9) * max(ext[1], 1e-9))
        radius = 4.0 * float(np.sqrt(area / max(cnt, 1)))
        nb = bucket_size(n)
        pts_b = torch.cat([points, points.new_zeros((nb - n, 3))])
        valid_b = torch.cat([valid, valid.new_zeros((nb - n,))])
        for _ in range(8):
            r = torch.tensor(radius, dtype=points.dtype, device=dev)
            grid = build_hash_grid(pts_b, r, valid_b)
            sqd, _, _ = hash_grid_knn(pts_b, grid, r, 1, exclude_self=True)
            d = torch.sqrt(sqd[:, 0])
            found = valid_b & torch.isfinite(d)
            med = _median_of_first(torch.sort(torch.where(found, d, torch.inf)).values, cnt)
            if 2 * int(found.sum()) > cnt:
                return med
            radius *= 2.0
    # The median feeds the voxel grid, where one ulp can move a point
    # across a cell boundary.
    sqd, _ = nn1_xla_rounded(points, points, mask, exclude_self=True)
    d = torch.sqrt(sqd)
    if mask is None:
        return _median_of_first(torch.sort(d).values, n)
    valid = mask.to(torch.bool) & torch.isfinite(d)
    return _median_of_first(torch.sort(torch.where(valid, d, torch.inf)).values, valid.sum())
