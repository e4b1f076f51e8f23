"""Brute-force k-nearest-neighbour search.

Port of ``fusion4landslide_tpu.ops.knn``. ``knn`` dispatches as the JAX
package does on an accelerator: feature-space inputs (D > 8, k <= 128) go
to kernel 3 (``ops.knn_cuda.knn_feature``: the CUDA kernel on the card,
its plain version on the CPU), which selects on the Pallas kernel's raw
score; everything else (the 3-d supervoxel graph for n <= 8192, the
per-pair ICP correspondence search) takes the exact XLA path
(``_knn_xla``, ``pairwise_sqdist``), ported as plain PyTorch.
For k > 1 on 2-d or 3-d points (the superpoint features' 30-NN of a
whole tile cloud, the ICP variants' normals) the search scans the
references in chunks of 4096 with a running top-k merge, as
``_knn_xla`` does: distances in the JAX CPU build's rounding
(``xla_sqnorm``), candidates ordered by an exact (distance, index) key so
ties go to the lower reference index, as ``lax.top_k`` breaks them. Above
``_LOCAL_PAIRS`` query-reference pairs the queries go in spatially sorted
blocks, each against the references in its bounding box grown until every
row's k-th distance lies inside it: the same distances and keys over a
candidate set that provably holds every row's k nearest, so the answer is
the brute-force one.
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

__all__ = ["pairwise_sqdist", "knn", "nn1", "nn1_xla_rounded", "median_nn_distance",
           "radius_neighbors"]

_DIFF_DIM_MAX = 8
_QUERY_BLOCK = 4096  # query rows per distance slab, at most
_SLAB_ELEMS = 1 << 26  # distances per slab, at most (256 MB in float32)
_REF_CHUNK = 4096  # reference rows per merge step of the k > 1 search
_LOCAL_PAIRS = 1 << 28  # k > 1 searches above this many pairs go block-local
_LOCAL_BLOCK = 8192  # query rows per block of the block-local search
_PROBE_ROWS = 256  # queries whose k-th distance sets the block-local radius


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
    dimensions of ``query``/``ref`` are supported."""
    if query.shape[-1] > _DIFF_DIM_MAX and k <= MAX_K:
        return knn_feature(query, ref, k, ref_mask, exclude_self=exclude_self)
    m = ref.shape[-2]
    mask = (
        torch.ones(ref.shape[:-1], dtype=torch.bool, device=query.device)
        if ref_mask is None
        else ref_mask.to(torch.bool)
    )
    if k > 1:
        if query.dim() == 2 and query.shape[0] * m > _LOCAL_PAIRS:
            return _knn_local(query, ref, k, mask, exclude_self)
        return _knn_topk_merge(query, ref, k, mask, exclude_self)
    block = max(1, min(_QUERY_BLOCK, _SLAB_ELEMS // max(m, 1)))
    outs_d, outs_i = [], []
    for s in range(0, max(query.shape[-2], 1), block):
        q = query[..., s:s + block, :]
        dist = torch.where(_bad(mask, s, q.shape[-2], 0, m, exclude_self),
                           torch.inf, pairwise_sqdist(q, ref))
        best_i = dist.argmin(dim=-1, keepdim=True)
        outs_d.append(torch.gather(dist, -1, best_i))
        outs_i.append(best_i)
    best_d = torch.cat(outs_d, dim=-2)
    best_i = torch.where(torch.isfinite(best_d), torch.cat(outs_i, dim=-2), 0)
    return best_d, best_i.to(torch.int32)


def _bad(mask, r0: int, nr: int, c0: int, nc: int, exclude_self: bool):
    """(..., nr, nc) excluded candidates: masked references, and with
    ``exclude_self`` the query's own row."""
    bad = ~mask[..., None, c0:c0 + nc]
    if exclude_self:
        dev = mask.device
        rows = torch.arange(r0, r0 + nr, device=dev)
        bad = bad | (rows[:, None] == torch.arange(c0, c0 + nc, device=dev)[None, :])
    return bad


_INF_KEY = 0x7F800000 << 32  # the key of (+inf, index 0)


def _topk_keys(q, r, k: int, bad_fn, r_cols):
    """(..., nq, k) smallest int64 keys (float32 bits of the squared
    distance << 32) | reference index, over ``r`` in chunks with a running
    merge. The key order equals (distance, index) order for distances >= 0,
    so ``torch.topk`` selects exactly what ``lax.top_k`` does and no two
    keys tie. ``bad_fn(c0, nc)`` masks candidates; ``r_cols`` (m,) are the
    references' indices in the caller's numbering."""
    lead = torch.broadcast_shapes(q.shape[:-2], r.shape[:-2])
    m, d = r.shape[-2], q.shape[-1]
    chunk = max(1, min(_REF_CHUNK, m))
    best = torch.tensor(_INF_KEY, dtype=torch.int64, device=q.device).expand(
        *lead, q.shape[-2], k)
    for c0 in range(0, m, chunk):
        rc = r[..., c0:c0 + chunk, :]
        diff = q[..., :, None, :] - rc[..., None, :, :]
        dist = xla_sqnorm(diff) if d in (2, 3) else (diff * diff).sum(-1)
        dist = torch.where(bad_fn(c0, rc.shape[-2]), torch.inf, dist)
        key = (dist.view(torch.int32).to(torch.int64) << 32) | r_cols[c0:c0 + chunk]
        best = torch.topk(torch.cat([best, key], dim=-1), k, dim=-1, largest=False).values
    return best


def _decode(best):
    best_d = (best >> 32).to(torch.int32).view(torch.float32)
    best_i = torch.where(torch.isfinite(best_d), best & 0xFFFFFFFF, 0)
    return best_d, best_i.to(torch.int32)


def _knn_topk_merge(query, ref, k: int, mask, exclude_self: bool):
    """``_knn_xla``'s chunked search with a running top-k merge
    (``_topk_keys``) over every reference."""
    n, m = query.shape[-2], ref.shape[-2]
    dev = query.device
    lead = torch.broadcast_shapes(query.shape[:-2], ref.shape[:-2], mask.shape[:-1])
    chunk = max(1, min(_REF_CHUNK, m))
    block = max(1, min(n, _SLAB_ELEMS // (chunk * max(lead.numel(), 1))))
    cols = torch.arange(m, device=dev)
    outs = []
    for s in range(0, max(n, 1), block):
        q = query[..., s:s + block, :]
        outs.append(_topk_keys(
            q, ref, k, lambda c0, nc: _bad(mask, s, q.shape[-2], c0, nc, exclude_self), cols))
    return _decode(torch.cat(outs, dim=-2))


def _knn_local(query, ref, k: int, mask, exclude_self: bool):
    """The k > 1 search in spatially compact query blocks (2-d inputs).
    Queries are ordered along a serpentine path through a grid of cells
    holding ~``_LOCAL_BLOCK`` points each; a block's candidates are the
    valid references in its bounding box grown by r (1.25x the 90th
    percentile of the k-th distance of a sample of queries) plus a
    rounding margin. A reference outside the box lies more
    than r away on some axis, so wherever a row's k-th squared distance is
    below r^2 its k nearest are all candidates and its keys are the
    brute-force ones; the other rows retry with 2r, and once r spans the
    cloud with every reference."""
    n, m = query.shape[0], ref.shape[0]
    dev = query.device
    both = torch.cat([query, ref[mask]])
    lo, hi = both.min(0).values, both.max(0).values
    ext = torch.clamp(hi - lo, min=1e-6)
    dims = ext.numel()
    slack = 4.0 * float(torch.finfo(torch.float32).eps) * float(both.abs().max())
    side = float((ext.prod() * _LOCAL_BLOCK / max(n, 1)) ** (1.0 / dims))
    ncell = (torch.floor(ext / side).to(torch.int64) + 1).tolist()
    cell = torch.clamp(torch.floor((query - lo) / side).to(torch.int64), min=0)
    lin = cell[:, 0]
    for a in range(1, dims):
        # Serpentine: odd rows of the cells so far run this axis backwards.
        c = torch.where(lin % 2 == 1, ncell[a] - 1 - cell[:, a], cell[:, a])
        lin = lin * ncell[a] + c
    order = torch.sort(lin, stable=True).indices
    # r0: 1.25x the 90th percentile of the k-th distance over a sample of
    # queries against every reference.
    cand = torch.nonzero(mask).squeeze(1)
    probe = torch.linspace(0, n - 1, min(n, _PROBE_ROWS), device=dev).long()
    best = _topk_keys(query[probe], ref[cand], k,
                      lambda c0, nc: (probe[:, None] == cand[None, c0:c0 + nc]) & exclude_self,
                      cand)
    kth = (best[:, -1] >> 32).to(torch.int32).view(torch.float32)
    kth = kth[torch.isfinite(kth)]
    span = float(ext.max())
    r0 = 1.25 * float(torch.sqrt(torch.quantile(kth, 0.9))) if kth.numel() else span
    r0 = max(r0, 1e-6 * span)
    out = torch.empty((n, k), dtype=torch.int64, device=dev)
    for s in range(0, n, _LOCAL_BLOCK):
        todo, r = order[s:s + _LOCAL_BLOCK], r0
        while todo.numel():
            q = query[todo]
            if r > span:
                cand = torch.nonzero(mask).squeeze(1)
            else:
                pad = 1.01 * r + slack
                box = (ref >= q.min(0).values - pad) & (ref <= q.max(0).values + pad)
                cand = torch.nonzero(mask & box.all(1)).squeeze(1)

            def bad(c0, nc, todo=todo, cand=cand):
                if not exclude_self:
                    return torch.zeros((1, nc), dtype=torch.bool, device=dev)
                return todo[:, None] == cand[None, c0:c0 + nc]

            best = _topk_keys(q, ref[cand], k, bad, cand)
            if r > span:
                out[todo] = best
                break
            kth = (best[:, -1] >> 32).to(torch.int32).view(torch.float32)
            done = kth < r * r
            out[todo[done]] = best[done]
            todo, r = todo[~done], 2.0 * r
    return _decode(out)


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


def radius_neighbors(query, ref, radius, k_max: int, ref_mask=None, **kw):
    """Up to ``k_max`` nearest neighbours within ``radius`` (the k_max
    nearest in-radius references are kept): (idx (n, k_max), valid
    (n, k_max) in radius and not padding, dist (n, k_max) Euclidean, inf
    where invalid). ``kw`` goes to ``knn`` (``exclude_self``)."""
    sqd, idx = knn(query, ref, k_max, ref_mask, **kw)
    dist = torch.sqrt(sqd)
    valid = torch.isfinite(dist) & (dist <= torch.as_tensor(radius, dtype=dist.dtype,
                                                            device=dist.device))
    return idx, valid, torch.where(valid, dist, torch.inf)
