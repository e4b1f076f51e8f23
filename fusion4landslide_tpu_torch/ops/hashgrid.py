"""Grid-bucketed spatial nearest-neighbour search (radius-bounded).

Port of ``fusion4landslide_tpu.ops.hashgrid``: reference points are binned
into cells of edge >= radius and sorted by linearised cell id; a dense
``starts`` table (exclusive prefix sum of cell counts over ``_MAX_CELLS``)
gives each cell's run. The join itself is the grid-window kernel
(:mod:`ops.hashgrid_cuda`), the path the JAX package takes on a TPU.

The radius-growing loops (``knn_grid_traced``, ``median_nn_distance_traced``)
are Python ``while`` loops over tensors; each attempt's control value is
read back once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops.hashgrid_cuda import hash_grid_knn_window
from fusion4landslide_tpu_torch.ops.segments import bucket_size

__all__ = [
    "HashGrid",
    "build_hash_grid",
    "hash_grid_knn",
    "knn_grid_traced",
    "median_nn_distance_traced",
]

#: Static bound on the dense cell table (int32 entries).
_MAX_CELLS = 1 << 21


class HashGrid(NamedTuple):
    points: torch.Tensor  # (m, 3) reference points sorted by cell id
    index: torch.Tensor  # (m,) int32 original indices, same order
    starts: torch.Tensor  # (max_cells + 1,) int32 exclusive-prefix starts
    dims: torch.Tensor  # (3,) int32 grid dimensions
    cell: torch.Tensor  # () effective cell edge (>= requested)
    origin: torch.Tensor  # (3,)
    m_valid: torch.Tensor  # () number of valid reference points


def build_hash_grid(ref: torch.Tensor, cell, ref_mask=None, *,
                    max_cells: int = _MAX_CELLS) -> HashGrid:
    """Bin reference points into a dense-start uniform grid. The
    reference count is padded to ``bucket_size`` (padded rows masked into
    the dump cell ``max_cells - 1``, which sorts after every valid point);
    the cell edge grows x1.5 until the grid fits the table."""
    m = ref.shape[0]
    dev, dtype = ref.device, ref.dtype
    cell = torch.as_tensor(cell, dtype=dtype, device=dev)
    mask = (
        torch.ones((m,), dtype=torch.bool, device=dev)
        if ref_mask is None
        else ref_mask.to(torch.bool)
    )
    mb = bucket_size(m)
    if mb != m:
        ref = torch.cat([ref, torch.zeros((mb - m, 3), dtype=dtype, device=dev)])
        mask = torch.cat([mask, torch.zeros((mb - m,), dtype=torch.bool, device=dev)])
        m = mb
    big = torch.tensor(3e38, dtype=dtype, device=dev)
    pts = torch.where(mask[:, None], ref, big)
    origin = pts.min(dim=0).values
    extent = torch.where(mask[:, None], ref, -big).max(dim=0).values - origin
    extent = torch.clamp(extent, min=0.0)
    # The growth loop runs on host copies: same float32 arithmetic, one
    # read-back instead of one per step.
    ext_h, c_h = extent.cpu(), cell.cpu()
    target = torch.tensor(float(max_cells - 1), dtype=dtype)
    while True:
        dims_f = torch.floor(ext_h / c_h) + 1.0
        if not bool(dims_f[0] * dims_f[1] * dims_f[2] > target):
            break
        c_h = c_h * 1.5
    cell_eff = c_h.to(dev)
    dims = (torch.floor(extent / cell_eff) + 1).to(torch.int32)
    cells = torch.floor((pts - origin) / cell_eff).to(torch.int32)
    cells = torch.clamp(cells, torch.zeros_like(dims), dims - 1)
    linear = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    linear = torch.where(mask, linear, max_cells - 1)
    order = torch.sort(linear, stable=True).indices
    counts = torch.bincount(linear.long(), minlength=max_cells)
    starts = torch.cat(
        [torch.zeros((1,), dtype=torch.int64, device=dev), torch.cumsum(counts, 0)]
    ).to(torch.int32)
    return HashGrid(
        points=ref[order],
        index=order.to(torch.int32),
        starts=starts,
        dims=dims,
        cell=cell_eff,
        origin=origin,
        m_valid=mask.sum().to(torch.int32),
    )


def hash_grid_knn(query, grid: HashGrid, radius, k: int = 1, *,
                  exclude_self: bool = False):
    """k nearest reference points within ``radius`` (grid.cell >= radius).

    The query count is padded to ``bucket_size`` (padded queries ride
    along in the kernel's blocks and are sliced off). Blocks whose window
    overflowed are truncated, as under the JAX package's traced callers.

    Returns ((n, k) squared distances, +inf past radius; (n, k) original
    indices, 0 where invalid; () overflow count).
    """
    if k > 32:
        raise NotImplementedError("grid kNN kernel takes k <= 32")
    n = query.shape[0]
    nb = bucket_size(n)
    qp = query
    if nb != n:
        qp = torch.cat([query, query.new_zeros((nb - n, 3))])
    d, i, ov = hash_grid_knn_window(qp, grid, radius, k, exclude_self=exclude_self)
    return d[:n], i[:n], ov


def _masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    s = torch.sort(torch.where(valid, vals, torch.inf)).values
    cnt = valid.sum()
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=0)
    return 0.5 * (s[lo] + s[hi])


def _density_radius(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Initial search radius 4*sqrt(area/n) from the horizontal bounding
    box of the valid points."""
    big = torch.tensor(3e38, dtype=points.dtype, device=points.device)
    lo = torch.where(valid[:, None], points, big).min(dim=0).values
    hi = torch.where(valid[:, None], points, -big).max(dim=0).values
    ext = torch.clamp(hi - lo, min=0.0)
    area = torch.clamp(ext[0], min=1e-9) * torch.clamp(ext[1], min=1e-9)
    cnt = torch.clamp(valid.sum(), min=1)
    return 4.0 * torch.sqrt(area / cnt)


def knn_grid_traced(query, ref, k: int, r0=None, ref_mask=None,
                    query_mask=None, *, r_max=None, exclude_self: bool = False,
                    max_doublings: int = 8):
    """Radius-growing grid kNN: doubles the radius from ``r0`` (default:
    the bounding-box density estimate) until every unmasked query has k
    in-radius neighbours, the radius exceeds ``r_max``, or
    ``max_doublings`` attempts ran. Queries finished in an earlier attempt
    keep that attempt's result.

    Returns (sqdist (n, k), idx (n, k), () window overflow count summed
    over the attempts); unfound slots are +inf / 0.
    """
    n = query.shape[0]
    dev, dtype = query.device, query.dtype
    qv = (
        torch.ones((n,), dtype=torch.bool, device=dev)
        if query_mask is None
        else query_mask.to(torch.bool)
    )
    rv = (
        torch.ones((ref.shape[0],), dtype=torch.bool, device=dev)
        if ref_mask is None
        else ref_mask.to(torch.bool)
    )
    if r0 is None:
        r0 = _density_radius(ref, rv)
    radius = torch.as_tensor(r0, dtype=dtype, device=dev)
    rmax = torch.as_tensor(
        torch.inf if r_max is None else r_max, dtype=dtype, device=dev
    )
    radius = torch.minimum(radius, rmax)
    best_d = torch.full((n, k), torch.inf, dtype=dtype, device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_doublings:
        unfinished = qv & ~torch.isfinite(best_d[:, k - 1])
        if not bool(unfinished.any() & (radius <= rmax)):
            break
        grid = build_hash_grid(ref, radius, rv)
        d, i, ov = hash_grid_knn(query, grid, radius, k, exclude_self=exclude_self)
        done = torch.isfinite(best_d[:, k - 1])
        best_d = torch.where(done[:, None], best_d, d)
        best_i = torch.where(done[:, None], best_i, i)
        overflow = overflow + ov
        radius = radius * 2.0
        it += 1
    return best_d, best_i, overflow


def median_nn_distance_traced(points, mask=None, *, max_doublings: int = 8):
    """Median nearest-other-point distance: the radius doubles until over
    half the valid points found an in-radius neighbour; every distance
    below the median has then been found exactly. Returns (median, ()
    window overflow count summed over the attempts)."""
    n = points.shape[0]
    dev, dtype = points.device, points.dtype
    valid = (
        torch.ones((n,), dtype=torch.bool, device=dev)
        if mask is None
        else mask.to(torch.bool)
    )
    cnt = int(torch.clamp(valid.sum(), min=1))
    radius = _density_radius(points, valid)
    med = torch.tensor(torch.inf, dtype=dtype, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    found, it = 0, 0
    while 2 * found <= cnt and it < max_doublings:
        grid = build_hash_grid(points, radius, valid)
        d, _, ov = hash_grid_knn(points, grid, radius, 1, exclude_self=True)
        dd = torch.sqrt(d[:, 0])
        ok = valid & torch.isfinite(dd)
        med = _masked_median(dd, ok)
        overflow = overflow + ov
        found = int(ok.sum())
        radius = radius * 2.0
        it += 1
    return med, overflow
