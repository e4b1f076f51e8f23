"""Grid-bucketed spatial nearest-neighbour search (radius-bounded).

Port of ``fusion4landslide_tpu.ops.hashgrid``: reference points are binned
into cells of edge >= radius and sorted by linearised cell id; a dense
``starts`` table (exclusive prefix sum of cell counts over ``_MAX_CELLS``)
gives each cell's run. The join itself is the grid-window kernel
(:mod:`ops.hashgrid_cuda`), the path the JAX package takes on a TPU.

The radius-growing loops (``knn_grid_traced``, ``median_nn_distance_traced``)
are Python ``while`` loops over tensors; each attempt's control value is
read back once. They run kernel 2 on a fitted window
(``hashgrid_cuda.fitted_window``), so no query block is truncated: the JAX
package's traced callers keep a truncated window's result (its window is a
static TPU shape), and on tiles whose blocks fit the default 32 768
positions the two are equal. ``nn1_spatial`` is the JAX package's eager
caller: a radius step whose kernel call reports overflow reruns every query
through the exact gather join ``hash_grid_knn_join`` (the JAX
``_hash_grid_knn_xla``).
A search for more than 32 neighbours takes that join too, as JAX's does:
the DIPs 'knn' branch (k = ``feat_k_max``, 512 by default).

``radius_sample_grid`` is the JAX package's traced patch sampler (the DIPs
'random' branch): the same candidate table as the join, hash or distance
priorities, and the ``num_samples`` smallest kept. Both select through a
stable sort, so ties go to the lower candidate position as under
``lax.top_k``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fusion4landslide_tpu_torch.ops.hashgrid_cuda import (
    hash_grid_knn_window,
    hash_priority,
    xla_sqnorm,
)
from fusion4landslide_tpu_torch.ops.segments import bucket_size

__all__ = [
    "HashGrid",
    "build_hash_grid",
    "hash_grid_knn",
    "hash_grid_knn_join",
    "knn_grid_traced",
    "median_nn_distance_traced",
    "nn1_spatial",
    "radius_sample_grid",
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


def hash_grid_knn(query, grid: HashGrid, radius, k: int = 1, *, cap: int = 32,
                  query_block: int = 8192, exclude_self: bool = False,
                  fit_window: bool = False):
    """k nearest reference points within ``radius`` (grid.cell >= radius).

    k <= 32 runs kernel 2: the query count is padded to ``bucket_size``
    (padded queries ride along in the kernel's blocks and are sliced off).
    Blocks whose window overflowed are truncated, as under the JAX
    package's traced callers, unless ``fit_window`` grows the window to
    the largest block's; a caller that must stay exact without it reruns
    through ``hash_grid_knn_join``. k > 32 runs that join with ``cap`` and
    ``query_block``, as the JAX function does.

    Returns ((n, k) squared distances, +inf past radius; (n, k) original
    indices, 0 where invalid; () overflow count: truncated window blocks
    for the kernel, truncated cell runs for the join).
    """
    if k > 32:
        return hash_grid_knn_join(query, grid, radius, k, cap=cap, query_block=query_block,
                                  exclude_self=exclude_self)
    n = query.shape[0]
    nb = bucket_size(n)
    qp = query
    if nb != n:
        qp = torch.cat([query, query.new_zeros((nb - n, 3))])
    d, i, ov = hash_grid_knn_window(qp, grid, radius, k, exclude_self=exclude_self,
                                    fit=fit_window)
    return d[:n], i[:n], ov


def _sorted_query_cells(query, grid: HashGrid, query_block: int):
    """(qorder, (n_pad, 3) int64 cells in that order): queries sorted by
    linear cell id (stable), as the JAX joins sort them, with zero cells
    padding the last block of ``query_block`` rows (the JAX joins' padded
    rows, which the overflow counts include)."""
    dims = grid.dims.long()
    qcell = torch.floor((query - grid.origin) / grid.cell).long()
    qcell = torch.clamp(qcell, torch.zeros_like(dims), dims - 1)
    qorder = torch.sort((qcell[:, 0] * dims[1] + qcell[:, 1]) * dims[2] + qcell[:, 2],
                        stable=True).indices
    n = query.shape[0]
    pad = -(-n // query_block) * query_block - n
    return qorder, torch.cat([qcell[qorder], qcell.new_zeros((pad, 3))])


def _neighbour_runs(qcell, grid: HashGrid, cap: int):
    """For (B, 3) query cells: the table positions of the first ``cap``
    entries of each of the 27 neighbour cells' runs ((B, 27 cap), clamped
    into the table), whether each lies inside its run, and the () count of
    runs longer than ``cap``."""
    dev = qcell.device
    m = grid.points.shape[0]
    r = torch.arange(-1, 2, device=dev)
    offsets = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    dims = grid.dims.long()
    B = qcell.shape[0]
    nc = qcell[:, None, :] + offsets[None]
    in_grid = ((nc >= 0) & (nc < dims)).all(-1)
    ncl = torch.clamp(nc, torch.zeros_like(dims), dims - 1)
    nlin = (ncl[..., 0] * dims[1] + ncl[..., 1]) * dims[2] + ncl[..., 2]
    starts = grid.starts.long()
    start = torch.where(in_grid, starts[nlin], 0)
    end = torch.where(in_grid, starts[nlin + 1], 0)
    overflow = (end - start > cap).sum()
    pos = (start[..., None] + torch.arange(cap, device=dev)).reshape(B, 27 * cap)
    in_run = pos < end[..., None].expand(B, 27, cap).reshape(B, 27 * cap)
    return torch.clamp(pos, 0, m - 1), in_run, overflow


def hash_grid_knn_join(query, grid: HashGrid, radius, k: int = 1, *, cap: int = 32,
                       query_block: int = 8192, exclude_self: bool = False):
    """The exact gather join (JAX ``_hash_grid_knn_xla``): queries sorted
    by cell (stable), in blocks of ``query_block``; each query reads the
    first ``cap`` points of each of its 27 neighbour cells' runs, with no
    window to overflow. Ties go to the lower candidate position. Returns
    ((n, k) squared distances, +inf past radius; (n, k) indices, 0 where
    invalid; () count of neighbour-cell runs longer than ``cap``, over
    the queries and the zero-cell rows that pad the last block, as the JAX
    function counts)."""
    n = query.shape[0]
    dev = query.device
    radius = torch.as_tensor(radius, dtype=query.dtype, device=dev)
    qorder, qc_sorted = _sorted_query_cells(query, grid, query_block)
    d_out = torch.zeros((n, k), dtype=query.dtype, device=dev)
    i_out = torch.zeros((n, k), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(0, n, query_block):
        rows = qorder[s0:s0 + query_block]
        q = query[rows]
        pos_c, valid, ov = _neighbour_runs(qc_sorted[s0:s0 + query_block], grid, cap)
        overflow = overflow + ov
        pos_c, valid = pos_c[:rows.shape[0]], valid[:rows.shape[0]]
        d2 = xla_sqnorm(grid.points[pos_c] - q[:, None, :])
        cand = grid.index[pos_c]
        bad = ~valid | (d2 > radius * radius)
        if exclude_self:
            bad = bad | (cand == rows[:, None].to(torch.int32))
        d2 = torch.where(bad, torch.inf, d2)
        if k == 1:
            sel = d2.argmin(dim=1, keepdim=True)
        else:
            sel = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(d2, 1, sel)
        best_i = torch.where(torch.isfinite(best_d), torch.gather(cand, 1, sel), 0)
        d_out[rows] = best_d
        i_out[rows] = best_i.to(torch.int32)
    return d_out, i_out, overflow.to(torch.int32)


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
                    query_mask=None, *, r_max=None, cap: int = 48, query_block: int = 4096,
                    exclude_self: bool = False, max_doublings: int = 8):
    """Radius-growing grid kNN: doubles the radius from ``r0`` (default:
    the bounding-box density estimate) until every unmasked query has k
    in-radius neighbours, the radius exceeds ``r_max``, or
    ``max_doublings`` attempts ran. Queries finished in an earlier attempt
    keep that attempt's result. ``cap`` and ``query_block`` reach the
    gather join (k > 32) only.

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
        d, i, ov = hash_grid_knn(query, grid, radius, k, cap=cap, query_block=query_block,
                                 exclude_self=exclude_self, fit_window=True)
        todo = ~torch.isfinite(best_d[:, k - 1])
        best_d[todo] = d[todo]
        best_i[todo] = i[todo]
        del d, i
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
        d, _, ov = hash_grid_knn(points, grid, radius, 1, exclude_self=True, fit_window=True)
        dd = torch.sqrt(d[:, 0])
        ok = valid & torch.isfinite(dd)
        med = _masked_median(dd, ok)
        overflow = overflow + ov
        found = int(ok.sum())
        radius = radius * 2.0
        it += 1
    return med, overflow


def radius_sample_grid(query, grid: HashGrid, radius, seed: int, *, num_samples: int = 256,
                       cap: int = 64, query_block: int = 2048, priority: str = "random"):
    """In-radius sample per query (the JAX package's traced sampler,
    ``ops/hashgrid.py::radius_sample_grid``). Each query scores the first
    ``cap`` entries of each of its 27 neighbour cells' runs; a candidate is
    kept when d^2 <= r^2 and d^2 > r^2 1e-6 (the query itself drops out),
    with the priority ``'random'`` (the 24-bit hash of the candidate's
    grid index and ``seed``, as kernel 1's) or ``'distance'`` (d^2); the
    ``num_samples`` smallest priorities are kept, ties to the lower
    candidate position. Queries are sorted by cell (stable) and run in
    blocks of ``query_block``.

    Returns ((n, num_samples, 3) coordinates, 0 where invalid; (n,
    num_samples) valid; () count of neighbour-cell runs longer than
    ``cap``, which were truncated, counted as ``hash_grid_knn_join``
    counts them).
    """
    if priority not in ("random", "distance"):
        raise ValueError(f"priority must be 'random' or 'distance', not {priority!r}")
    n = query.shape[0]
    dev = query.device
    radius = torch.as_tensor(radius, dtype=query.dtype, device=dev)
    r2 = radius * radius
    qorder, qc_sorted = _sorted_query_cells(query, grid, query_block)
    coords = torch.zeros((n, num_samples, 3), dtype=query.dtype, device=dev)
    valid = torch.zeros((n, num_samples), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(0, n, query_block):
        rows = qorder[s0:s0 + query_block]
        pos, in_run, ov = _neighbour_runs(qc_sorted[s0:s0 + query_block], grid, cap)
        overflow = overflow + ov
        pos, in_run = pos[:rows.shape[0]], in_run[:rows.shape[0]]
        pts = grid.points[pos]
        d2 = xla_sqnorm(pts - query[rows][:, None, :])
        pri = d2 if priority == "distance" else hash_priority(grid.index[pos], int(seed))
        keyed = torch.where(in_run & (d2 <= r2) & (d2 > r2 * 1e-6), pri, torch.inf)
        srt = torch.sort(keyed, dim=1, stable=True)
        sel = srt.indices[:, :num_samples]
        ok = torch.isfinite(srt.values[:, :num_samples])
        picked = torch.gather(pts, 1, sel[..., None].expand(-1, -1, 3))
        coords[rows] = torch.where(ok[..., None], picked, 0.0)
        valid[rows] = ok
    return coords, valid, overflow.to(torch.int32)


#: Radius doublings ``nn1_spatial`` tries (a 4096-fold radius).
_NN1_DOUBLINGS = 12


def nn1_spatial(query, ref):
    """Unbounded spatial 1-NN through the grid join with radius growth:
    the radius starts at the bounding-box density 4 sqrt(area / m) and
    doubles until every query found a neighbour. A radius step whose
    kernel call overflowed its window reruns every query through the exact
    gather join, as the JAX package's eager call does. Returns ((n,)
    squared distances, (n,) int32 indices); queries still unmatched after
    ``_NN1_DOUBLINGS`` (an empty reference only) get +inf / 0."""
    n, m = query.shape[0], ref.shape[0]
    dev = query.device
    valid = torch.ones((m,), dtype=torch.bool, device=dev)
    best_d = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    if m == 0:
        return best_d, best_i
    ext = (ref.max(dim=0).values - ref.min(dim=0).values).cpu().numpy()
    area = float(max(ext[0], 1e-9) * max(ext[1], 1e-9))
    radius = 4.0 * float(np.sqrt(area / m))
    for _ in range(_NN1_DOUBLINGS):
        grid = build_hash_grid(ref, radius, valid)
        d, i, ov = hash_grid_knn(query, grid, radius, 1)
        if int(ov) > 0:
            d, i, _ = hash_grid_knn_join(query, grid, radius, 1)
        found_new = torch.isfinite(d[:, 0]) & ~torch.isfinite(best_d)
        best_d = torch.where(found_new, d[:, 0], best_d)
        best_i = torch.where(found_new, i[:, 0], best_i)
        if bool(torch.isfinite(best_d).all()):
            break
        radius *= 2.0
    return best_d, best_i
