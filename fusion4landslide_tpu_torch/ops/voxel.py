"""Grid binning and voxel-grid downsampling.

Port of ``fusion4landslide_tpu.ops.voxel``: cells are grouped by a stable
lexicographic sort of their integer coordinates (no linearised key to
overflow). Everything is fixed-shape: with N input points there are at
most N occupied cells, so outputs are padded to N with an occupancy count.
"""

from __future__ import annotations

import torch

__all__ = ["grid_cells", "group_by_cells", "lexsort3", "segment_mean", "segment_sum",
           "voxel_downsample"]

_INT32_MAX = 2**31 - 1


def grid_cells(points, cell_size, origin) -> torch.Tensor:
    """Integer grid coordinates floor((p - origin) / cell) of each point."""
    return torch.floor((points - origin) / cell_size).to(torch.int32)


def lexsort3(cells: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order of (n, 3) rows, column 0 most
    significant (``jnp.lexsort((c2, c1, c0))``)."""
    order = torch.sort(cells[:, 2], stable=True).indices
    order = order[torch.sort(cells[order, 1], stable=True).indices]
    return order[torch.sort(cells[order, 0], stable=True).indices]


def group_by_cells(cells: torch.Tensor, mask=None):
    """Group points by identical integer cells: (point2group (n,) int32,
    n_groups () int, order (n,)). Valid groups are ids 0..n_groups-1 in
    lexicographic cell order; invalid points sort last."""
    n = cells.shape[0]
    if mask is not None:
        cells = torch.where(mask.to(torch.bool)[:, None], cells, _INT32_MAX)
    order = lexsort3(cells)
    sc = cells[order]
    new_group = torch.ones((n,), dtype=torch.bool, device=cells.device)
    new_group[1:] = (sc[1:] != sc[:-1]).any(dim=-1)
    gid_sorted = torch.cumsum(new_group.to(torch.int32), 0).to(torch.int32) - 1
    point2group = torch.empty_like(gid_sorted)
    point2group[order] = gid_sorted
    if mask is not None:
        valid_sorted = mask.to(torch.bool)[order]
        n_groups = torch.where(valid_sorted, gid_sorted + 1, 0).max()
    else:
        n_groups = gid_sorted[-1] + 1
    return point2group, n_groups, order


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Per-segment sums of ``values`` rows; segment ids outside [0, num)
    are dropped. On the CPU the sum runs in the input dtype in index
    order — bit for bit XLA's ``segment_sum``; on the card it accumulates
    in float64, so the atomics' order cannot change the float32 result
    from run to run."""
    seg = seg.long()
    keep = (seg >= 0) & (seg < num)
    acc_dtype = torch.float64 if values.is_cuda else values.dtype
    shape = (num,) + tuple(values.shape[1:])
    acc = torch.zeros(shape, dtype=acc_dtype, device=values.device)
    acc.index_add_(0, seg[keep], values[keep].to(acc_dtype))
    return acc.to(values.dtype)


def segment_mean(values: torch.Tensor, seg: torch.Tensor, num: int):
    """Mean of ``values`` rows per segment: (means (num, ...), counts
    (num,)); the count is clamped at 1 in the divide, so empty segments
    read 0."""
    counts = segment_sum(torch.ones(values.shape[:1], dtype=values.dtype,
                                    device=values.device), seg, num)
    sums = segment_sum(values, seg, num)
    return sums / torch.clamp(counts, min=1.0)[..., None], counts


def voxel_downsample(points, voxel_size, mask=None, origin=None):
    """Voxel-grid downsample to per-voxel centroids with index maps:
    (centroids (n, 3) padded, point2voxel (n,), counts (n,), n_voxels)."""
    valid = None if mask is None else mask.to(torch.bool)
    if origin is None:
        p = points if valid is None else torch.where(valid[:, None], points, torch.inf)
        origin = p.min(dim=0).values
    cells = grid_cells(points, voxel_size, origin)
    point2voxel, n_voxels, _ = group_by_cells(cells, mask)
    n = points.shape[0]
    w = (
        torch.ones((n,), dtype=points.dtype, device=points.device)
        if valid is None
        else valid.to(points.dtype)
    )
    counts = segment_sum(w, point2voxel, n)
    sums = segment_sum(points * w[:, None], point2voxel, n)
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    return centroids, point2voxel, counts, n_voxels
