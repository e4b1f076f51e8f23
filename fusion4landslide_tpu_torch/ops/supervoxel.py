"""Boundary-preserving supervoxel segmentation (VCCS metric).

Port of ``fusion4landslide_tpu.ops.supervoxel``: one seed per occupied grid
cell at the target resolution (the point nearest the cell centroid), then
the reference's boundary-refinement rule run as data-parallel label
propagation over a kNN graph — every point adopts the neighbouring label
whose seed is VCCS-closest, d = 1 - |n_p.n_q| + 0.4 ||p - q|| / R — until
no label changes or ``num_sweeps`` sweeps ran.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid
from fusion4landslide_tpu_torch.ops.hashgrid_cuda import radius_sample_window
from fusion4landslide_tpu_torch.ops.knn import knn
from fusion4landslide_tpu_torch.ops.normals import pca_normals
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.ops.voxel import grid_cells, group_by_cells, segment_sum

__all__ = ["SupervoxelResult", "supervoxel_graph", "supervoxel_segmentation",
           "supervoxel_segmentation_pair"]


class SupervoxelResult(NamedTuple):
    labels: torch.Tensor  # (n,) supervoxel id per point (-1 masked)
    n_supervoxels: torch.Tensor  # ()
    seed_idx: torch.Tensor  # (n,) point index of each cell's seed
    normals: torch.Tensor  # (n, 3)
    overflow: torch.Tensor | int = 0  # () sampler window overflow of the graph built here


def _vccs(p, n_p, q, n_q, resolution):
    d = torch.linalg.norm(p - q, dim=-1)
    return 1.0 - torch.abs((n_p * n_q).sum(-1)) + d / resolution * 0.4


def supervoxel_graph(points, resolution, mask=None, *, k_neighbors: int = 15):
    """kNN graph (neigh_idx (n, k), neigh_mask (n, k), () sampler
    window overflow count) for label propagation, bounded at
    ``resolution``.

    n <= 8192: exact brute force. Larger clouds: the grid-window sampler
    (kernel 1, ``'distance'`` priority, 128 candidates) on the cloud
    padded to ``bucket_size(n)``, then the k nearest candidates (stable
    sort: ties to the lower candidate slot, as ``lax.top_k``).
    """
    n = points.shape[0]
    dev = points.device
    valid = (
        torch.ones((n,), dtype=torch.bool, device=dev)
        if mask is None
        else mask.to(torch.bool)
    )
    res = torch.as_tensor(resolution, dtype=points.dtype, device=dev)
    if n <= 8192:
        sqd, neigh_idx = knn(points, points, k_neighbors, valid, exclude_self=True)
        neigh_mask = torch.isfinite(sqd) & (sqd <= res**2)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.where(neigh_mask, neigh_idx, 0), neigh_mask, overflow
    nb = bucket_size(n)
    pts_p = torch.cat([points, points.new_zeros((nb - n, 3))])
    valid_p = torch.cat([valid, valid.new_zeros((nb - n,))])
    grid = build_hash_grid(pts_p, res, valid_p)
    cand_i, cand_v, cand_x, overflow = radius_sample_window(
        pts_p, grid, res, 128, priority="distance"
    )
    cand_i, cand_v, cand_x = cand_i[:n], cand_v[:n], cand_x[:n]
    d2 = ((cand_x - points[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(cand_v, d2, torch.inf)
    sd, sel = torch.sort(d2, dim=1, stable=True)
    sd, sel = sd[:, :k_neighbors], sel[:, :k_neighbors]
    neigh_mask = torch.isfinite(sd)
    neigh_idx = torch.where(neigh_mask, torch.gather(cand_i, 1, sel), 0)
    return neigh_idx, neigh_mask, overflow


def supervoxel_segmentation(points, resolution, mask=None, *,
                            k_neighbors: int = 15, num_sweeps: int = 24,
                            neigh_idx=None, neigh_mask=None, normals=None):
    """Segment a cloud into supervoxels of roughly ``resolution`` size;
    labels compacted to 0..K-1, masked points -1. The result's
    ``overflow`` is the window overflow of the kNN graph when it is built
    here (0 when the caller passes ``neigh_idx`` / ``neigh_mask``)."""
    n = points.shape[0]
    valid = (
        torch.ones((n,), dtype=torch.bool, device=points.device)
        if mask is None
        else mask.to(torch.bool)
    )
    overflow = 0
    if neigh_idx is None or neigh_mask is None:
        neigh_idx, neigh_mask, overflow = supervoxel_graph(
            points, resolution, valid, k_neighbors=k_neighbors
        )
    return _supervoxel_core(
        points, torch.as_tensor(resolution, dtype=points.dtype, device=points.device),
        valid, neigh_idx, neigh_mask, normals=normals, num_sweeps=num_sweeps,
    )._replace(overflow=overflow)


def supervoxel_segmentation_pair(points, resolution, valid, neigh_idx, neigh_mask, normals, *,
                                 num_sweeps: int = 24) -> SupervoxelResult:
    """Segment B same-shape clouds (``points`` (B, n, 3), ``valid`` (B, n),
    ``neigh_idx`` / ``neigh_mask`` (B, n, k), ``normals`` (B, n, 3); one
    ``resolution``) in ONE batched propagation that sweeps until the last
    cloud converges. A sweep past a cloud's fixed point changes nothing,
    so every field equals the per-cloud call's exactly (each with a
    leading B). The tile steps keep their per-cloud calls, as JAX's do."""
    res = torch.as_tensor(resolution, dtype=points.dtype, device=points.device)
    seeds = [_seed(points[b], res, valid[b].to(torch.bool), normals[b])
             for b in range(points.shape[0])]
    labels, seed_of_cell, seed_pn, n_cells = (torch.stack(x) for x in zip(*seeds))
    labels = _propagate(points, normals, res, valid.to(torch.bool), neigh_idx, neigh_mask,
                        labels, seed_pn, n_cells, num_sweeps)
    labels, n_spv = _compact(labels, valid.to(torch.bool))
    return SupervoxelResult(labels=labels, n_supervoxels=n_spv, seed_idx=seed_of_cell,
                            normals=normals)


def _supervoxel_core(points, resolution, valid, neigh_idx, neigh_mask,
                     normals=None, *, num_sweeps: int = 24) -> SupervoxelResult:
    if normals is None:
        normals = pca_normals(points, valid, neigh_idx=neigh_idx, neigh_mask=neigh_mask)
    labels, seed_of_cell, seed_pn, n_cells = _seed(points, resolution, valid, normals)
    labels = _propagate(points[None], normals[None], resolution, valid[None], neigh_idx[None],
                        neigh_mask[None], labels[None], seed_pn[None], n_cells[None],
                        num_sweeps)
    labels, n_spv = _compact(labels, valid[None])
    return SupervoxelResult(labels=labels[0], n_supervoxels=n_spv[0], seed_idx=seed_of_cell,
                            normals=normals)


def _seed(points, resolution, valid, normals):
    """Seeds, one per occupied cell: the point nearest the cell centroid
    (earliest in stable distance order on ties). Returns each point's
    initial label (its cell), the cells' seed points, their packed (n, 6)
    position | normal rows and the cell count."""
    n = points.shape[0]
    dev = points.device
    origin = torch.where(valid[:, None], points, torch.inf).min(dim=0).values
    cells = grid_cells(points, resolution, origin)
    p2cell, n_cells, _ = group_by_cells(cells, valid)
    w = valid.to(points.dtype)
    counts = segment_sum(w, p2cell, n)
    sums = segment_sum(points * w[:, None], p2cell, n)
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    d2c = torch.linalg.norm(points - centroids[p2cell.long()], dim=-1)
    d2c = torch.where(valid, d2c, torch.inf)
    order = torch.sort(d2c, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    first = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, p2cell.long(), rank, reduce="amin"
    )
    seed_of_cell = torch.where(
        first < n, order[torch.clamp(first, max=n - 1)], n - 1
    ).to(torch.int32)
    seed_pn = torch.cat([points[seed_of_cell.long()], normals[seed_of_cell.long()]], 1)
    labels = torch.where(valid, p2cell, n - 1).to(torch.int32)
    return labels, seed_of_cell, seed_pn, n_cells


def _propagate(points, normals, resolution, valid, neigh_idx, neigh_mask, labels, seed_pn,
               n_cells, num_sweeps: int):
    """VCCS label propagation over B clouds at once ((B, n, .) inputs,
    (B,) ``n_cells``): every point adopts the candidate label (its own or
    a neighbour's) whose seed is VCCS-closest, until no label of any
    cloud changes or ``num_sweeps`` sweeps ran."""
    B, n = labels.shape
    dev = points.device
    # Row offsets of each cloud in the flattened (B * n) tables.
    off = (torch.arange(B, device=dev) * n)[:, None, None]
    nidx = neigh_idx.long() + off
    seed_flat = seed_pn.reshape(B * n, 6)
    ok_base = torch.cat(
        [torch.ones((B, n, 1), dtype=torch.bool, device=dev), neigh_mask], 2
    )
    it = 0
    while it < num_sweeps:
        cand = torch.cat([labels[..., None], labels.reshape(-1)[nidx]], 2)
        cand_pn = seed_flat[cand.long() + off]
        cost = _vccs(
            points[:, :, None, :], normals[:, :, None, :],
            cand_pn[..., :3], cand_pn[..., 3:], resolution,
        )
        cost = torch.where(ok_base & (cand < n_cells[:, None, None]), cost, torch.inf)
        best = cost.argmin(dim=2, keepdim=True)
        new = torch.where(valid, torch.gather(cand, 2, best)[..., 0], n - 1)
        changed = bool((new != labels).any())
        labels = new
        it += 1
        if not changed:
            break
    return labels


def _compact(labels, valid):
    """Labels of (B, n) clouds compacted to 0..K-1 (-1 masked), and K."""
    B, n = labels.shape
    used = torch.zeros((B, n), dtype=torch.int32, device=labels.device).scatter_reduce(
        1, labels.long(), valid.to(torch.int32), reduce="amax"
    )
    remap = torch.cumsum(used, 1) - 1
    labels = torch.where(valid, torch.gather(remap, 1, labels.long()), -1).to(torch.int32)
    return labels, used.sum(1)
