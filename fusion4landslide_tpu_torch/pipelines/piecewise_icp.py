"""Piecewise-ICP deformation baseline: octree-cell centroid matching
(port of ``fusion4landslide_tpu.pipelines.piecewise_icp``; reference
src/piecewise_icp.py, "Identification of stable surfaces within point
clouds for areal deformation monitoring", JISDM 2016).

Both epochs are binned on one uniform grid at the octree's leaf size
(a cube root box of side ``extent`` split to depth
``ceil(log2(extent / smax))``, from the joint min corner); each occupied
cell with at least ``n_min`` points has a centroid; every source centroid
takes its nearest target centroid (exact brute force, 3-d); a matched cell
is stable when its centroid distance is at most mean + std of all matched
distances. Stable cells emit zero displacement, unstable ones the centroid
offset. No kernel runs here.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.io.results import (
    save_dvfms,
    save_dvfs,
    save_txt,
    visual_clamp_magnitude,
)
from fusion4landslide_tpu_torch.ops.knn import nn1_xla_rounded
from fusion4landslide_tpu_torch.ops.voxel import grid_cells, group_by_cells, segment_sum
from fusion4landslide_tpu_torch.utils.profiling import tile
from fusion4landslide_tpu_torch.utils.timing import StageTimer

__all__ = [
    "PiecewiseResult",
    "piecewise_icp_core",
    "run_piecewise_icp",
    "suggest_max_cells",
    "write_piecewise_tables",
]


def suggest_max_cells(extent: float, smax: float, n: int, n_min: int = 1) -> int:
    """Static bound on occupied leaves for ``piecewise_icp_core``: the
    octree at depth ceil(log2(extent / smax)) has (2^depth)^3 leaves, of
    which at most n / n_min hold n_min points or more."""
    depth = max(int(np.ceil(np.log2(max(extent / max(smax, 1e-9), 1.0)))), 0)
    bound = min(int(min(8.0**depth, float(n))), n // max(n_min, 1) + 1)
    return max(1 << max(bound - 1, 1).bit_length(), 1024)


class PiecewiseResult(NamedTuple):
    displacement: torch.Tensor  # (n, 3) per source point
    out_mask: torch.Tensor  # (n,) point belongs to a kept cell
    stable_point: torch.Tensor  # (n,) point's cell classified stable
    n_cells_src: torch.Tensor  # ()
    n_stable: torch.Tensor  # () stable matched-cell count


def _cell_stats(points, mask, cell_size, origin, n_min):
    """Grid cells -> (point->cell (n,), centroids (n, 3), counts (n,),
    cell validity (n,), () occupied cells), padded to n."""
    n = points.shape[0]
    p2c, n_cells, _ = group_by_cells(grid_cells(points, cell_size, origin), mask)
    w = mask.to(points.dtype)
    counts = segment_sum(w, p2c, n)
    sums = segment_sum(points * w[:, None], p2c, n)
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    cell_valid = (torch.arange(n, device=points.device) < n_cells) & (counts >= n_min)
    return p2c, centroids, counts, cell_valid, n_cells


def piecewise_icp_core(src, tgt, src_mask, tgt_mask, smax, n_min, *,
                       max_cells: int = 1 << 17) -> PiecewiseResult:
    """Per-tile piecewise displacement on padded clouds. ``max_cells``
    bounds the occupied leaves per epoch; the centroid tables are cut to
    it before matching."""
    n = src.shape[0]
    dev, f32 = src.device, src.dtype
    src_mask, tgt_mask = src_mask.to(torch.bool), tgt_mask.to(torch.bool)
    max_cells = min(max_cells, n)
    lo = torch.minimum(torch.where(src_mask[:, None], src, torch.inf).min(dim=0).values,
                       torch.where(tgt_mask[:, None], tgt, torch.inf).min(dim=0).values)
    hi = torch.maximum(torch.where(src_mask[:, None], src, -torch.inf).max(dim=0).values,
                       torch.where(tgt_mask[:, None], tgt, -torch.inf).max(dim=0).values)
    # Leaf size (piecewise_icp.py:107-109), log2 as the JAX package forms
    # it: log(x) / log(2) in float32.
    extent = (hi - lo).max()
    ratio = torch.clamp(extent / torch.tensor(smax, dtype=f32, device=dev), min=1.0)
    depth = torch.ceil(torch.log(ratio) / torch.log(torch.tensor(2.0, dtype=f32, device=dev)))
    cell = extent / torch.exp2(depth)

    sp2c, s_cent, _, s_valid, _ = _cell_stats(src, src_mask, cell, lo, n_min)
    _, t_cent, _, t_valid, _ = _cell_stats(tgt, tgt_mask, cell, lo, n_min)
    s_cent, t_cent = s_cent[:max_cells], t_cent[:max_cells]
    s_valid, t_valid = s_valid[:max_cells], t_valid[:max_cells]

    # Nearest target centroid per source centroid; the selected distance
    # in the rounding of the JAX package's CPU build.
    sq, match = nn1_xla_rounded(s_cent, t_cent, t_valid)
    match = match.long()
    dist = torch.sqrt(sq)
    matched = s_valid & torch.isfinite(dist)

    # Stable at mean + std of the matched distances (piecewise_icp.py:151-156).
    cnt = torch.clamp(matched.to(f32).sum(), min=1.0)
    mean = torch.where(matched, dist, 0.0).sum() / cnt
    var = torch.where(matched, (dist - mean) ** 2, 0.0).sum() / cnt
    stable_cell = matched & (dist <= mean + torch.sqrt(var))

    cell_disp = t_cent[match] - s_cent
    cell_disp = torch.where((stable_cell | ~matched)[:, None], 0.0, cell_disp)
    point_cell = torch.clamp(sp2c, 0, max_cells - 1).long()
    out_mask = src_mask & (sp2c < max_cells) & matched[point_cell]
    return PiecewiseResult(
        displacement=cell_disp[point_cell],
        out_mask=out_mask,
        stable_point=out_mask & stable_cell[point_cell],
        n_cells_src=s_valid.sum(),
        n_stable=stable_cell.sum(),
    )


def write_piecewise_tables(results: str, tile_id, dvfs: np.ndarray, dataset) -> None:
    """``piecewise_icp_dvf(m)s_of_tile_*`` and the visual-clamped copy
    (piecewise_icp.py:201-216)."""
    save_dvfs(os.path.join(results, f"piecewise_icp_dvfs_of_tile_{tile_id}.txt"), dvfs)
    dvfms = save_dvfms(os.path.join(results, f"piecewise_icp_dvfms_of_tile_{tile_id}.txt"), dvfs)
    save_txt(os.path.join(results, f"piecewise_dvfms_visualize_of_tile_{tile_id}.txt"),
             visual_clamp_magnitude(dvfms, dataset))


@tile("tile.piecewise_icp")
@torch.inference_mode()
def run_piecewise_icp(src_points: np.ndarray, tgt_points: np.ndarray, *, smax: float,
                      number_points_min: int, output_dir: str | None = None, tile_id=0,
                      dataset: str | None = None, logger=None, device=None,
                      timings: dict | None = None) -> np.ndarray:
    """One tile on one device: centre on the source mean, run the core,
    return the (n_kept, 6) dvfs table in the original frame and, with
    ``output_dir``, write it under ``output_dir/results``. ``timings``
    (optional dict) collects per-stage seconds."""
    dev = resolve_device(device)
    timer = StageTimer(timings, dev)
    with timer.stage("cells_match"):
        center = src_points.mean(axis=0)
        src = (src_points - center).astype(np.float32)
        tgt = (tgt_points - center).astype(np.float32)
        lo = np.minimum(src.min(axis=0), tgt.min(axis=0))
        hi = np.maximum(src.max(axis=0), tgt.max(axis=0))
        res = piecewise_icp_core(
            torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev),
            torch.ones(src.shape[0], dtype=torch.bool, device=dev),
            torch.ones(tgt.shape[0], dtype=torch.bool, device=dev),
            float(smax), int(number_points_min),
            max_cells=suggest_max_cells(float((hi - lo).max()), float(smax), src.shape[0],
                                        int(number_points_min)),
        )
        keep = res.out_mask.cpu().numpy()
        src_kept = src_points[keep]
        dvfs = np.hstack([src_kept, src_kept + res.displacement.cpu().numpy()[keep]])
    if logger is not None:
        logger.info("piecewise_icp tile %s: %d cells, %d/%d points stable", tile_id,
                    int(res.n_cells_src), int(res.stable_point.cpu().numpy()[keep].sum()),
                    int(keep.sum()))
    if output_dir is not None:
        with timer.stage("write_tables"):
            write_piecewise_tables(os.path.join(output_dir, "results"), tile_id, dvfs, dataset)
    return dvfs
