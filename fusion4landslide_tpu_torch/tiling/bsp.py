"""BSP tiling of an epoch pair with halo overlap (the port's own copy of
``fusion4landslide_tpu.tiling.bsp``, numpy on the host).

Capability parity with the native tiling core
(reference: cpp_core/pcd_tiling/pcd_tiling.cpp ``tile_point_clouds``):

1. crop both epochs to the intersection of their bounding boxes
   (pcd_tiling.cpp:770-778),
2. optional voxel-grid filter, leaf = given size or the median point
   resolution (pcd_tiling.cpp:812-822),
3. projection axis = argmax of the overlap box's face areas if not given
   (pcd_tiling.cpp:844-845),
4. recursive *midpoint* bisection along the longer of the two in-plane axes
   until max(|src|, |tgt|) <= max_pts (pcd_tiling.cpp:244-248, 276-339),
5. per tile, a halo ("overlap") cloud cropped with a fixed ±20 m in-plane
   buffer (pcd_tiling.cpp:295-301) — the halo makes per-tile matching exact
   without cross-tile communication, i.e. the same role as a halo exchange in
   a domain decomposition,
6. tiles where either epoch has <= 1 point are dropped
   (pcd_tiling.cpp:248-251; note the reference ignores ``min_pts`` here).

This re-design returns **index sets** instead of writing 4 PLY files per tile
(tiles reference the parent arrays — zero copies until a pipeline gathers its
tile), with an optional writer for artifact parity. The recursion is a host
loop over numpy boolean masks: O(N · depth) comparisons on pre-sliced
sub-arrays, run once per epoch pair.

The tile list is the unit of data parallelism: the runners pad tiles to a
common bucket size (``fusion4landslide_tpu_torch.parallel``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = ["TilePair", "tile_epoch_pair", "tile_point_clouds"]

HALO_M = 20.0  # fixed in-plane halo (pcd_tiling.cpp:297-301)


@dataclass
class TilePair:
    """One spatial tile of an epoch pair (indices into the tiled clouds)."""

    tile_id: int
    bbox_min: np.ndarray  # (3,) core box (split axes only are meaningful)
    bbox_max: np.ndarray  # (3,)
    src_idx: np.ndarray  # (ns,) indices into the cropped/filtered source
    tgt_idx: np.ndarray  # (nt,)
    src_halo_idx: np.ndarray  # (nsh,) core + halo
    tgt_halo_idx: np.ndarray  # (nth,)


def _bbox(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return points.min(axis=0), points.max(axis=0)


def _in_box(points: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return np.all((points >= lo) & (points <= hi), axis=1)


def _median_resolution(points: np.ndarray, sample: int = 200_000) -> float:
    """Median 2-NN distance (pcd_tiling.cpp:37-54), subsampled for speed."""
    from scipy.spatial import cKDTree

    if points.shape[0] > sample:
        sel = np.random.default_rng(0).choice(points.shape[0], sample, replace=False)
        q = points[sel]
    else:
        q = points
    tree = cKDTree(points)
    dist, _ = tree.query(q, k=2)
    return float(np.median(dist[:, 1]))


def _voxel_filter(points: np.ndarray, leaf: float, extras: list[np.ndarray]):
    """Centroid-per-voxel downsample (PCL VoxelGrid semantics) in numpy."""
    cells = np.floor((points - points.min(axis=0)) / leaf).astype(np.int64)
    _, inv, counts = np.unique(
        cells, axis=0, return_inverse=True, return_counts=True
    )
    n_vox = counts.shape[0]
    out = np.zeros((n_vox, 3))
    for d in range(3):
        out[:, d] = np.bincount(inv, weights=points[:, d], minlength=n_vox)
    out /= counts[:, None]
    new_extras = []
    for e in extras:
        if e is None:
            new_extras.append(None)
            continue
        acc = np.zeros((n_vox, e.shape[1]))
        for d in range(e.shape[1]):
            acc[:, d] = np.bincount(inv, weights=e[:, d].astype(np.float64), minlength=n_vox)
        acc /= counts[:, None]
        new_extras.append(acc.astype(e.dtype))
    return out, new_extras


def tile_epoch_pair(
    src: np.ndarray,
    tgt: np.ndarray,
    max_pts: int,
    min_pts: int = 2,
    *,
    voxel_size: float | None = None,
    proj_dir: int | None = None,
    halo: float = HALO_M,
    src_colors: np.ndarray | None = None,
    tgt_colors: np.ndarray | None = None,
):
    """Tile two epochs; returns (tiles, src_f, tgt_f, src_colors_f, tgt_colors_f, proj_dir).

    ``src_f``/``tgt_f`` are the cropped (and optionally voxel-filtered) clouds
    the tile indices refer to.
    """
    lo1, hi1 = _bbox(src)
    lo2, hi2 = _bbox(tgt)
    lo = np.maximum(lo1, lo2)
    hi = np.minimum(hi1, hi2)
    if np.any(lo >= hi):
        raise ValueError("epoch bounding boxes do not overlap")

    keep_s = _in_box(src, lo, hi)
    keep_t = _in_box(tgt, lo, hi)
    src_f = src[keep_s]
    tgt_f = tgt[keep_t]
    src_c = None if src_colors is None else src_colors[keep_s]
    tgt_c = None if tgt_colors is None else tgt_colors[keep_t]

    if voxel_size is not None:
        leaf_s = voxel_size if voxel_size > 0 else _median_resolution(src_f)
        leaf_t = voxel_size if voxel_size > 0 else _median_resolution(tgt_f)
        src_f, (src_c,) = _voxel_filter(src_f, leaf_s, [src_c])
        tgt_f, (tgt_c,) = _voxel_filter(tgt_f, leaf_t, [tgt_c])

    if proj_dir is None or proj_dir == -1:
        ext = hi - lo
        face_areas = np.array(
            [ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]]
        )
        proj_dir = int(np.argmax(face_areas))
    axes = [a for a in range(3) if a != proj_dir]

    tiles: list[TilePair] = []
    # Explicit stack replaces the C++ recursion; each frame carries index sets.
    stack = [
        (
            np.arange(src_f.shape[0]),
            np.arange(tgt_f.shape[0]),
            np.arange(src_f.shape[0]),
            np.arange(tgt_f.shape[0]),
            lo.copy(),
            hi.copy(),
        )
    ]
    while stack:
        si, ti, shi, thi, blo, bhi = stack.pop()
        n_max = max(si.shape[0], ti.shape[0])
        if n_max <= max_pts:
            if min(si.shape[0], ti.shape[0]) > max(1, min_pts - 1):
                tiles.append(
                    TilePair(
                        tile_id=-1,
                        bbox_min=blo,
                        bbox_max=bhi,
                        src_idx=si,
                        tgt_idx=ti,
                        src_halo_idx=shi,
                        tgt_halo_idx=thi,
                    )
                )
            continue
        side = bhi - blo
        ax = axes[0] if side[axes[0]] > side[axes[1]] else axes[1]
        mid = 0.5 * (blo[ax] + bhi[ax])
        for half in (0, 1):
            hlo, hhi = blo.copy(), bhi.copy()
            if half == 0:
                hhi[ax] = mid
            else:
                hlo[ax] = mid
            # Halo box: expand both in-plane axes by the buffer.
            olo, ohi = hlo.copy(), hhi.copy()
            for a in axes:
                olo[a] -= halo
                ohi[a] += halo
            s_sub = si[_in_box(src_f[si], hlo, hhi)]
            t_sub = ti[_in_box(tgt_f[ti], hlo, hhi)]
            sh_sub = shi[_in_box(src_f[shi], olo, ohi)]
            th_sub = thi[_in_box(tgt_f[thi], olo, ohi)]
            stack.append((s_sub, t_sub, sh_sub, th_sub, hlo, hhi))

    # Deterministic ordering: sort by bbox corner (stack order is LIFO).
    tiles.sort(key=lambda tp: tuple(tp.bbox_min))
    for i, tp in enumerate(tiles):
        tp.tile_id = i
    return tiles, src_f, tgt_f, src_c, tgt_c, proj_dir


def tile_point_clouds(
    src_path: str,
    tgt_path: str,
    max_pts: int,
    min_pts: int,
    voxel_flag: bool,
    voxel_size: float,
    overlap: float,
    proj_dir: int,
    save_dir: str,
    verbose: bool = False,
    halo: float = HALO_M,
) -> int:
    """File-level API matching the reference SWIG entry point
    (cpp_core/pcd_tiling/pcd_tiling.h:3-12): reads two PLYs, writes
    ``non_overlap/{source,target}_tile_N.ply`` and
    ``overlap/..._tile_N_overlap.ply`` under ``save_dir``. Returns the tile
    count."""
    from fusion4landslide_tpu_torch.io import read_point_cloud
    from fusion4landslide_tpu_torch.io.ply import write_ply

    s = read_point_cloud(src_path)
    t = read_point_cloud(tgt_path)
    tiles, src_f, tgt_f, src_c, tgt_c, _ = tile_epoch_pair(
        s.points,
        t.points,
        max_pts,
        min_pts,
        voxel_size=(voxel_size if voxel_flag else None),
        proj_dir=(None if proj_dir == -1 else proj_dir),
        halo=halo,
        src_colors=s.colors,
        tgt_colors=t.colors,
    )
    non_overlap = os.path.join(save_dir, "non_overlap")
    overlap_dir = os.path.join(save_dir, "overlap")
    os.makedirs(non_overlap, exist_ok=True)
    os.makedirs(overlap_dir, exist_ok=True)
    for tp in tiles:
        def col(c, idx):
            return None if c is None else c[idx]

        write_ply(
            os.path.join(non_overlap, f"source_tile_{tp.tile_id}.ply"),
            src_f[tp.src_idx],
            col(src_c, tp.src_idx),
        )
        write_ply(
            os.path.join(non_overlap, f"target_tile_{tp.tile_id}.ply"),
            tgt_f[tp.tgt_idx],
            col(tgt_c, tp.tgt_idx),
        )
        write_ply(
            os.path.join(overlap_dir, f"source_tile_{tp.tile_id}_overlap.ply"),
            src_f[tp.src_halo_idx],
            col(src_c, tp.src_halo_idx),
        )
        write_ply(
            os.path.join(overlap_dir, f"target_tile_{tp.tile_id}_overlap.ply"),
            tgt_f[tp.tgt_halo_idx],
            col(tgt_c, tp.tgt_halo_idx),
        )
    if verbose:
        print(f"tiled into {len(tiles)} tiles under {save_dir}")
    return len(tiles)
