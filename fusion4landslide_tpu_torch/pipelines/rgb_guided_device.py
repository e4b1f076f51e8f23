"""The RGB-guided tile step on fixed padded shapes (port of
``fusion4landslide_tpu.pipelines.rgb_guided_device``).

The image pair's pixel matches are computed once per epoch pair on the
host (``image.matching``) and padded; everything after is per tile:
projection in the tile's original coordinates, pixel-NN chaining, the
magnitude prune, the median resolution (exact brute-force 3-d self 1-NN,
as the JAX step), supervoxels (kernel 1 builds their graph above 8192
points), label compaction on the device, the capped member table, the
per-supervoxel rigid refinement and the re-assignment of every point of a
quality supervoxel. ``parallel.pipeline.run_rgb_guided_tiles`` runs it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.geometry import chain_2d_matches_to_3d, project_points
from fusion4landslide_tpu_torch.ops.knn import nn1_xla_rounded
from fusion4landslide_tpu_torch.ops.segments import label_members
from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_segmentation
from fusion4landslide_tpu_torch.utils.timing import StageTimer
from fusion4landslide_tpu_torch.pipelines.f2s3_device import masked_median
from fusion4landslide_tpu_torch.pipelines.rgb_guided import refine_supervoxels_rigid

__all__ = ["RGBGuidedTileResult", "rgb_guided_tile_step"]


class RGBGuidedTileResult(NamedTuple):
    moved: torch.Tensor  # (N, 3) refined target position per src point
    valid: torch.Tensor  # (N,) belongs to a quality supervoxel
    matched: torch.Tensor  # (N,) has a lifted 2D match (pre-refinement)
    tgt_match: torch.Tensor  # (N, 3) lifted match target (pre-refinement)
    median_res: torch.Tensor  # ()
    n_dropped: torch.Tensor  # () points lost to the static supervoxel caps
    labels: torch.Tensor  # (N,) supervoxel (> 10 matches) per src point, -1 none
    overflow_by_source: dict  # window overflow: {"sampler", "grid_knn"}


@torch.inference_mode()
def rgb_guided_tile_step(src, smask, tgt, tmask, center, corres_2d, cmask, src_extrinsic,
                         tgt_extrinsic, intrinsic, tgt_intrinsic, pixel_thres=5.0,
                         max_magnitude=10.0, icp_threshold=0.1, voxel_size=0.0, *,
                         image_size: tuple[int, int], v_flip: bool = True,
                         k_neighbors: int = 30, sv_cap: int = 1024, member_cap: int = 512,
                         mode: str = "nn_src_only", icp_type: str = "point2point",
                         icp_max_iter: int = 30, timings: dict | None = None,
                         device=None) -> RGBGuidedTileResult:
    """One RGB-guided tile (reference ``implement_rgb_guided_estimation``,
    rgb_guided.py:1064-1639) on padded, centred (N, 3) ``src`` / (M, 3)
    ``tgt`` with masks; ``center`` (3,) is the tile's centring offset
    (the cameras are georeferenced), ``corres_2d`` (C, 4) the padded pixel
    matches with mask ``cmask``. Runs on ``device`` (default ``cuda``).
    ``timings`` (optional dict) accumulates per-stage seconds."""
    dev = resolve_device(device)

    def on_dev(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    src, tgt, center = on_dev(src), on_dev(tgt), on_dev(center)
    smask, tmask = on_dev(smask, torch.bool), on_dev(tmask, torch.bool)
    corres_2d, cmask = on_dev(corres_2d), on_dev(cmask, torch.bool)
    f32 = src.dtype
    N = src.shape[0]
    stages = StageTimer(timings, dev)

    # 1.-2. Projection in the original coordinates (rgb_guided.py:2284),
    # pixel-NN chaining (rgb_guided.py:1096-1100), magnitude prune.
    uv_s, _, val_s = project_points(src + center, on_dev(src_extrinsic), on_dev(intrinsic),
                                    image_size, mask=smask, v_flip=v_flip)
    uv_t, _, val_t = project_points(tgt + center, on_dev(tgt_extrinsic), on_dev(tgt_intrinsic),
                                    image_size, mask=tmask, v_flip=v_flip)
    tgt_idx, valid2d = chain_2d_matches_to_3d(corres_2d, uv_s, uv_t, pixel_thres,
                                              corres_mask=cmask, src_valid=val_s,
                                              tgt_valid=val_t, mode=mode)
    tgt_match = tgt[tgt_idx.long()]
    mag = torch.linalg.norm(tgt_match - src, dim=-1)
    matched = valid2d & (mag <= torch.tensor(max_magnitude, dtype=f32, device=dev)) & smask
    stages.mark("chain_2d")

    # 3. Median resolution, supervoxels of the source (rgb_guided.py:868-950).
    d_s = torch.sqrt(nn1_xla_rounded(src, src, smask, exclude_self=True)[0])
    median_res = masked_median(d_s, smask & torch.isfinite(d_s))
    stages.mark("median_res")
    svl_radius = torch.maximum(torch.sqrt(torch.tensor(3.0, dtype=f32, device=dev)) * 10.0
                               * median_res, torch.tensor(voxel_size, dtype=f32, device=dev))
    seg = supervoxel_segmentation(src, svl_radius, smask, k_neighbors=k_neighbors)

    # Supervoxels with > 10 matched points, compacted on the device.
    has = smask & (seg.labels >= 0)
    lab0 = torch.where(has, seg.labels, 0).long()
    match_counts = torch.zeros((N,), dtype=torch.int32, device=dev).index_add_(
        0, lab0, (has & matched).to(torch.int32))
    ok = has & (match_counts[lab0] > 10)
    used = torch.zeros((N,), dtype=torch.int32, device=dev).scatter_reduce(
        0, lab0, ok.to(torch.int32), reduce="amax")
    remap = torch.cumsum(used, 0) - 1
    labels = torch.where(ok, remap[lab0], -1).to(torch.int32)
    stages.mark("segmentation")

    # 4. Per-supervoxel rigid refinement (rgb_guided.py:981-1047).
    members, member_mask = label_members(labels, sv_cap, member_cap)
    in_table = torch.zeros((N + 1,), dtype=torch.bool, device=dev)
    in_table[torch.where(member_mask, members.long(), N).reshape(-1)] = member_mask.reshape(-1)
    n_dropped = (ok & ~in_table[:N]).sum()
    ref = refine_supervoxels_rigid(members, member_mask, matched, src, tgt_match,
                                   icp_threshold=icp_threshold, icp_type=icp_type,
                                   icp_max_iter=icp_max_iter)
    stages.mark("refine")

    # 5. Every source point of a quality supervoxel moves with it.
    pl = torch.clamp(labels, 0, sv_cap - 1).long()
    valid = (labels >= 0) & ref.quality[pl]
    moved = torch.einsum("nij,nj->ni", ref.R[pl], src) + ref.t[pl]
    moved = torch.where(valid[:, None], moved, src)
    stages.mark("reassign")
    return RGBGuidedTileResult(
        moved=moved, valid=valid, matched=matched, tgt_match=tgt_match,
        median_res=median_res, n_dropped=n_dropped, labels=labels,
        overflow_by_source={"sampler": int(seg.overflow), "grid_knn": 0},
    )
