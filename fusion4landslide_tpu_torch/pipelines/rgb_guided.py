"""RGB-guided displacement estimation: dense image matches lifted to 3D,
refined per supervoxel by a rigid fit (port of
``fusion4landslide_tpu.pipelines.rgb_guided``; reference src/rgb_guided.py).

Stages of ``run_rgb_guided_tile``: project both epochs into their images
(v flipped unless the dataset is ``rockfall_simulator``), match the image
pair (``image.matching``: E-LoFTR, RoMa or ZNCC), chain each projected source
point through the pixel matches to a projected target point
(``image.geometry.chain_2d_matches_to_3d``), drop chains longer than
``max_magnitude``, write the ``wo_refinement`` table, segment the source
(supervoxels, or HDBSCAN on the host), keep segments with more than 10
matched points, fit each one rigidly (``refine_supervoxels_rigid``) and
move every point of a quality segment by its segment's transform.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import NamedTuple

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.geometry import chain_2d_matches_to_3d, project_points
from fusion4landslide_tpu_torch.image.matching import match_epoch_images, matcher_options
from fusion4landslide_tpu_torch.io.results import (
    save_dvfms,
    save_dvfs,
    save_txt,
    visual_clamp_magnitude,
)
from fusion4landslide_tpu_torch.ops.kabsch import weighted_kabsch
from fusion4landslide_tpu_torch.ops.knn import median_nn_distance_counted
from fusion4landslide_tpu_torch.ops.registration import icp_by_type
from fusion4landslide_tpu_torch.ops.segments import bucket_size, label_members
from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_segmentation
from fusion4landslide_tpu_torch.utils.timing import StageTimer
from fusion4landslide_tpu_torch.utils.visualization import require_matplotlib, save_matching_figure

__all__ = ["SupervoxelRefineResult", "refine_supervoxels_rigid", "run_rgb_guided_tile"]

#: Distances per batched ICP correspondence slab, at most: supervoxels go
#: through ICP in chunks of ``_ICP_SLAB // P^2`` rows.
_ICP_SLAB = 1 << 27


class SupervoxelRefineResult(NamedTuple):
    R: torch.Tensor  # (S, 3, 3)
    t: torch.Tensor  # (S, 3)
    quality: torch.Tensor  # (S,) inlier fraction >= 0.70
    n_matches: torch.Tensor  # (S,)


def refine_supervoxels_rigid(members, member_mask, matched, src_pts, tgt_match_pts, *,
                             icp_threshold=0.1, icp_max_iter: int = 30,
                             icp_type: str = "point2point",
                             max_matches: int = 1024) -> SupervoxelRefineResult:
    """Per-supervoxel rigid refinement (rgb_guided.py:981-1047) over an
    (S, P) member table: a weighted Kabsch fit on the matched members,
    whose residuals against 2.5x their lower median only set the quality
    flag (>= 70% inliers), then ICP from that fit over all matched
    members. Above ``max_matches`` columns the matched members come first,
    each group in member order, and the first ``max_matches`` are kept.
    Rows without a match keep the identity (ICP has nothing to fit); the
    others go through ICP in chunks, each row independent of its chunk."""
    S, P = members.shape
    mem = members.long()
    mv = member_mask.to(torch.bool) & matched.to(torch.bool)[mem]
    if P > max_matches:
        sel = torch.sort((~mv).to(torch.int8), dim=1, stable=True).indices[:, :max_matches]
        mem, mv = torch.gather(mem, 1, sel), torch.gather(mv, 1, sel)
        P = max_matches
    src_m, tgt_m = src_pts[mem], tgt_match_pts[mem]
    n_match = mv.sum(dim=1)
    R, t, res, _ = weighted_kabsch(src_m, tgt_m, mv.to(src_m.dtype))
    rs = torch.sort(torch.where(mv, res, torch.inf), dim=1).values
    med = torch.gather(rs, 1, torch.clamp(torch.div(n_match - 1, 2, rounding_mode="floor"),
                                          min=0)[:, None])
    inlier = mv & (res < 2.5 * med)
    quality = inlier.sum(dim=1) / torch.clamp(n_match, min=1) >= 0.70
    rows = torch.nonzero(n_match > 0)[:, 0]
    chunk = max(1, _ICP_SLAB // (P * P))
    for s0 in range(0, rows.numel(), chunk):
        r = rows[s0:s0 + chunk]
        icp = icp_by_type(icp_type, src_m[r], tgt_m[r], icp_threshold, src_mask=mv[r],
                          tgt_mask=mv[r], max_iter=icp_max_iter, R_init=R[r], t_init=t[r])
        R[r], t[r] = icp.R, icp.t
    return SupervoxelRefineResult(R=R, t=t, quality=quality, n_matches=n_match)


def write_rgb_guided_tables(results_dir: str, tile_id, wo: np.ndarray, dvfs: np.ndarray,
                            dataset) -> None:
    """The method's tables: ``wo_refinement`` (x y z |d| of the lifted
    matches), the refined dvfs and dvfms, and their visualisation copy."""
    save_txt(osp.join(results_dir, f"rgb_guided_wo_refinement_dvfms_tile_{tile_id}.txt"), wo)
    save_dvfs(osp.join(results_dir, f"rgb_guided_w_refinement_dvfs_src2tgt_tile_{tile_id}.txt"),
              dvfs)
    dvfms = save_dvfms(
        osp.join(results_dir, f"rgb_guided_w_refinement_dvfms_src2tgt_tile_{tile_id}.txt"), dvfs)
    if dvfms.shape[0] > 2:
        save_txt(osp.join(results_dir,
                          f"rgb_guided_w_refinement_dvfms_src2tgt_visualize_tile_{tile_id}.txt"),
                 visual_clamp_magnitude(dvfms, dataset))


@torch.inference_mode()
def run_rgb_guided_tile(cfg, src_core: np.ndarray, tgt_core: np.ndarray, src_image, tgt_image,
                        intrinsic: np.ndarray, src_extrinsic: np.ndarray,
                        tgt_extrinsic: np.ndarray, *, tgt_intrinsic: np.ndarray | None = None,
                        tile_id=0, logger=None, corres_2d: np.ndarray | None = None,
                        device=None, timings: dict | None = None) -> dict:
    """One tile of the RGB-guided method on one device (``main_rgb_guided``
    with ``use_mesh: auto``). ``cfg`` keys as in
    ``configs/landslide/rgb_guided_brienz.yaml``; ``corres_2d`` injects
    precomputed (M, 4) pixel matches instead of running the matcher. The
    tile is projected in its original (georeferenced) coordinates and
    solved centred on its source mean. ``timings`` (optional dict)
    collects per-stage seconds, synchronised at each stage boundary.

    Returns {"dvfs", "n_matches", "n_supervoxels", "corres_2d", "matched",
    "quality", "overflow_by_source"}."""
    require_matplotlib(cfg, ("save_img_matching_visualization",))
    dev = resolve_device(device)
    timer = StageTimer(timings, dev)
    image_size = tuple(int(v) for v in (cfg.get("image_size") or src_image.shape[:2]))
    pixel_thres = float(cfg.get("pixel_thres", 5))
    max_mag = float(cfg.get("max_magnitude", 10.0))
    v_flip = str(cfg.get("dataset", "")).lower() != "rockfall_simulator"
    dataset = cfg.get("dataset")

    def on_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    # 1. Projection (rgb_guided.py:2284).
    K_t = intrinsic if tgt_intrinsic is None else tgt_intrinsic
    uv_s, _, val_s = project_points(on_dev(src_core), on_dev(src_extrinsic), on_dev(intrinsic),
                                    image_size, v_flip=v_flip)
    uv_t, _, val_t = project_points(on_dev(tgt_core), on_dev(tgt_extrinsic), on_dev(K_t),
                                    image_size, v_flip=v_flip)
    if logger:
        logger.info("tile %s: %d/%d src and %d/%d tgt points project in-image", tile_id,
                    int(val_s.sum()), len(src_core), int(val_t.sum()), len(tgt_core))

    # 2. Dense 2D matching (rgb_guided.py:2063).
    if corres_2d is None:
        corres_2d = match_epoch_images(src_image, tgt_image, **matcher_options(cfg), logger=logger,
                                       weights=cfg.get("img_matcher_weights"), device=dev)
    timer.mark("match_2d")
    if logger:
        logger.info("tile %s: %d 2D matches", tile_id, len(corres_2d))
    if bool(cfg.get("save_img_matching_visualization", False)) and len(corres_2d):
        # Reference rgb_guided.py:2269-2279 (make_matching_figure JPG).
        save_matching_figure(
            src_image, tgt_image, np.asarray(corres_2d),
            osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")),
                     "img_matching_results", "visualization", f"tile_{tile_id}.jpg"),
            text=f"tile {tile_id}")
        timer.mark("figures")
    corres_2d = np.asarray(corres_2d, np.float32).reshape(-1, 4)

    center = src_core.mean(axis=0)
    s = (src_core - center).astype(np.float32)
    t = (tgt_core - center).astype(np.float32)
    results_dir = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")),
                           "results")
    os.makedirs(results_dir, exist_ok=True)
    none = {"sampler": 0, "grid_knn": 0}
    if len(corres_2d) == 0:
        if logger:
            logger.warning("tile %s: no 2D matches — emitting empty results", tile_id)
        save_txt(osp.join(results_dir, f"rgb_guided_wo_refinement_dvfms_tile_{tile_id}.txt"),
                 np.zeros((0, 4)))
        return {"dvfs": np.zeros((0, 6)), "n_matches": 0, "overflow_by_source": none}

    # 3. Pixel-NN chaining (rgb_guided.py:1096-1100), magnitude prune.
    tgt_idx, valid = chain_2d_matches_to_3d(on_dev(corres_2d), uv_s, uv_t, pixel_thres,
                                            src_valid=val_s, tgt_valid=val_t)
    tgt_match = t[tgt_idx.cpu().numpy()]
    mag = np.linalg.norm(tgt_match - s, axis=1)
    matched = valid.cpu().numpy() & (mag <= max_mag)
    timer.mark("chain_2d")
    if logger:
        logger.info("tile %s: %d/%d points lifted to 3D matches", tile_id, int(matched.sum()),
                    len(s))
    wo = np.hstack([src_core[matched], mag[matched][:, None]])

    # 4. Segmentation (rgb_guided.py:868-931); segments with > 10 matches.
    s_d = torch.from_numpy(s).to(dev)
    med, med_overflow = median_nn_distance_counted(s_d)
    median_res = float(med)
    clustering = str(cfg.get("clustering_type", "supervoxel")).lower()
    overflow = dict(none, grid_knn=med_overflow)
    if clustering == "hdbscan":
        from fusion4landslide_tpu_torch.ops.clustering import hdbscan_labels

        labels = hdbscan_labels(s, min_cluster_size=int(cfg.get("hdbscan_min_cluster_size", 10)),
                                min_samples=int(cfg.get("hdbscan_min_samples", 1000)))
        n_lab = int(labels.max()) + 1 if labels.max() >= 0 else 0
    else:
        svl_radius = max(float(np.sqrt(3) * 10.0 * median_res),
                         float(cfg.get("voxel_size", 0.0) or 0.0))
        seg = supervoxel_segmentation(s_d, svl_radius, k_neighbors=int(cfg.get("n_normals", 30)))
        labels = seg.labels.cpu().numpy()
        n_lab = int(seg.n_supervoxels)
        overflow["sampler"] += int(seg.overflow)
    match_counts = np.bincount(labels[(labels >= 0) & matched], minlength=max(n_lab, 1))
    keep_lab = match_counts > 10
    remap = np.full(max(n_lab, 1), -1)
    remap[keep_lab] = np.arange(keep_lab.sum())
    labels = np.where(labels >= 0, remap[np.clip(labels, 0, None)], -1)
    n_kept = int(keep_lab.sum())
    timer.mark("segmentation")
    if logger:
        logger.info("tile %s: %d/%d supervoxels with >10 matches", tile_id, n_kept, n_lab)

    # 5. Rigid refinement, then every point of a quality supervoxel moves.
    dvfs = np.zeros((0, 6))
    quality = np.zeros((0,), bool)
    if n_kept > 0:
        counts = np.bincount(labels[labels >= 0], minlength=n_kept)
        members, member_mask = label_members(torch.from_numpy(labels.astype(np.int32)).to(dev),
                                             bucket_size(n_kept), bucket_size(int(counts.max())))
        ref = refine_supervoxels_rigid(
            members, member_mask, torch.from_numpy(matched).to(dev), s_d,
            torch.from_numpy(np.ascontiguousarray(tgt_match)).to(dev),
            icp_threshold=float(cfg.get("icp_threshold", cfg.get("threshold", 0.1))),
            icp_type=str(cfg.get("icp_type", "point2point")),
            icp_max_iter=30 if bool(cfg.get("icp_refine", True)) else 0,
        )
        Rs, ts = ref.R.cpu().numpy(), ref.t.cpu().numpy()
        quality = ref.quality.cpu().numpy()
        lbl = np.clip(labels, 0, None)
        has = (labels >= 0) & quality[lbl]
        moved = np.einsum("nij,nj->ni", Rs[lbl], s) + ts[lbl]
        dvfs = np.hstack([src_core[has], moved[has] + center])
    timer.mark("refine")
    write_rgb_guided_tables(results_dir, tile_id, wo, dvfs, dataset)
    timer.mark("write_tables")
    return {
        "dvfs": dvfs,
        "n_matches": int(matched.sum()),
        "n_supervoxels": n_kept,
        "corres_2d": corres_2d,
        "matched": matched,
        "quality": quality[:n_kept],
        "overflow_by_source": overflow,
    }
