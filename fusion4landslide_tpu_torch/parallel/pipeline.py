"""Single-GPU tile runner for the 3D-only fusion step.

Port of ``fusion4landslide_tpu.parallel.pipeline.run_fusion3d_tiles_sharded``
for one device: the JAX mesh runs tiles with no collectives, so the
multi-GPU form is one such tile stream per GPU. Statics are derived from
the config exactly as the JAX runner derives them; each tile is centred on
its source mean, padded to its bucket, run through
``fusion3d_tile_step``, and its ``c2f_*`` result tables are written.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.io.results import (
    dvf_magnitudes,
    save_dvfms,
    save_txt,
    visual_clamp_magnitude,
)
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

__all__ = ["fusion3d_statics", "run_fusion3d_tiles"]


def fusion3d_statics(cfg: dict, N: int, M: int) -> dict:
    """Static step options from a flat config dict (the JAX runner's
    derivation, ``parallel/pipeline.py:388-421``)."""
    if str(cfg.get("partition_type", "supervoxel")) == "superpoint":
        raise NotImplementedError("partition_type 'superpoint' is not ported yet")
    if bool(cfg.get("use_2d_matches", False)):
        raise NotImplementedError("the RGB 2D-match channel is not ported yet")
    sv_cap = int(cfg.get("sv_cap", 0)) or max(bucket_size(max(N // 16, 1)), 64)
    sv_cap_t = int(cfg.get("sv_cap_tgt", 0)) or max(bucket_size(max(M // 16, 1)), 64)
    member_cap = int(cfg.get("member_cap", 0)) or 512
    return dict(
        levels=tuple(int(v) for v in (cfg.get("level_of_superpoint") or [1])),
        patch_points=int(cfg.get("feat_patch_points", 256)),
        feat_dtype=cfg.get("feat_dtype"),
        chunk=min(int(cfg.get("feat_chunk", 2048)), N),
        sv_cap=sv_cap,
        sv_cap_tgt=sv_cap_t,
        member_cap=member_cap,
        agg_max_points=min(int(cfg.get("agg_max_points", 512)), member_cap),
        small_patch=int(cfg.get("num_min_matches_for_small_patch", 10)),
        icp_type=str(cfg.get("icp_type", "point2point")),
        icp_max_iter=30 if bool(cfg.get("icp_refine", True)) else 0,
        coarse_mutual=str(cfg.get("coarse_refinement_3d_type", "nn_mutual")) != "only_max_mag",
        global_gated=bool(cfg.get("global_matching_gated", True)),
        with_sparse=str(cfg.get("assign_type", "assign_then_nn")) == "assign_then_nn",
        with_tgt2src=bool(cfg.get("output_tgt2src", False)),
        fine_max_matches=int(cfg.get("fine_max_matches", 256)) or (1 << 30),
    )


def run_fusion3d_tiles(cfg: dict, dips, agg, tiles, *, device=None,
                       n_bucket: int | None = None, m_bucket: int | None = None,
                       logger=None, timings: dict | None = None) -> dict:
    """Process (tile_id, src (n, 3), tgt (m, 3)) tiles one after another
    on one device and write the ``c2f_*`` result tables under
    ``<output_dir>/<output_folder>/results``.

    Returns {tile_id: {"dvfs", "valid", "assigned_fraction", "n_dropped",
    "overflow"}}. ``timings`` (optional dict) collects per-stage seconds
    of the step, synchronised at each stage boundary.
    """
    dev = resolve_device(device)
    tiles = list(tiles)
    if not tiles:
        return {}
    N = n_bucket or bucket_size(max(t[1].shape[0] for t in tiles))
    M = m_bucket or bucket_size(max(t[2].shape[0] for t in tiles))
    statics = fusion3d_statics(cfg, N, M)
    remove_low = bool(cfg.get("remove_low_quality_patch_matches", True))
    scalars = dict(
        max_magnitude=float(cfg.get("max_magnitude", 10.0)),
        icp_threshold=float(cfg.get("icp_threshold", 0.1)),
        voxel_size_init=float(cfg.get("voxel_size_init", 0.0) or 0.0),
        num_min_fine=int(cfg.get("num_min_fine_match", 10)),
        num_min_quality=int(cfg.get("num_min_matches_for_quality_check", 10)),
        thres_dist_diff=float(cfg.get("thres_dist_diff", 0.5)) if remove_low else float("inf"),
        thres_inlier_ratio=float(cfg.get("thres_inlier_ratio", 0.15)) if remove_low else 0.0,
    )
    out_root = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")))
    results_dir = osp.join(out_root, "results")
    os.makedirs(results_dir, exist_ok=True)
    dips = dips.to(dev).eval()
    agg = agg.to(dev).eval()

    results: dict = {}
    for tile_id, src, tgt in tiles:
        n, m = src.shape[0], tgt.shape[0]
        center = src.mean(axis=0)
        sb = np.zeros((N, 3), np.float32)
        sb[:n] = src - center
        tb = np.zeros((M, 3), np.float32)
        tb[:m] = tgt - center
        out = fusion3d_tile_step(
            dips, agg,
            torch.from_numpy(sb).to(dev), torch.arange(N, device=dev) < n,
            torch.from_numpy(tb).to(dev), torch.arange(M, device=dev) < m,
            timings=timings, device=dev, **scalars, **statics,
        )
        valid = out.valid[:n].cpu().numpy()
        moved = out.moved[:n].cpu().numpy()
        n_dropped = int(out.n_dropped)
        if n_dropped and logger:
            logger.warning(
                "tile %s: %d voxels exceeded the supervoxel caps (sv_cap=%d, member_cap=%d)",
                tile_id, n_dropped, statics["sv_cap"], statics["member_cap"],
            )
        dvfs_dense = np.hstack([src[valid], moved[valid] + center])
        save_txt(osp.join(results_dir, f"c2f_dvfs_src2tgt_tile_{tile_id}.txt"), dvfs_dense)
        dvfms = save_dvfms(
            osp.join(results_dir, f"c2f_dvfms_src2tgt_tile_{tile_id}.txt"), dvfs_dense
        )
        if dvfms.shape[0] > 2:
            save_txt(
                osp.join(results_dir, f"c2f_dvfms_src2tgt_visualize_tile_{tile_id}.txt"),
                visual_clamp_magnitude(dvfms, cfg.get("dataset")),
            )
        if statics["with_sparse"]:
            ok = out.sparse_ok[:n].cpu().numpy()
            dvfs_sparse = np.hstack([src[ok], out.sparse_tgt[:n].cpu().numpy()[ok] + center])
            if dvfs_sparse.shape[0]:
                sparse_ms = np.hstack([dvfs_sparse[:, :3], dvf_magnitudes(dvfs_sparse)[:, None]])
                save_txt(
                    osp.join(results_dir,
                             f"c2f_dvfms_src2tgt_discrete_visualize_tile_{tile_id}.txt"),
                    visual_clamp_magnitude(sparse_ms, cfg.get("dataset")),
                )
        if statics["with_tgt2src"]:
            tok = out.t2s_valid[:m].cpu().numpy()
            src_est = out.t2s_src_est[:m].cpu().numpy()[tok] + center
            t2s = np.hstack([src_est, tgt[tok]])
            save_txt(
                osp.join(results_dir, f"c2f_dvfms_tgt2src_tile_{tile_id}.txt"),
                np.hstack([t2s[:, 3:6], dvf_magnitudes(t2s)[:, None]]),
            )
        if logger:
            logger.info(
                "tile %s (fusion_3d): %.1f%% of src points assigned, %d/%d voxels",
                tile_id, 100.0 * float(valid.mean()) if n else 0.0, int(out.n_vox_src), n,
            )
        results[tile_id] = {
            "dvfs": dvfs_dense,
            "valid": valid,
            "assigned_fraction": float(valid.mean()) if n else 0.0,
            "n_dropped": n_dropped,
            "overflow": int(out.overflow),
        }
    return results
