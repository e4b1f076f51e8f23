"""The fusion method's matching stages and its host-orchestrated tile.

Port of ``fusion4landslide_tpu.pipelines.fusion``:

- ``global_matches_3d`` (the ungated search-then-gate feature 1-NN on
  kernel 3, reference base:2756-2889), ``coarse_match_superpoints``
  (superpoint mutual matching under the magnitude gate, base:2966-2999,
  scanned over target chunks), ``aggregate_superpoints`` (re-exported
  from ``models.aggregation``: ClusterFeatureNet over member buckets,
  base:2561-2656),
  ``coarse_match_2d_votes`` (base:3019-3070) and ``fine_match_pairs``
  (quality gate + SVD + ICP, base:3254-3436, with one correspondence
  channel or two: 3D matches and 3D matches lifted from 2D pixel matches,
  base:3258-3296), shared with the device step;
- ``run_fusion3d_tile`` / ``run_fusion_tile``: the host tile that
  ``main_fusion`` runs per tile on one device (3D-only, or RGB+3D with
  precomputed pixel matches or the image matcher over one or more image
  pairs): unpadded clouds, numpy bookkeeping between the stages, the same
  ``c2f_*`` tables as the runner.

``partition_type: superpoint`` takes each level's labels per tile point
from the reference's 15-column table (``ops/partition_io.py``, generated
by ``ops/superpoint.py`` when absent), gives each voxel its first point's
label and dedups the per-level output tables with the reference's
distance threshold (``ops/merge.py``). ``icp_type`` selects the fine
stage's solver (``ops/registration.py::icp_by_type``).

The reference's figures (``visualize_patch``,
``visualize_matches_within_patch``, ``save_img_matching_visualization``)
are written by ``utils/visualization.py`` where the JAX host tile writes
them; a tile that asks for them without matplotlib raises ``ImportError``
before any work.

DIPs options as in the JAX host tile: ``feat_patch_points`` (a multiple
of 128 runs kernel 1; any other size the exact-kNN branch with
``feat_k_max`` neighbours and one (chunk, k_max) draw of priorities per
chunk), ``feat_chunk`` and ``feat_dtype`` ('bfloat16' runs the PointNet
trunks in bf16). The draws are ``dips_draws`` (source, target
``DipsDraws``) or come from a ``torch.Generator`` seeded with
``rng_seed``.
"""

from __future__ import annotations

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.geometry import (
    chain_2d_matches_to_3d,
    lift_matches_to_3d,
    project_points,
    rasterize_depth,
)
from fusion4landslide_tpu_torch.image.matching import match_epoch_images, matcher_options
from fusion4landslide_tpu_torch.io.results import dvf_magnitudes, save_txt, visual_clamp_magnitude
from fusion4landslide_tpu_torch.ops.gated_match import gated_feature_nn1
from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, hash_grid_knn
from fusion4landslide_tpu_torch.ops.kabsch import weighted_kabsch
from fusion4landslide_tpu_torch.ops.knn import median_nn_distance, nn1, nn1_xla_rounded
from fusion4landslide_tpu_torch.ops.merge import merge_correspondences_by_priority
from fusion4landslide_tpu_torch.ops.normals import pca_normals
from fusion4landslide_tpu_torch.ops.partition_io import load_or_generate_partition_labels
from fusion4landslide_tpu_torch.ops.registration import icp_by_type
from fusion4landslide_tpu_torch.ops.segments import bucket_size, label_members
from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_graph, supervoxel_segmentation
from fusion4landslide_tpu_torch.ops.voxel import voxel_downsample
from fusion4landslide_tpu_torch.pipelines.driver import load_or_compute_features
from fusion4landslide_tpu_torch.models.aggregation import aggregate_superpoints
from fusion4landslide_tpu_torch.models.dips import feat_torch_dtype
from fusion4landslide_tpu_torch.pipelines.f2s3 import compute_dips_features
from fusion4landslide_tpu_torch.utils.timing import StageTimer
from fusion4landslide_tpu_torch.utils.visualization import (
    FIGURE_KEYS,
    patch_visualization_requests,
    require_matplotlib,
    save_matches_within_patch_figure,
    save_matching_figure,
    save_patch_match_figure,
)

__all__ = [
    "FinePairResult",
    "aggregate_superpoints",
    "coarse_match_2d_votes",
    "coarse_match_superpoints",
    "fine_match_pairs",
    "global_matches_3d",
    "run_fusion3d_tile",
    "run_fusion_tile",
]


def global_matches_3d(src_vox_feat, tgt_vox_feat, src_vox, tgt_vox, max_magnitude,
                      src_valid=None, tgt_valid=None):
    """Feature-space 1-NN voxel matches (kernel 3), gated by displacement
    magnitude: (tgt_idx (Vs,) int32, valid (Vs,)). The JAX function pads
    its inputs to bucket sizes for compile reuse; padding changes no row
    of the result (padded refs are masked), so none is added here."""
    n = src_vox_feat.shape[0]
    dev = src_vox_feat.device
    sv = (
        torch.ones((n,), dtype=torch.bool, device=dev)
        if src_valid is None
        else src_valid.to(torch.bool)
    )
    sqd, idx = nn1(src_vox_feat, tgt_vox_feat, tgt_valid)
    mag = torch.linalg.norm(src_vox - tgt_vox[idx.long()], dim=-1)
    valid = torch.isfinite(sqd) & (mag <= max_magnitude) & sv
    return idx, valid


def coarse_match_superpoints(feat_s, coord_s, valid_s, feat_t, coord_t, valid_t,
                             max_magnitude, *, chunk: int = 2048, mutual: bool = True):
    """Superpoint matching (base:2966-2999): feature distances with
    centroid pairs farther than ``max_magnitude`` masked to +inf, argmin
    per source superpoint, optional mutual check; scanned over target
    chunks so only an (S, chunk) slab is live. Returns (tgt_idx, valid)."""
    S, Q = feat_s.shape[0], feat_t.shape[0]
    dev = feat_s.device
    chunk = min(chunk, max(Q, 1))
    s2 = (feat_s**2).sum(-1)
    vs = valid_s.to(torch.bool)
    vt = valid_t.to(torch.bool)
    mm2 = torch.as_tensor(max_magnitude, dtype=feat_s.dtype, device=dev) ** 2
    best_d = torch.full((S,), torch.inf, dtype=feat_s.dtype, device=dev)
    best_i = torch.zeros((S,), dtype=torch.int64, device=dev)
    src_of_tgt = []
    for base in range(0, Q, chunk):
        ftc, ctc, vtc = feat_t[base:base + chunk], coord_t[base:base + chunk], vt[base:base + chunk]
        f2 = s2[:, None] - 2.0 * (feat_s @ ftc.T) + (ftc**2).sum(-1)[None, :]
        c2 = None
        for d in range(3):
            cd = coord_s[:, None, d] - ctc[None, :, d]
            c2 = cd * cd if c2 is None else c2 + cd * cd
        bad = (c2 > mm2) | ~vs[:, None] | ~vtc[None, :]
        dist = torch.where(bad, torch.inf, f2)
        m, a = dist.min(dim=1)
        upd = m < best_d
        best_d = torch.where(upd, m, best_d)
        best_i = torch.where(upd, a + base, best_i)
        src_of_tgt.append(dist.argmin(dim=0))
    src_of_tgt = torch.cat(src_of_tgt)
    valid = torch.isfinite(best_d)
    if mutual:
        valid = valid & (src_of_tgt[best_i] == torch.arange(S, device=dev))
    return best_i.to(torch.int32), valid


class FinePairResult(NamedTuple):
    R: torch.Tensor  # (Pairs, 3, 3)
    t: torch.Tensor  # (Pairs, 3)
    rmse: torch.Tensor  # (Pairs,)
    valid: torch.Tensor  # (Pairs,)
    n_matches: torch.Tensor  # (Pairs,)


def _solve_pairs(members, mmask, tgt_label, corres_tgt_idx, corres_valid,
                 tgt_vox_label, src_vox, tgt_vox, *, corres2_tgt_idx,
                 corres2_valid, weighting, num_min_quality, thres_dist_diff,
                 thres_inlier_ratio, num_min_fine, icp_threshold, icp_max_iter,
                 icp_type, fine_max_matches, iso_cap):
    Pc, P = members.shape
    dev, f32 = src_vox.device, src_vox.dtype
    ml = members.long()

    def channel(idx, ok):
        w = idx[ml].long()
        return w, mmask & ok[ml] & (tgt_vox_label[w] == tgt_label[:, None])

    w, mv = channel(corres_tgt_idx, corres_valid)
    all_src = ml
    if corres2_tgt_idx is not None:
        # Each member adds up to two matches: the member list, then itself
        # again with the second channel's targets (base:3273-3275).
        w2, mv2 = channel(corres2_tgt_idx, corres2_valid)
        n3, n2 = mv.sum(-1), mv2.sum(-1)
        all_src = torch.cat([ml, ml], dim=1)
        w = torch.cat([w, w2], dim=1)
        mv = torch.cat([mv, mv2], dim=1)
    L = all_src.shape[1]
    n_match = mv.sum(-1)

    # Compact to the matched correspondences first (the reference only
    # feeds matched ones, base:3259-3274): matched in list order, then the
    # unmatched ones — the order lax.top_k gives the JAX key
    # ``mv - j * 1e-9`` (a key full of float32 ties at small j, which
    # top_k breaks to the lowest position: a stable sort, not torch.topk).
    F = min(L, int(fine_max_matches))
    sel = torch.sort((~mv).to(torch.int8), dim=1, stable=True).indices[:, :F]
    mv = torch.gather(mv, 1, sel)
    src_m = src_vox[torch.gather(all_src, 1, sel)]
    tgt_m = tgt_vox[torch.gather(w, 1, sel)]
    wts = mv.to(f32)
    if corres2_tgt_idx is not None and weighting:
        # weighting_svd (base:3283-3293): 3D matches weigh n3 / (n3 + n2),
        # 2D matches the complement.
        w3d = (n3.to(f32) / torch.clamp(n3 + n2, min=1).to(f32))[:, None]
        wts = torch.where(sel < P, w3d, 1.0 - w3d) * wts

    # Isometry quality gate (base:3310-3323) on iso_cap matches sampled
    # with an even stride across the matched prefix.
    Fi = min(F, int(iso_cap))
    n_comp = torch.clamp(n_match, max=F)
    ar = torch.arange(Fi, device=dev)
    stride_pos = (ar.to(f32)[None] * (n_comp.to(f32) / Fi)[:, None]).to(torch.int64)
    pos = torch.where((n_comp > Fi)[:, None], stride_pos, ar[None])
    pos = torch.clamp(pos, 0, F - 1)
    s_i = torch.gather(src_m, 1, pos[..., None].expand(Pc, Fi, 3))
    t_i = torch.gather(tgt_m, 1, pos[..., None].expand(Pc, Fi, 3))
    m_i = torch.gather(mv, 1, pos)

    def pd2(x):
        out = None
        for d in range(3):
            cd = x[:, :, None, d] - x[:, None, :, d]
            out = cd * cd if out is None else out + cd * cd
        return torch.sqrt(torch.clamp(out, min=0.0))

    diff = torch.abs(pd2(s_i) - pd2(t_i))
    off_diag = ~torch.eye(Fi, dtype=torch.bool, device=dev)
    wgt = (m_i[:, :, None] & m_i[:, None, :] & off_diag).to(f32)
    n_off = torch.clamp(wgt.sum((1, 2)), min=1.0)
    dist_mean = (diff * wgt).sum((1, 2)) / n_off
    ratio_inlier = ((diff <= thres_dist_diff) * wgt).sum((1, 2)) / n_off
    quality_ok = torch.where(
        n_match >= num_min_quality,
        (ratio_inlier > thres_inlier_ratio) & (dist_mean < thres_dist_diff),
        True,
    )

    R0, t0, _, _ = weighted_kabsch(src_m, tgt_m, wts)
    icp = icp_by_type(
        icp_type, src_m, tgt_m, icp_threshold, src_mask=mv, tgt_mask=mv,
        max_iter=icp_max_iter, R_init=R0, t_init=t0,
    )
    valid = quality_ok & (n_match >= num_min_fine)
    return icp.R, icp.t, icp.inlier_rmse, valid, n_match.to(torch.int32)


def fine_match_pairs(src_members, src_member_mask, pair_tgt_label,
                     corres_tgt_idx, corres_valid, tgt_vox_label, src_vox,
                     tgt_vox, *, corres2_tgt_idx=None, corres2_valid=None,
                     weighting: bool = False, num_min_quality=10, thres_dist_diff=0.5,
                     thres_inlier_ratio=0.15, num_min_fine=10,
                     icp_threshold=0.1, icp_max_iter: int = 30,
                     icp_type: str = "point2point", pair_chunk: int = 1024,
                     fine_max_matches: int = 1024,
                     iso_cap: int = 128) -> FinePairResult:
    """Per patch pair (rows of ``src_members``): matched-correspondence
    compaction, isometry quality gate, weighted-Kabsch seed, ICP.

    ``corres2_*`` (per source voxel: target voxel, valid) is a second
    correspondence channel (the fusion method's 3D matches from 2D pixel
    matches); ``weighting`` weighs the two in the Kabsch seed as
    ``weighting_svd`` does (ICP takes the matches unweighted).

    Dead pairs (label -1 or empty member mask) solve to exactly
    (I, 0, rmse 0, valid False, 0 matches) and are not computed: only live
    pairs go through the solver, ``pair_chunk`` at a time."""
    Pairs = src_members.shape[0]
    dev, f32 = src_vox.device, src_vox.dtype
    R = torch.eye(3, dtype=f32, device=dev).repeat(Pairs, 1, 1)
    t = torch.zeros((Pairs, 3), dtype=f32, device=dev)
    rmse = torch.zeros((Pairs,), dtype=f32, device=dev)
    valid = torch.zeros((Pairs,), dtype=torch.bool, device=dev)
    n_match = torch.zeros((Pairs,), dtype=torch.int32, device=dev)
    live = torch.nonzero((pair_tgt_label >= 0) & src_member_mask.any(-1)).squeeze(1)
    for c0 in range(0, live.shape[0], pair_chunk):
        idx = live[c0:c0 + pair_chunk]
        out = _solve_pairs(
            src_members[idx], src_member_mask[idx], pair_tgt_label[idx],
            corres_tgt_idx, corres_valid, tgt_vox_label, src_vox, tgt_vox,
            corres2_tgt_idx=corres2_tgt_idx, corres2_valid=corres2_valid,
            weighting=weighting, num_min_quality=num_min_quality, thres_dist_diff=thres_dist_diff,
            thres_inlier_ratio=thres_inlier_ratio, num_min_fine=num_min_fine,
            icp_threshold=icp_threshold, icp_max_iter=icp_max_iter,
            icp_type=icp_type, fine_max_matches=fine_max_matches,
            iso_cap=iso_cap,
        )
        R[idx], t[idx], rmse[idx], valid[idx], n_match[idx] = out
    return FinePairResult(R=R, t=t, rmse=rmse, valid=valid, n_matches=n_match)


def _first_point_of_voxel(p2v: np.ndarray, n_vox: int) -> np.ndarray:
    """(n_vox,) lowest point index of each voxel (0 for an empty one)."""
    first = np.zeros(n_vox, np.int64)
    rev = p2v[::-1]
    sel = rev < n_vox
    first[rev[sel]] = np.arange(len(p2v))[::-1][sel]
    return first


def _compact_labels(labels: np.ndarray, min_count: int) -> tuple[np.ndarray, int]:
    """Drop labels with <= min_count members and compact the rest to
    0..K-1 in label order (small-patch removal, base:1309-1321)."""
    labels = np.asarray(labels)
    if labels.max() < 0:
        return np.full_like(labels, -1), 0
    counts = np.bincount(labels[labels >= 0])
    keep = counts > min_count
    remap = np.full(counts.size, -1)
    remap[keep] = np.arange(keep.sum())
    return np.where(labels >= 0, remap[np.clip(labels, 0, None)], -1), int(keep.sum())


def coarse_match_2d_votes(lab_s: np.ndarray, lab_t: np.ndarray, c2d_idx: np.ndarray,
                          c2d_valid: np.ndarray, n_s: int, n_t: int,
                          min_votes: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Majority vote of per-voxel 2D matches into target superpoints
    (base:3019-3070): each source voxel with a valid 2D match votes for
    its matched target voxel's superpoint; each source superpoint takes
    the most-voted one (ties to the lowest label). Returns
    (tgt_label_of_src_label (n_s,), valid (n_s,))."""
    ok = c2d_valid & (lab_s >= 0)
    tlab = lab_t[np.clip(c2d_idx, 0, max(len(lab_t) - 1, 0))]
    ok = ok & (tlab >= 0)
    votes = np.zeros((n_s, n_t), np.int32)
    np.add.at(votes, (lab_s[ok], tlab[ok]), 1)
    best = votes.argmax(axis=1)
    return best, votes[np.arange(n_s), best] >= max(min_votes, 1)


def _check_ported(cfg, image_data) -> None:
    """Raise before tile work for an unknown ``feat_dtype``, for figures
    without matplotlib, and for an RGB tile without an image size."""
    feat_torch_dtype(cfg.get("feat_dtype"))
    require_matplotlib(cfg, ("visualize_patch",) if image_data is None else FIGURE_KEYS)
    if image_data is None:
        return
    if not cfg.get("image_size") and image_data.get("src_image") is None:
        raise ValueError("image_size is not in the config and no source image was given")


def _patch_figures(cfg, out_root, tile_id, level, center, src_vox, tgt_vox, lab_s, lab_t,
                   pair_src, pair_tgt, ch1_idx, ch1_valid, rng_seed: int) -> None:
    """The reference's ``visualize_patch`` / ``visualize_matches_within_patch``
    figures of one level's coarse pairs (base:3159-3231, :4279-4403) under
    ``<run>/visualization``, as the JAX host tile writes them; with
    ``random_choice`` the pairs are drawn with the tile's ``rng_seed``."""
    vis_idx = patch_visualization_requests(cfg, len(pair_src), seed=rng_seed)
    if not len(vis_idx):
        return
    vis_dir = osp.join(out_root, "visualization")
    off = tuple(cfg.get("offset") or (75.0, 75.0, 75.0))
    small = cfg.get("small_region")
    within = bool(cfg.get("visualize_matches_within_patch", False))
    ch1_idx, ch1_valid = np.asarray(ch1_idx), np.asarray(ch1_valid)
    for k in vis_idx:
        ps, pt = int(pair_src[k]), int(pair_tgt[k])
        p_s = src_vox[lab_s == ps] + center
        p_t = tgt_vox[lab_t == pt] + center
        save_patch_match_figure(
            src_vox + center, tgt_vox + center, p_s, p_t,
            osp.join(vis_dir, f"patch_match_tile_{tile_id}_l{level}_{k}.png"), offset=off,
            small_region=float(small) if small is not None else None)
        if within:
            sel = (lab_s == ps) & ch1_valid & (lab_t[np.clip(ch1_idx, 0, None)] == pt)
            save_matches_within_patch_figure(
                p_s, p_t, src_vox[sel] + center, tgt_vox[ch1_idx[sel]] + center,
                osp.join(vis_dir, f"matches_within_patch_tile_{tile_id}_l{level}_{k}.png"))


def run_fusion3d_tile(cfg, dips, agg, src_core: np.ndarray, tgt_core: np.ndarray, *,
                      src_halo: np.ndarray | None = None, tgt_halo: np.ndarray | None = None,
                      tile_id=0, logger=None, device=None, timings: dict | None = None,
                      rng_seed: int = 0, dips_draws=None) -> dict:
    """One tile of the fusion_3d method (use_2d_matches=False), host
    orchestrated: what ``main_fusion.py`` runs per tile on one device.
    ``cfg`` keys follow ``configs/landslide/fusion_3d_brienz.yaml``; runs
    on ``device`` (default ``cuda``). ``timings`` (optional dict) collects
    per-stage seconds, synchronised at each stage boundary. ``rng_seed``
    / ``dips_draws``: the DIPs draws (module docstring)."""
    return _fusion_tile_core(cfg, dips, agg, src_core, tgt_core, image_data=None,
                             src_halo=src_halo, tgt_halo=tgt_halo, tile_id=tile_id,
                             logger=logger, device=device, timings=timings,
                             rng_seed=rng_seed, dips_draws=dips_draws)


def run_fusion_tile(cfg, dips, agg, src_core: np.ndarray, tgt_core: np.ndarray,
                    src_image: np.ndarray | None, tgt_image: np.ndarray | None,
                    intrinsic: np.ndarray, src_extrinsic: np.ndarray,
                    tgt_extrinsic: np.ndarray, *, corres_2d: np.ndarray | None = None,
                    src_images: list | None = None, tgt_images: list | None = None,
                    src_extrinsics: list | None = None, tgt_extrinsics: list | None = None,
                    src_halo: np.ndarray | None = None, tgt_halo: np.ndarray | None = None,
                    tile_id=0, logger=None, device=None, timings: dict | None = None,
                    rng_seed: int = 0, dips_draws=None) -> dict:
    """One tile of the RGB+3D fusion method (use_2d_matches=True), host
    orchestrated: learned 3D matches fused with 3D matches chained from
    pixel matches, at the coarse vote (base:3015-3070) and the fine solve
    (base:3258-3296). ``corres_2d`` injects precomputed (M, 4) matches of
    the one image pair (the reference's ``img_matching_result_dir``);
    otherwise the configured matcher (``img_matching_type``) runs on every
    pair of ``src_images`` x ``tgt_images`` (default the one pair, with
    ``src_extrinsics`` / ``tgt_extrinsics`` aligned, best camera first),
    and the pairs' matches merge by fill-in (base:1697-1953). Without
    ``image_size`` in the config it is the source image's size.
    ``rng_seed`` / ``dips_draws``: the DIPs draws (module docstring)."""
    image_data = {
        "src_image": src_image,
        "intrinsic": np.asarray(intrinsic, np.float32),
        "corres_2d": corres_2d,
        "src_images": src_images or [src_image],
        "tgt_images": tgt_images or [tgt_image],
        "src_extrinsics": [np.asarray(e, np.float32)
                           for e in (src_extrinsics or [src_extrinsic])],
        "tgt_extrinsics": [np.asarray(e, np.float32)
                           for e in (tgt_extrinsics or [tgt_extrinsic])],
    }
    return _fusion_tile_core(cfg, dips, agg, src_core, tgt_core, image_data=image_data,
                             src_halo=src_halo, tgt_halo=tgt_halo, tile_id=tile_id,
                             logger=logger, device=device, timings=timings,
                             rng_seed=rng_seed, dips_draws=dips_draws)


def _interim_table(src_vox, tgt_vox, idx, valid, center, dataset) -> np.ndarray:
    """Pre-pruning magnitudes of voxel matches, clamped for display."""
    rows = np.hstack([
        src_vox[valid] + center,
        np.linalg.norm(tgt_vox[idx[valid]] - src_vox[valid], axis=1)[:, None],
    ])
    return visual_clamp_magnitude(rows, dataset)


@torch.inference_mode()
def _fusion_tile_core(cfg, dips, agg, src_core: np.ndarray, tgt_core: np.ndarray, *,
                      image_data: dict | None, src_halo: np.ndarray | None,
                      tgt_halo: np.ndarray | None, tile_id, logger, device,
                      timings: dict | None, rng_seed: int = 0, dips_draws=None) -> dict:
    """The coarse-to-fine tile solve of ``fusion4landslide_tpu.pipelines.
    fusion._fusion_tile_core``; the 2D-match channel runs when
    ``image_data`` is given. Stages: median resolution, voxel subsampling
    on one shared origin, DIPs descriptors on the voxel clouds (the
    ``features_tile_*.npz`` cache), global 3D matches, the 2D channel,
    then per level: partition, members, aggregation, coarse matching
    (with 2D votes), fine SVD + ICP, priority merge; dense output and the
    sparse re-association. The JAX key split at its start becomes the two
    clouds' ``dips_draws``, or one generator seeded with ``rng_seed``; only
    the exact-kNN DIPs branch draws."""
    _check_ported(cfg, image_data)
    dev = resolve_device(device)
    dips, agg = dips.to(dev).eval(), agg.to(dev).eval()
    timer = StageTimer({} if timings is None else timings, dev)
    src_halo = src_core if src_halo is None else src_halo
    tgt_halo = tgt_core if tgt_halo is None else tgt_halo

    def on_dev(a, dtype=None):
        if torch.is_tensor(a):
            return a.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    def log(msg, *args):
        if logger:
            logger.info(msg, *args)

    center = src_core.mean(axis=0)
    s = (src_core - center).astype(np.float32)
    t = (tgt_core - center).astype(np.float32)
    s_d, t_d = on_dev(s), on_dev(t)

    max_mag = float(cfg.get("max_magnitude", 10.0))
    icp_thr = float(cfg.get("icp_threshold", 0.1))
    icp_type = str(cfg.get("icp_type", "point2point"))
    # icp_refine: False returns the SVD transform (base:3346).
    icp_iter = 30 if bool(cfg.get("icp_refine", True)) else 0
    levels = list(cfg.get("level_of_superpoint", [1, 2, 3]) or [1])
    num_min_fine = int(cfg.get("num_min_fine_match", 10))
    # 0 uncaps the per-pair match subsample of the fine solve.
    fine_cap = int(cfg.get("fine_max_matches", 256)) or (1 << 30)
    num_min_quality = int(cfg.get("num_min_matches_for_quality_check", 10))
    thres_dd = float(cfg.get("thres_dist_diff", 0.5))
    thres_ir = float(cfg.get("thres_inlier_ratio", 0.15))
    if not bool(cfg.get("remove_low_quality_patch_matches", True)):
        thres_ir, thres_dd = 0.0, float("inf")  # the quality gate off (base:3299)
    mutual_3d = str(cfg.get("coarse_refinement_3d_type", "nn_mutual")) != "only_max_mag"
    small_patch = int(cfg.get("num_min_matches_for_small_patch", 10))
    assign_type = str(cfg.get("assign_type", "assign_then_nn"))
    out_tgt2src = bool(cfg.get("output_tgt2src", False))
    dataset = cfg.get("dataset")
    overflow = {"sampler": 0, "grid_knn": 0}  # window overflow by kernel

    # 1. median resolution and voxel subsampling on the clouds' shared min
    # corner (base:1012-1030).
    median_res = max(float(median_nn_distance(s_d)), float(median_nn_distance(t_d)))
    timer.mark("median_resolution")
    grid0 = on_dev(np.minimum(s.min(axis=0), t.min(axis=0)).astype(np.float32))
    s_cent, s_p2v, _, s_nv = voxel_downsample(s_d, median_res, origin=grid0)
    t_cent, t_p2v, _, t_nv = voxel_downsample(t_d, median_res, origin=grid0)
    s_nv, t_nv = int(s_nv), int(t_nv)
    src_vox_d, tgt_vox_d = s_cent[:s_nv].contiguous(), t_cent[:t_nv].contiguous()
    src_vox, tgt_vox = src_vox_d.cpu().numpy(), tgt_vox_d.cpu().numpy()
    s_p2v, t_p2v = s_p2v.cpu().numpy(), t_p2v.cpu().numpy()
    timer.mark("voxel_subsampling")
    log("tile %s: median_res=%.4f, voxels src=%d tgt=%d", tile_id, median_res, s_nv, t_nv)

    # 2. DIPs descriptors of the voxel clouds with patches from the halo
    # clouds (base:1965-2049), cached as features_tile_N.npz.
    radius = float(np.sqrt(3) * 10.0 * median_res)
    feat_kw = dict(k_max=int(cfg.get("feat_k_max", 512)),
                   patch_points=int(cfg.get("feat_patch_points", 256)),
                   chunk=int(cfg.get("feat_chunk", 2048)), dtype=cfg.get("feat_dtype"),
                   generator=torch.Generator(device=dev).manual_seed(rng_seed))
    draws_s, draws_t = dips_draws or (None, None)
    sh_d = on_dev((src_halo - center).astype(np.float32))
    th_d = on_dev((tgt_halo - center).astype(np.float32))
    dips_overflow = []

    def compute_feats():
        fs, ov_s = compute_dips_features(dips, src_vox_d, sh_d, radius, draws=draws_s, **feat_kw)
        ft, ov_t = compute_dips_features(dips, tgt_vox_d, th_d, radius, draws=draws_t, **feat_kw)
        dips_overflow.append(int(ov_s) + int(ov_t))
        return {"src_feat": fs, "tgt_feat": ft}

    feats = load_or_compute_features(cfg, tile_id, "features", compute_feats, logger)
    if feats["src_feat"].shape[0] != s_nv or feats["tgt_feat"].shape[0] != t_nv:
        if logger:
            logger.warning("cached features shape mismatch (%d/%d vs %d/%d voxels): recomputing",
                           feats["src_feat"].shape[0], feats["tgt_feat"].shape[0], s_nv, t_nv)
        feats = compute_feats()
    src_feat_d = on_dev(feats["src_feat"], torch.float32)
    tgt_feat_d = on_dev(feats["tgt_feat"], torch.float32)
    overflow["sampler"] += sum(dips_overflow)
    timer.mark("dips_features")

    # 3. Global 3D voxel matches: the banded magnitude-gated search by
    # default, the reference's search-then-gate (kernel 3) with
    # global_matching_gated: false (base:2756-2889).
    if bool(cfg.get("global_matching_gated", True)):
        nb_, mb_ = bucket_size(s_nv), bucket_size(t_nv)

        def pad(x, rows):
            return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])

        _, g_idx, g_valid = gated_feature_nn1(
            pad(src_feat_d, nb_), pad(tgt_feat_d, mb_), pad(src_vox_d, nb_),
            pad(tgt_vox_d, mb_), np.float32(max_mag),
            torch.arange(nb_, device=dev) < s_nv, torch.arange(mb_, device=dev) < t_nv,
        )
        g_idx, g_valid = g_idx[:s_nv], g_valid[:s_nv]
    else:
        g_idx, g_valid = global_matches_3d(src_feat_d, tgt_feat_d, src_vox_d, tgt_vox_d,
                                           max_mag)
    g_idx, g_valid = g_idx.cpu().numpy(), g_valid.cpu().numpy()
    timer.mark("global_3d_matches")

    out_root = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")))
    results_dir = osp.join(out_root, "results")
    os.makedirs(results_dir, exist_ok=True)

    # 3b. 3D voxel matches from the 2D pixel matches (base:1480-1675):
    # project both voxel clouds, chain (nn_search) or lift through depth
    # maps (interpolation), magnitude-gate; image pairs merge by fill-in.
    c2d_idx = c2d_valid = None
    if image_data is not None:
        image_size = tuple(int(x) for x in (cfg.get("image_size")
                                            or image_data["src_image"].shape[:2]))
        pixel_thres = float(cfg.get("pixel_thres", 5))
        v_flip = str(cfg.get("dataset", "")).lower() != "rockfall_simulator"
        lifting = str(cfg.get("lifting_type", "nn_search"))
        mode = str(cfg.get("matches_from_2d_type", "nn_src_only"))
        if mode == "nn_src_with_tgt_for_visualize":
            mode = "nn_src_only"
        K = on_dev(image_data["intrinsic"])
        center32 = center.astype(np.float32)
        # Each image's projection once, outside the cross-pair loop.
        src_projs = [project_points(on_dev(src_vox + center32), on_dev(e), K, image_size,
                                    v_flip=v_flip) for e in image_data["src_extrinsics"]]
        tgt_projs = [project_points(on_dev(tgt_vox + center32), on_dev(e), K, image_size,
                                    v_flip=v_flip) for e in image_data["tgt_extrinsics"]]
        single_pair = len(image_data["src_images"]) == 1 and len(image_data["tgt_images"]) == 1
        pair_channels, n_px_total = [], 0
        for a, simg in enumerate(image_data["src_images"]):
            for b, timg in enumerate(image_data["tgt_images"]):
                (uv_s, dep_s, pval_s), (uv_t, dep_t, pval_t) = src_projs[a], tgt_projs[b]
                if image_data["corres_2d"] is not None and single_pair:
                    corres_2d = image_data["corres_2d"]
                else:
                    corres_2d = match_epoch_images(
                        simg, timg, **matcher_options(cfg), logger=logger,
                        weights=cfg.get("img_matcher_weights"), device=dev)
                if bool(cfg.get("save_img_matching_visualization", False)) and len(corres_2d):
                    # Reference base:1213-1224 (make_matching_figure JPG).
                    save_matching_figure(
                        simg, timg, np.asarray(corres_2d),
                        osp.join(out_root, "img_matching_results", "visualization",
                                 f"src_{a}_tgt_{b}_tile_{tile_id}.jpg"),
                        text=f"tile {tile_id} src img {a} x tgt img {b}")
                corres_2d = np.asarray(corres_2d, np.float32).reshape(-1, 4)
                n_px_total += len(corres_2d)
                if not len(corres_2d):
                    continue
                c2 = on_dev(corres_2d)
                sext, text = (on_dev(image_data[k][i]) for k, i in
                              (("src_extrinsics", a), ("tgt_extrinsics", b)))
                if lifting == "interpolation":
                    dmap_s, _ = rasterize_depth(uv_s, dep_s, pval_s, image_size)
                    dmap_t, _ = rasterize_depth(uv_t, dep_t, pval_t, image_size)
                    p3d, ok3 = lift_matches_to_3d(c2, dmap_s, dmap_t, sext, text, K,
                                                  image_size, v_flip=v_flip)
                    c32 = on_dev(center32)
                    ds2, i_s = nn1_xla_rounded(p3d[:, 0:3] - c32, src_vox_d)
                    dt2, i_t = nn1_xla_rounded(p3d[:, 3:6] - c32, tgt_vox_d)
                    thr3 = 2.0 * max(median_res, 1e-6)
                    ok = (ok3.cpu().numpy() & (np.sqrt(ds2.cpu().numpy()) < thr3)
                          & (np.sqrt(dt2.cpu().numpy()) < thr3))
                    # Duplicate source voxels: the last match wins (numpy
                    # fancy assignment, as in the JAX host path).
                    t2d, v2d = np.zeros(s_nv, np.int64), np.zeros(s_nv, bool)
                    src_i = i_s.cpu().numpy()[ok]
                    t2d[src_i] = i_t.cpu().numpy()[ok]
                    v2d[src_i] = True
                else:
                    t2d, v2d = chain_2d_matches_to_3d(c2, uv_s, uv_t, pixel_thres,
                                                      src_valid=pval_s, tgt_valid=pval_t,
                                                      mode=mode)
                    t2d, v2d = t2d.cpu().numpy().astype(np.int64), v2d.cpu().numpy()
                # Per-pair max-magnitude gate (base:1640-1646).
                mag2d = np.linalg.norm(tgt_vox[np.clip(t2d, 0, max(t_nv - 1, 0))] - src_vox,
                                       axis=1)
                pair_channels.append((t2d, v2d & (mag2d <= max_mag)))
        # Fill-in merge over image pairs (base:1940-1953): the first pair
        # is primary, later pairs fill unmatched voxels.
        c2d_idx, c2d_valid = np.zeros(s_nv, np.int64), np.zeros(s_nv, bool)
        for t2d, v2d in pair_channels:
            fill = ~c2d_valid & v2d
            c2d_idx[fill] = t2d[fill]
            c2d_valid |= fill
        log("tile %s: %d 2D pixel matches over %d image pair(s) -> %d lifted 3D voxel matches",
            tile_id, n_px_total, max(len(pair_channels), 1), int(c2d_valid.sum()))
        if c2d_valid.any():
            save_txt(osp.join(results_dir, "c2f_dvfms_from_global_2d_src2tgt_wo_pruning_"
                              f"visualize_tile_{tile_id}.txt"),
                     _interim_table(src_vox, tgt_vox, c2d_idx, c2d_valid, center, dataset))
        timer.mark("rgb_2d")
    save_txt(osp.join(results_dir, "c2f_dvfms_from_global_3d_src2tgt_wo_pruning_visualize_"
                      f"tile_{tile_id}.txt"),
             _interim_table(src_vox, tgt_vox, g_idx, g_valid, center, dataset))

    base_svl_radius = max(radius, float(cfg.get("voxel_size_init", 0.0) or 0.0))
    n_src_pts, n_tgt_pts = s.shape[0], t.shape[0]
    # partition_type: superpoint (base:1241-1276): per-point labels of each
    # level from the tile's table (generated when absent); each voxel takes
    # its first point's label.
    use_spt = str(cfg.get("partition_type", "supervoxel")) == "superpoint"
    if use_spt:
        spt_labels = {
            which: load_or_generate_partition_labels(
                out_root, "superpoint", tile_id, which, core, levels, logger=logger,
                device=dev, timings=timings)
            for which, core in (("src", src_core), ("tgt", tgt_core))
        }
        first_pt = {"src": _first_point_of_voxel(s_p2v, s_nv),
                    "tgt": _first_point_of_voxel(t_p2v, t_nv)}
        timer.mark("partition_tables")
    # Per-point transforms merged across levels by priority (list order).
    merged_R = np.tile(np.eye(3, dtype=np.float32), (n_src_pts, 1, 1))
    merged_t = np.zeros((n_src_pts, 3), np.float32)
    merged_valid = np.zeros(n_src_pts, bool)
    merged_rmse = np.zeros(n_src_pts, np.float32)
    # The level that claimed each point: the superpoint tables' cross-level
    # dedup (coarse_to_fine_matching.py:40-118, :282-287) reads it.
    merged_level = np.full(n_src_pts, -1, np.int8)
    t2s_level = np.full(n_tgt_pts, -1, np.int8)
    # tgt->src: each pair's inverse transform on its target patch's points
    # (base:3386-3393).
    t2s_R = np.tile(np.eye(3, dtype=np.float32), (n_tgt_pts, 1, 1))
    t2s_t = np.zeros((n_tgt_pts, 3), np.float32)
    t2s_valid = np.zeros(n_tgt_pts, bool)
    per_level_stats = []
    lab_t_dev = None
    # return_interim: True returns each level's labels and the global
    # matches beside the result, as the JAX tile does.
    keep_interim = bool(cfg.get("return_interim", False))
    interim_levels: list = []

    # The supervoxel kNN graph and normals are built once per voxel cloud
    # (at the first level's radius) and reused at every level.
    graphs: dict = {}

    def segment(which, vox_d, svl_radius):
        if which not in graphs:
            ni, nm, ov = supervoxel_graph(vox_d, svl_radius)
            overflow["sampler"] += int(ov)
            graphs[which] = (ni, nm, pca_normals(vox_d, neigh_idx=ni, neigh_mask=nm))
        ni, nm, nrm = graphs[which]
        return supervoxel_segmentation(vox_d, svl_radius, neigh_idx=ni, neigh_mask=nm,
                                       normals=nrm).labels.cpu().numpy()

    for li, level in enumerate(levels):
        svl_radius = base_svl_radius * (2.0 ** (int(level) - 1))
        if use_spt:
            raw_s = spt_labels["src"][li][first_pt["src"]]
            raw_t = spt_labels["tgt"][li][first_pt["tgt"]]
        else:
            raw_s = segment("src", src_vox_d, svl_radius)
            raw_t = segment("tgt", tgt_vox_d, svl_radius)
        lab_s, n_s = _compact_labels(raw_s, small_patch)
        lab_t, n_t = _compact_labels(raw_t, small_patch)
        if bool(cfg.get("use_debugging", False)):
            # Only the first num_spt superpoints of each epoch
            # (coarse_to_fine_matching.py:292-308).
            num_spt = int(cfg.get("num_spt", 2))
            lab_s = np.where(lab_s < num_spt, lab_s, -1)
            lab_t = np.where(lab_t < num_spt, lab_t, -1)
            n_s, n_t = min(n_s, num_spt), min(n_t, num_spt)
        timer.mark(f"partition_l{level}")
        if keep_interim:
            interim_levels.append({"level": level, "lab_s": lab_s.copy(), "lab_t": lab_t.copy(),
                                   "n_s": n_s, "n_t": n_t})
        if n_s == 0 or n_t == 0:
            per_level_stats.append((level, 0, 0))
            timer.mark(f"match_l{level}")
            continue

        S_s, S_t = bucket_size(n_s), bucket_size(n_t)
        P_s = bucket_size(int(np.bincount(lab_s[lab_s >= 0], minlength=n_s).max()))
        P_t = bucket_size(int(np.bincount(lab_t[lab_t >= 0], minlength=n_t).max()))
        lab_s_dev, lab_t_dev = on_dev(lab_s, torch.int32), on_dev(lab_t, torch.int32)
        mem_s, memmask_s = label_members(lab_s_dev, S_s, P_s)
        mem_t, memmask_t = label_members(lab_t_dev, S_t, P_t)

        # 5. Superpoint aggregation (base:2561-2656) and coarse matching.
        P_agg = min(int(cfg.get("agg_max_points", 512)), P_s, P_t)
        spt_feat_s, spt_coord_s = aggregate_superpoints(agg, src_feat_d, src_vox_d, mem_s,
                                                        memmask_s, agg_max_points=P_agg)
        spt_feat_t, spt_coord_t = aggregate_superpoints(agg, tgt_feat_d, tgt_vox_d, mem_t,
                                                        memmask_t, agg_max_points=P_agg)
        valid_s = torch.arange(S_s, device=dev) < n_s
        valid_t = torch.arange(S_t, device=dev) < n_t
        # Coarse mode (coarse_matching_{fusion,only_3d,only_2d}).
        has_2d = c2d_idx is not None
        coarse_only_2d = bool(cfg.get("coarse_matching_only_2d", False)) and has_2d
        coarse_fusion = (bool(cfg.get("coarse_matching_fusion", has_2d)) and has_2d
                         and not coarse_only_2d)
        pair_list = []
        if not coarse_only_2d:
            tgt_of_src, pair_valid = coarse_match_superpoints(
                spt_feat_s, spt_coord_s, valid_s, spt_feat_t, spt_coord_t, valid_t, max_mag,
                mutual=mutual_3d,
            )
            tgt_of_src = tgt_of_src.cpu().numpy().astype(np.int64)
            src_3d = np.where(pair_valid.cpu().numpy()[:n_s])[0]
            pair_list.append(np.stack([src_3d, tgt_of_src[src_3d]], axis=1))
        if coarse_fusion or coarse_only_2d:
            vote_tgt, vote_ok = coarse_match_2d_votes(lab_s, lab_t, c2d_idx, c2d_valid, n_s, n_t)
            src_2d = np.where(vote_ok)[0]
            pair_list.append(np.stack([src_2d, vote_tgt[src_2d]], axis=1))
        pairs = (np.unique(np.concatenate(pair_list, axis=0), axis=0) if pair_list
                 else np.zeros((0, 2), np.int64))
        pair_src, pair_tgt = pairs[:, 0], pairs[:, 1]
        if pair_src.size == 0:
            per_level_stats.append((level, n_s, 0))
            timer.mark(f"match_l{level}")
            continue

        # 6. Fine matching over the pairs, the pair count padded to its
        # bucket with dead pairs.
        fine_only_2d = bool(cfg.get("fine_matching_only_2d", False)) and has_2d
        fine_fusion = (bool(cfg.get("fine_matching_fusion", has_2d)) and has_2d
                       and not fine_only_2d)
        ch1_idx, ch1_valid = (c2d_idx, c2d_valid) if fine_only_2d else (g_idx, g_valid)
        fine_kw = {}
        if fine_fusion:
            fine_kw = dict(corres2_tgt_idx=on_dev(c2d_idx, torch.int32),
                           corres2_valid=on_dev(c2d_valid),
                           weighting=bool(cfg.get("weighting_svd", False)))
        n_pairs = pair_src.size
        pairs_cap = bucket_size(n_pairs)
        pair_src_b = np.zeros(pairs_cap, np.int64)
        pair_src_b[:n_pairs] = pair_src
        pair_tgt_b = np.full(pairs_cap, -1, np.int64)
        pair_tgt_b[:n_pairs] = pair_tgt
        psb = on_dev(pair_src_b)
        memmask_pad = memmask_s[psb] & (torch.arange(pairs_cap, device=dev) < n_pairs)[:, None]
        fine = fine_match_pairs(
            mem_s[psb], memmask_pad, on_dev(pair_tgt_b, torch.int32),
            on_dev(ch1_idx, torch.int32), on_dev(ch1_valid), lab_t_dev, src_vox_d, tgt_vox_d,
            num_min_quality=num_min_quality, thres_dist_diff=thres_dd,
            thres_inlier_ratio=thres_ir, num_min_fine=num_min_fine, icp_threshold=icp_thr,
            icp_max_iter=icp_iter, icp_type=icp_type, fine_max_matches=fine_cap, **fine_kw,
        )
        fR = fine.R[:n_pairs].cpu().numpy()
        ft = fine.t[:n_pairs].cpu().numpy()
        frmse = fine.rmse[:n_pairs].cpu().numpy()
        fvalid = fine.valid[:n_pairs].cpu().numpy()

        # Per-pair transforms onto source-label slots.
        lab_R = np.tile(np.eye(3, dtype=np.float32), (n_s, 1, 1))
        lab_t_arr = np.zeros((n_s, 3), np.float32)
        lab_rmse = np.zeros(n_s, np.float32)
        lab_ok = np.zeros(n_s, bool)
        lab_R[pair_src], lab_t_arr[pair_src] = fR, ft
        lab_rmse[pair_src], lab_ok[pair_src] = frmse, fvalid
        _patch_figures(cfg, out_root, tile_id, level, center, src_vox, tgt_vox, lab_s, lab_t,
                       pair_src, pair_tgt, ch1_idx, ch1_valid, rng_seed)

        # 7. Dense per-point assignment, merged by level priority.
        pt_label = np.where(s_p2v < s_nv, lab_s[np.clip(s_p2v, 0, max(s_nv - 1, 0))], -1)
        take = (pt_label >= 0) & lab_ok[np.clip(pt_label, 0, None)] & ~merged_valid
        lbl = np.clip(pt_label, 0, None)[take]
        merged_R[take], merged_t[take], merged_rmse[take] = lab_R[lbl], lab_t_arr[lbl], lab_rmse[lbl]
        merged_level[take] = li
        merged_valid |= take

        if out_tgt2src:
            Rinv = fR.transpose(0, 2, 1)
            tinv = -np.einsum("nij,nj->ni", Rinv, ft)
            tlab_R = np.tile(np.eye(3, dtype=np.float32), (n_t, 1, 1))
            tlab_t = np.zeros((n_t, 3), np.float32)
            tlab_ok = np.zeros(n_t, bool)
            tlab_R[pair_tgt[fvalid]], tlab_t[pair_tgt[fvalid]] = Rinv[fvalid], tinv[fvalid]
            tlab_ok[pair_tgt[fvalid]] = True
            tp_label = np.where(t_p2v < t_nv, lab_t[np.clip(t_p2v, 0, max(t_nv - 1, 0))], -1)
            ttake = (tp_label >= 0) & tlab_ok[np.clip(tp_label, 0, None)] & ~t2s_valid
            tl = np.clip(tp_label, 0, None)[ttake]
            t2s_R[ttake], t2s_t[ttake] = tlab_R[tl], tlab_t[tl]
            t2s_level[ttake] = li
            t2s_valid |= ttake
        per_level_stats.append((level, n_s, int(fvalid.sum())))
        log("tile %s level %s: %d src spts, %d matched pairs, %d fine-valid",
            tile_id, level, n_s, n_pairs, int(fvalid.sum()))
        timer.mark(f"match_l{level}")

    # Dense output R p + t of every assigned source point (base:3371-3380);
    # the text tables are written on a thread while the sparse
    # re-association runs, and joined before returning.
    writer = ThreadPoolExecutor(max_workers=1)
    write_futs = []
    # With superpoint tables over several levels the reference dedups each
    # output table across levels by priority with a distance threshold
    # (coarse_to_fine_matching.py:282-287).
    merge_thr = float(cfg.get("merge_distance_threshold", 1e-3))

    def level_merge(rows: np.ndarray, row_level: np.ndarray) -> np.ndarray:
        if not (use_spt and len(levels) > 1):
            return rows
        return merge_correspondences_by_priority(
            [rows[row_level == li] for li in range(len(levels))],
            distance_threshold=merge_thr, device=dev)

    moved = np.einsum("nij,nj->ni", merged_R, s) + merged_t
    dvfs_dense = level_merge(np.hstack([src_core[merged_valid], moved[merged_valid] + center]),
                             merged_level[merged_valid])
    dvfms = np.hstack([dvfs_dense[:, :3], dvf_magnitudes(dvfs_dense)[:, None]])

    def write_dense():
        save_txt(osp.join(results_dir, f"c2f_dvfs_src2tgt_tile_{tile_id}.txt"), dvfs_dense)
        save_txt(osp.join(results_dir, f"c2f_dvfms_src2tgt_tile_{tile_id}.txt"), dvfms)
        if dvfms.shape[0] > 2:
            save_txt(osp.join(results_dir, f"c2f_dvfms_src2tgt_visualize_tile_{tile_id}.txt"),
                     visual_clamp_magnitude(dvfms, dataset))

    write_futs.append(writer.submit(write_dense))
    timer.mark("dense_output")

    # Sparse 'assign_then_nn' output: the moved points re-associated with
    # target points within max(2 rmse, median_res) (base:3414-3436).
    dvfs_sparse = None
    if assign_type == "assign_then_nn" and merged_valid.any():
        adaptive = np.maximum(2.0 * merged_rmse[merged_valid], median_res)
        radius_nn = float(np.maximum(adaptive.max(), median_res))
        nq = int(merged_valid.sum())
        q = np.zeros((bucket_size(nq), 3), np.float32)
        q[:nq] = moved[merged_valid]
        r_nn = torch.tensor(radius_nn, dtype=torch.float32, device=dev)
        grid = build_hash_grid(t_d, r_nn)
        d2, nn_idx, ov = hash_grid_knn(on_dev(q), grid, r_nn, 1)
        overflow["grid_knn"] += int(ov)
        d = np.sqrt(d2[:nq, 0].cpu().numpy())
        ok = np.isfinite(d) & (d < adaptive)
        nn_idx = nn_idx[:nq, 0].cpu().numpy()
        dvfs_sparse = level_merge(np.hstack([src_core[merged_valid][ok], t[nn_idx[ok]] + center]),
                                  merged_level[merged_valid][ok])
        sparse_ms = np.hstack([dvfs_sparse[:, :3], dvf_magnitudes(dvfs_sparse)[:, None]])
        write_futs.append(writer.submit(
            save_txt,
            osp.join(results_dir, f"c2f_dvfms_src2tgt_discrete_visualize_tile_{tile_id}.txt"),
            visual_clamp_magnitude(sparse_ms, dataset),
        ))
        timer.mark("sparse_assign")

    if out_tgt2src and t2s_valid.any():
        src_est = np.einsum("nij,nj->ni", t2s_R[t2s_valid], t[t2s_valid]) + t2s_t[t2s_valid]
        dvfs_t2s = level_merge(np.hstack([src_est + center, tgt_core[t2s_valid]]),
                               t2s_level[t2s_valid])
        save_txt(osp.join(results_dir, f"c2f_dvfms_tgt2src_tile_{tile_id}.txt"),
                 np.hstack([dvfs_t2s[:, 3:6], dvf_magnitudes(dvfs_t2s)[:, None]]))

    for fut in write_futs:
        fut.result()
    writer.shutdown()
    timer.mark("write_tables")
    log("tile %s stage times (s): %s", tile_id,
        ", ".join(f"{k} {v:.3f}" for k, v in timer.timings.items()))
    out = {
        "dvfs": dvfs_dense,
        "dvfs_sparse": dvfs_sparse,
        "assigned_fraction": float(merged_valid.mean()),
        "per_level": per_level_stats,
        "R": merged_R,
        "t": merged_t,
        "valid": merged_valid,
        "n_2d_matches": int(c2d_valid.sum()) if c2d_valid is not None else 0,
        "median_res": median_res,
        "n_vox": (s_nv, t_nv),
        "overflow": sum(overflow.values()),
        "overflow_by_source": overflow,
    }
    if keep_interim:
        out["interim"] = {
            "center": center, "median_res": median_res, "src_vox": src_vox, "tgt_vox": tgt_vox,
            "s_p2v": s_p2v, "t_p2v": t_p2v, "src_feat": src_feat_d.cpu().numpy(),
            "tgt_feat": tgt_feat_d.cpu().numpy(), "g_idx": g_idx, "g_valid": g_valid,
            "levels": interim_levels,
        }
    return out
