"""The 3D-only fusion tile step on one device.

Port of ``fusion4landslide_tpu.pipelines.fusion_device.fusion3d_tile_step``
(reference ``Coarse2Fine.implement_c2f_matching``,
src/coarse_to_fine_matching.py:201-290 with use_2d_matches=False): median
resolution -> adaptive voxel subsampling on one shared origin -> DIPs
descriptors -> gated global 3D matches -> multi-level supervoxel partition
(nested levels) -> attention aggregation -> coarse mutual matching -> fine
per-pair SVD + ICP -> priority merge -> dense / sparse / tgt2src outputs.

Fixed-shape conventions as in the JAX step: voxel clouds are padded to the
input point count; supervoxels use per-level static caps ``(sv_cap,
member_cap)`` and what falls past them is counted in ``n_dropped``.

Not ported yet (raise ``NotImplementedError``): the RGB 2D-match channel
(image inputs), precomputed partition inputs (``sp_lab_*``), ICP types
other than point2point, the ungated global match, and bf16 descriptors.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.ops.gated_match import gated_feature_nn1
from fusion4landslide_tpu_torch.ops.hashgrid import (
    knn_grid_traced,
    median_nn_distance_traced,
)
from fusion4landslide_tpu_torch.ops.normals import pca_normals
from fusion4landslide_tpu_torch.ops.segments import label_members
from fusion4landslide_tpu_torch.ops.supervoxel import (
    supervoxel_graph,
    supervoxel_segmentation,
)
from fusion4landslide_tpu_torch.ops.voxel import segment_sum, voxel_downsample
from fusion4landslide_tpu_torch.pipelines.f2s3_device import (
    dips_features_device,
    drop_small_and_compact,
)
from fusion4landslide_tpu_torch.pipelines.fusion import fine_match_pairs

__all__ = [
    "Fusion3DTileResult",
    "fusion3d_tile_step",
    "coarse_match_superpoints_chunked",
]


def coarse_match_superpoints_chunked(feat_s, coord_s, valid_s, feat_t, coord_t,
                                     valid_t, max_magnitude, *, chunk: int = 2048,
                                     mutual: bool = True):
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


def _aggregate_chunked(agg, feat_arr, coords, member_idx, member_mask, *,
                       agg_max_points: int, s_chunk: int = 128):
    """ClusterFeatureNet over supervoxel buckets, chunked over S, with a
    strided member subsample bounding the quadratic attention. Chunks
    with no live member are skipped (their features are never read)."""
    S, P = member_idx.shape
    if P > agg_max_points:
        stride = -(-P // agg_max_points)
        mi = member_idx[:, ::stride][:, :agg_max_points]
        mm = member_mask[:, ::stride][:, :agg_max_points]
    else:
        mi, mm = member_idx, member_mask
    spt_feat = torch.zeros((S, 64), dtype=torch.float32, device=feat_arr.device)
    live = mm.view(-1, mm.shape[1]).any(-1)
    for s0 in range(0, S, s_chunk):
        if not bool(live[s0:s0 + s_chunk].any()):
            continue
        mic, mmc = mi[s0:s0 + s_chunk].long(), mm[s0:s0 + s_chunk]
        feats = feat_arr[mic] * mmc[..., None]
        spt_feat[s0:s0 + s_chunk] = agg(feats, mmc)
    # Centroid over the FULL member set (not the strided subsample).
    w = member_mask.to(coords.dtype)[..., None]
    cent = (coords[member_idx.long()] * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    return spt_feat, cent


def _segment_centroids(coords, prev_lab, prev_cap: int, prev_n, svl_radius,
                       k_neighbors: int):
    """Nested partition level: segment the previous level's cluster
    centroids and compose back onto the voxels. Returns (labels, ()
    graph-sampler window overflow count)."""
    has = (prev_lab >= 0) & (prev_lab < prev_cap)
    lab0 = torch.where(has, prev_lab, prev_cap)
    w = has.to(coords.dtype)
    sums = segment_sum(coords * w[:, None], lab0, prev_cap + 1)[:prev_cap]
    cnts = segment_sum(w, lab0, prev_cap + 1)[:prev_cap]
    cent = sums / torch.clamp(cnts[:, None], min=1.0)
    cvalid = torch.arange(prev_cap, device=coords.device) < prev_n
    k = min(k_neighbors, 15)
    gi, gm, overflow = supervoxel_graph(cent, svl_radius, cvalid, k_neighbors=k)
    seg = supervoxel_segmentation(
        cent, svl_radius, cvalid, k_neighbors=k, neigh_idx=gi, neigh_mask=gm
    )
    labels = torch.where(
        has, seg.labels[torch.clamp(prev_lab, 0, prev_cap - 1).long()], -1
    )
    return labels, overflow


class Fusion3DTileResult(NamedTuple):
    moved: torch.Tensor  # (N, 3) R p + t per src point (p where unassigned)
    valid: torch.Tensor  # (N,) src point got a fine transform
    rmse: torch.Tensor  # (N,) its pair's ICP inlier RMSE
    sparse_tgt: torch.Tensor  # (N, 3) assign_then_nn re-associated target
    sparse_ok: torch.Tensor  # (N,)
    t2s_src_est: torch.Tensor  # (M, 3) per-target estimated source position
    t2s_valid: torch.Tensor  # (M,)
    median_res: torch.Tensor  # ()
    n_vox_src: torch.Tensor  # ()
    n_vox_tgt: torch.Tensor  # ()
    n_dropped: torch.Tensor  # () voxels lost to the static supervoxel caps
    overflow: int  # grid-window blocks truncated to the window, this step


class _Stages:
    """Per-stage wall seconds, synchronised with the device at each mark
    (only when the caller passes a ``timings`` dict)."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings, self.device = timings, device
        self.last = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.last
        self.last = now


def _per_level_caps(cap, n_levels: int):
    if isinstance(cap, int):
        floor = min(256, cap)
        return tuple(max(cap >> (2 * li), floor) for li in range(n_levels))
    return tuple(cap)


@torch.inference_mode()
def fusion3d_tile_step(
    dips,
    agg,
    src: torch.Tensor,
    smask: torch.Tensor,
    tgt: torch.Tensor,
    tmask: torch.Tensor,
    max_magnitude: float = 10.0,
    icp_threshold: float = 0.1,
    voxel_size_init: float = 0.0,
    num_min_fine: int = 10,
    num_min_quality: int = 10,
    thres_dist_diff: float = 0.5,
    thres_inlier_ratio: float = 0.15,
    *,
    levels: tuple[int, ...] = (1, 2, 3),
    patch_points: int = 256,
    chunk: int = 2048,
    k_neighbors: int = 15,
    sv_cap=1024,
    sv_cap_tgt=None,
    member_cap: int = 512,
    agg_max_points: int = 512,
    small_patch: int = 10,
    icp_max_iter: int = 30,
    icp_type: str = "point2point",
    fine_max_matches: int = 256,
    coarse_mutual: bool = True,
    global_gated: bool = True,
    with_sparse: bool = True,
    with_tgt2src: bool = True,
    feat_dtype: str | None = None,
    sp_lab_src=None,
    sp_lab_tgt=None,
    pix_matches=None,
    timings: dict | None = None,
    device=None,
) -> Fusion3DTileResult:
    """One 3D-only fusion tile: padded, centred (N, 3) ``src`` / (M, 3)
    ``tgt`` clouds with masks, on ``device`` (default ``cuda``; a CUDA
    run without a card raises). ``dips`` and ``agg`` are the
    PointNetFeature and ClusterFeatureNet modules (moved to ``device``).

    The JAX step takes a PRNG key; on the accelerator branch this port
    follows, the key feeds nothing (the patch sampler runs with seed 0),
    so the port takes none. ``timings`` (optional dict) accumulates
    per-stage seconds, synchronising the device at each stage boundary.
    """
    if pix_matches is not None:
        raise NotImplementedError("the RGB 2D-match channel is not ported yet")
    if sp_lab_src is not None or sp_lab_tgt is not None:
        raise NotImplementedError("precomputed partition inputs are not ported yet")
    if icp_type != "point2point":
        raise NotImplementedError(f"icp_type {icp_type!r} is not ported yet")
    if not global_gated:
        raise NotImplementedError("the ungated global match is not ported yet")
    if feat_dtype not in (None, "float32"):
        raise NotImplementedError("only float32 descriptors are ported")
    if patch_points % 128:
        raise NotImplementedError("patch_points must be a multiple of 128")
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    smask = torch.as_tensor(smask, device=dev).to(torch.bool)
    tmask = torch.as_tensor(tmask, device=dev).to(torch.bool)
    dips, agg = dips.to(dev), agg.to(dev)
    f32 = src.dtype
    stages = _Stages(timings, dev)
    N, M = src.shape[0], tgt.shape[0]

    # 1. median resolution + voxel subsampling on the union min corner.
    med_s, ov_s = median_nn_distance_traced(src, smask)
    med_t, ov_t = median_nn_distance_traced(tgt, tmask)
    median_res = torch.maximum(med_s, med_t)
    overflow = ov_s + ov_t  # grid-window overflow, summed over the step
    # float32 throughout, as the JAX expression sqrt(3.0) * 10.0 * res.
    radius = torch.sqrt(torch.tensor(3.0, dtype=f32, device=dev)) * 10.0 * median_res
    grid0 = torch.minimum(
        torch.where(smask[:, None], src, torch.inf).min(dim=0).values,
        torch.where(tmask[:, None], tgt, torch.inf).min(dim=0).values,
    )
    s_cent, s_p2v, _, s_nv = voxel_downsample(src, median_res, smask, origin=grid0)
    t_cent, t_p2v, _, t_nv = voxel_downsample(tgt, median_res, tmask, origin=grid0)
    vvalid_s = torch.arange(N, device=dev) < s_nv
    vvalid_t = torch.arange(M, device=dev) < t_nv
    stages.mark("median_res_voxels")

    # 2. DIPs descriptors on the voxel clouds; support = full clouds.
    feat_kw = dict(patch_points=patch_points, chunk=chunk)
    src_feat, ov_s = dips_features_device(dips, s_cent, src, smask, radius,
                                          query_count=s_nv, **feat_kw)
    tgt_feat, ov_t = dips_features_device(dips, t_cent, tgt, tmask, radius,
                                          query_count=t_nv, **feat_kw)
    overflow = overflow + ov_s + ov_t
    stages.mark("dips_features")

    # 3. Gated global 3D voxel matches.
    _, g_idx, g_valid = gated_feature_nn1(
        src_feat, tgt_feat, s_cent, t_cent, max_magnitude, vvalid_s, vvalid_t
    )
    stages.mark("global_match")

    base_svl = torch.clamp(radius, min=float(voxel_size_init))
    gi_s, gm_s, ov_s = supervoxel_graph(s_cent, base_svl, vvalid_s, k_neighbors=k_neighbors)
    nrm_s = pca_normals(s_cent, vvalid_s, neigh_idx=gi_s, neigh_mask=gm_s)
    gi_t, gm_t, ov_t = supervoxel_graph(t_cent, base_svl, vvalid_t, k_neighbors=k_neighbors)
    overflow = overflow + ov_s + ov_t
    nrm_t = pca_normals(t_cent, vvalid_t, neigh_idx=gi_t, neigh_mask=gm_t)
    stages.mark("graph_normals")

    eye = torch.eye(3, dtype=f32, device=dev)
    merged_R = eye.repeat(N, 1, 1)
    merged_t = torch.zeros((N, 3), dtype=f32, device=dev)
    merged_valid = torch.zeros((N,), dtype=torch.bool, device=dev)
    merged_rmse = torch.zeros((N,), dtype=f32, device=dev)
    t2s_R = eye.repeat(M, 1, 1)
    t2s_t = torch.zeros((M, 3), dtype=f32, device=dev)
    t2s_valid = torch.zeros((M,), dtype=torch.bool, device=dev)
    n_dropped = torch.zeros((), dtype=torch.int64, device=dev)

    sv_caps = _per_level_caps(sv_cap, len(levels))
    sv_caps_t = sv_caps if sv_cap_tgt is None else _per_level_caps(sv_cap_tgt, len(levels))

    lab_s_prev = lab_t_prev = n_s_prev = n_t_prev = None
    for li, level in enumerate(levels):
        sv_cap_l, sv_cap_tl = sv_caps[li], sv_caps_t[li]
        svl_radius = base_svl * (2.0 ** (int(level) - 1))
        if li == 0:
            raw_s = supervoxel_segmentation(
                s_cent, svl_radius, vvalid_s, neigh_idx=gi_s, neigh_mask=gm_s,
                normals=nrm_s,
            ).labels
            raw_t = supervoxel_segmentation(
                t_cent, svl_radius, vvalid_t, neigh_idx=gi_t, neigh_mask=gm_t,
                normals=nrm_t,
            ).labels
        else:
            raw_s, ov_s = _segment_centroids(s_cent, lab_s_prev, sv_caps[li - 1],
                                             n_s_prev, svl_radius, k_neighbors)
            raw_t, ov_t = _segment_centroids(t_cent, lab_t_prev, sv_caps_t[li - 1],
                                             n_t_prev, svl_radius, k_neighbors)
            overflow = overflow + ov_s + ov_t
        lab_s, n_s = drop_small_and_compact(raw_s, vvalid_s, small_patch)
        lab_t, n_t = drop_small_and_compact(raw_t, vvalid_t, small_patch)
        lab_s_prev, n_s_prev, lab_t_prev, n_t_prev = lab_s, n_s, lab_t, n_t
        stages.mark("partition")

        mem_s, memmask_s = label_members(lab_s, sv_cap_l, member_cap)
        mem_t, memmask_t = label_members(lab_t, sv_cap_tl, member_cap)
        in_table = torch.zeros((N,), dtype=torch.bool, device=dev)
        in_table[mem_s[memmask_s].long()] = True
        n_dropped = n_dropped + (vvalid_s & (lab_s >= 0) & ~in_table).sum()

        svalid_s = torch.arange(sv_cap_l, device=dev) < n_s
        svalid_t = torch.arange(sv_cap_tl, device=dev) < n_t
        # 4. Superpoint aggregation + coarse matching.
        spt_feat_s, spt_coord_s = _aggregate_chunked(
            agg, src_feat, s_cent, mem_s, memmask_s, agg_max_points=agg_max_points
        )
        spt_feat_t, spt_coord_t = _aggregate_chunked(
            agg, tgt_feat, t_cent, mem_t, memmask_t, agg_max_points=agg_max_points
        )
        tgt_of_src, pair_valid = coarse_match_superpoints_chunked(
            spt_feat_s, spt_coord_s, svalid_s, spt_feat_t, spt_coord_t, svalid_t,
            max_magnitude, mutual=coarse_mutual,
        )
        stages.mark("aggregate_coarse")

        # 5. Fine matching per matched pair.
        fine = fine_match_pairs(
            mem_s, memmask_s & pair_valid[:, None],
            torch.where(pair_valid, tgt_of_src, -1).to(torch.int32),
            g_idx, g_valid, lab_t, s_cent, t_cent,
            num_min_quality=num_min_quality, thres_dist_diff=thres_dist_diff,
            thres_inlier_ratio=thres_inlier_ratio, num_min_fine=num_min_fine,
            icp_threshold=icp_threshold, icp_max_iter=icp_max_iter,
            icp_type=icp_type, fine_max_matches=fine_max_matches,
        )
        lab_ok = fine.valid[:sv_cap_l] & pair_valid & svalid_s
        stages.mark("fine")

        # 6. Dense per-point assignment, merged by level priority.
        pt_vox = torch.clamp(s_p2v, 0, N - 1).long()
        pt_label = torch.where(smask & (s_p2v < s_nv), lab_s[pt_vox], -1)
        pl = torch.clamp(pt_label, 0, sv_cap_l - 1).long()
        take = (pt_label >= 0) & lab_ok[pl] & ~merged_valid
        merged_R = torch.where(take[:, None, None], fine.R[pl], merged_R)
        merged_t = torch.where(take[:, None], fine.t[pl], merged_t)
        merged_rmse = torch.where(take, fine.rmse[pl], merged_rmse)
        merged_valid = merged_valid | take

        if with_tgt2src:
            # Each matched pair's inverse transform applies to the TARGET
            # patch's points (base:3386-3393).
            Rinv = fine.R[:sv_cap_l].transpose(-1, -2)
            tinv = -torch.einsum("sij,sj->si", Rinv, fine.t[:sv_cap_l])
            pair_R = eye.repeat(sv_cap_tl, 1, 1)
            pair_t = torch.zeros((sv_cap_tl, 3), dtype=f32, device=dev)
            pair_ok = torch.zeros((sv_cap_tl,), dtype=torch.bool, device=dev)
            # Mutual matching makes the target labels of valid pairs unique.
            sel = torch.nonzero(lab_ok & (tgt_of_src < sv_cap_tl)).squeeze(1)
            tl = tgt_of_src[sel].long()
            pair_R[tl], pair_t[tl], pair_ok[tl] = Rinv[sel], tinv[sel], True
            tp_vox = torch.clamp(t_p2v, 0, M - 1).long()
            tp_label = torch.where(tmask & (t_p2v < t_nv), lab_t[tp_vox], -1)
            tpl = torch.clamp(tp_label, 0, sv_cap_tl - 1).long()
            ttake = (tp_label >= 0) & pair_ok[tpl] & ~t2s_valid
            t2s_R = torch.where(ttake[:, None, None], pair_R[tpl], t2s_R)
            t2s_t = torch.where(ttake[:, None], pair_t[tpl], t2s_t)
            t2s_valid = t2s_valid | ttake
        stages.mark("merge")

    # Dense output: R p + t for every assigned source point.
    moved = torch.einsum("nij,nj->ni", merged_R, src) + merged_t
    moved = torch.where(merged_valid[:, None], moved, src)

    # Sparse assign_then_nn: re-associate moved points with target points
    # within max(2 rmse, median_res) (bounded grid search, exact).
    if with_sparse:
        adaptive = torch.maximum(2.0 * merged_rmse, median_res)
        r_need = torch.where(merged_valid, adaptive, 0.0).max()
        nn_sq, nn_i, ov = knn_grid_traced(
            moved, tgt, 1, r0=2.0 * median_res, ref_mask=tmask,
            query_mask=merged_valid, r_max=r_need * 1.001,
        )
        overflow = overflow + ov
        nn_d = torch.sqrt(nn_sq[:, 0])
        sparse_ok = merged_valid & torch.isfinite(nn_d) & (nn_d < adaptive)
        sparse_tgt = tgt[nn_i[:, 0].long()]
    else:
        sparse_ok = torch.zeros((N,), dtype=torch.bool, device=dev)
        sparse_tgt = torch.zeros((N, 3), dtype=f32, device=dev)

    if with_tgt2src:
        t2s_src_est = torch.einsum("mij,mj->mi", t2s_R, tgt) + t2s_t
        t2s_src_est = torch.where(t2s_valid[:, None], t2s_src_est, tgt)
    else:
        t2s_src_est = torch.zeros((M, 3), dtype=f32, device=dev)
        t2s_valid = torch.zeros((M,), dtype=torch.bool, device=dev)
    stages.mark("dense_sparse_out")

    return Fusion3DTileResult(
        moved=moved, valid=merged_valid, rmse=merged_rmse, sparse_tgt=sparse_tgt,
        sparse_ok=sparse_ok, t2s_src_est=t2s_src_est, t2s_valid=t2s_valid,
        median_res=median_res, n_vox_src=s_nv, n_vox_tgt=t_nv,
        n_dropped=n_dropped, overflow=int(overflow),
    )
