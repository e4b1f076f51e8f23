"""Global voxel matching and fine per-pair matching.

Port of ``fusion4landslide_tpu.pipelines.fusion``: ``global_matches_3d``
(the ungated search-then-gate feature 1-NN, reference base:2756-2889) and
``fine_match_pairs`` (quality gate + SVD + ICP, reference base:3254-3436)
with one correspondence channel (3D matches) or two (3D matches and 3D
matches lifted from 2D pixel matches, base:3258-3296) and point2point ICP.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops.kabsch import weighted_kabsch
from fusion4landslide_tpu_torch.ops.knn import nn1
from fusion4landslide_tpu_torch.ops.registration import icp_by_type

__all__ = ["FinePairResult", "fine_match_pairs", "global_matches_3d"]


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
    if icp_type != "point2point":
        raise NotImplementedError(f"icp_type {icp_type!r} is not ported yet")
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
