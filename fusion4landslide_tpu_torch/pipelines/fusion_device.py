"""The fusion tile step on one device, 3D-only or RGB+3D.

Port of ``fusion4landslide_tpu.pipelines.fusion_device.fusion3d_tile_step``
(reference ``Coarse2Fine.implement_c2f_matching``,
src/coarse_to_fine_matching.py:201-290): median resolution -> adaptive
voxel subsampling on one shared origin -> DIPs descriptors -> gated global
3D matches -> (with image inputs) 3D matches lifted from 2D pixel matches
-> multi-level supervoxel partition (nested levels, or each level afresh
with ``nested_levels=False``) -> attention
aggregation -> coarse mutual matching, fused with 2D majority votes ->
fine per-pair SVD + ICP on one or two correspondence channels -> priority
merge -> dense / sparse / tgt2src outputs.

The RGB channel (use_2d_matches=True): per image pair the voxel clouds are
projected, pixel matches are chained to voxels through pixel-space 1-NN
(``lifting='nn_search'``) or lifted through z-buffered depth maps
(``'interpolation'``), merged across pairs (first valid pair wins) and
magnitude-gated. Every pixel-space and re-association search is one
kernel-2 launch (``knn_grid_traced`` with one attempt).

Fixed-shape conventions as in the JAX step: voxel clouds are padded to the
input point count; supervoxels use per-level static caps ``(sv_cap,
member_cap)``, 2D-vote pairs that no 3D pair proposed go to a per-level
extras table of ``extra_pair_cap`` rows, and what falls past them is
counted in ``n_dropped``.

Precomputed partition inputs (``sp_lab_src`` / ``sp_lab_tgt``, the
reference's ``partition_type: superpoint``) replace the supervoxel levels:
each voxel takes its first point's label, with the flat ``sv_cap`` at
every level. ``icp_type`` selects the fine stage's solver
(``ops/registration.py::icp_by_type``).

DIPs descriptors take ``dips_features_device``'s branches: kernel 1 for
patch sizes that are multiples of 128, the 'knn' / 'random' grid branches
otherwise, the PointNet trunks in bf16 with ``feat_dtype='bfloat16'``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.geometry import (
    bilinear_depth,
    lift_pixels_to_world,
    project_points,
    rasterize_depth,
)
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
from fusion4landslide_tpu_torch.pipelines.fusion import (
    aggregate_superpoints as _aggregate_chunked,
    coarse_match_superpoints as coarse_match_superpoints_chunked,
    fine_match_pairs,
    global_matches_3d,
)
from fusion4landslide_tpu_torch.utils.profiling import tile
from fusion4landslide_tpu_torch.utils.timing import StageTimer

__all__ = [
    "Fusion3DTileResult",
    "fusion3d_tile_step",
    "coarse_match_superpoints_chunked",
]


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


def _last_writer(slots: torch.Tensor, ok: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(n_slots,) int64: the largest row i with ``ok[i]`` and
    ``slots[i] == s`` per slot s, -1 where none (the JAX step's
    ``.at[slots].max(rows, mode="drop")`` and its in-order scatter-set)."""
    rows = torch.arange(slots.shape[0], device=slots.device)
    out = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=slots.device)
    out = out.scatter_reduce(0, torch.where(ok, slots.long(), n_slots), rows, "amax")
    return out[:n_slots]


def _pixel_nn1(query_uv, query_valid, ref_uv, ref_valid, thr):
    """Radius-bounded 1-NN in pixel space: the 2D points ride the grid
    kNN with a zero z column, one attempt at radius ``thr`` (one kernel-2
    launch). Returns ((n,) index, (n,) found with sq < thr^2, () window
    overflow)."""
    thr = torch.as_tensor(thr, dtype=query_uv.dtype, device=query_uv.device)
    q3 = torch.cat([query_uv, torch.zeros_like(query_uv[:, :1])], dim=1)
    r3 = torch.cat([ref_uv, torch.zeros_like(ref_uv[:, :1])], dim=1)
    sq, idx, ov = knn_grid_traced(
        q3, r3, 1, r0=thr, ref_mask=ref_valid, query_mask=query_valid,
        r_max=thr, max_doublings=1,
    )
    ok = query_valid & torch.isfinite(sq[:, 0]) & (sq[:, 0] < thr * thr)
    return idx[:, 0].long(), ok, ov


def _chain_2d_device(uv_s, pv_s, uv_t, pv_t, pix, pmask, thr, mode: str):
    """3D voxel correspondences from 2D pixel matches (base:387-470): per
    source voxel, the nearest match source endpoint within ``thr`` px ->
    that match's target endpoint -> the nearest projected target voxel
    within ``thr``. ``mode`` is the reference's ``matches_from_2d_type``
    (nn_src_only / nn_mutual / nn_union). Returns ((N,) target voxel,
    (N,) valid, () overflow)."""
    if mode not in ("nn_src_only", "nn_mutual", "nn_union"):
        raise ValueError(
            f"unknown matches_from_2d_type mode '{mode}' (nn_src_only | nn_mutual | nn_union)"
        )
    m_idx, hop1, ov = _pixel_nn1(uv_s, pv_s, pix[:, 0:2], pmask, thr)
    t_idx, mask_src, ov2 = _pixel_nn1(pix[m_idx, 2:4], hop1, uv_t, pv_t, thr)
    ov = ov + ov2
    if mode == "nn_src_only":
        return t_idx, mask_src, ov
    # Reverse chain (base:431-470) for the mutual / union modes.
    m_idx_r, hop1r, ov3 = _pixel_nn1(uv_t, pv_t, pix[:, 2:4], pmask, thr)
    s_idx, mask_tgt, ov4 = _pixel_nn1(pix[m_idx_r, 0:2], hop1r, uv_s, pv_s, thr)
    ov = ov + ov3 + ov4
    back = s_idx[t_idx] == torch.arange(uv_s.shape[0], device=uv_s.device)
    mask_tgt_at_i = mask_tgt[t_idx]
    if mode == "nn_mutual":
        return t_idx, mask_src & mask_tgt_at_i & back, ov
    return t_idx, (mask_src | mask_tgt_at_i) & back, ov


def _lift_2d_device(s_cent, vvalid_s, t_cent, vvalid_t, uv_s, dep_s, pv_s, uv_t,
                    dep_t, pv_t, pix, pmask, sext, text, K, ctr, median_res,
                    image_size, v_flip):
    """Depth-map lifting (``lifting_type: interpolation``): z-buffer both
    projected voxel clouds (base:1436-1443), read the depth at each match
    endpoint's floor pixel (base:320-384), back-project (base:664-728) and
    associate each lifted endpoint with its nearest voxel within
    ``2 * median_res`` (one kernel-2 launch per side). A source voxel
    matched by several rows keeps the LAST valid row. Returns ((N,)
    target voxel, (N,) valid, () overflow)."""
    dmap_s, _ = rasterize_depth(uv_s, dep_s, pv_s, image_size)
    dmap_t, _ = rasterize_depth(uv_t, dep_t, pv_t, image_size)
    d_s, ok_s = bilinear_depth(dmap_s, pix[:, 0:2])
    d_t, ok_t = bilinear_depth(dmap_t, pix[:, 2:4])
    ok3 = pmask & ok_s & ok_t
    p_s = lift_pixels_to_world(pix[:, 0:2], d_s, sext, K, image_size, v_flip=v_flip) - ctr
    p_t = lift_pixels_to_world(pix[:, 2:4], d_t, text, K, image_size, v_flip=v_flip) - ctr
    thr3 = 2.0 * torch.clamp(median_res, min=1e-6)
    ds2, i_s, ov = knn_grid_traced(
        p_s, s_cent, 1, r0=thr3, ref_mask=vvalid_s, query_mask=ok3,
        r_max=thr3 * 1.001, max_doublings=1,
    )
    dt2, i_t, ov2 = knn_grid_traced(
        p_t, t_cent, 1, r0=thr3, ref_mask=vvalid_t, query_mask=ok3,
        r_max=thr3 * 1.001, max_doublings=1,
    )
    thr3_sq = thr3 * thr3
    ok = (
        ok3
        & torch.isfinite(ds2[:, 0]) & (ds2[:, 0] < thr3_sq)
        & torch.isfinite(dt2[:, 0]) & (dt2[:, 0] < thr3_sq)
    )
    win = _last_writer(i_s[:, 0], ok, s_cent.shape[0])
    t2d = i_t[torch.clamp(win, 0, pix.shape[0] - 1), 0].long()
    return t2d, win >= 0, ov + ov2


def _vote_2d_device(lab_s, lab_t, c2d_idx, c2d_valid, n_lab_s: int, n_lab_t: int):
    """Majority vote of per-voxel 2D matches into target superpoints
    (base:3019-3070): each source voxel with a valid 2D match votes for
    its matched target voxel's superpoint; each source superpoint takes
    the most-voted target, ties to the smallest target label. One stable
    sort on a composite int64 (source label, target label) key. Returns
    ((n_lab_s,) target label, sentinel clamped to ``n_lab_t - 1`` where no
    vote; (n_lab_s,) votes)."""
    V = lab_s.shape[0]
    dev = lab_s.device
    tlab = lab_t[torch.clamp(c2d_idx, 0, lab_t.shape[0] - 1)].long()
    ok = c2d_valid & (lab_s >= 0) & (tlab >= 0)
    k1 = torch.where(ok, lab_s.long(), n_lab_s)
    k2 = torch.where(ok, tlab, n_lab_t)
    span = max(n_lab_t, lab_t.shape[0]) + 1  # > every k2
    order = torch.sort(k1 * span + k2, stable=True).indices
    k1, k2 = k1[order], k2[order]
    idxs = torch.arange(V, device=dev)
    same = (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1])
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    first = torch.cat([one, ~same])
    last = torch.cat([~same, one])
    start = torch.cummax(torch.where(first, idxs, 0), dim=0).values
    count = idxs - start + 1  # run length, valid at each run's last slot
    emit = last & (k1 < n_lab_s)
    cnt_max = torch.zeros((n_lab_s + 1,), dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(emit, k1, n_lab_s), torch.where(emit, count, 0), "amax"
    )[:n_lab_s]
    is_best = emit & (count == cnt_max[torch.clamp(k1, 0, n_lab_s - 1)])
    vote_tgt = torch.full((n_lab_s + 1,), n_lab_t, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(is_best, k1, n_lab_s), k2, "amin"
    )[:n_lab_s]
    return torch.clamp(vote_tgt, max=n_lab_t - 1), cnt_max


class ExtrasTable(NamedTuple):
    sel: torch.Tensor  # (E,) source labels, valid extras first
    sel_ok: torch.Tensor  # (E,) the row holds a valid extra
    tgt: torch.Tensor  # (E,) its voted target label, -1 where not
    n_over: torch.Tensor  # () valid extras past the table


def _extras_table(vote_tgt, vote_cnt, svalid_s, tgt_of_src, pair_valid,
                  cap: int) -> ExtrasTable:
    """The per-level table of 2D-vote pairs that no 3D pair proposed
    (base:3019-3146): valid rows first in label order (a stable sort), at
    most ``cap`` rows; the overflow is counted."""
    extra_valid = (vote_cnt >= 1) & svalid_s & ~(pair_valid & (tgt_of_src == vote_tgt))
    sel = torch.sort((~extra_valid).to(torch.int8), stable=True).indices[:cap]
    sel_ok = extra_valid[sel]
    return ExtrasTable(
        sel=sel, sel_ok=sel_ok, tgt=torch.where(sel_ok, vote_tgt[sel], -1),
        n_over=extra_valid.sum() - sel_ok.sum(),
    )


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
    n_c2d: torch.Tensor  # () src voxels with a lifted 2D match (0 if no RGB)
    overflow_by_source: dict | None = None  # overflow split: {"sampler", "grid_knn"}


def _per_level_caps(cap, n_levels: int, flat: bool = False):
    """Per-level superpoint caps: each supervoxel level doubles the radius,
    so an int cap shrinks 4x a level down to 256; partition inputs carry
    no such guarantee and keep it flat (``flat``)."""
    if isinstance(cap, int):
        if flat:
            return (cap,) * n_levels
        floor = min(256, cap)
        return tuple(max(cap >> (2 * li), floor) for li in range(n_levels))
    return tuple(cap)


@tile("tile.fusion_step")
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
    k_max: int = 512,
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
    nested_levels: bool = True,
    coarse_mutual: bool = True,
    global_gated: bool = True,
    with_sparse: bool = True,
    with_tgt2src: bool = True,
    feat_dtype: str | None = None,
    sample_cap: int = 48,
    sample_priority: str = "knn",
    dips_draws=None,
    rng_seed: int = 0,
    sp_lab_src=None,
    sp_lab_tgt=None,
    pix_matches=None,
    pix_count=None,
    intrinsic=None,
    src_extrinsics=None,
    tgt_extrinsics=None,
    center=None,
    pixel_thres: float = 5.0,
    image_size: tuple[int, int] | None = None,
    v_flip: bool = True,
    lifting: str = "nn_search",
    matches_2d_mode: str = "nn_src_only",
    coarse_2d_mode: str = "fusion",
    fine_2d_mode: str = "fusion",
    extra_pair_cap: int = 0,
    weighting_svd: bool = False,
    timings: dict | None = None,
    device=None,
) -> Fusion3DTileResult:
    """One fusion tile: padded, centred (N, 3) ``src`` / (M, 3) ``tgt``
    clouds with masks, on ``device`` (default ``cuda``; a CUDA run without
    a card raises). ``dips`` and ``agg`` are the PointNetFeature and
    ClusterFeatureNet modules (moved to ``device``).

    With ``image_size`` and ``pix_matches`` (IP, Pc, 4) [su, sv, tu, tv]
    given, plus ``pix_count`` (IP,) valid rows per image pair,
    ``intrinsic`` (3, 3), ``src_extrinsics`` / ``tgt_extrinsics`` (IP, 4,
    4) world->camera and ``center`` (3,) (the world offset of the centred
    tile), the step runs the RGB 2D-match channel (module docstring).
    ``coarse_2d_mode`` / ``fine_2d_mode``: 'fusion', 'only_2d' or 'off';
    ``extra_pair_cap`` bounds the per-level extras table (0: ``max(sv_cap
    // 4, 64)``). Where a source superpoint has both a 3D pair and a
    differing 2D-vote pair, the 3D pair wins and the 2D pair claims only
    points the 3D pair left unassigned, as in the JAX step.

    ``sp_lab_src`` / ``sp_lab_tgt`` ((L, N) / (L, M) per-point labels of
    the ``levels``, -1 for none) replace the supervoxel levels;
    ``icp_type`` is the fine stage's solver (``ops/registration.py``).
    ``nested_levels`` (default True) segments each level above the first
    from the level below's supervoxel centroids; False segments the voxel
    cloud afresh at each level's radius, on the first level's graph and
    normals, as the JAX step does. The per-level caps shrink either way
    (JAX's ``_per_level_caps`` does not read the option).

    ``k_max``, ``sample_cap``, ``sample_priority`` and ``feat_dtype`` are
    the DIPs options of ``f2s3_device.dips_features_device``. The JAX step
    splits its PRNG key into the two clouds' draws (its
    ``pipelines/fusion_device.py:555``): here ``dips_draws`` (source,
    target ``DipsDraws``) gives them, and draws not given come from one
    ``torch.Generator`` on the device seeded with ``rng_seed`` (the
    source's first; kernel 1 draws nothing). Each stage is a span
    (``utils.timing``); ``timings`` (optional dict) accumulates per-stage
    seconds, synchronising the device at each stage boundary, and the
    kernels' work under ``counters`` (``utils.profiling``).
    """
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    smask = torch.as_tensor(smask, device=dev).to(torch.bool)
    tmask = torch.as_tensor(tmask, device=dev).to(torch.bool)
    dips, agg = dips.to(dev), agg.to(dev)
    f32 = src.dtype
    stages = StageTimer(timings, dev)
    with stages.stage("median_res_voxels"):
        N, M = src.shape[0], tgt.shape[0]

        # 1. median resolution + voxel subsampling on the union min corner.
        med_s, ov_s = median_nn_distance_traced(src, smask)
        med_t, ov_t = median_nn_distance_traced(tgt, tmask)
        median_res = torch.maximum(med_s, med_t)
        ov_grid = ov_s + ov_t  # window overflow by kernel, summed over the step
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

    with stages.stage("dips_features"):
        # 2. DIPs descriptors on the voxel clouds; support = full clouds.
        feat_kw = dict(k_max=k_max, patch_points=patch_points, chunk=chunk, sample_cap=sample_cap,
                       sample_priority=sample_priority, dtype=feat_dtype,
                       generator=torch.Generator(device=dev).manual_seed(rng_seed))
        draws_s, draws_t = dips_draws or (None, None)
        src_feat, ov_s = dips_features_device(dips, s_cent, src, smask, radius, draws=draws_s,
                                              query_count=s_nv, **feat_kw)
        tgt_feat, ov_t = dips_features_device(dips, t_cent, tgt, tmask, radius, draws=draws_t,
                                              query_count=t_nv, **feat_kw)
        ov_sampler = ov_s + ov_t

    with stages.stage("global_match"):
        # 3. Global 3D voxel matches: the banded magnitude-gated search, or
        # (global_gated=False) the reference's search-then-gate brute force
        # through kernel 3.
        if global_gated:
            _, g_idx, g_valid = gated_feature_nn1(
                src_feat, tgt_feat, s_cent, t_cent, max_magnitude, vvalid_s, vvalid_t
            )
        else:
            g_idx, g_valid = global_matches_3d(
                src_feat, tgt_feat, s_cent, t_cent, max_magnitude, vvalid_s, vvalid_t
            )

    # 3b. Voxel matches lifted from 2D pixel matches (base:1480-1675):
    # project both voxel clouds per image pair, chain or lift, merge
    # across pairs (the first valid pair wins), gate by magnitude.
    with_2d = image_size is not None and pix_matches is not None
    c2d_idx = torch.zeros((N,), dtype=torch.int64, device=dev)
    c2d_ok = torch.zeros((N,), dtype=torch.bool, device=dev)
    if with_2d:
        with stages.stage("rgb_2d"):
            if lifting not in ("nn_search", "interpolation"):
                raise ValueError(f"unknown lifting_type '{lifting}' (nn_search | interpolation)")
            image_size = tuple(int(v) for v in image_size)
            pix_all = torch.as_tensor(pix_matches, dtype=f32, device=dev)
            counts = torch.as_tensor(pix_count, device=dev)
            K = torch.as_tensor(intrinsic, dtype=f32, device=dev)
            sexts = torch.as_tensor(src_extrinsics, dtype=f32, device=dev)
            texts = torch.as_tensor(tgt_extrinsics, dtype=f32, device=dev)
            ctr = (torch.zeros((3,), dtype=f32, device=dev) if center is None
                   else torch.as_tensor(center, device=dev).to(f32))
            mm2 = torch.as_tensor(max_magnitude, dtype=f32, device=dev) ** 2
            for ip in range(pix_all.shape[0]):
                uv_s, dep_s, pv_s = project_points(s_cent + ctr, sexts[ip], K, image_size,
                                                   mask=vvalid_s, v_flip=v_flip)
                uv_t, dep_t, pv_t = project_points(t_cent + ctr, texts[ip], K, image_size,
                                                   mask=vvalid_t, v_flip=v_flip)
                pix = pix_all[ip]
                pmask = torch.arange(pix.shape[0], device=dev) < counts[ip]
                if lifting == "interpolation":
                    t2d, v2d, ov = _lift_2d_device(
                        s_cent, vvalid_s, t_cent, vvalid_t, uv_s, dep_s, pv_s, uv_t, dep_t,
                        pv_t, pix, pmask, sexts[ip], texts[ip], K, ctr, median_res,
                        image_size, v_flip,
                    )
                else:
                    t2d, v2d, ov = _chain_2d_device(uv_s, pv_s, uv_t, pv_t, pix, pmask,
                                                    pixel_thres, matches_2d_mode)
                ov_grid = ov_grid + ov
                mag2 = ((t_cent[t2d] - s_cent) ** 2).sum(dim=1)
                fill = ~c2d_ok & v2d & (mag2 <= mm2)
                c2d_idx = torch.where(fill, t2d, c2d_idx)
                c2d_ok = c2d_ok | fill

    base_svl = torch.clamp(radius, min=float(voxel_size_init))
    use_partition_inputs = sp_lab_src is not None
    if use_partition_inputs:
        # Per-point partition labels (L, N) / (L, M), -1 for none: each
        # voxel takes its first member point's label, as the host tile.
        sp_lab_src = torch.as_tensor(sp_lab_src, device=dev).to(torch.int32)
        sp_lab_tgt = torch.as_tensor(sp_lab_tgt, device=dev).to(torch.int32)
        first_s = torch.full((N,), N, dtype=torch.int64, device=dev).scatter_reduce(
            0, s_p2v.long(), torch.arange(N, device=dev), reduce="amin")
        first_t = torch.full((M,), M, dtype=torch.int64, device=dev).scatter_reduce(
            0, t_p2v.long(), torch.arange(M, device=dev), reduce="amin")
    else:
        with stages.stage("graph_normals"):
            gi_s, gm_s, ov_s = supervoxel_graph(s_cent, base_svl, vvalid_s,
                                                k_neighbors=k_neighbors)
            nrm_s = pca_normals(s_cent, vvalid_s, neigh_idx=gi_s, neigh_mask=gm_s)
            gi_t, gm_t, ov_t = supervoxel_graph(t_cent, base_svl, vvalid_t,
                                                k_neighbors=k_neighbors)
            ov_sampler = ov_sampler + ov_s + ov_t
            nrm_t = pca_normals(t_cent, vvalid_t, neigh_idx=gi_t, neigh_mask=gm_t)

    eye = torch.eye(3, dtype=f32, device=dev)
    merged_R = eye.repeat(N, 1, 1)
    merged_t = torch.zeros((N, 3), dtype=f32, device=dev)
    merged_valid = torch.zeros((N,), dtype=torch.bool, device=dev)
    merged_rmse = torch.zeros((N,), dtype=f32, device=dev)
    t2s_R = eye.repeat(M, 1, 1)
    t2s_t = torch.zeros((M, 3), dtype=f32, device=dev)
    t2s_valid = torch.zeros((M,), dtype=torch.bool, device=dev)
    n_dropped = torch.zeros((), dtype=torch.int64, device=dev)

    sv_caps = _per_level_caps(sv_cap, len(levels), use_partition_inputs)
    sv_caps_t = (sv_caps if sv_cap_tgt is None
                 else _per_level_caps(sv_cap_tgt, len(levels), use_partition_inputs))

    lab_s_prev = lab_t_prev = n_s_prev = n_t_prev = None
    for li, level in enumerate(levels):
        with stages.stage("partition"):
            sv_cap_l, sv_cap_tl = sv_caps[li], sv_caps_t[li]
            svl_radius = base_svl * (2.0 ** (int(level) - 1))
            if use_partition_inputs:
                raw_s = torch.where(vvalid_s & (first_s < N),
                                    sp_lab_src[li][torch.clamp(first_s, max=N - 1)], -1)
                raw_t = torch.where(vvalid_t & (first_t < M),
                                    sp_lab_tgt[li][torch.clamp(first_t, max=M - 1)], -1)
            elif li == 0 or not nested_levels:
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
                ov_sampler = ov_sampler + ov_s + ov_t
            lab_s, n_s = drop_small_and_compact(raw_s, vvalid_s, small_patch)
            lab_t, n_t = drop_small_and_compact(raw_t, vvalid_t, small_patch)
            lab_s_prev, n_s_prev, lab_t_prev, n_t_prev = lab_s, n_s, lab_t, n_t
        with stages.stage("aggregate_coarse"):

            mem_s, memmask_s = label_members(lab_s, sv_cap_l, member_cap)
            mem_t, memmask_t = label_members(lab_t, sv_cap_tl, member_cap)
            in_table = torch.zeros((N,), dtype=torch.bool, device=dev)
            in_table[mem_s[memmask_s].long()] = True
            n_dropped = n_dropped + (vvalid_s & (lab_s >= 0) & ~in_table).sum()

            svalid_s = torch.arange(sv_cap_l, device=dev) < n_s
            svalid_t = torch.arange(sv_cap_tl, device=dev) < n_t
            if with_2d and coarse_2d_mode == "only_2d":
                # Reference coarse_matching_only_2d: the 2D votes alone propose
                # pairs; no aggregation, no 3D coarse matcher.
                vote_tgt, vote_cnt = _vote_2d_device(lab_s, lab_t, c2d_idx, c2d_ok,
                                                     sv_cap_l, sv_cap_tl)
                tgt_of_src, pair_valid = vote_tgt, (vote_cnt >= 1) & svalid_s
            else:
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
                tgt_of_src = tgt_of_src.long()
            mem_f, memmask_f = mem_s, memmask_s & pair_valid[:, None]
            tgtlab_f = torch.where(pair_valid, tgt_of_src, -1)

            # 4b. Coarse fusion (base:3019-3146): 2D majority votes that no 3D
            # pair proposed go to a compacted extras table, appended to the
            # fine solve (valid rows first, in label order).
            fusion_votes = with_2d and coarse_2d_mode == "fusion"
            if fusion_votes:
                vote_tgt, vote_cnt = _vote_2d_device(lab_s, lab_t, c2d_idx, c2d_ok,
                                                     sv_cap_l, sv_cap_tl)
                ext = _extras_table(vote_tgt, vote_cnt, svalid_s, tgt_of_src, pair_valid,
                                    extra_pair_cap or max(sv_cap_l // 4, 64))
                E_l = ext.sel.shape[0]
                n_dropped = n_dropped + ext.n_over
                mem_f = torch.cat([mem_s, mem_s[ext.sel]])
                memmask_f = torch.cat([memmask_f, memmask_s[ext.sel] & ext.sel_ok[:, None]])
                tgtlab_f = torch.cat([tgtlab_f, ext.tgt])
        with stages.stage("fine"):

            # 5. Fine matching per pair; with 2D matches in 'fusion' mode a
            # second correspondence channel inside each pair (base:3258-3296).
            if with_2d and fine_2d_mode == "only_2d":
                ch1_idx, ch1_valid = c2d_idx, c2d_ok
            else:
                ch1_idx, ch1_valid = g_idx, g_valid
            fine_kw = {}
            if with_2d and fine_2d_mode == "fusion":
                fine_kw = dict(corres2_tgt_idx=c2d_idx, corres2_valid=c2d_ok,
                               weighting=weighting_svd)
            fine = fine_match_pairs(
                mem_f, memmask_f, tgtlab_f.to(torch.int32), ch1_idx, ch1_valid, lab_t,
                s_cent, t_cent,
                num_min_quality=num_min_quality, thres_dist_diff=thres_dist_diff,
                thres_inlier_ratio=thres_inlier_ratio, num_min_fine=num_min_fine,
                icp_threshold=icp_threshold, icp_max_iter=icp_max_iter,
                icp_type=icp_type, fine_max_matches=fine_max_matches, **fine_kw,
            )
            lab_ok = fine.valid[:sv_cap_l] & pair_valid & svalid_s
        with stages.stage("merge"):

            # 6. Dense per-point assignment, merged by level priority.
            pt_vox = torch.clamp(s_p2v, 0, N - 1).long()
            pt_label = torch.where(smask & (s_p2v < s_nv), lab_s[pt_vox], -1)
            pl = torch.clamp(pt_label, 0, sv_cap_l - 1).long()

            def assign(has, rows):
                nonlocal merged_R, merged_t, merged_rmse, merged_valid
                take = has & ~merged_valid
                merged_R = torch.where(take[:, None, None], fine.R[rows], merged_R)
                merged_t = torch.where(take[:, None], fine.t[rows], merged_t)
                merged_rmse = torch.where(take, fine.rmse[rows], merged_rmse)
                merged_valid = merged_valid | take

            assign((pt_label >= 0) & lab_ok[pl], pl)
            if fusion_votes:
                # A 2D-vote pair claims its superpoint's points only where the
                # 3D pair (and earlier levels) left them unassigned.
                e_fine_ok = fine.valid[sv_cap_l:] & ext.sel_ok
                row_of_lab = _last_writer(ext.sel, ext.sel_ok, sv_cap_l)
                prow = row_of_lab[pl]
                prow_c = torch.clamp(prow, 0, E_l - 1)
                assign((pt_label >= 0) & (prow >= 0) & e_fine_ok[prow_c], sv_cap_l + prow_c)

            if with_tgt2src:
                # Each pair's inverse transform applies to the TARGET patch's
                # points (base:3386-3393); on a shared target label the 3D
                # pair wins over an extra, and a later row over an earlier one.
                Rinv = fine.R.transpose(-1, -2)
                tinv = -torch.einsum("sij,sj->si", Rinv, fine.t)
                rows = _last_writer(tgt_of_src, lab_ok, sv_cap_tl)
                if fusion_votes:
                    rows_e = _last_writer(ext.tgt, e_fine_ok, sv_cap_tl)
                    rows = torch.where(rows >= 0, rows,
                                       torch.where(rows_e >= 0, sv_cap_l + rows_e, -1))
                pair_ok = rows >= 0
                rc = torch.clamp(rows, min=0)
                tp_vox = torch.clamp(t_p2v, 0, M - 1).long()
                tp_label = torch.where(tmask & (t_p2v < t_nv), lab_t[tp_vox], -1)
                tpl = torch.clamp(tp_label, 0, sv_cap_tl - 1).long()
                ttake = (tp_label >= 0) & pair_ok[tpl] & ~t2s_valid
                t2s_R = torch.where(ttake[:, None, None], Rinv[rc[tpl]], t2s_R)
                t2s_t = torch.where(ttake[:, None], tinv[rc[tpl]], t2s_t)
                t2s_valid = t2s_valid | ttake
    with stages.stage("dense_sparse_out"):

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
            ov_grid = ov_grid + ov
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

    return Fusion3DTileResult(
        moved=moved, valid=merged_valid, rmse=merged_rmse, sparse_tgt=sparse_tgt,
        sparse_ok=sparse_ok, t2s_src_est=t2s_src_est, t2s_valid=t2s_valid,
        median_res=median_res, n_vox_src=s_nv, n_vox_tgt=t_nv,
        n_dropped=n_dropped, overflow=int(ov_sampler + ov_grid),
        n_c2d=(c2d_ok & vvalid_s).sum() if with_2d else torch.zeros((), dtype=torch.int64, device=dev),
        overflow_by_source={"sampler": int(ov_sampler), "grid_knn": int(ov_grid)},
    )
