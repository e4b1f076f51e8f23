"""The F2S3 pipeline: DIPs descriptors, feature-space 1-NN and the learned
per-supervoxel outlier filter.

Port of ``fusion4landslide_tpu.pipelines.f2s3`` (reference
``Deformation_Analyze``, src/f2s3.py:19-507):

- ``compute_dips_features``: for patch sizes that are multiples of 128
  the JAX function's accelerator branch: one radius sampler sweep (kernel
  1, ``'random'`` priority, seed 0 — the sampler's fixed seed matches the
  reference's ``setup_seed(0)``) draws each patch's in-radius subset, then
  LRF + PointNet run in chunks. The sampler's window is fitted to the
  largest query block's (``hashgrid_cuda.fitted_window``: no block is
  truncated; JAX's TPU window truncates the blocks that exceed it, on
  tiles of ~1M core points). The whole padded query cloud is sorted and
  blocked ONCE, exactly as the window prologue does (kernel 1 centres on
  each 512-query block's mean, so re-blocking per chunk would move
  borderline radius decisions); the kernel and the network then run over
  consecutive ranges of those blocks, so the whole-cloud (n, P, 3) sampler
  output never exists at once. Rows at or past ``n_core`` (padding) skip
  the network and get zero descriptors. Other patch sizes take the JAX
  function's second branch: per chunk of ``chunk`` queries, the exact
  ``k_max`` nearest support points and a random ``patch_points`` subset
  of those in the radius (``ops.lrf.extract_lrf_patches``), with one
  (chunk, k_max) draw of uniform priorities per chunk (``DipsDraws`` or a
  ``torch.Generator``). ``dtype='bfloat16'`` runs the PointNet trunks in
  bf16 (``models.dips``); descriptors are float32 either way.
- ``drop_small_and_compact``: small-supervoxel removal and label
  compaction, shared by both F2S3 tiles and the fusion step.
- ``filter_supervoxel_buckets``: the FilteringNetwork and the robust
  Kabsch re-fit over dense (S, P) supervoxel member tables.
- ``prune_supervoxel_correspondences``, ``write_f2s3_outputs`` and
  ``run_f2s3_tile``: the host tile (``main_f2s3.py`` on one device) and
  the result tables shared with ``parallel.pipeline.run_f2s3_tiles``.

The host tile keeps the reference's feature cache (f2s3.py:97-101,
139-149): ``save_interim: true`` writes each tile's descriptors to
``<output_dir>/<output_folder>/features/features_tile_<id>.npz`` (keys
``src_feat`` / ``tgt_feat``, the JAX package's file), and ``feat_compute:
false`` loads that file where it exists instead of running DIPs. It is not
the fusion host tile's cache (``pipelines/driver.py``, under ``interim/``).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import NamedTuple

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.io.results import save_dvfms, save_txt, visual_clamp_magnitude
from fusion4landslide_tpu_torch.models.dips import feat_torch_dtype
from fusion4landslide_tpu_torch.models.filtering import filter_correspondences
from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, nn1_spatial
from fusion4landslide_tpu_torch.ops.hashgrid_cuda import (
    block_centres,
    radius_sample_blocks,
    window_prologue,
)
from fusion4landslide_tpu_torch.ops.kabsch import transform_points
from fusion4landslide_tpu_torch.ops.knn import median_nn_distance_counted, nn1
from fusion4landslide_tpu_torch.ops.lrf import extract_lrf_patches, lrf_patches_from_neighbors
from fusion4landslide_tpu_torch.ops.segments import bucket_size, label_members
from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_segmentation
from fusion4landslide_tpu_torch.utils.timing import StageTimer

__all__ = [
    "DipsDraws",
    "compute_dips_features",
    "drop_small_and_compact",
    "filter_supervoxel_buckets",
    "is_rockfall",
    "prune_supervoxel_correspondences",
    "run_f2s3_tile",
    "write_f2s3_outputs",
]

#: Query blocks per sampler launch (65536 queries at block 512).
_SAMPLE_BLOCKS = 128
#: Window positions per sampler scan step; the fitted window is a whole
#: number of them.
_SAMPLE_CHUNK = 2048


class DipsDraws(NamedTuple):
    """The random draws of the DIPs branches other than kernel 1's (the
    JAX package takes them from ``jax.random``), as inputs. ``'knn'``:
    ``priorities`` (rows, k_max) uniform [0, 1), one row per padded query
    row (the JAX function draws ``uniform(key_c, (chunk, k_max))`` per
    chunk c). ``'random'``: ``perm`` (m,) the support permutation and
    ``seed`` the sampler's hash seed."""

    priorities: torch.Tensor | None = None
    perm: torch.Tensor | None = None
    seed: int | None = None


def chunk_priorities(draws: DipsDraws | None, c0: int, rows: int):
    """Rows ``c0 .. c0 + rows`` of the drawn priorities (None: draw)."""
    if draws is None or draws.priorities is None:
        return None
    return draws.priorities[c0:c0 + rows]


@torch.inference_mode()
def compute_dips_features(model, core_pts, halo_pts, radius, *, k_max: int = 512,
                          patch_points: int = 256, chunk: int = 2048, halo_mask=None,
                          n_core=None, dtype=None, draws: DipsDraws | None = None,
                          generator=None):
    """((n, 64) descriptors of ``core_pts`` with patches from ``halo_pts``,
    () sampler window overflow count). ``n_core``: exclusive bound on the
    valid query rows (padded clouds); rows at or past it get zeros.
    ``dtype``: the trunks' compute dtype (``feat_dtype``: None, 'float32'
    or 'bfloat16'). Patch sizes that are not a multiple of 128 take the
    exact-kNN branch (module docstring) with ``draws.priorities`` or draws
    from ``generator``; it overflows nothing."""
    tdt = feat_torch_dtype(dtype)
    if patch_points % 128:
        return _dips_features_knn(model, core_pts, halo_pts, radius, k_max=k_max,
                                  patch_points=patch_points, chunk=chunk, halo_mask=halo_mask,
                                  n_core=n_core, dtype=tdt, draws=draws, generator=generator)
    n = core_pts.shape[0]
    dev = core_pts.device
    nb = max(bucket_size(n), chunk)
    nb = -(-nb // chunk) * chunk
    q = torch.cat([core_pts, core_pts.new_zeros((nb - n, 3))])
    m = halo_pts.shape[0]
    mb = bucket_size(m)
    halo_p = torch.cat([halo_pts, halo_pts.new_zeros((mb - m, 3))])
    hmask = (
        torch.ones((m,), dtype=torch.bool, device=dev)
        if halo_mask is None
        else halo_mask.to(torch.bool)
    )
    hmask_p = torch.cat([hmask, hmask.new_zeros((mb - m,))])
    radius_q = torch.as_tensor(radius, dtype=torch.float32, device=dev)

    grid = build_hash_grid(halo_p, radius_q, hmask_p)
    win = window_prologue(q, grid, fit_chunk=_SAMPLE_CHUNK)
    cen = block_centres(win)
    r2 = radius_q**2
    n_valid = n if n_core is None else int(n_core)
    feats = torch.zeros((n, 64), dtype=torch.float32, device=dev)
    for b0 in range(0, win.nb, _SAMPLE_BLOCKS):
        b1 = min(win.nb, b0 + _SAMPLE_BLOCKS)
        rows = win.qrow[b0 * win.block:b1 * win.block].long()
        keep = (rows >= 0) & (rows < n_valid)
        if not bool(keep.any()):
            continue
        _, valid, xyz = radius_sample_blocks(
            win, cen, r2, patch_points, 0, "random", chunk=_SAMPLE_CHUNK, b0=b0, b1=b1
        )
        sel = torch.nonzero(keep).squeeze(1)
        qpos = win.qpos[b0 * win.block:b1 * win.block]
        for c0 in range(0, sel.shape[0], chunk):
            s = sel[c0:c0 + chunk]
            patches = lrf_patches_from_neighbors(qpos[s], xyz[s], valid[s], radius_q)
            feats[rows[s]] = model(patches, tdt)
    return feats, win.overflow


def _dips_features_knn(model, core_pts, halo_pts, radius, *, k_max, patch_points, chunk,
                       halo_mask, n_core, dtype, draws, generator):
    """The JAX function's second branch: zero-padded chunks of ``chunk``
    queries, each through ``extract_lrf_patches`` (its own (chunk, k_max)
    priorities) and the network; chunks at or past ``n_core`` are skipped
    and those rows are zero."""
    n = core_pts.shape[0]
    n_valid = n if n_core is None else int(n_core)
    q = torch.cat([core_pts, core_pts.new_zeros(((-n) % chunk, 3))])
    feats = torch.zeros((n, 64), dtype=torch.float32, device=core_pts.device)
    for c0 in range(0, min(n_valid, n), chunk):
        patches = extract_lrf_patches(
            q[c0:c0 + chunk], halo_pts, radius, chunk_priorities(draws, c0, chunk), k_max=k_max,
            num_points=patch_points, support_mask=halo_mask, generator=generator)
        feats[c0:c0 + chunk] = model(patches, dtype)[:n - c0]
    feats[n_valid:] = 0.0
    return feats, 0


def drop_small_and_compact(labels: torch.Tensor, valid: torch.Tensor, min_count):
    """Labels with <= min_count valid members become -1; survivors are
    renumbered 0..K-1 in order. Returns (labels (n,), n_labels ())."""
    n = labels.shape[0]
    has = valid & (labels >= 0)
    lab0 = torch.where(has, labels, 0).long()
    counts = torch.zeros((n,), dtype=torch.int32, device=labels.device)
    counts.index_add_(0, lab0, has.to(torch.int32))
    ok = has & (counts[lab0] > min_count)
    used = torch.zeros((n,), dtype=torch.int32, device=labels.device).scatter_reduce(
        0, lab0, ok.to(torch.int32), reduce="amax"
    )
    remap = torch.cumsum(used, 0) - 1
    new = torch.where(ok, remap[lab0], -1)
    return new.to(torch.int32), used.sum()


#: Score above which a correspondence survives a non-robust supervoxel
#: (f2s3.py:363).
_KEEP_SCORE = 0.99999
#: Supervoxels per filter chunk.
_S_CHUNK = 64


@torch.inference_mode()
def filter_supervoxel_buckets(filt, correspondences, member_idx, member_mask, *,
                              rockfall: bool = False):
    """FilteringNetwork + robust Kabsch re-fit over supervoxel buckets
    (reference filter_input, outlier_classifier.py:65-105, and
    f2s3.py:340-366), chunked over S; the (chunk, P, 6) correspondence
    slab is gathered per chunk.

    Per supervoxel ``models.filtering.filter_correspondences``: where its
    estimate is robust, every member's target becomes the rigid prediction
    and every member is kept; otherwise the matched target stays and only
    scores > 0.99999 are kept.

    Returns (new_tgt (S, P, 3), keep (S, P), scores (S, P), robust (S,)).
    Chunks with no member are skipped: their rows are masked out of every
    output (keep False, score 0, robust False; new_tgt is 0 there, where
    the JAX function carries point 0's target)."""
    S, P = member_idx.shape
    dev = correspondences.device
    new_tgt = torch.zeros((S, P, 3), dtype=torch.float32, device=dev)
    keep = torch.zeros((S, P), dtype=torch.bool, device=dev)
    scores = torch.zeros((S, P), dtype=torch.float32, device=dev)
    robust = torch.zeros((S,), dtype=torch.bool, device=dev)
    live = member_mask.any(dim=1)
    for s0 in range(0, S, _S_CHUNK):
        sl = slice(s0, s0 + _S_CHUNK)
        if not bool(live[sl].any()):
            continue
        m = member_mask[sl]
        c = correspondences[member_idx[sl].long()]  # (sc, P, 6)
        f = filter_correspondences(filt, c, m, rockfall=rockfall)
        sc, rob = f["scores"], f["robust_estimate"]
        pred = transform_points(c[..., :3], f["R"], f["t"])
        new_tgt[sl] = torch.where(rob[:, None, None], pred, c[..., 3:6])
        keep[sl] = torch.where(rob[:, None], m, m & (sc > _KEEP_SCORE))
        scores[sl] = sc
        robust[sl] = rob
    return new_tgt, keep, scores, robust


def prune_supervoxel_correspondences(filt, correspondences: np.ndarray,
                                     labels: np.ndarray, *, rockfall: bool = False,
                                     refine_results: bool = True, device=None):
    """Host orchestration of the per-supervoxel filter with uncapped
    buckets (P and S bucketed from the largest supervoxel and the label
    count). Returns (updated correspondences (n, 6), keep mask (n,))."""
    n_labels = int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 0
    if n_labels == 0:
        return correspondences, np.zeros(len(labels), bool)
    dev = resolve_device(device)
    counts = np.bincount(labels[labels >= 0], minlength=n_labels)
    P = bucket_size(int(counts.max()))
    S = bucket_size(n_labels)
    member_idx, member_mask = label_members(
        torch.from_numpy(labels.astype(np.int32)).to(dev), S, P
    )
    corr = torch.from_numpy(np.asarray(correspondences, np.float32)).to(dev)
    new_tgt, keep, scores, _ = filter_supervoxel_buckets(
        filt.to(dev), corr, member_idx, member_mask, rockfall=rockfall
    )
    if not refine_results:
        keep = member_mask & (scores > _KEEP_SCORE)
        new_tgt = corr[member_idx.long()][..., 3:6]
    mm = member_mask.cpu().numpy()
    flat_idx = member_idx.cpu().numpy()[mm]
    out = correspondences.copy()
    keep_pts = np.zeros(len(labels), bool)
    out[flat_idx, 3:6] = new_tgt.cpu().numpy()[mm]
    keep_pts[flat_idx] = keep.cpu().numpy()[mm]
    return out, keep_pts


def write_f2s3_outputs(cfg, tile_id, center: np.ndarray, s: np.ndarray,
                       t: np.ndarray, pruned: np.ndarray, keep: np.ndarray, *,
                       c2c: np.ndarray | None = None, logger=None,
                       device=None) -> dict:
    """Write one tile's F2S3 result tables (reference f2s3.py:369-477):
    the max-magnitude gate, ``f2s3_dvfs_of_tile_*`` / ``f2s3_dvfms_of_tile_*``
    (+ the ``_visualize_0_5`` clamp), the 30x-median magnitude filter and
    the C2C gap fill. ``s`` / ``t`` / ``pruned`` are centred on ``center``;
    ``c2c`` (n,) spatial 1-NN distances, computed here (on ``device``)
    when the gap fill needs them and none are given."""
    out_root = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")))
    results_dir = osp.join(out_root, "results")
    os.makedirs(results_dir, exist_ok=True)

    filtered = pruned[keep]
    mags = np.linalg.norm(filtered[:, 3:6] - filtered[:, :3], axis=1)
    # Max-magnitude gate (f2s3.py:392-394).
    max_disp = float(cfg.get("max_disp_magnitude", 0) or 0)
    if max_disp > 0:
        sel = mags <= max_disp
        filtered, mags = filtered[sel], mags[sel]

    final = np.hstack([filtered[:, :3] + center, filtered[:, 3:6] + center])
    save_txt(osp.join(results_dir, f"f2s3_dvfs_of_tile_{tile_id}.txt"), final)
    dvfms = save_dvfms(osp.join(results_dir, f"f2s3_dvfms_of_tile_{tile_id}.txt"), final, mags)
    if dvfms.shape[0] > 2:
        save_txt(
            osp.join(results_dir, f"f2s3_dvfms_of_tile_{tile_id}_visualize_0_5.txt"),
            visual_clamp_magnitude(dvfms, max_magnitude=5.0),
        )

    # Median-magnitude filter: drop > 30x median (f2s3.py:427-449).
    if cfg.get("filter_median_magnitude", False) and mags.size:
        sel = mags < 30 * np.median(mags)
        save_txt(
            osp.join(results_dir, "filtered_by_magnitude",
                     f"f2s3_dvfms_filtered_by_median_mag_of_tile_{tile_id}.txt"),
            np.hstack([final[sel][:, :3], mags[sel][:, None]]),
        )

    # C2C gap fill: C2C distance everywhere, learned magnitudes at kept
    # points (f2s3.py:452-477).
    if cfg.get("fill_gaps_c2c", False):
        if c2c is None:
            dev = resolve_device(device)
            c2c_sq, _ = nn1_spatial(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
            c2c = np.sqrt(c2c_sq.cpu().numpy())
        else:
            c2c = np.asarray(c2c).copy()
        kept_idx = np.where(keep)[0]
        kmags = np.linalg.norm(pruned[kept_idx][:, 3:6] - pruned[kept_idx][:, :3], axis=1)
        if max_disp > 0:
            ksel = kmags <= max_disp
            kept_idx, kmags = kept_idx[ksel], kmags[ksel]
        c2c[kept_idx] = kmags
        save_txt(
            osp.join(results_dir, "combined_with_c2c",
                     f"f2s3_dvfms_combined_with_c2c_of_tile_{tile_id}.txt"),
            np.hstack([s + center, c2c[:, None]]),
        )
    return {"dvfs": final, "magnitudes": mags}


def is_rockfall(cfg) -> bool:
    """The rockfall dataset switch of the reference (f2s3.py:185-186,
    outlier_classifier.py:76-79): supervoxel radius 0.1, inlier coeff 2.5."""
    return "rockfall" in str(cfg.get("output_dir", "")).lower() or str(
        cfg.get("dataset", "")
    ).lower().startswith("rockfall")


@torch.inference_mode()
def run_f2s3_tile(cfg, dips, filt, src_core: np.ndarray, tgt_core: np.ndarray, *,
                  src_halo: np.ndarray | None = None,
                  tgt_halo: np.ndarray | None = None, tile_id=0, logger=None,
                  device=None, timings: dict | None = None) -> dict:
    """One F2S3 tile, host-orchestrated (``main_f2s3.py`` on one device):
    centre, median resolution, DIPs, supervoxels with small-patch removal,
    feature 1-NN (kernel 3), the pre-pruning table, learned pruning and
    the result tables. ``cfg`` keys as in ``configs/landslide/f2s3_brienz.yaml``.
    Runs on ``device`` (default ``cuda``); ``timings`` (optional dict)
    collects per-stage seconds, synchronised at each stage boundary.

    ``feat_compute: false`` loads the tile's descriptors from its cache
    file where it exists (stage ``feature_cache`` in place of
    ``dips_features``; the sampler does not run); ``save_interim: true``
    writes them there after computing them (float32 on disk, whatever
    ``feat_dtype`` is).

    As in the JAX host tile, patches have 256 points whatever
    ``feat_patch_points`` says; ``feat_dtype`` and ``feat_k_max`` are
    read."""
    feat_kw = dict(k_max=int(cfg.get("feat_k_max", 512)), dtype=cfg.get("feat_dtype"))
    feat_torch_dtype(feat_kw["dtype"])  # an unknown dtype raises before tile work
    dev = resolve_device(device)
    timer = StageTimer(timings, dev)
    dips, filt = dips.to(dev).eval(), filt.to(dev).eval()
    src_halo = src_core if src_halo is None else src_halo
    tgt_halo = tgt_core if tgt_halo is None else tgt_halo
    center = src_core.mean(axis=0)
    s = (src_core - center).astype(np.float32)
    t = (tgt_core - center).astype(np.float32)
    sh = torch.from_numpy((src_halo - center).astype(np.float32)).to(dev)
    th = torch.from_numpy((tgt_halo - center).astype(np.float32)).to(dev)
    s_d, t_d = torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)

    # 1. median resolution -> patch radius (f2s3.py:106, 481-507).
    med_s, mov_s = median_nn_distance_counted(s_d)
    med_t, mov_t = median_nn_distance_counted(t_d)
    median_res = max(float(med_s), float(med_t))
    radius = float(np.sqrt(3) * 10.0 * median_res)
    timer.mark("median_res")
    if logger:
        logger.info("tile %s: median_res=%.4f, patch radius=%.4f", tile_id, median_res, radius)

    # 2. DIPs descriptors, patches from the halo clouds (f2s3.py:111-114),
    # or the tile's cached ones (f2s3.py:97-101, 139-149).
    out_root = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")))
    feat_cache = osp.join(out_root, "features", f"features_tile_{tile_id}.npz")
    if not cfg.get("feat_compute", True) and osp.exists(feat_cache):
        with np.load(feat_cache) as cached:
            src_feat, tgt_feat = (torch.from_numpy(np.asarray(cached[k], np.float32)).to(dev)
                                  for k in ("src_feat", "tgt_feat"))
        ov_s = ov_t = 0
        timer.mark("feature_cache")
        if logger:
            logger.info("tile %s: features loaded from %s", tile_id, feat_cache)
    else:
        src_feat, ov_s = compute_dips_features(dips, s_d, sh, radius, **feat_kw)
        tgt_feat, ov_t = compute_dips_features(dips, t_d, th, radius, **feat_kw)
        timer.mark("dips_features")
        if cfg.get("save_interim", False):
            os.makedirs(osp.dirname(feat_cache), exist_ok=True)
            np.savez_compressed(feat_cache, src_feat=src_feat.cpu().numpy(),
                                tgt_feat=tgt_feat.cpu().numpy())
            timer.mark("feature_cache")

    # 3. Supervoxels of the source, small patches removed, labels compacted
    # (f2s3.py:183-225).
    svl_radius = max(radius, float(cfg.get("voxel_size", 0.0)))
    if is_rockfall(cfg):
        svl_radius = 0.1
    seg = supervoxel_segmentation(s_d, svl_radius, k_neighbors=int(cfg.get("n_normals", 30)))
    min_count = 10 if cfg.get("small_patch_removal", True) else 1
    labels, n_kept = drop_small_and_compact(
        seg.labels, torch.ones_like(seg.labels, dtype=torch.bool), min_count
    )
    labels = labels.cpu().numpy()
    timer.mark("supervoxels")
    if logger:
        logger.info("tile %s: %d supervoxels kept", tile_id, int(n_kept))

    # 4. Feature-space 1-NN correspondences (f2s3.py:273-285), kernel 3.
    _, nn_idx = nn1(src_feat, tgt_feat)
    correspondences = np.hstack([s, t[nn_idx.cpu().numpy()]])
    timer.mark("feature_nn1")

    # Pre-pruning table (f2s3.py:286-294).
    results_dir = osp.join(out_root, "results")
    mag0 = np.linalg.norm(correspondences[:, 3:6] - correspondences[:, :3], axis=1)
    save_txt(
        osp.join(results_dir, f"f2s3_dvfms_without_pruning_of_tile_{tile_id}.txt"),
        np.hstack([correspondences[:, :3] + center, mag0[:, None]]),
    )

    # 5. Per-supervoxel pruning (f2s3.py:321-366).
    pruned, keep = prune_supervoxel_correspondences(
        filt, correspondences, labels, rockfall=svl_radius == 0.1,
        refine_results=bool(cfg.get("refine_results", True)), device=dev,
    )
    timer.mark("filter")
    # 6.-8. Gates, dvf(m)s, median filter, C2C fill.
    written = write_f2s3_outputs(cfg, tile_id, center, s, t, pruned, keep,
                                 logger=logger, device=dev)
    timer.mark("tables")
    return {
        "dvfs": written["dvfs"],
        "magnitudes": written["magnitudes"],
        "keep": keep,
        "labels": labels,
        "overflow": int(ov_s) + int(ov_t) + int(seg.overflow) + mov_s + mov_t,
        "overflow_by_source": {"sampler": int(ov_s) + int(ov_t) + int(seg.overflow),
                               "grid_knn": mov_s + mov_t},
        "src_feat": src_feat.cpu().numpy(),
        "tgt_feat": tgt_feat.cpu().numpy(),
    }
