"""Tile runners for the fusion step (3D-only or RGB+3D), the F2S3 step,
the RGB-guided step and piecewise ICP: one tile stream per device entry.

Port of ``fusion4landslide_tpu.parallel.pipeline``'s
``run_fusion3d_tiles_sharded``, ``run_f2s3_tiles_sharded``,
``run_rgb_guided_tiles_sharded`` and ``run_piecewise_tiles_sharded``. The
JAX mesh runs tiles with no collectives, so the multi-GPU form is one
tile stream per GPU: ``devices=["cuda:0", "cuda:1", ...]`` runs one
worker thread per entry, each with its own copy of the models on its
device and its own ``torch.cuda.Stream`` (an entry may repeat: two
streams on one card). Tiles go out in order and results come back in tile
order; one entry (or ``device=``) runs the tiles inline, on the calling
thread. Statics and the padded buckets are derived once per run from the
config and the largest tiles, exactly as the JAX runners derive them, so a
tile's result does not depend on how many streams ran. Each tile is
centred on its source mean, padded to its bucket, run through its tile
step, and its result tables (``c2f_*`` / ``f2s3_*`` / ...) are written by
its stream.
"""

from __future__ import annotations

import contextlib
import copy
import os
import os.path as osp
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.matching import match_epoch_images, matcher_options
from fusion4landslide_tpu_torch.io.results import (
    dvf_magnitudes,
    save_dvfms,
    save_txt,
    visual_clamp_magnitude,
)
from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.ops.partition_io import load_or_generate_partition_labels
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.pipelines.f2s3 import is_rockfall, write_f2s3_outputs
from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step
from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step
from fusion4landslide_tpu_torch.pipelines.piecewise_icp import (
    piecewise_icp_core,
    suggest_max_cells,
    write_piecewise_tables,
)
from fusion4landslide_tpu_torch.pipelines.rgb_guided import write_rgb_guided_tables
from fusion4landslide_tpu_torch.pipelines.rgb_guided_device import rgb_guided_tile_step
from fusion4landslide_tpu_torch.utils.timing import StageTimer

__all__ = [
    "f2s3_statics",
    "fusion3d_statics",
    "resolve_devices",
    "run_f2s3_tiles",
    "run_fusion3d_tiles",
    "run_piecewise_tiles",
    "run_rgb_guided_tiles",
]


def _padded_tile(src: np.ndarray, tgt: np.ndarray, N: int, M: int, dev):
    """(centre, src (N, 3), smask (N,), tgt (M, 3), tmask (M,)) of one
    tile, centred on its source mean and zero-padded to its buckets."""
    n, m = src.shape[0], tgt.shape[0]
    center = src.mean(axis=0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - center
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - center
    return (
        center,
        torch.from_numpy(sb).to(dev), torch.arange(N, device=dev) < n,
        torch.from_numpy(tb).to(dev), torch.arange(M, device=dev) < m,
    )


def _tiles_and_buckets(tiles, n_bucket: int | None, m_bucket: int | None):
    """(tiles, (N, M)): with given buckets the tiles stay a lazy iterable;
    otherwise they are listed and (N, M) are the buckets of the largest
    source and target tile ((0, 0) for no tile)."""
    if n_bucket is not None and m_bucket is not None:
        return tiles, (n_bucket, m_bucket)
    tiles = list(tiles)
    if not tiles:
        return tiles, (0, 0)
    return tiles, (bucket_size(max(t[1].shape[0] for t in tiles)),
                   bucket_size(max(t[2].shape[0] for t in tiles)))


def _with_seeds(tiles, rng_seed: int):
    """(tile_id, src, tgt, seed) per tile: the i-th tile in the order given
    draws its DIPs randomness with seed ``rng_seed + i``, whichever stream
    runs it (JAX splits a key made from ``rng_seed`` per batch of tiles)."""
    return ((*tile, rng_seed + i) for i, tile in enumerate(tiles))


def resolve_devices(devices=None, device=None) -> list[torch.device]:
    """The tile streams' devices: one per entry of ``devices`` (entries may
    repeat), else the one ``device`` (default ``cuda``). A CUDA entry
    without an index is the current card; one past the card count
    raises."""
    if devices is None:
        devices = [device]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices= names no device")
    out = []
    for d in devs:
        if d.type == "cuda":
            index = torch.cuda.current_device() if d.index is None else d.index
            if index >= torch.cuda.device_count():
                raise ValueError(f"{d}: this machine has {torch.cuda.device_count()} CUDA "
                                 "device(s)")
            d = torch.device("cuda", index)
        out.append(d)
    return out


def _run_streams(tiles, devs: list[torch.device], make_state, run_tile,
                 timings: dict | None) -> dict:
    """{tile_id: run_tile(state, dev, tile, timings)} over ``tiles``
    ((tile_id, src, tgt), possibly lazy) in tile order.

    One device runs inline with ``make_state(dev, False)``. Several run one
    worker thread each: the worker makes its device current, takes a
    stream of its own (ordered after the caller's work on that device),
    builds its state with ``make_state(dev, True)`` (its own model copies)
    and pulls the next tile under a lock until none is left or a stream
    failed; stage seconds are summed over the streams into ``timings``.
    Kernels are built before the workers start."""
    if len(devs) == 1:
        state = make_state(devs[0], False)
        return {tile[0]: run_tile(state, devs[0], tile, timings) for tile in tiles}
    if any(d.type == "cuda" for d in devs):
        cuda_build.build_all()
        for name in cuda_build.SOURCES:
            cuda_build.load(name)
    caller = {d: torch.cuda.current_stream(d) for d in set(devs) if d.type == "cuda"}
    source = enumerate(tiles)
    lock, failed = threading.Lock(), threading.Event()
    done: dict[int, tuple] = {}
    per_stream = [None if timings is None else {} for _ in devs]

    def worker(w: int, dev: torch.device) -> None:
        stream = None
        with contextlib.ExitStack() as ctx:
            if dev.type == "cuda":
                ctx.enter_context(torch.cuda.device(dev))
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(caller[dev])
                ctx.enter_context(torch.cuda.stream(stream))
            try:
                state = make_state(dev, True)
                while not failed.is_set():
                    with lock:
                        item = next(source, None)
                    if item is None:
                        break
                    i, tile = item
                    done[i] = (tile[0], run_tile(state, dev, tile, per_stream[w]))
            except BaseException:
                failed.set()
                raise
            finally:
                if stream is not None:
                    stream.synchronize()

    with ThreadPoolExecutor(max_workers=len(devs), thread_name_prefix="tile-stream") as pool:
        futures = [pool.submit(worker, w, d) for w, d in enumerate(devs)]
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:
        raise errors[0]
    if timings is not None:
        for st in per_stream:
            for k, v in st.items():
                timings[k] = timings.get(k, 0.0) + v
    return dict(done[i] for i in sorted(done))


def _models_on(dev: torch.device, own: bool, *models):
    """The models in eval mode on ``dev``: moved in place, or (``own``)
    copies for one stream."""
    return tuple((copy.deepcopy(m) if own else m).to(dev).eval() for m in models)


def _image_statics(cfg: dict) -> dict:
    """The RGB channel's static options (``parallel/pipeline.py:422-448``
    of the JAX package)."""
    mode_2d = str(cfg.get("matches_from_2d_type", "nn_src_only"))
    if mode_2d == "nn_src_with_tgt_for_visualize":
        mode_2d = "nn_src_only"

    def switch(prefix: str) -> str:
        if bool(cfg.get(f"{prefix}_only_2d", False)):
            return "only_2d"
        return "fusion" if bool(cfg.get(f"{prefix}_fusion", True)) else "off"

    return dict(
        image_size=tuple(int(v) for v in cfg["image_size"]),
        v_flip=str(cfg.get("dataset", "")).lower() != "rockfall_simulator",
        lifting=str(cfg.get("lifting_type", "nn_search")),
        matches_2d_mode=mode_2d,
        coarse_2d_mode=switch("coarse_matching"),
        fine_2d_mode=switch("fine_matching"),
        extra_pair_cap=int(cfg.get("extra_pair_cap", 0)),
        weighting_svd=bool(cfg.get("weighting_svd", False)),
    )


def _dips_statics(cfg: dict, N: int) -> dict:
    """The DIPs step options of a flat config dict (JAX
    ``parallel/pipeline.py:154-158,397-402``)."""
    return dict(
        k_max=int(cfg.get("feat_k_max", 512)),
        patch_points=int(cfg.get("feat_patch_points", 256)),
        feat_dtype=cfg.get("feat_dtype"),
        sample_cap=int(cfg.get("feat_sample_cap", 48)),
        sample_priority=str(cfg.get("feat_sample_priority", "knn")),
        chunk=min(int(cfg.get("feat_chunk", 2048)), N),
    )


def fusion3d_statics(cfg: dict, N: int, M: int, *, with_image: bool = False) -> dict:
    """Static step options from a flat config dict (the JAX runner's
    derivation, ``parallel/pipeline.py:388-448``); ``with_image`` adds the
    RGB channel's."""
    sv_cap = int(cfg.get("sv_cap", 0)) or max(bucket_size(max(N // 16, 1)), 64)
    sv_cap_t = int(cfg.get("sv_cap_tgt", 0)) or max(bucket_size(max(M // 16, 1)), 64)
    member_cap = int(cfg.get("member_cap", 0)) or 512
    statics = dict(
        levels=tuple(int(v) for v in (cfg.get("level_of_superpoint") or [1])),
        **_dips_statics(cfg, N),
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
    if with_image:
        statics.update(_image_statics(cfg))
    return statics


def _image_inputs(kit: dict, n_image_pairs: int, pix_cap: int, center, cfg: dict,
                  tile_id, dev, logger=None) -> dict:
    """One tile's RGB step inputs from ``image_kit_fn``'s dict: pixel
    matches padded into (IP, pix_cap, 4) with a (IP,) count, identity
    extrinsics for absent pairs, the tile's world offset."""
    IP, Pc = n_image_pairs, pix_cap
    pix = np.zeros((IP, Pc, 4), np.float32)
    count = np.zeros((IP,), np.int64)
    sext = np.tile(np.eye(4, dtype=np.float32), (IP, 1, 1))
    text = np.tile(np.eye(4, dtype=np.float32), (IP, 1, 1))
    for j, p in enumerate(kit["pix"][:IP]):
        p = np.asarray(p, np.float32).reshape(-1, 4)
        c = min(p.shape[0], Pc)
        if p.shape[0] > Pc and logger:
            logger.warning("tile %s image pair %d: %d pixel matches exceed pix_cap=%d; "
                           "truncating", tile_id, j, p.shape[0], Pc)
        pix[j, :c] = p[:c]
        count[j] = c
        sext[j] = np.asarray(kit["src_extrinsics"][j], np.float32)
        text[j] = np.asarray(kit["tgt_extrinsics"][j], np.float32)
    return dict(
        pix_matches=torch.from_numpy(pix).to(dev),
        pix_count=torch.from_numpy(count).to(dev),
        intrinsic=torch.as_tensor(np.asarray(kit["intrinsic"], np.float32), device=dev),
        src_extrinsics=torch.from_numpy(sext).to(dev),
        tgt_extrinsics=torch.from_numpy(text).to(dev),
        center=torch.as_tensor(np.asarray(center, np.float32), device=dev),
        pixel_thres=float(cfg.get("pixel_thres", 5.0)),
    )


def run_fusion3d_tiles(cfg: dict, dips, agg, tiles, *, device=None, devices=None,
                       logger=None, timings: dict | None = None,
                       image_kit_fn=None, pix_cap: int | None = None,
                       n_image_pairs: int = 1, n_bucket: int | None = None,
                       m_bucket: int | None = None, rng_seed: int = 0) -> dict:
    """Process (tile_id, src (n, 3), tgt (m, 3)) tiles through the fusion
    step, one tile stream per entry of ``devices`` (else on ``device``),
    and write the ``c2f_*`` result tables under
    ``<output_dir>/<output_folder>/results``. ``image_kit_fn`` is called
    from the streams' threads.

    ``image_kit_fn`` enables the RGB+3D method (use_2d_matches=True): it
    is called per tile as ``image_kit_fn(tile_id, src, tgt)`` and returns
    ``pix`` (list of (P_j, 4) pixel-match arrays, one per image pair),
    ``intrinsic`` (3, 3) and ``src_extrinsics`` / ``tgt_extrinsics``
    (lists of (4, 4) world->camera, aligned with ``pix``); ``pix_cap``
    (rows per pair, required) and ``n_image_pairs`` fix the padded shape.

    ``n_bucket`` / ``m_bucket`` fix the padded source / target sizes (the
    driver's, from the tile files' headers; every tile must fit), and the
    statics derived from them; without them they are the buckets of the
    largest tile. ``rng_seed``: the i-th tile's DIPs draws come from a
    generator seeded with ``rng_seed + i``.

    Returns {tile_id: {"dvfs", "valid", "assigned_fraction", "n_dropped",
    "overflow", "n_c2d"}}. ``timings`` (optional dict) collects per-stage
    seconds of the step, synchronised at each stage boundary.
    """
    devs = resolve_devices(devices, device)
    with_image = image_kit_fn is not None
    if with_image and pix_cap is None:
        raise ValueError("image_kit_fn requires pix_cap")
    tiles, (N, M) = _tiles_and_buckets(tiles, n_bucket, m_bucket)
    if N == 0:
        return {}
    statics = fusion3d_statics(cfg, N, M, with_image=with_image)
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
    # partition_type: superpoint: per-point labels per level from each
    # tile's table, generated when absent (the host tile's loader);
    # sharded_partition_fallback: true keeps the supervoxel levels.
    use_partition = (str(cfg.get("partition_type", "supervoxel")) == "superpoint"
                     and not bool(cfg.get("sharded_partition_fallback", False)))
    if (str(cfg.get("partition_type", "supervoxel")) == "superpoint" and not use_partition
            and logger):
        logger.warning("partition_type=superpoint: the step partitions with multi-level "
                       "supervoxels (sharded_partition_fallback: true)")

    def partition_labels(tile_id, pts, which, size, dev, timings):
        labs = load_or_generate_partition_labels(out_root, "superpoint", tile_id, which, pts,
                                                 statics["levels"], logger=logger, device=dev,
                                                 timings=timings)
        lab = np.full((len(labs), size), -1, np.int32)
        for li, pl in enumerate(labs):
            lab[li, :pl.shape[0]] = pl
        return torch.from_numpy(lab).to(dev)

    def run_tile(models, dev, tile, timings):
        tile_id, src, tgt, seed = tile
        n, m = src.shape[0], tgt.shape[0]
        center, sb, sm, tb, tm = _padded_tile(src, tgt, N, M, dev)
        images = {}
        if use_partition:
            images = dict(sp_lab_src=partition_labels(tile_id, src, "src", N, dev, timings),
                          sp_lab_tgt=partition_labels(tile_id, tgt, "tgt", M, dev, timings))
        if with_image:
            images |= _image_inputs(image_kit_fn(tile_id, src, tgt), n_image_pairs, pix_cap,
                                   center, cfg, tile_id, dev, logger)
        out = fusion3d_tile_step(
            *models, sb, sm, tb, tm, timings=timings, device=dev, rng_seed=seed, **scalars,
            **statics, **images,
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
                "tile %s (fusion_3d): %.1f%% of src points assigned, %d/%d voxels, "
                "window overflow %s",
                tile_id, 100.0 * float(valid.mean()) if n else 0.0, int(out.n_vox_src), n,
                out.overflow_by_source,
            )
        return {
            "dvfs": dvfs_dense,
            "valid": valid,
            "assigned_fraction": float(valid.mean()) if n else 0.0,
            "n_dropped": n_dropped,
            "n_vox": [int(out.n_vox_src), int(out.n_vox_tgt)],
            "overflow": int(out.overflow),
            "overflow_by_source": out.overflow_by_source,
            "n_c2d": int(out.n_c2d),
        }

    return _run_streams(_with_seeds(tiles, rng_seed), devs,
                        lambda dev, own: _models_on(dev, own, dips, agg), run_tile, timings)


def f2s3_statics(cfg: dict, N: int, M: int) -> dict:
    """Static F2S3 step options from a flat config dict (the JAX runner's
    derivation, ``parallel/pipeline.py:146-170``). The filter's depth is
    the FilteringNetwork module's own."""
    return dict(
        **_dips_statics(cfg, N),
        k_neighbors=int(cfg.get("n_normals", 30)),
        sv_cap=int(cfg.get("sv_cap", 0)) or max(bucket_size(max(N // 16, 1)), 64),
        member_cap=int(cfg.get("member_cap", 0)) or 1024,
        rockfall=is_rockfall(cfg),
        refine_results=bool(cfg.get("refine_results", True)),
        small_patch_removal=bool(cfg.get("small_patch_removal", True)),
        with_c2c=bool(cfg.get("fill_gaps_c2c", False)),
    )


def run_f2s3_tiles(cfg: dict, dips, filt, tiles, *, device=None, devices=None,
                   logger=None, timings: dict | None = None,
                   n_bucket: int | None = None, m_bucket: int | None = None,
                   rng_seed: int = 0) -> dict:
    """Process (tile_id, src (n, 3), tgt (m, 3)) tiles through
    ``f2s3_tile_step``, one tile stream per entry of ``devices`` (else on
    ``device``), and write the ``f2s3_*``
    result tables (the pre-pruning ``f2s3_dvfms_without_pruning_of_tile_*``
    included) under ``<output_dir>/<output_folder>/results``.

    ``n_bucket`` / ``m_bucket`` fix the padded sizes, and ``rng_seed``
    seeds the DIPs draws, as in ``run_fusion3d_tiles``.

    Returns {tile_id: {"dvfs", "magnitudes", "keep", "n_dropped",
    "overflow"}}. ``timings`` (optional dict) collects per-stage seconds
    of the step, synchronised at each stage boundary.
    """
    devs = resolve_devices(devices, device)
    tiles, (N, M) = _tiles_and_buckets(tiles, n_bucket, m_bucket)
    if N == 0:
        return {}
    statics = f2s3_statics(cfg, N, M)
    max_disp = float(cfg.get("max_disp_magnitude", 0) or 0)
    voxel_size = float(cfg.get("voxel_size", 0.0) or 0.0)
    results_dir = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")), "results")
    os.makedirs(results_dir, exist_ok=True)

    def run_tile(models, dev, tile, timings):
        tile_id, src, tgt, seed = tile
        n, m = src.shape[0], tgt.shape[0]
        center, sb, sm, tb, tm = _padded_tile(src, tgt, N, M, dev)
        out = f2s3_tile_step(
            *models, sb, sm, tb, tm, max_disp, voxel_size,
            timings=timings, device=dev, rng_seed=seed, **statics,
        )
        n_dropped = int(out.n_dropped)
        if n_dropped and logger:
            logger.warning(
                "tile %s: %d points exceeded the supervoxel caps (sv_cap=%d, "
                "member_cap=%d) and were not filtered",
                tile_id, n_dropped, statics["sv_cap"], statics["member_cap"],
            )
        s = sb[:n].cpu().numpy()
        t = tb[:m].cpu().numpy()
        keep = out.keep[:n].cpu().numpy()
        # Pre-pruning table (f2s3.py:286-294).
        mag0 = np.linalg.norm(out.nn_tgt[:n].cpu().numpy() - s, axis=1)
        save_txt(
            osp.join(results_dir, f"f2s3_dvfms_without_pruning_of_tile_{tile_id}.txt"),
            np.hstack([s + center, mag0[:, None]]),
        )
        pruned = np.hstack([s, out.new_tgt[:n].cpu().numpy()])
        c2c = out.c2c[:n].cpu().numpy() if statics["with_c2c"] else None
        written = write_f2s3_outputs(cfg, tile_id, center, s, t, pruned, keep,
                                     c2c=c2c, logger=logger, device=dev)
        if logger:
            logger.info("tile %s (f2s3): %d kept correspondences, window overflow %s",
                        tile_id, int(keep.sum()), out.overflow_by_source)
        return {
            **written,
            "keep": keep,
            "n_dropped": n_dropped,
            "overflow": out.overflow,
            "overflow_by_source": out.overflow_by_source,
        }

    return _run_streams(_with_seeds(tiles, rng_seed), devs,
                        lambda dev, own: _models_on(dev, own, dips, filt), run_tile, timings)


def run_rgb_guided_tiles(cfg: dict, tiles, src_image, tgt_image, intrinsic, src_extrinsic,
                         tgt_extrinsic, *, tgt_intrinsic=None, corres_2d=None, device=None,
                         devices=None, logger=None, timings: dict | None = None,
                         n_bucket: int | None = None, m_bucket: int | None = None) -> dict:
    """RGB-guided estimation over (tile_id, src (n, 3), tgt (m, 3)) tiles,
    one tile stream per entry of ``devices`` (else on ``device``): the
    image pair is matched once on the first device (``image.matching``,
    unless ``corres_2d`` is given), its matches padded to
    ``max(bucket(M), 64)`` rows, then each tile runs through
    ``rgb_guided_tile_step`` (``sv_cap`` = ``bucket(N / 16)``, at least 64,
    ``member_cap`` 1024) and its ``rgb_guided_*`` tables are written.

    Returns {tile_id: {"dvfs", "valid", "matched", "n_matches",
    "n_dropped", "overflow_by_source"}}. ``timings`` (optional
    dict) collects the matcher's and the step's per-stage seconds."""

    devs = resolve_devices(devices, device)
    dev = devs[0]
    tiles, (N, M) = _tiles_and_buckets(tiles, n_bucket, m_bucket)
    if N == 0:
        return {}
    timer = StageTimer(timings, dev)
    if corres_2d is None:
        corres_2d = match_epoch_images(src_image, tgt_image, **matcher_options(cfg), logger=logger,
                                       device=dev)
    corres_2d = np.asarray(corres_2d, np.float32).reshape(-1, 4)
    timer.mark("match_2d")
    C = max(bucket_size(max(len(corres_2d), 1)), 64)
    c2 = torch.zeros((C, 4), dtype=torch.float32, device=dev)
    c2[:len(corres_2d)] = torch.from_numpy(corres_2d).to(dev)
    cmask = torch.arange(C, device=dev) < len(corres_2d)
    mode = str(cfg.get("matches_from_2d_type", "nn_src_only"))
    if mode == "nn_src_with_tgt_for_visualize":
        mode = "nn_src_only"
    statics = dict(
        image_size=tuple(int(v) for v in (cfg.get("image_size") or src_image.shape[:2])),
        v_flip=str(cfg.get("dataset", "")).lower() != "rockfall_simulator",
        k_neighbors=int(cfg.get("n_normals", 30)),
        sv_cap=int(cfg.get("sv_cap", 0)) or max(bucket_size(max(N // 16, 1)), 64),
        member_cap=int(cfg.get("member_cap", 0)) or 1024,
        mode=mode,
        icp_type=str(cfg.get("icp_type", "point2point")),
        icp_max_iter=30 if bool(cfg.get("icp_refine", True)) else 0,
    )
    scalars = dict(
        pixel_thres=float(cfg.get("pixel_thres", 5)),
        max_magnitude=float(cfg.get("max_magnitude", 10.0)),
        icp_threshold=float(cfg.get("icp_threshold", cfg.get("threshold", 0.1))),
        voxel_size=float(cfg.get("voxel_size", 0.0) or 0.0),
    )
    K = np.asarray(intrinsic, np.float32)
    cams = dict(src_extrinsic=np.asarray(src_extrinsic, np.float32),
                tgt_extrinsic=np.asarray(tgt_extrinsic, np.float32), intrinsic=K,
                tgt_intrinsic=K if tgt_intrinsic is None else np.asarray(tgt_intrinsic, np.float32))
    results_dir = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")),
                           "results")
    os.makedirs(results_dir, exist_ok=True)

    def run_tile(matches, dev, tile, timings):
        tile_id, src, tgt = tile
        n = src.shape[0]
        center, sb, sm, tb, tm = _padded_tile(src, tgt, N, M, dev)
        out = rgb_guided_tile_step(
            sb, sm, tb, tm, center.astype(np.float32), *matches, **cams, **scalars,
            **statics, timings=timings, device=dev,
        )
        matched = out.matched[:n].cpu().numpy()
        valid = out.valid[:n].cpu().numpy()
        mags0 = np.linalg.norm(out.tgt_match[:n].cpu().numpy() - sb[:n].cpu().numpy(), axis=1)
        dvfs = np.hstack([src[valid], out.moved[:n].cpu().numpy()[valid] + center])
        write_rgb_guided_tables(results_dir, tile_id,
                                np.hstack([src[matched], mags0[matched][:, None]]), dvfs,
                                cfg.get("dataset"))
        n_dropped = int(out.n_dropped)
        if n_dropped and logger:
            logger.warning("tile %s: %d points exceeded the supervoxel caps (sv_cap=%d, "
                           "member_cap=%d)", tile_id, n_dropped, statics["sv_cap"],
                           statics["member_cap"])
        if logger:
            logger.info("tile %s (rgb_guided): %d matched, %d assigned, window overflow %s",
                        tile_id, int(matched.sum()), int(valid.sum()), out.overflow_by_source)
        return {
            "dvfs": dvfs,
            "valid": valid,
            "matched": matched,
            "n_matches": int(matched.sum()),
            "n_dropped": n_dropped,
            "overflow_by_source": out.overflow_by_source,
        }

    return _run_streams(tiles, devs, lambda d, own: (c2.to(d), cmask.to(d)), run_tile,
                        timings)


def run_piecewise_tiles(cfg: dict, tiles, *, device=None, devices=None, logger=None) -> dict:
    """Piecewise ICP over (tile_id, src (n, 3), tgt (m, 3)) tiles, one tile
    stream per entry of ``devices`` (else on ``device``), padded to the
    buckets of the largest tiles with one static cell bound from the
    largest source extent; writes the same tables as
    ``pipelines.piecewise_icp.run_piecewise_icp``. Returns {tile_id:
    {"dvfs"}}."""
    devs = resolve_devices(devices, device)
    smax = float(cfg.get("smax", 5.0))
    n_min = int(cfg.get("number_points_min", 10))
    tiles, (N, M) = _tiles_and_buckets(tiles, None, None)
    if N == 0:
        return {}
    ext = max(float((t[1].max(axis=0) - t[1].min(axis=0)).max()) for t in tiles)
    max_cells = suggest_max_cells(ext, smax, N, n_min)
    results_dir = osp.join(str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run")),
                           "results")
    os.makedirs(results_dir, exist_ok=True)
    @torch.inference_mode()
    def run_tile(_, dev, tile, timings):
        tile_id, src, tgt = tile
        n = src.shape[0]
        _, sb, sm, tb, tm = _padded_tile(src, tgt, N, M, dev)
        out = piecewise_icp_core(sb, tb, sm, tm, smax, n_min, max_cells=max_cells)
        keep = out.out_mask[:n].cpu().numpy()
        src_kept = src[keep]
        dvfs = np.hstack([src_kept, src_kept + out.displacement[:n].cpu().numpy()[keep]])
        write_piecewise_tables(results_dir, tile_id, dvfs, cfg.get("dataset"))
        if logger:
            logger.info("tile %s (piecewise): %d kept, %d cells", tile_id, int(keep.sum()),
                        int(out.n_cells_src))
        return {"dvfs": dvfs}

    return _run_streams(tiles, devs, lambda dev, own: None, run_tile, None)
