"""Shared CLI-driver plumbing of the port's entry points (port of
``fusion4landslide_tpu.pipelines.driver``, numpy on the host).

Mirrors the per-driver boilerplate of the reference (main_piecewise_icp.py:
20-102 and siblings): config → output dirs → logger → tile the epochs if no
tiles exist → enumerate tile files → crop each tile to its core plus
margins, with the next tile read while the device works on this one.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import re
import time

import torch

from fusion4landslide_tpu_torch.config import Config, load_yaml
from fusion4landslide_tpu_torch.utils.logging import get_logger

__all__ = [
    "setup_run",
    "ensure_tiles",
    "list_tiles",
    "log_config",
    "skip_completed_tiles",
    "load_or_compute_features",
    "halo_split_spec",
    "crop_cloud_to_core",
    "iter_tile_clouds",
    "stream_devices",
    "tile_size_buckets",
]


def stream_devices(dev: torch.device) -> list[torch.device]:
    """The runners' tile streams for a driver run on ``dev``: one per GPU
    for ``cuda`` without an index (the JAX drivers shard tiles over every
    device), else ``dev`` alone."""
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def setup_run(config_path: str, method: str, keep_sub_directory: bool = False):
    """Load config, create output/log dirs, return (cfg, logger)."""
    cfg = load_yaml(config_path, keep_sub_directory=keep_sub_directory)
    cfg.output_root = osp.join(cfg.output_dir, cfg.get("output_folder", "run"))
    log_dir = osp.join(cfg.output_root, "logs")
    os.makedirs(log_dir, exist_ok=True)
    logger = get_logger(f"fusion4landslide_tpu_torch.{method}", log_dir)
    cfg.tile_dir = osp.join(cfg.output_root, "tiled_data")
    return cfg, logger


def log_config(cfg: Config, logger) -> None:
    logger.info("-" * 70)
    msg = "Config:\n" + "\n".join(
        f"{k}={v}" for k, v in cfg.items() if not isinstance(v, Config)
    )
    logger.info(msg)
    logger.info("-" * 70)


def ensure_tiles(cfg: Config, logger) -> None:
    """Tile the raw epoch pair unless ``tile_dir`` already has tiles
    (artifact-level resume, main_piecewise_icp.py:60-75)."""
    from fusion4landslide_tpu_torch.tiling import tile_point_clouds

    os.makedirs(cfg["tile_dir"], exist_ok=True)
    if any(os.listdir(cfg["tile_dir"])):
        # Resume takes precedence over the tiling_type guard below: a run
        # with pre-generated (or externally provided) tiles never tiles,
        # whatever tiling_type says.
        logger.info("Skip tiling; tiles loaded from %s", cfg["tile_dir"])
        return
    tiling_type = str(cfg.get("tiling_type", "xy_tiling"))
    if tiling_type != "xy_tiling":
        # The reference dispatches on tiling_type but its hv_tiling /
        # python_based_tiling branches are stubs returning None
        # (src/functions.py:170-173); fail loudly instead.
        raise ValueError(
            f"tiling_type={tiling_type!r} is not implemented (the reference "
            "only ships xy_tiling, src/functions.py:147-173)"
        )
    data_dir = cfg.get("input_root") or cfg.get("data_dir")
    src_name = cfg.get("src_pcd") or cfg.get("src_name")
    tgt_name = cfg.get("tgt_pcd") or cfg.get("tgt_name")
    src_path = osp.join(data_dir, "raw_pcd", src_name)
    if not osp.exists(src_path):
        src_path = osp.join(data_dir, src_name)
    tgt_path = osp.join(data_dir, "raw_pcd", tgt_name)
    if not osp.exists(tgt_path):
        tgt_path = osp.join(data_dir, tgt_name)
    voxel = float(cfg.get("voxel_size", cfg.get("voxel_size_init", 0.0)) or 0.0)
    t0 = time.time()
    n = tile_point_clouds(
        src_path,
        tgt_path,
        int(cfg.max_pts_per_tile),
        int(cfg.min_pts_per_tile),
        bool(voxel),
        voxel,
        0.0,
        -1,
        cfg.tile_dir,
        verbose=bool(cfg.get("verbose", True)),
        # Reference parity: fixed ±20 m (pcd_tiling.cpp:297-301). A smaller
        # halo is sound when max_magnitude is small — the target halo only
        # has to cover the largest admissible displacement plus patch
        # context — so it is exposed as a config knob.
        halo=float(cfg.get("tile_halo", 20.0)),
    )
    logger.info("Tiled into %d tiles in %.1fs", n, time.time() - t0)


def list_tiles(cfg: Config, overlap: bool = True) -> list[tuple[str, str, str]]:
    """Sorted [(tile_id, src_path, tgt_path)] from the tile directory."""
    sub = "overlap" if overlap else "non_overlap"
    pattern = osp.join(cfg.tile_dir, sub, "source_tile_*")
    paths = sorted(
        glob.glob(pattern),
        key=lambda x: int(re.search(r"\d+", osp.basename(x)).group()),
    )
    out = []
    for p in paths:
        tid = re.findall(r"\d+", osp.basename(p))[0]
        out.append((tid, p, p.replace("source_tile_", "target_tile_")))
    return out


def skip_completed_tiles(
    cfg: Config,
    tiles: list[tuple[str, str, str]],
    marker: str,
    logger,
) -> list[tuple[str, str, str]]:
    """Tile-level resume: drop tiles whose result file already exists.

    Replaces the reference's hand-edited ``continue_tile`` pointer
    (main_fusion.py:133) with an automatic check; ``continue_tile: N`` in
    the config additionally skips every tile with id < N, and
    ``overwrite_results: True`` disables resume entirely. ``marker`` is the
    result filename pattern with ``{tile}``, e.g.
    ``c2f_dvfms_src2tgt_tile_{tile}.txt``.

    Multi-host scale-out: tiles are communication-free (±20 m halo
    decomposition), so epochs larger than one host shard across hosts
    without any collective — set ``tile_shard_count: H`` and a
    per-host ``tile_shard_index`` and each process keeps the tiles whose
    integer id ≡ index (mod count). Hosts share nothing but the output
    directory; the per-tile result files and this resume check make the
    union restartable.
    """
    count = int(cfg.get("tile_shard_count", 1) or 1)
    if count > 1:
        index = int(cfg.get("tile_shard_index", 0) or 0)
        tiles = [t for t in tiles if int(t[0]) % count == index]
        logger.info(
            "Tile shard %d/%d: %d tile(s) owned by this host",
            index, count, len(tiles),
        )
    if bool(cfg.get("overwrite_results", False)):
        return tiles
    start = int(cfg.get("continue_tile", 0) or 0)
    results = osp.join(cfg.output_root, "results")
    kept = []
    for tid, s, t in tiles:
        if int(tid) < start:
            logger.info("Tile %s skipped (continue_tile=%d)", tid, start)
            continue
        if osp.exists(osp.join(results, marker.format(tile=tid))):
            logger.info("Tile %s already complete; skipping (resume)", tid)
            continue
        kept.append((tid, s, t))
    return kept


def load_or_compute_features(
    cfg: Config, tile_id, name: str, compute_fn, logger=None
):
    """Artifact-level feature cache (reference ``features_tile_N.npz``,
    base:2039-2049, f2s3.py:139-149): when ``point_feat_compute`` is False
    and the cache exists, load it; otherwise compute and save.

    ``compute_fn()`` returns a dict of arrays (numpy or torch); a loaded
    cache holds numpy arrays.
    """
    import numpy as np

    out_root = cfg.get("output_root") or osp.join(
        str(cfg.get("output_dir", ".")), str(cfg.get("output_folder", "run"))
    )
    interim = osp.join(out_root, "interim")
    os.makedirs(interim, exist_ok=True)
    path = osp.join(interim, f"{name}_tile_{tile_id}.npz")
    if not bool(cfg.get("point_feat_compute", True)) and osp.exists(path):
        if logger:
            logger.info("Loading cached features from %s", path)
        with np.load(path) as z:
            return dict(z)
    out = compute_fn()
    # Compressing ~50 MB of descriptors costs seconds of single-core CPU
    # per tile; only persist the cache when interim artifacts are wanted
    # (the reference always writes, base:2039-2049 — save_interim: True
    # restores that).
    if bool(cfg.get("save_interim", True)):
        np.savez_compressed(
            path, **{k: v.cpu().numpy() if hasattr(v, "cpu") else v for k, v in out.items()}
        )
        if logger:
            logger.info("Saved feature cache to %s", path)
    return out


def halo_split_spec(cfg) -> tuple[float, float] | None:
    """Margins (src_m, tgt_m) in metres for the core/halo query split, or
    ``None`` when disabled.

    The reference recomputes every tile's full ±20 m overlap cloud as BOTH
    query and support (the reference's main_fusion.py:128-144, halo from
    pcd_tiling.cpp:297-301) — redundancy, not semantics: each point is core
    in exactly one tile, so source-side queries (descriptors, partitions,
    fine solves, DVF output) only need core(+margin) points, while the halo
    only has to exist as target/support context. The split crops the
    per-tile clouds to

    - source: core bbox + ``halo_src_margin``   (default max_magnitude —
      partition/patch context so boundary supervoxels keep their extent),
    - target: core bbox + ``halo_tgt_margin``   (default 2·max_magnitude —
      match candidates for every source-margin point plus patch context),

    both clamped to ``tile_halo``. ``halo_query_split: false`` restores the
    reference's full-overlap redundancy (exact-parity mode).
    """
    if not bool(cfg.get("halo_query_split", True)):
        return None
    halo = float(cfg.get("tile_halo", 20.0))
    # Displacement gate: fusion/rgb_guided use max_magnitude, f2s3 uses
    # max_disp_magnitude (0/absent = ungated → no safe margin → no split).
    mm = float(
        cfg.get("max_magnitude", 0)
        or cfg.get("max_disp_magnitude", 0)
        or 0.0
    )
    if mm <= 0 and "halo_src_margin" not in cfg:
        return None
    sm = min(float(cfg.get("halo_src_margin", mm)), halo)
    tm = min(float(cfg.get("halo_tgt_margin", max(2.0 * mm, sm))), halo)
    if sm >= halo and tm >= halo:
        return None  # margins cover the halo — identical to the full clouds
    return sm, tm


def _core_path(overlap_path: str) -> str:
    """non_overlap core PLY for an overlap tile path (tiler naming:
    overlap/source_tile_N_overlap.ply ↔ non_overlap/source_tile_N.ply)."""
    head, name = osp.split(overlap_path)
    root, sub = osp.split(head)
    if sub != "overlap":
        return ""
    return osp.join(root, "non_overlap", name.replace("_overlap", ""))


def crop_cloud_to_core(cloud, lo, hi, margin: float, budget: int | None = None):
    """Crop a cloud to the core bbox [lo, hi] expanded by ``margin`` per
    axis. With ``budget`` set, a crop that would exceed it keeps the
    ``budget`` points nearest the core box instead (the largest margin that
    fits the padded bucket — the core itself always fits, its excess is 0)."""
    import numpy as np

    p = cloud.points
    excess = np.maximum(np.maximum(lo - p, p - hi), 0.0).max(axis=1)
    keep = excess <= margin
    if budget is not None and int(keep.sum()) > budget:
        idx = np.argsort(excess, kind="stable")[:budget]
        keep = np.zeros(len(p), bool)
        keep[idx] = True
        keep &= excess <= margin
    if keep.all():
        return cloud
    from fusion4landslide_tpu_torch.io.ply import PointCloud

    return PointCloud(
        points=p[keep],
        colors=None if cloud.colors is None else cloud.colors[keep],
        extras={k: v[keep] for k, v in cloud.extras.items()},
    )


def iter_tile_clouds(
    tiles,
    *,
    prefetch: int = 2,
    split: tuple[float, float] | None = None,
    budgets: tuple[int, int] | None = None,
    logger=None,
):
    """Yield (tile_id, src_cloud, tgt_cloud) with background prefetch.

    While the device crunches tile i, a reader thread parses tile i+1's
    PLY pair — the host-IO double buffering the serial reference loop
    lacks (main_fusion.py:134 reads synchronously per tile).

    With ``split=(src_margin, tgt_margin)`` (see ``halo_split_spec``) the
    overlap clouds are cropped to the tile's core bbox expanded by the
    margins — the core/halo query split. ``budgets=(N, M)`` bounds the
    cropped sizes to the padded buckets (margin shrinks for a tile whose
    crop would overflow; the core always fits).
    """
    from concurrent.futures import ThreadPoolExecutor

    from fusion4landslide_tpu_torch.io import read_point_cloud

    def load(entry):
        tile_id, src_path, tgt_path = entry
        src = read_point_cloud(src_path)
        tgt = read_point_cloud(tgt_path)
        if split is not None:
            core_p = _core_path(src_path)
            if core_p and osp.exists(core_p):
                core = read_point_cloud(core_p).points
                lo = core.min(axis=0)
                hi = core.max(axis=0)
                nb, mb = budgets if budgets else (None, None)
                n0, m0 = len(src), len(tgt)
                src = crop_cloud_to_core(src, lo, hi, split[0], nb)
                tgt = crop_cloud_to_core(tgt, lo, hi, split[1], mb)
                if logger:
                    logger.info(
                        "tile %s: core/halo split %d->%d src, %d->%d tgt "
                        "(margins %.1f/%.1f m)",
                        tile_id, n0, len(src), m0, len(tgt),
                        split[0], split[1],
                    )
            elif logger:
                logger.warning(
                    "tile %s: no non_overlap core PLY next to %s — "
                    "halo split skipped for this tile",
                    tile_id, src_path,
                )
        return tile_id, src, tgt

    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = [pool.submit(load, e) for e in tiles[:prefetch]]
        nxt = prefetch
        for _ in range(len(tiles)):
            result = futures.pop(0).result()
            if nxt < len(tiles):
                futures.append(pool.submit(load, tiles[nxt]))
                nxt += 1
            yield result


def _split_count_estimate(
    n_core: int, n_olap: int, halo: float, margin: float
) -> int:
    """Upper estimate of a tile's cropped point count under the query split,
    from header counts only: solve the uniform-density square model
    n_olap/n_core = ((a+2·halo)/a)^2 for the core side a, scale to the
    margin, add 15% headroom (the quarter-octave bucket ladder absorbs it;
    ``crop_cloud_to_core``'s budget bound guarantees no overflow either way).
    """
    import math

    if margin >= halo or n_olap <= n_core or halo <= 0:
        return n_olap
    ratio = n_olap / max(n_core, 1)
    a = 2.0 * halo / max(math.sqrt(ratio) - 1.0, 1e-6)
    est = n_core * ((a + 2.0 * margin) / a) ** 2
    return int(min(n_olap, math.ceil(est * 1.15)))


def tile_size_buckets(
    tiles,
    split: tuple[float, float] | None = None,
    halo: float = 20.0,
) -> tuple[int, int]:
    """(src_bucket, tgt_bucket) padded sizes for a tile list, read from the
    PLY headers only: the runners' padded shapes before any cloud is read.
    With ``split`` margins the buckets size the cropped clouds (see
    ``halo_split_spec``)."""
    from fusion4landslide_tpu_torch.io.ply import ply_vertex_count
    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    if split is None:
        n = max(ply_vertex_count(sp) for _, sp, _ in tiles)
        m = max(ply_vertex_count(tp) for _, _, tp in tiles)
        return bucket_size(n), bucket_size(m)
    n = m = 1
    for _, sp, tp in tiles:
        core_p = _core_path(sp)
        n_o = ply_vertex_count(sp)
        m_o = ply_vertex_count(tp)
        if core_p and osp.exists(core_p):
            n_c = ply_vertex_count(core_p)
            n = max(n, _split_count_estimate(n_c, n_o, halo, split[0]))
            m = max(m, _split_count_estimate(n_c, m_o, halo, split[1]))
        else:
            n, m = max(n, n_o), max(m, m_o)
    return bucket_size(n), bucket_size(m)
