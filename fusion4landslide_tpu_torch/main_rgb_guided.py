"""RGB-guided driver: dense image matches lifted to 3D and refined per
supervoxel by a rigid fit (port of the repository's
``main_rgb_guided.py``).

    python -m fusion4landslide_tpu_torch.main_rgb_guided \
        --config configs/landslide/rgb_guided_brienz.yaml [--device cpu]

Reads the YAML config, tiles the epoch pair into ``<output_root>/tiled_data``
unless tiles exist, skips tiles whose
``rgb_guided_w_refinement_dvfms_src2tgt_tile_*.txt`` exists, loads the
cameras (``image/camera_intrinsic.txt`` or ``camera_intrinsic_{src,tgt}.txt``,
``image/transformations``) and the two images (``image/raw_images``).
``use_mesh: auto`` (the default) runs the host tile ``run_rgb_guided_tile``
per tile on one GPU, and the runner ``run_rgb_guided_tiles`` (which
matches the image pair once) with one tile stream per GPU where the JAX
driver takes its mesh (several GPUs, several tiles); ``use_mesh: true``
always takes the runner, over every GPU. ``clustering_type: hdbscan``
always takes the host tiles. The image matcher is ``img_matching_type``: the shipped
``eloftr`` (``weights/eloftr_tiny.npz``), ``roma``, ``zncc`` or ``loftr``
(an upstream LoFTR checkpoint given as ``img_matcher_weights``; with none,
the E-LoFTR paths are probed as in the JAX package); a learned matcher
whose weights are not provisioned falls back to ZNCC. The
driver logs one ``run summary:`` JSON line at the end.
"""

from __future__ import annotations

import argparse
import os.path as osp


from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.cameras import load_extrinsics, load_intrinsic_pair
from fusion4landslide_tpu_torch.io.images import load_image
from fusion4landslide_tpu_torch.pipelines.driver import (
    ensure_tiles,
    halo_split_spec,
    iter_tile_clouds,
    list_tiles,
    log_config,
    setup_run,
    skip_completed_tiles,
    stream_devices,
    tile_size_buckets,
)
from fusion4landslide_tpu_torch.pipelines.run_summary import RunSummary

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str,
                        default="./configs/landslide/rgb_guided_brienz.yaml",
                        help="Path to config file.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, logger = setup_run(args.config, "rgb_guided")
    log_config(cfg, logger)
    summary = RunSummary(dev)

    with summary.phase("tiling_s"):
        ensure_tiles(cfg, logger)
    tiles = list_tiles(cfg, overlap=True)
    tiles = skip_completed_tiles(cfg, tiles,
                                 "rgb_guided_w_refinement_dvfms_src2tgt_tile_{tile}.txt", logger)
    logger.info("Num. of tile(s): %d", len(tiles))

    input_root = cfg.get("input_root") or cfg.get("data_dir")
    with summary.phase("load_images_s"):
        intrinsic, tgt_intrinsic = load_intrinsic_pair(input_root)
        src_ext, tgt_ext = load_extrinsics(
            input_root, cfg.get("dataset"), coord_type=cfg.get("coord_type", "PRCS"),
            src_pose=cfg.get("src_pose"), tgt_pose=cfg.get("tgt_pose"),
        )
        raw = osp.join(input_root, "image", "raw_images")
        src_img = load_image(osp.join(raw, cfg.get("src_image")))
        tgt_img = load_image(osp.join(raw, cfg.get("tgt_image")))

    split = halo_split_spec(cfg)
    if split is not None:
        logger.info("Core/halo query split: src margin %.1f m, tgt margin %.1f m",
                    split[0], split[1])

    hdbscan = str(cfg.get("clustering_type", "supervoxel")) == "hdbscan"
    devices = stream_devices(dev)
    use_mesh = cfg.get("use_mesh", "auto")
    if not tiles:
        use_mesh = False
    elif use_mesh == "auto":
        use_mesh = len(devices) > 1 and len(tiles) > 1 and not hdbscan
    if use_mesh and hdbscan:
        logger.warning("clustering_type=hdbscan is host-side; falling back to the serial "
                       "per-tile path")
        use_mesh = False
    if use_mesh:
        from fusion4landslide_tpu_torch.parallel.pipeline import run_rgb_guided_tiles

        logger.info("Running %d tiles through the runner, one tile stream per device: %s",
                    len(tiles), [str(d) for d in devices])
        n_bucket, m_bucket = tile_size_buckets(tiles, split=split,
                                               halo=float(cfg.get("tile_halo", 20.0)))
        clouds = ((tid, s.points, t.points) for tid, s, t in summary.timed_reads(
            iter_tile_clouds(tiles, split=split, budgets=(n_bucket, m_bucket), logger=logger)))
        timings: dict = {}
        with summary.phase("runner_s"):
            res = run_rgb_guided_tiles(cfg, clouds, src_img, tgt_img, intrinsic, src_ext,
                                       tgt_ext, tgt_intrinsic=tgt_intrinsic, devices=devices,
                                       logger=logger, timings=timings, n_bucket=n_bucket,
                                       m_bucket=m_bucket)
        summary.add_overflow(*res.values())
        summary.stages["runner"] = timings
        tiles = []

    from fusion4landslide_tpu_torch.pipelines.rgb_guided import run_rgb_guided_tile

    for tile_id, src, tgt in summary.timed_reads(iter_tile_clouds(tiles, split=split,
                                                                  logger=logger)):
        logger.info("Processing tile %s", tile_id)
        with summary.tile(tile_id) as timings:
            res = run_rgb_guided_tile(cfg, src.points, tgt.points, src_img, tgt_img, intrinsic,
                                      src_ext, tgt_ext, tgt_intrinsic=tgt_intrinsic,
                                      tile_id=tile_id, logger=logger, device=dev,
                                      timings=timings)
        summary.add_overflow(res)
    return summary.finish(logger, cfg.output_root)


if __name__ == "__main__":
    main()
