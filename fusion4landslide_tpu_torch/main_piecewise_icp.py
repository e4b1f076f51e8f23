"""Piecewise-ICP driver: octree-cell centroid matching with a
stable/unstable split (port of the repository's ``main_piecewise_icp.py``).

    python -m fusion4landslide_tpu_torch.main_piecewise_icp \
        --config configs/landslide/piecewise_icp_brienz.yaml [--device cpu]

Tiles the epoch pair unless tiles exist, skips tiles whose
``piecewise_icp_dvfms_of_tile_*.txt`` exists and writes the
``piecewise_*`` tables. ``use_mesh: auto`` (the default) runs
``run_piecewise_icp`` per tile on one GPU, and the runner
``run_piecewise_tiles`` with one tile stream per GPU where the JAX driver
takes its mesh (several GPUs, several tiles); ``use_mesh: true`` always
takes the runner, over every GPU. No kernel runs in this method. The
driver logs one ``run summary:`` JSON line at the end.
"""

from __future__ import annotations

import argparse


from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.pipelines.driver import (
    ensure_tiles,
    iter_tile_clouds,
    list_tiles,
    log_config,
    setup_run,
    skip_completed_tiles,
    stream_devices,
)
from fusion4landslide_tpu_torch.pipelines.piecewise_icp import run_piecewise_icp
from fusion4landslide_tpu_torch.pipelines.run_summary import RunSummary

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str,
                        default="./configs/landslide/piecewise_icp_brienz.yaml",
                        help="Path to config file.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, logger = setup_run(args.config, "piecewise_icp")
    log_config(cfg, logger)
    summary = RunSummary(dev)

    with summary.phase("tiling_s"):
        ensure_tiles(cfg, logger)
    tiles = list_tiles(cfg, overlap=True)
    tiles = skip_completed_tiles(cfg, tiles, "piecewise_icp_dvfms_of_tile_{tile}.txt", logger)
    logger.info("Num. of tile(s): %d", len(tiles))

    devices = stream_devices(dev)
    use_mesh = cfg.get("use_mesh", "auto")
    if not tiles:
        use_mesh = False
    elif use_mesh == "auto":
        use_mesh = len(devices) > 1 and len(tiles) > 1
    if use_mesh:
        from fusion4landslide_tpu_torch.parallel.pipeline import run_piecewise_tiles

        logger.info("Running %d tiles through the runner, one tile stream per device: %s",
                    len(tiles), [str(d) for d in devices])
        loaded = [(tid, s.points, t.points)
                  for tid, s, t in summary.timed_reads(iter_tile_clouds(tiles))]
        with summary.phase("runner_s"):
            run_piecewise_tiles(cfg, loaded, devices=devices, logger=logger)
        tiles = []

    for tile_id, src, tgt in summary.timed_reads(iter_tile_clouds(tiles)):
        logger.info("Processing tile %s", tile_id)
        with summary.tile(tile_id) as timings:
            run_piecewise_icp(src.points, tgt.points, smax=float(cfg.smax),
                              number_points_min=int(cfg.number_points_min),
                              output_dir=cfg.output_root, tile_id=tile_id,
                              dataset=cfg.get("dataset"), logger=logger, device=dev,
                              timings=timings)
    return summary.finish(logger, cfg.output_root)


if __name__ == "__main__":
    main()
