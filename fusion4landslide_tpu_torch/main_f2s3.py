"""F2S3 driver: tiling, per-tile DIPs descriptors, supervoxels,
feature-space 1-NN and learned correspondence pruning (port of the
repository's ``main_f2s3.py``).

    python -m fusion4landslide_tpu_torch.main_f2s3 \
        --config configs/landslide/f2s3_brienz.yaml [--device cpu]

Checkpoints under ``weight_dir``: ``local_feature_descriptor_best.pth``
(DIPs) and ``outlier_classifier_best.pt``, in the reference's format.
``use_mesh: auto`` (the default) takes the host tile ``run_f2s3_tile`` on
one GPU, and the runner ``run_f2s3_tiles`` with one tile stream per GPU
where the JAX driver takes its mesh (several GPUs, several tiles);
``use_mesh: true`` always takes the runner, over every GPU. Tiles whose
``f2s3_dvfms_of_tile_*.txt`` exists are skipped. The driver logs one
``run summary:`` JSON line at the end.
"""

from __future__ import annotations

import argparse
import os.path as osp


from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.models.convert import (
    CHECKPOINT_NAMES,
    dips_from_reference,
    filter_from_reference,
    load_torch_checkpoint,
)
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

__all__ = ["load_model_params", "main"]


def load_model_params(cfg, device):
    """(PointNetFeature, FilteringNetwork) from the reference checkpoints
    under ``weight_dir`` (reference main_f2s3.py:92-114)."""
    wdir = cfg.get("weight_dir", "weights/")
    dips_path = osp.join(wdir, CHECKPOINT_NAMES["dips"])
    filt_path = osp.join(wdir, CHECKPOINT_NAMES["filter"])
    if not osp.exists(dips_path):
        raise FileNotFoundError(
            f"DIPs checkpoint not found: {dips_path} — download it per the "
            "reference README (weights section)."
        )
    if not osp.exists(filt_path):
        raise FileNotFoundError(f"outlier classifier not found: {filt_path}")
    return (dips_from_reference(load_torch_checkpoint(dips_path), device),
            filter_from_reference(load_torch_checkpoint(filt_path), device=device))


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str, default="./configs/landslide/f2s3_brienz.yaml",
                        help="Path to config file.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, logger = setup_run(args.config, "f2s3")
    log_config(cfg, logger)
    summary = RunSummary(dev)

    with summary.phase("tiling_s"):
        ensure_tiles(cfg, logger)
    tiles = list_tiles(cfg, overlap=True)
    tiles = skip_completed_tiles(cfg, tiles, "f2s3_dvfms_of_tile_{tile}.txt", logger)
    logger.info("Num. of tile(s): %d", len(tiles))
    with summary.phase("load_weights_s"):
        dips, filt = load_model_params(cfg, dev)

    # Core/halo query split; the margin derives from max_disp_magnitude.
    split = halo_split_spec(cfg)
    if split is not None:
        logger.info("Core/halo query split: src margin %.1f m, tgt margin %.1f m",
                    split[0], split[1])

    devices = stream_devices(dev)
    use_mesh = cfg.get("use_mesh", "auto")
    if not tiles:
        use_mesh = False
    elif use_mesh == "auto":
        use_mesh = len(devices) > 1 and len(tiles) > 1
    if use_mesh:
        from fusion4landslide_tpu_torch.parallel.pipeline import run_f2s3_tiles

        logger.info("Running %d tiles through the runner, one tile stream per device: %s",
                    len(tiles), [str(d) for d in devices])
        n_bucket, m_bucket = tile_size_buckets(tiles, split=split,
                                               halo=float(cfg.get("tile_halo", 20.0)))
        clouds = ((tid, s.points, t.points) for tid, s, t in summary.timed_reads(
            iter_tile_clouds(tiles, split=split, budgets=(n_bucket, m_bucket), logger=logger)))
        timings: dict = {}
        with summary.phase("runner_s"):
            res = run_f2s3_tiles(cfg, dips, filt, clouds, devices=devices, logger=logger,
                                 timings=timings, n_bucket=n_bucket, m_bucket=m_bucket)
        summary.add_overflow(*res.values())
        summary.stages["runner"] = timings
    else:
        from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile

        for tile_id, src, tgt in summary.timed_reads(iter_tile_clouds(tiles, split=split,
                                                                      logger=logger)):
            logger.info("Processing tile %s", tile_id)
            with summary.tile(tile_id) as timings:
                res = run_f2s3_tile(cfg, dips, filt, src.points, tgt.points, tile_id=tile_id,
                                    logger=logger, device=dev, timings=timings)
            summary.add_overflow(res)
    return summary.finish(logger, cfg.output_root)


if __name__ == "__main__":
    main()
