"""Fusion driver: coarse-to-fine matching with supervoxel partitions and
learned descriptors, RGB+3D fusion or 3D-only (port of the repository's
``main_fusion.py``).

    python -m fusion4landslide_tpu_torch.main_fusion \
        --config configs/landslide/fusion_3d_brienz.yaml [--device cpu]

Reads the YAML config, tiles the epoch pair into ``<output_root>/tiled_data``
unless tiles exist, skips tiles whose ``c2f_dvfms_src2tgt_tile_*.txt``
exists, loads the reference-format checkpoints under ``weight_dir``
(``local_feature_descriptor_best.pth`` and the aggregation checkpoint) and
runs each tile. ``use_mesh: auto`` (the default) takes the host tile
(``run_fusion3d_tile`` / ``run_fusion_tile``) on one GPU, and the runner
``run_fusion3d_tiles`` with one tile stream per GPU where the JAX driver
takes its mesh (several GPUs, several tiles, no depth-map lifting);
``use_mesh: true`` always takes the runner, over every GPU.

The RGB+3D method (``use_2d_matches: true``) takes the fixed image pair
(``src_image`` / ``tgt_image``) with precomputed pixel matches
(``img_matching_result_dir/*.txt``) when they exist, else the image
matcher (``img_matching_type``: ``eloftr``, ``roma``, ``zncc`` or ``loftr``,
which runs an upstream LoFTR checkpoint given as ``img_matcher_weights``)
on the pair, or with ``Images_used.txt`` on each tile's best cameras
(``num_sub_img`` per epoch), matching each distinct image pair once. Image pixels are read
only where the matcher needs them or the config has no ``image_size``. The
driver logs one ``run summary:`` JSON line at the end (tile seconds, stage
times, tiling and I/O seconds, peak device memory, kernel launches,
window overflow).
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.models.convert import (
    CHECKPOINT_NAMES,
    aggregation_from_reference,
    dips_from_reference,
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
    """(PointNetFeature, ClusterFeatureNet) from the reference checkpoints
    under ``weight_dir`` (reference main_fusion.py:35-45)."""
    wdir = cfg.get("weight_dir", "weights/")
    dips_path = osp.join(wdir, CHECKPOINT_NAMES["dips"])
    agg_path = osp.join(wdir, cfg.get("pretrained_feature_aggregation_weight",
                                      CHECKPOINT_NAMES["agg"]))
    if not osp.exists(dips_path):
        raise FileNotFoundError(
            f"DIPs checkpoint not found: {dips_path} — download it per the "
            "reference README (weights section)."
        )
    if not osp.exists(agg_path):
        raise FileNotFoundError(f"aggregation checkpoint not found: {agg_path}")
    return (dips_from_reference(load_torch_checkpoint(dips_path), device),
            aggregation_from_reference(load_torch_checkpoint(agg_path), device))


def _precomputed_matches(mdir: str | None, logger):
    """(M, 4) pixel matches of ``img_matching_result_dir/*.txt``, or None."""
    if not (mdir and osp.isdir(mdir)):
        return None
    parts = [np.loadtxt(f, ndmin=2) for f in sorted(glob.glob(osp.join(mdir, "*.txt")))]
    parts = [p for p in parts if p.size]
    if not parts:
        return None
    corres = np.vstack(parts)[:, :4]
    logger.info("Loaded %d precomputed 2D matches from %s", len(corres), mdir)
    return corres


def _image_setup(cfg, logger):
    """(image_kit, image_candidates) of the RGB+3D method: the fixed image
    pair with its cameras and precomputed matches, or the candidate
    cameras of ``Images_used.txt`` for per-tile selection."""
    from fusion4landslide_tpu_torch.image.cameras import (
        load_extrinsics,
        load_images_used,
        load_intrinsic,
    )
    from fusion4landslide_tpu_torch.io.images import load_image

    input_root = cfg.get("input_root") or cfg.get("data_dir")
    intrinsic = load_intrinsic(input_root)
    if osp.exists(osp.join(input_root, "image", "transformations", "Images_used.txt")):
        # Per-tile camera selection over the candidate pool (reference
        # _find_the_most_matched_image, base:760-858).
        entries = load_images_used(input_root)
        src_id = str(cfg.get("src_pcd", "")).split("_")[0]
        tgt_id = str(cfg.get("tgt_pcd", "")).split("_")[0]
        src_entries = [e for e in entries if src_id and src_id in e[0]]
        tgt_entries = [e for e in entries if tgt_id and tgt_id in e[0]]
        if src_entries and tgt_entries:
            logger.info("Camera selection: %d src / %d tgt candidate images",
                        len(src_entries), len(tgt_entries))
            return None, (src_entries, tgt_entries, intrinsic)
    src_ext, tgt_ext = load_extrinsics(
        input_root, cfg.get("dataset"), coord_type=cfg.get("coord_type", "PRCS"),
        src_pose=cfg.get("src_pose"), tgt_pose=cfg.get("tgt_pose"),
    )
    mdir = cfg.get("img_matching_result_dir")
    if mdir and not osp.isabs(mdir):
        mdir = osp.join(input_root, mdir)
    corres_2d = _precomputed_matches(mdir, logger)
    # Pixels are read where the matcher runs, or for the image size.
    raw = osp.join(input_root, "image", "raw_images")
    src_img = tgt_img = None
    if corres_2d is None or not cfg.get("image_size"):
        src_img = load_image(osp.join(raw, cfg.get("src_image")))
    if corres_2d is None:
        tgt_img = load_image(osp.join(raw, cfg.get("tgt_image")))
    return (src_img, tgt_img, intrinsic, src_ext, tgt_ext, corres_2d), None



def _select_cameras(cfg, image_candidates, points: np.ndarray, device):
    """Per-tile best source / target cameras (base:760-858)."""
    from fusion4landslide_tpu_torch.image.cameras import select_best_images

    src_entries, tgt_entries, intrinsic = image_candidates
    num_sub = int(cfg.get("num_sub_img", 1) or 1)
    image_size = tuple(cfg.get("image_size"))
    v_flip = str(cfg.get("dataset", "")).lower() != "rockfall_simulator"
    return tuple(select_best_images(points[i], entries, intrinsic, image_size, num=num_sub,
                                    v_flip=v_flip, device=device)
                 for i, entries in ((0, src_entries), (1, tgt_entries)))


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str,
                        default="./configs/landslide/fusion_3d_brienz.yaml",
                        help="Path to config file.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, logger = setup_run(args.config, "fusion", keep_sub_directory=True)
    log_config(cfg, logger)
    summary = RunSummary(dev)

    with summary.phase("tiling_s"):
        ensure_tiles(cfg, logger)
    tiles = list_tiles(cfg, overlap=True)
    tiles = skip_completed_tiles(cfg, tiles, "c2f_dvfms_src2tgt_tile_{tile}.txt", logger)
    logger.info("Num. of tile(s): %d", len(tiles))
    with summary.phase("load_weights_s"):
        dips, agg = load_model_params(cfg, dev)

    # Core/halo query split (halo_query_split: false disables it): source
    # queries over core(+margin) points, the halo only as target context.
    split = halo_split_spec(cfg)
    if split is not None:
        logger.info("Core/halo query split: src margin %.1f m, tgt margin %.1f m "
                    "(halo_query_split: false disables)", split[0], split[1])

    image_kit = image_candidates = None
    if cfg.get("use_2d_matches", False):
        image_kit, image_candidates = _image_setup(cfg, logger)
    has_rgb = image_kit is not None or image_candidates is not None
    images: dict = {}

    def candidate_image(side: str, name: str) -> np.ndarray:
        """A candidate camera's image (``raw_images/<side>_images``), read once."""
        from fusion4landslide_tpu_torch.io.images import load_image

        if (side, name) not in images:
            root = cfg.get("input_root") or cfg.get("data_dir")
            images[side, name] = load_image(osp.join(root, "image", "raw_images",
                                                     f"{side}_images", name))
        return images[side, name]

    devices = stream_devices(dev)
    use_mesh = cfg.get("use_mesh", "auto")
    if not tiles:
        use_mesh = False  # nothing to run (empty epoch, or every tile done)
    elif use_mesh == "auto":
        # The multi-device path of the JAX driver; depth-map lifting is
        # host-only there.
        use_mesh = (len(devices) > 1 and len(tiles) > 1
                    and not (has_rgb and str(cfg.get("lifting_type", "nn_search"))
                             == "interpolation"))
    if use_mesh:
        from fusion4landslide_tpu_torch.ops.segments import bucket_size
        from fusion4landslide_tpu_torch.parallel.pipeline import run_fusion3d_tiles

        logger.info("Running %d tiles through the runner, one tile stream per device: %s",
                    len(tiles), [str(d) for d in devices])
        image_kit_fn = pix_cap = None
        n_ip = 1
        if has_rgb:
            from fusion4landslide_tpu_torch.image.matching import (
                match_epoch_images,
                matcher_options,
            )

            def match_pair(simg, timg):
                m = match_epoch_images(simg, timg, **matcher_options(cfg), logger=logger,
                                       weights=cfg.get("img_matcher_weights"), device=dev)
                return np.asarray(m, np.float32).reshape(-1, 4)

            if image_kit is not None:
                src_img, tgt_img, intrinsic, src_ext, tgt_ext, corres_2d = image_kit
                pix = (np.asarray(corres_2d, np.float32)[:, :4] if corres_2d is not None
                       else match_pair(src_img, tgt_img))
                kit0 = {"pix": [pix], "intrinsic": intrinsic, "src_extrinsics": [src_ext],
                        "tgt_extrinsics": [tgt_ext]}
                kits = None
                max_px = max(1, len(pix))
            else:
                # Each tile's best cameras; each distinct image pair is
                # matched once across tiles.
                n_ip = int(cfg.get("num_sub_img", 1) or 1) ** 2
                pair_cache: dict = {}
                kits, max_px = {}, 1
                for tile_id, src, tgt in iter_tile_clouds(tiles, split=split):
                    best_s, best_t = _select_cameras(cfg, image_candidates,
                                                     (src.points, tgt.points), dev)
                    kit = {"pix": [], "intrinsic": image_candidates[2], "src_extrinsics": [],
                           "tgt_extrinsics": []}
                    for sn, sext in best_s:
                        for tn, text in best_t:
                            if (sn, tn) not in pair_cache:
                                pair_cache[(sn, tn)] = match_pair(candidate_image("src", sn),
                                                                  candidate_image("tgt", tn))
                            kit["pix"].append(pair_cache[(sn, tn)])
                            kit["src_extrinsics"].append(sext)
                            kit["tgt_extrinsics"].append(text)
                    max_px = max([max_px] + [len(p) for p in kit["pix"]])
                    kits[tile_id] = kit
            if kits is None:
                image_kit_fn = lambda tid, s, t: kit0  # noqa: E731
            else:
                image_kit_fn = lambda tid, s, t: kits[tid]  # noqa: E731
            pix_cap = bucket_size(max_px)
        n_bucket, m_bucket = tile_size_buckets(tiles, split=split,
                                               halo=float(cfg.get("tile_halo", 20.0)))
        clouds = ((tid, s.points, t.points) for tid, s, t in summary.timed_reads(
            iter_tile_clouds(tiles, split=split, budgets=(n_bucket, m_bucket), logger=logger)))
        timings: dict = {}
        with summary.phase("runner_s"):
            res = run_fusion3d_tiles(cfg, dips, agg, clouds, devices=devices, logger=logger,
                                     timings=timings, n_bucket=n_bucket, m_bucket=m_bucket,
                                     image_kit_fn=image_kit_fn, pix_cap=pix_cap,
                                     n_image_pairs=n_ip)
        summary.add_overflow(*res.values())
        summary.stages["runner"] = timings
        tiles = []

    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile, run_fusion_tile

    for tile_id, src, tgt in summary.timed_reads(iter_tile_clouds(tiles, split=split,
                                                                  logger=logger)):
        logger.info("Processing tile %s", tile_id)
        with summary.tile(tile_id) as timings:
            if image_candidates is not None:
                best_s, best_t = _select_cameras(cfg, image_candidates,
                                                 (src.points, tgt.points), dev)
                logger.info("tile %s: selected src image(s) %s / tgt %s", tile_id,
                            [n for n, _ in best_s], [n for n, _ in best_t])
                simgs = [candidate_image("src", n) for n, _ in best_s]
                timgs = [candidate_image("tgt", n) for n, _ in best_t]
                res = run_fusion_tile(
                    cfg, dips, agg, src.points, tgt.points, simgs[0], timgs[0],
                    image_candidates[2], best_s[0][1], best_t[0][1], src_images=simgs,
                    tgt_images=timgs, src_extrinsics=[e for _, e in best_s],
                    tgt_extrinsics=[e for _, e in best_t], tile_id=tile_id, logger=logger,
                    device=dev, timings=timings,
                )
            elif image_kit is not None:
                src_img, tgt_img, intrinsic, src_ext, tgt_ext, corres_2d = image_kit
                res = run_fusion_tile(cfg, dips, agg, src.points, tgt.points, src_img, tgt_img,
                                      intrinsic, src_ext, tgt_ext, corres_2d=corres_2d,
                                      tile_id=tile_id, logger=logger, device=dev,
                                      timings=timings)
            else:
                res = run_fusion3d_tile(cfg, dips, agg, src.points, tgt.points,
                                        tile_id=tile_id, logger=logger, device=dev,
                                        timings=timings)
        summary.add_overflow(res)
    return summary.finish(logger, cfg.output_root)


if __name__ == "__main__":
    main()
