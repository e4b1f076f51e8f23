"""The image matchers' accuracy and speed at production crop size.

The port's twin of the repository's ``tools/matcher_eval.py``. It renders
a textured epoch-image pair of the synthetic slope through a nadir camera
(``synth.nadir_camera`` / ``synth.render_image``) with a planted world
shift of about ``--shift-px`` pixels on the moving half, runs
``image.matching.match_epoch_images`` as ``main_fusion`` does at the
reference sizes (``fusion_brienz.yaml``: image 1920 x 2560, crop 960 x
1280, overlap 480 x 640), and reports per matcher one JSON line: the
median and mean endpoint error against the analytic flow
(``synth.planted_flow``), the precision at 3 and 5 px, the match count,
the seconds of the first (cold) and the best later (warm) call per image
pair and the warm seconds per crop pair, whether ``match_epoch_images``
fell back to the ZNCC matcher (no weights found, or every RoMa crop
failing its self-check), and the device. A last line gathers the rows.

Matchers: ``zncc``, ``eloftr`` (``weights/eloftr_tiny.npz``) and ``roma``
(``weights/roma_tiny.npz``); ``loftr`` needs an upstream checkpoint
(``weights=``), which the repository does not ship. A matcher that raises
fails the run.

Usage::

    python -m fusion4landslide_tpu_torch.matcher_eval [--image-size 1920 2560]
        [--crop 960 1280] [--overlap 480 640] [--shift-px 25] [--extent 150]
        [--matchers zncc eloftr roma] [--repeats 3] [--device cuda|cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.synth import nadir_camera, planted_flow, render_image

__all__ = ["Scene", "evaluate", "evaluate_matcher", "n_crop_pairs"]

#: ``match_epoch_images``' warning when it matches with ZNCC instead.
FALLBACK_WARNING = "falling back to the ZNCC matcher"


class Scene:
    """The rendered image pair and the camera and shift behind its flow."""

    def __init__(self, image_size, extent: float, shift_px: float):
        h, w = image_size
        self.image_size = (h, w)
        self.extent = extent
        self.K, self.E, _ = nadir_camera(extent, (h, w))
        self.px_per_m = float(self.K[0, 0] / np.linalg.inv(self.E)[2, 3])  # f / altitude
        shift_m = shift_px / self.px_per_m
        self.shift = (shift_m, -0.4 * shift_m, 0.05 * shift_m)
        self.img0 = render_image((h, w), self.K, self.E, extent)
        self.img1 = render_image((h, w), self.K, self.E, extent, shift=self.shift)

    def flow(self, uv_src: np.ndarray) -> np.ndarray:
        """(n, 2) true target pixels of source pixels."""
        return planted_flow(uv_src, self.image_size, self.K, self.E, self.extent, self.shift)


def n_crop_pairs(image_size, crop, overlap) -> int:
    (h, w), (ch, cw), (oh, ow) = image_size, crop, overlap
    return (max(1, int(np.ceil((h - oh) / (ch - oh))))
            * max(1, int(np.ceil((w - ow) / (cw - ow)))))


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def evaluate_matcher(scene: Scene, matcher: str, crop, overlap, shift_px: float, *,
                     repeats: int = 3, device=None) -> dict:
    """One matcher's row: EPE, precision, match count, seconds, fallback."""
    from fusion4landslide_tpu_torch.image.matching import match_epoch_images

    dev = resolve_device(device)
    logger = logging.getLogger(f"{__name__}.{matcher}")
    logger.propagate = False
    warned = _Warnings()
    logger.addHandler(warned)
    kw = dict(matcher=matcher, crop_size=tuple(crop), overlap_size=tuple(overlap),
              max_flow_px=2.0 * shift_px, logger=logger, device=dev)
    seconds = []
    try:
        for _ in range(1 + repeats):
            t0 = time.perf_counter()
            m = match_epoch_images(scene.img0, scene.img1, **kw)
            seconds.append(time.perf_counter() - t0)
    finally:
        logger.removeHandler(warned)
    m = np.asarray(m, np.float32).reshape(-1, 4)
    row = {"matcher": matcher, "n_matches": int(len(m))}
    if len(m):
        epe = np.linalg.norm(m[:, 2:4] - scene.flow(m[:, :2]), axis=1)
        row.update(epe_median_px=float(np.median(epe)), epe_mean_px=float(epe.mean()),
                   precision_3px=float((epe < 3).mean()), precision_5px=float((epe < 5).mean()))
    n_crops = n_crop_pairs(scene.image_size, crop, overlap)
    warm = min(seconds[1:], default=seconds[0])
    row.update(pair_seconds_warm=warm, pair_seconds_cold=seconds[0],
               seconds_per_crop_pair=warm / n_crops, n_crop_pairs=n_crops,
               zncc_fallback=any(FALLBACK_WARNING in s for s in warned.messages),
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    return row


def evaluate(matchers=("zncc", "eloftr", "roma"), image_size=(1920, 2560), crop=(960, 1280),
             overlap=(480, 640), shift_px: float = 25.0, extent: float = 150.0,
             repeats: int = 3, device=None, emit=None) -> dict:
    """Every matcher's row on one rendered scene; ``emit(row)`` is called
    as each row is done. Returns the tool's summary record."""
    dev = resolve_device(device)
    scene = Scene(image_size, extent, shift_px)
    print(f"# scene: {image_size[0]}x{image_size[1]}, {scene.px_per_m:.2f} px/m, planted "
          f"shift {scene.shift[0]:.2f} m (~{shift_px:.0f} px)", file=sys.stderr)
    rows = []
    for matcher in matchers:
        rows.append(evaluate_matcher(scene, matcher, crop, overlap, shift_px, repeats=repeats,
                                     device=dev))
        if emit is not None:
            emit(rows[-1])
    return {"image_size": list(image_size), "crop": list(crop), "overlap": list(overlap),
            "shift_px": shift_px, "results": rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, nargs=2, default=[1920, 2560])
    ap.add_argument("--crop", type=int, nargs=2, default=[960, 1280])
    ap.add_argument("--overlap", type=int, nargs=2, default=[480, 640])
    ap.add_argument("--shift-px", type=float, default=25.0)
    ap.add_argument("--matchers", nargs="+", default=["zncc", "eloftr", "roma"])
    ap.add_argument("--extent", type=float, default=150.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = evaluate(args.matchers, tuple(args.image_size), tuple(args.crop),
                       tuple(args.overlap), args.shift_px, args.extent, args.repeats,
                       args.device, emit=lambda row: print(json.dumps(row), flush=True))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
