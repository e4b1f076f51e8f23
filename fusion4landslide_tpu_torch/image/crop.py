"""Sliding-window image crops (port of ``fusion4landslide_tpu.image.crop``).

The reference's ``src/image_crop.py``: crop epoch images into overlapping
windows written as ``cropped_images/<image name>/<x>_<y>.jpg``. The same
window grid, without the clamped last row and column, is the crop loop of
``image.matching.match_epoch_images``. Host-side only (PIL / numpy).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

__all__ = ["crop_and_save", "crop_image", "grid_crop_boxes"]


def grid_crop_boxes(image_size: tuple[int, int], crop_size: tuple[int, int],
                    overlap_size: tuple[int, int]) -> list[tuple[int, int, int, int]]:
    """Sliding-window boxes (top, left, height, width) covering the image:
    stride = crop - overlap, the last row / column clamped flush with the
    image border so every pixel is covered."""
    h, w = image_size
    ch, cw = crop_size
    oh, ow = overlap_size
    sy, sx = max(ch - oh, 1), max(cw - ow, 1)
    ys = sorted({min(y, max(h - ch, 0)) for y in range(0, max(h - ch, 0) + sy, sy)})
    xs = sorted({min(x, max(w - cw, 0)) for x in range(0, max(w - cw, 0) + sx, sx)})
    return [(y, x, min(ch, h), min(cw, w)) for y in ys for x in xs]


def crop_image(image: np.ndarray, crop_size: tuple[int, int],
               overlap_size: tuple[int, int]) -> list[tuple[tuple[int, int], np.ndarray]]:
    """[((top, left), crop)] for every sliding window."""
    return [((y, x), image[y:y + ch, x:x + cw])
            for y, x, ch, cw in grid_crop_boxes(image.shape[:2], crop_size, overlap_size)]


def crop_and_save(image_path: str, out_root: str, crop_size: tuple[int, int],
                  overlap_size: tuple[int, int]) -> list[str]:
    """Crop an image file to ``out_root/cropped_images/<name>/<x>_<y>.jpg``;
    returns the written paths."""
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"))
    name = osp.splitext(osp.basename(image_path))[0]
    out_dir = osp.join(out_root, "cropped_images", name)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for (y, x), crop in crop_image(img, crop_size, overlap_size):
        path = osp.join(out_dir, f"{x}_{y}.jpg")
        Image.fromarray(crop).save(path)
        written.append(path)
    return written
