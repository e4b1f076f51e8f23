"""Image loading (port of ``fusion4landslide_tpu.io.images``; reference
cv2.imread at base:839-841, PIL here). The image matcher
(``image.matching``) reads the pixels; the fusion driver reads an image
only where it runs the matcher or the config gives no ``image_size``."""

from __future__ import annotations

import numpy as np

__all__ = ["load_image"]


def load_image(path: str) -> np.ndarray:
    """(h, w, 3) uint8 RGB pixels of an image file."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))
