"""Console + file logger (port of ``fusion4landslide_tpu.utils.logging``;
reference utils/logger.py:27-51)."""

from __future__ import annotations

import logging
import os
import sys
import time

_FMT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(
    name: str = "fusion4landslide_tpu_torch",
    log_dir: str | None = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """Create (or fetch) a logger writing to console and, optionally, a
    timestamped file under ``log_dir`` (mirrors the reference's per-run log
    file, main_fusion.py:68-71)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(log_dir, f"run_{stamp}.log")
        if not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == os.path.abspath(path)
            for h in logger.handlers
        ):
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
    logger.propagate = False
    return logger
