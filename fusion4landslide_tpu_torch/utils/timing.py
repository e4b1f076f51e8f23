"""Per-stage wall-clock timing of the port's tiles and steps (the port's
counterpart of ``fusion4landslide_tpu.utils.timing``).

The reference times whole runs only (main_fusion.py:108,154-160); the
stage times here let the drivers' ``run summary`` and ``chip_smoke.py``
attribute a tile's seconds.
"""

from __future__ import annotations

import time

import torch

__all__ = ["StageTimer"]


class StageTimer:
    """Per-stage wall seconds, synchronised with the current stream of
    ``device`` at each mark (only when the caller passes a ``timings``
    dict). A tile stream (``parallel.pipeline``) times its own stream's
    work, so streams sharing a card do not wait for each other here."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings, self.device = timings, device
        self.last = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.last
        self.last = now
