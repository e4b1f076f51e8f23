"""What a driver run reports at its end: seconds per tile with the tile's
stage times, seconds of tiling, weight loading and tile reading (the
reader thread's time the loop waited for), peak device memory, the
kernel launches of the run (``ops.cuda_build.LAUNCHES``, counted from the
summary's creation), the grid-window overflow summed over the run's
tiles, by kernel (``sampler``: kernel 1, ``grid_knn``: kernel 2), and the
device's free and total memory at the end (``torch.cuda.mem_get_info``)."""

from __future__ import annotations

import contextlib
import json
import time

import torch

from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES

__all__ = ["RunSummary"]


class RunSummary:
    """Collects one driver run's readings; ``finish`` logs them as one
    ``run summary:`` JSON line and returns them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.start = time.perf_counter()
        self.phases: dict[str, float] = {"read_tiles_s": 0.0}
        self.tile_seconds: dict[str, float] = {}
        self.stages: dict[str, dict] = {}
        self.launches0 = dict(LAUNCHES)
        self.overflow = {"sampler": 0, "grid_knn": 0}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def tile(self, tile_id):
        """Times one tile; yields the dict its stage times go into."""
        timings: dict = {}
        t0 = time.perf_counter()
        try:
            yield timings
        finally:
            self._sync()
            self.tile_seconds[str(tile_id)] = time.perf_counter() - t0
            self.stages[str(tile_id)] = timings

    def add_overflow(self, *tile_results: dict) -> None:
        """Add the window overflow (``overflow_by_source``) of tile results."""
        for res in tile_results:
            for key, val in res["overflow_by_source"].items():
                self.overflow[key] += int(val)

    def timed_reads(self, items):
        """Yield from ``items``, adding the time spent waiting for each to
        ``read_tiles_s``."""
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self.phases["read_tiles_s"] += time.perf_counter() - t0
            yield item

    def finish(self, logger, output_root: str) -> dict:
        self._sync()
        out = {
            "device": str(self.device),
            "total_s": time.perf_counter() - self.start,
            **self.phases,
            "tile_s": self.tile_seconds,
            "stages_s": self.stages,
            "launches": {k: v - self.launches0.get(k, 0) for k, v in LAUNCHES.items()},
            "overflow": self.overflow,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(self.device) / 2**30
                             if self.device.type == "cuda" else None),
            "mem_free_total_gib": ([b / 2**30 for b in torch.cuda.mem_get_info(self.device)]
                                   if self.device.type == "cuda" else None),
        }
        logger.info("run summary: %s", json.dumps(out))
        logger.info("Displacement estimation done. Results in '%s'. Total time: %.2f hours "
                    "(%.1f s).", output_root, out["total_s"] / 3600, out["total_s"])
        return out
