"""Per-stage spans and wall-clock seconds of the port's tiles and steps
(the port's counterpart of ``fusion4landslide_tpu.utils.timing``).

The reference times whole runs only (main_fusion.py:108,154-160). Here
each stage is a span on the profiler's clock (``utils.profiling.span``),
whatever the caller passes, and, when the caller passes a ``timings``
dict, its synchronised wall seconds too: the drivers' ``run summary``,
``chip_smoke.py`` and the benchmark's traced runs attribute a tile's
seconds by them.
"""

from __future__ import annotations

import contextlib
import time

import torch

from fusion4landslide_tpu_torch.utils.profiling import span

__all__ = ["StageTimer", "add_timings", "for_log"]


class StageTimer:
    """The stages of one tile or step. ``stage(name)`` opens a span named
    ``name`` around its block; with a ``timings`` dict it also adds to
    ``timings[name]`` the wall seconds from the previous stage's end (or
    the timer's creation) to the block's end, synchronised with the
    current stream of ``device`` there. A tile stream
    (``parallel.pipeline``) times its own stream's work, so streams
    sharing a card do not wait for each other here."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings, self.device = timings, device
        self.last = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(name):
            yield
            if self.timings is not None:
                now = self._now()
                self.timings[name] = self.timings.get(name, 0.0) + now - self.last
                self.last = now


def add_timings(into: dict, other: dict) -> None:
    """Add one ``timings`` dict's stage seconds and ``counters`` to
    another's (tile streams sum theirs into the caller's)."""
    for k, v in other.items():
        if k == "counters":
            dst = into.setdefault("counters", {})
            for ck, cv in v.items():
                dst[ck] = dst.get(ck, 0) + cv
        else:
            into[k] = into.get(k, 0.0) + v


def for_log(timings: dict, ndigits: int = 3) -> dict:
    """A ``timings`` dict as a log line shows it: stage seconds rounded to
    ``ndigits``, the ``counters`` (``utils.profiling``) as they are."""
    return {k: v if k == "counters" else round(v, ndigits) for k, v in timings.items()}
