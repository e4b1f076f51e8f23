"""The port's tracing: spans on ``torch.profiler``'s clock, and counters
of the hand-written kernels' work, per tile.

Spans. ``span(name)`` is a ``torch.profiler.record_function`` span. With
a profiler running it lands in the trace on kineto's clock, the clock of
the device kernels beside it; without one it costs a dispatcher call on
entry and on exit. ``utils.timing.StageTimer.stage`` opens one per stage,
named by the stage's ``timings`` key; the steps inside a stage open their
own, named ``<layer>.<step>`` after the layers of PERF.md §3 (which lists
every name).

Counters. A tile or step function decorated with ``tile(name)`` runs
inside a span ``name`` and, when it is called with a ``timings`` dict,
with a record of kernel work active in the calling thread. The record is
found through a context variable, so each tile stream's thread keeps its
own, and a decorated function called inside another's tile adds to that
tile's record. The kernels' launch wrappers add their work to the record
(``count``) as device tensors, without a sync; when the tile ends, the
record is read back to ints in one copy and added to
``timings["counters"]``. With no record active, ``record()`` is None and
the wrappers count nothing: no tensor op, no sync.

Counter keys (summed over the tile's launches): kernel 1
``radius_sample.positions`` (window positions scanned, over the launched
blocks), ``.evaluations`` (positions x block: candidate evaluations),
``.rows`` (output rows) and ``.slots`` (rows x ``num_points``); kernel 2
``grid_knn.positions``, ``.evaluations``, ``.rows`` (``n_pad``) and
``.slots`` (``n_pad`` x k); kernel 3 (on the card only) ``knn.rows`` (query
rows) and ``knn.rescored`` (candidates its filter passed to the exact
rescoring); the DIPs epilogue (``ops/dips_epilogue.py``, both paths)
``dips.epilogues`` (calls: ten per ``PointNetFeature`` call).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

__all__ = ["count", "record", "span", "tile"]

_RECORD: contextvars.ContextVar[dict | None] = contextvars.ContextVar("tile_record",
                                                                      default=None)


def span(name: str):
    """A span named ``name`` in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)


def record() -> dict | None:
    """The active tile's record of kernel work in this thread, or None."""
    return _RECORD.get()


def count(rec: dict, key: str, value) -> None:
    """Add ``value`` (an int, or an integer tensor left on its device) to
    ``rec[key]``."""
    rec[key] = rec.get(key, 0) + value


def _read_back(rec: dict) -> dict[str, int]:
    """The record's counts as ints: its tensors in one device-to-host copy."""
    tensors = [v.to(torch.int64).reshape(()) for v in rec.values() if torch.is_tensor(v)]
    host = iter(torch.stack(tensors).tolist() if tensors else ())
    return {k: int(next(host)) if torch.is_tensor(v) else int(v) for k, v in rec.items()}


@contextlib.contextmanager
def _recording(timings: dict | None):
    if timings is None or _RECORD.get() is not None:
        yield
        return
    rec: dict = {}
    token = _RECORD.set(rec)
    try:
        yield
    finally:
        _RECORD.reset(token)
    counters = timings.setdefault("counters", {})
    for key, value in _read_back(rec).items():
        counters[key] = counters.get(key, 0) + value


def tile(name: str):
    """Decorate a tile or step function that takes ``timings=`` as a
    keyword: it runs inside a span ``name`` and, with a ``timings`` dict,
    counts its kernels' work into ``timings["counters"]`` (module
    docstring)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, timings: dict | None = None, **kwargs):
            with span(name), _recording(timings):
                return fn(*args, timings=timings, **kwargs)
        return run
    return wrap
