"""Reduction of a ``torch.profiler`` trace of the window to device busy
time, kernel time by name and the longest idle gaps, each named by what
the host was doing during it (the innermost benchmark span, and the
innermost host operation inside it, that cover the gap's middle)."""

from __future__ import annotations

import bisect
import re

from torch.autograd import DeviceType

#: Kernel names of the port's hand-written kernels.
KERNELS = {"radius_sample": r"\bradius_sample_kernel\b", "grid_knn": r"\bgrid_knn_kernel\b",
           "knn": r"\bknn_kernel\b"}
WINDOW_SPAN = "bench.window"


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def reduce(prof) -> dict:
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the profiler saw no window span")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    span_names = {e.name() for e in events if e.is_user_annotation()}
    dev, spans, ops = [], [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0 or s + d <= w0 or s >= w1:
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() in span_names:
                continue  # a span's shadow on the device timeline, not work
            dev.append((max(s, w0), min(s + d, w1), e.name()))
        elif e.name() != WINDOW_SPAN:
            (spans if e.is_user_annotation() else ops).append((s, s + d, e.name()))
    by_name: dict[str, float] = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-9
    merged = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    spans.sort()
    ops.sort()

    def innermost(items, t):
        hits = [(e - s, n) for s, e, n in items[:bisect.bisect_right(items, (t, float("inf"), ""))]
                if s <= t <= e]
        return min(hits)[1] if hits else None

    idle = []
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        name = innermost(spans, mid) or "outside any span"
        op = innermost(ops, mid)
        idle.append([_short(name + (f" / {op}" if op else " / host Python")), length * 1e-9])
    kernels = {k: sum(v for n, v in by_name.items() if re.search(p, n))
               for k, p in KERNELS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy, "kernels_s": kernels,
            "device_ops": [[_short(n), v] for n, v in top], "idle_gaps": idle}
