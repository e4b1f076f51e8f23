"""Spans and captures around the program's calls into its layers.

A probe replaces a name in one of the program's modules by a wrapper that
calls the original. With tracing on, the wrapper opens a
``torch.profiler.record_function`` span named after the layer, so the
trace can say what the host was doing while the device idled. A capture
hook, where one is given, sees the call's arguments and result; it keeps
what the judge reads after the window, copied to pinned host memory
without waiting for the device (``to_host``), so holding it takes no
device memory and no synchronisation inside the window. A fault (the
tests' and ``calibrate.py``'s, ``faults.py``) alters a call's result, or
replaces the call."""

from __future__ import annotations

import functools

import torch


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that lands once the device reaches this point
    of its stream (read it after ``torch.cuda.synchronize()``)."""
    if not t.is_cuda:
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t.detach(), non_blocking=True)
    return out


class Probes:
    """Installed wrappers; ``tracing`` turns the spans on."""

    def __init__(self):
        self.tracing = False
        self._undo = []

    def wrap(self, module, name: str, span: str, capture=None, alter=None) -> None:
        orig = getattr(module, name)

        @functools.wraps(orig)
        def probe(*args, **kwargs):
            if getattr(alter, "replaces", False):
                out = alter(orig, args, kwargs)
            elif self.tracing:
                with torch.profiler.record_function(span):
                    out = orig(*args, **kwargs)
            else:
                out = orig(*args, **kwargs)
            if alter is not None and not getattr(alter, "replaces", False):
                out = alter(out)
            if capture is not None:
                capture(args, kwargs, out)
            return out

        setattr(module, name, probe)
        self._undo.append((module, name, orig))

    def remove(self) -> None:
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()
