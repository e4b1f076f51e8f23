"""Profiler hooks over ``torch.profiler`` (the port's counterpart of
``fusion4landslide_tpu.utils.profiling``, which traces with
``jax.profiler``).

Set ``profile_dir`` (or ``F4L_PROFILE_DIR`` in the environment) and the
enclosed block writes a Chrome trace of host and CUDA activity there;
without one the hooks do nothing. Like the JAX package, no pipeline calls
them yet: wrap the code to be traced.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["annotate", "maybe_trace"]


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None = None):
    """Trace the enclosed block with ``torch.profiler`` into
    ``<profile_dir>/trace_<time>_<pid>.json`` when a directory is
    configured; a no-op otherwise."""
    profile_dir = profile_dir or os.environ.get("F4L_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def annotate(name: str):
    """A named span inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
