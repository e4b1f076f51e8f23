"""Build and load the port's CUDA C++ kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. Libraries go to ``_build/`` beside the package
(listed in ``.gitignore``), named by a hash of their source, the ``csrc``
headers it includes and the compiler flags, so an edited kernel, header or
flag is rebuilt. ``build_all`` starts one ``nvcc`` per source, all at
once; ``load`` builds a single library at first use. ``LAUNCHES`` counts
each kernel's launches (its wrapper calls ``count_launch`` once per
launch, under a lock, since tile streams launch from several threads;
calls of the plain versions are not counted).

Arithmetic is compiled with ``-fmad=false``: no product and sum is fused
unless the source says so (``__fmaf_rn``), so each operation rounds as in
the plain PyTorch versions the kernels are held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

__all__ = ["LAUNCHES", "SOURCES", "build_all", "count_launch", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("grid_knn", "radius_sample", "knn", "dips_epilogue")
#: Kernel launches per source.
LAUNCHES = {name: 0 for name in SOURCES}
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``."""
    with _LOCK:
        LAUNCHES[name] += 1


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _lib_path(name: str) -> Path:
    """Library path named by a hash of the source, of every ``csrc`` header
    it includes (``#include "x.cuh"``) and of the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src)
    for header in sorted(set(_INCLUDE.findall(src.decode()))):
        path = CSRC / header
        if path.exists():
            h.update(path.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's log per
    source (``-Xptxas -v`` register/shared-memory report)."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
    return lib
