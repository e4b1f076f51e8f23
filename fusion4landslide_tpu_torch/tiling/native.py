"""ctypes binding of the native host tiler ``cpp/tiler.cpp`` (the port's
own copy of ``fusion4landslide_tpu.tiling.native``).

The library is built from the source in the checkout at first use, with
``cpp/Makefile``'s flags (``g++ -O3 -std=c++17 -fPIC -Wall -shared``),
into ``_build/`` beside the package (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt. The prebuilt
``cpp/libf4lhost.so`` is neither loaded nor rebuilt. The drivers tile with
the numpy tiler (``tiling.bsp``), as the JAX drivers do; this is a
library function, and it raises when the library cannot be built: it does
not hand over to the numpy tiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["build_native", "native_available", "tile_point_clouds_native"]

SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "tiler.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


def _lib_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD / f"libf4lhost-{h.hexdigest()[:12]}.so"


def _load(build: bool) -> ctypes.CDLL | None:
    """The loaded library; built first when ``build`` and absent (raises
    ``RuntimeError`` with the compiler's output when that fails)."""
    path = _lib_path()
    with _LOCK:
        if path in _LIBS:
            return _LIBS[path]
        if not path.exists():
            if not build:
                return None
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cxx = os.environ.get("CXX", "g++")
            try:
                proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(SOURCE)],
                                      capture_output=True, text=True)
            except FileNotFoundError as exc:
                raise RuntimeError(f"native tiler: no C++ compiler ({cxx})") from exc
            if proc.returncode != 0:
                raise RuntimeError(f"native tiler: {cxx} failed for {SOURCE}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.f4l_tile_point_clouds.restype = ctypes.c_int
        lib.f4l_tile_point_clouds.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_char_p,
        ]
        lib.f4l_last_error.restype = ctypes.c_char_p
        lib.f4l_last_error.argtypes = []
        _LIBS[path] = lib
        return lib


def native_available() -> bool:
    """Whether the library of the current source is built (nothing is
    compiled here)."""
    return _load(build=False) is not None


def build_native() -> bool:
    """Compile ``cpp/tiler.cpp`` into ``_build/`` if needed; returns
    success (``tile_point_clouds_native`` raises the compiler's message
    instead)."""
    try:
        _load(build=True)
    except RuntimeError:
        return False
    return True


def tile_point_clouds_native(src_path: str, tgt_path: str, max_pts: int, min_pts: int,
                             save_dir: str, halo: float = 20.0) -> int:
    """Tile two PLY epochs with the native core into
    ``save_dir/{non_overlap,overlap}``, the numpy tiler's layout; returns
    the tile count. Builds the library at first use; raises
    ``RuntimeError`` with the native or the compiler's message on
    failure."""
    lib = _load(build=True)
    os.makedirs(save_dir, exist_ok=True)
    n = lib.f4l_tile_point_clouds(os.fsencode(src_path), os.fsencode(tgt_path), int(max_pts),
                                  int(min_pts), float(halo), os.fsencode(save_dir))
    if n < 0:
        raise RuntimeError(lib.f4l_last_error().decode())
    return n
