"""Minimal, fast PLY point-cloud I/O in pure numpy (the port's own copy of
``fusion4landslide_tpu.io.ply``).

Replaces PCL's PLY reader/writer used by the native tiling core
(cpp_core/pcd_tiling/pcd_tiling.cpp loadPLYFile/savePLYFile) and Open3D
``read_point_cloud`` used by every pipeline. Binary little-endian payloads are
memory-mapped with a structured dtype — a single ``np.frombuffer`` per file,
no per-point Python.

Only the ``vertex`` element is interpreted; coordinates (x, y, z) are
required, colours (red, green, blue[, alpha]) and any scalar extras are
passed through.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PointCloud", "read_ply", "write_ply", "ply_vertex_count"]

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


@dataclass
class PointCloud:
    """A host-side point cloud: float64 coordinates + optional attributes."""

    points: np.ndarray  # (n, 3) float64
    colors: np.ndarray | None = None  # (n, 3) uint8
    extras: dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return self.points.shape[0]


def _parse_header(f) -> tuple[str, list[tuple[str, int, list[tuple[str, str]]]]]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b"format":
            fmt = tokens[1].decode()
        elif key == b"element":
            elements.append((tokens[1].decode(), int(tokens[2]), []))
        elif key == b"property":
            if tokens[1] == b"list":
                # count-type item-type name; only occurs for faces, which we
                # skip — record as a marker.
                elements[-1][2].append((tokens[-1].decode(), "LIST:" + tokens[2].decode() + ":" + tokens[3].decode()))
            else:
                elements[-1][2].append((tokens[-1].decode(), tokens[1].decode()))
        elif key == b"end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, elements


def read_ply(path: str) -> PointCloud:
    """Read a PLY file's vertex element."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if fmt != "binary_big_endian" else ">"
        result: PointCloud | None = None
        for name, count, props in elements:
            if any(t.startswith("LIST:") for _, t in props):
                if name == "vertex":
                    raise ValueError("list properties on vertex element unsupported")
                # Skip a list element (e.g. faces): only possible by streaming.
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                    continue
                raise ValueError(f"cannot skip binary list element '{name}'")
            dtype = np.dtype([(p, endian + _PLY_TO_NP[t]) for p, t in props])
            if fmt == "ascii":
                rows = np.loadtxt(
                    _io.BytesIO(b"".join(f.readline() for _ in range(count))),
                    dtype=np.float64,
                    ndmin=2,
                )
                data = np.zeros(count, dtype)
                for i, (p, _) in enumerate(props):
                    data[p] = rows[:, i]
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
            if name != "vertex":
                continue
            fields = set(data.dtype.names)
            if not {"x", "y", "z"} <= fields:
                raise ValueError("vertex element lacks x/y/z")
            pts = np.stack(
                [data["x"], data["y"], data["z"]], axis=1
            ).astype(np.float64)
            colors = None
            if {"red", "green", "blue"} <= fields:
                colors = np.stack(
                    [data["red"], data["green"], data["blue"]], axis=1
                ).astype(np.uint8)
            extras = {
                p: np.ascontiguousarray(data[p])
                for p in data.dtype.names
                if p not in {"x", "y", "z", "red", "green", "blue"}
            }
            result = PointCloud(points=pts, colors=colors, extras=extras)
        if result is None:
            raise ValueError("PLY file has no vertex element")
        return result


def write_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    *,
    ascii_format: bool = False,
    coord_dtype: str = "f8",
) -> None:
    """Write a point cloud as PLY (binary little-endian by default)."""
    points = np.asarray(points)
    n = points.shape[0]
    fields: list[tuple[str, str]] = [(c, coord_dtype) for c in ("x", "y", "z")]
    if colors is not None:
        fields += [(c, "u1") for c in ("red", "green", "blue")]
    dtype = np.dtype([(name, "<" + t) for name, t in fields])
    data = np.zeros(n, dtype)
    for i, c in enumerate(("x", "y", "z")):
        data[c] = points[:, i]
    if colors is not None:
        colors = np.asarray(colors)
        for i, c in enumerate(("red", "green", "blue")):
            data[c] = colors[:, i]
    header = ["ply"]
    header.append("format ascii 1.0" if ascii_format else "format binary_little_endian 1.0")
    header.append(f"element vertex {n}")
    for name, t in fields:
        header.append(f"property {_NP_TO_PLY[t]} {name}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if ascii_format:
            cols = [data[name] for name, _ in fields]
            np.savetxt(f, np.column_stack(cols), fmt="%.8g")
        else:
            f.write(data.tobytes())


def ply_vertex_count(path: str) -> int:
    """Vertex count from the PLY header alone (no point data read) — used
    to size padded tile buckets before streaming tiles through the mesh."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        for _ in range(200):
            line = fh.readline()
            if not line:
                break
            if line.startswith(b"element vertex"):
                return int(line.split()[2])
            if line.strip() == b"end_header":
                break
    raise ValueError(f"{path}: no 'element vertex' in header")
