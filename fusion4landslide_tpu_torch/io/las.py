"""Minimal LAS point-cloud reader in pure numpy (the port's own copy of
``fusion4landslide_tpu.io.las``).

The reference reads LAS epochs via laspy (src/piecewise_icp.py:7; laspy in
requirements.txt), which is not a dependency here, so the subset needed for
epoch loading is implemented directly: LAS 1.2–1.4 headers, point formats
0–10, returning scaled float64 XYZ plus intensity and RGB when present.
Compressed LAZ is not supported (the reference's laspy base install doesn't
decompress LAZ either).
"""

from __future__ import annotations

import struct

import numpy as np

from fusion4landslide_tpu_torch.io.ply import PointCloud

__all__ = ["read_las"]

# Offsets of (rgb, intensity-after-xyz) per point-data-record format.
_RGB_OFFSET = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}


def read_las(path: str) -> PointCloud:
    with open(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError("not a LAS file")
        if len(header) < 227:  # smallest valid header (LAS <= 1.3)
            raise ValueError("truncated LAS header")
        ver_major, ver_minor = header[24], header[25]
        header_size = struct.unpack_from("<H", header, 94)[0]
        if header_size < 227 or (ver_minor >= 4 and header_size < 375):
            raise ValueError(
                f"LAS {ver_major}.{ver_minor} header size {header_size} is "
                "below the specification minimum"
            )
        offset_to_points = struct.unpack_from("<I", header, 96)[0]
        if offset_to_points < header_size:
            raise ValueError("point-data offset inside the header")
        fmt_id = header[104]
        if fmt_id & 0x80:  # LAZ compression bit
            raise ValueError("LAZ-compressed files are not supported")
        record_len = struct.unpack_from("<H", header, 105)[0]
        if record_len < 20:  # format 0 minimum
            raise ValueError(f"invalid point record length {record_len}")
        n_points = struct.unpack_from("<I", header, 107)[0]
        scales = struct.unpack_from("<3d", header, 131)
        offsets = struct.unpack_from("<3d", header, 155)
        if ver_minor >= 4 and n_points == 0:
            n_points = struct.unpack_from("<Q", header, 247)[0]

        f.seek(offset_to_points)
        buf = f.read(n_points * record_len)
        if len(buf) < n_points * record_len:
            raise ValueError(
                f"truncated LAS point data: header declares {n_points} "
                f"records of {record_len} B, file holds {len(buf)} B"
            )
        raw = np.frombuffer(buf, dtype=np.uint8).reshape(n_points, record_len)

    def field(off, dt):
        width = np.dtype(dt).itemsize
        return (
            raw[:, off : off + width]
            .copy()
            .view(dt)
            .reshape(n_points)
        )

    x = field(0, "<i4").astype(np.float64) * scales[0] + offsets[0]
    y = field(4, "<i4").astype(np.float64) * scales[1] + offsets[1]
    z = field(8, "<i4").astype(np.float64) * scales[2] + offsets[2]
    pts = np.stack([x, y, z], axis=1)

    extras = {"intensity": field(12, "<u2")}
    colors = None
    if fmt_id in _RGB_OFFSET and record_len >= _RGB_OFFSET[fmt_id] + 6:
        off = _RGB_OFFSET[fmt_id]
        rgb16 = np.stack(
            [field(off, "<u2"), field(off + 2, "<u2"), field(off + 4, "<u2")],
            axis=1,
        )
        colors = (rgb16 / 257.0).astype(np.uint8)
    return PointCloud(points=pts, colors=colors, extras=extras)
