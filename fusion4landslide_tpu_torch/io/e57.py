"""Minimal ASTM E57 point-cloud reader and writer, pure Python and numpy
(the port's own copy of ``fusion4landslide_tpu.io.e57``).

The Rockfall Simulator epochs ship as E57 files (README.md:83); the
reference converts them offline. This module reads the common subset that
laser-scanner exports write: Data3D CompressedVector sections whose
prototype stores cartesianX/Y/Z as Float (double or single) or
ScaledInteger, with optional colorRed/Green/Blue and intensity. It writes
standard-conformant files with Float(double) coordinates and 8-bit
Integer colours, so the drivers read E57 epochs directly.

Format essentials (ASTM E2807):
- the file is a sequence of 1024-byte physical pages, each ending in a
  CRC-32C checksum of its 1020 payload bytes (the logical stream excludes
  the checksums);
- a 48-byte header (signature, version, physical length, XML physical
  offset and logical length, page size);
- an XML document describing the element tree; point records live in
  CompressedVector binary sections: a 32-byte section header, then data
  packets (header, per-bytestream byte counts, then one bit-packed
  bytestream per prototype field).

Refused with a clear message: index-packet seeking (every packet is
streamed), zLib-compressed packets (the flag bit) and exotic prototypes.
A file written by either package reads the same in the other.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET

import numpy as np

from fusion4landslide_tpu_torch.io.ply import PointCloud

__all__ = ["read_e57", "write_e57"]

_SIGNATURE = b"ASTM-E57"
_PAGE = 1024
_PAYLOAD = _PAGE - 4
_NS = "http://www.astm.org/COMMIT/E57/2010-e57-v1.0"


def _crc32c_table():
    poly = 0x82F63B78  # reversed Castagnoli
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table[i] = c
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = np.uint32(0xFFFFFFFF)
    table = _CRC_TABLE
    for b in data:
        crc = table[(int(crc) ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _crc32c_pages(pages: np.ndarray) -> np.ndarray:
    """CRC-32C of every row of a (n_pages, _PAYLOAD) uint8 array at once.

    Page checksums are independent, so the sequential byte recurrence runs
    vectorized ACROSS pages: _PAYLOAD numpy steps total instead of a
    Python-level loop over every byte of the file."""
    crc = np.full(pages.shape[0], 0xFFFFFFFF, np.uint32)
    table = _CRC_TABLE
    for j in range(pages.shape[1]):
        crc = table[(crc ^ pages[:, j]) & 0xFF] ^ (crc >> np.uint32(8))
    return crc ^ np.uint32(0xFFFFFFFF)


def _delogical(raw: bytes) -> bytes:
    """Strip the per-page CRC words: physical stream -> logical stream
    (the bytes of a page-by-page copy, a short last page included)."""
    full, tail = divmod(len(raw), _PAGE)
    pages = np.frombuffer(raw, np.uint8, count=full * _PAGE).reshape(full, _PAGE)
    return pages[:, :_PAYLOAD].tobytes() + raw[full * _PAGE : full * _PAGE + min(tail, _PAYLOAD)]


def _phys_to_logical(offset: int) -> int:
    return (offset // _PAGE) * _PAYLOAD + (offset % _PAGE)


def _logical_to_phys(offset: int) -> int:
    return (offset // _PAYLOAD) * _PAGE + (offset % _PAYLOAD)


def _tag(name: str) -> str:
    return f"{{{_NS}}}{name}"


def _parse_field(el) -> dict:
    t = el.get("type")
    out = {"name": el.tag.split("}")[-1], "type": t}
    if t == "Float":
        out["precision"] = el.get("precision", "double")
    elif t == "ScaledInteger":
        out["minimum"] = int(el.get("minimum", "0"))
        out["maximum"] = int(el.get("maximum", "0"))
        out["scale"] = float(el.get("scale", "1.0"))
        out["offset"] = float(el.get("offset", "0.0"))
    elif t == "Integer":
        out["minimum"] = int(el.get("minimum", "0"))
        out["maximum"] = int(el.get("maximum", "0"))
    else:
        raise NotImplementedError(
            f"e57 prototype field type '{t}' for {out['name']}"
        )
    return out


def _field_bits(f: dict) -> int:
    if f["type"] == "Float":
        return 64 if f["precision"] == "double" else 32
    span = f["maximum"] - f["minimum"]
    return max(span.bit_length(), 1) if span > 0 else 0


def _unpack_stream(buf: bytes, f: dict, max_records: int) -> np.ndarray:
    bits = _field_bits(f)
    if f["type"] == "Float":
        dtype = "<f8" if bits == 64 else "<f4"
        n = min(len(buf) // (bits // 8), max_records)
        return np.frombuffer(buf, dtype=dtype, count=n).astype(np.float64)
    if bits == 0:
        return np.full(max_records, float(f["minimum"]))
    # Bit-unpack little-endian LSB-first integers of width `bits`.
    arr = np.frombuffer(buf, np.uint8)
    bitvals = np.unpackbits(arr, bitorder="little")
    n = min(len(bitvals) // bits, max_records)
    bitvals = bitvals[: n * bits].reshape(n, bits).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(bits, dtype=np.uint64))
    raw = (bitvals * weights).sum(axis=1)
    vals = raw.astype(np.float64) + f["minimum"]
    if f["type"] == "ScaledInteger":
        vals = vals * f["scale"] + f["offset"]
    return vals


def read_e57(path: str, scan_index: int = 0):
    """Read one Data3D scan.

    Returns a :class:`fusion4landslide_tpu_torch.io.ply.PointCloud`
    (points (n, 3) float64 in the scan's pose frame, colors (n, 3) uint8
    or None).
    """

    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not an E57 file (bad signature)")
    logical = _delogical(raw)
    (
        _major,
        _minor,
        _phys_len,
        xml_phys,
        xml_len,
        page,
    ) = struct.unpack_from("<IIQQQQ", logical, 8)
    if page != _PAGE:
        raise NotImplementedError(f"e57 page size {page} != 1024")
    xml_log = _phys_to_logical(xml_phys)
    root = ET.fromstring(logical[xml_log : xml_log + xml_len].decode("utf-8"))

    data3d = root.find(_tag("data3D"))
    if data3d is None:
        raise ValueError("no data3D section")
    scans = data3d.findall(_tag("vectorChild"))
    if scan_index >= len(scans):
        raise IndexError(f"scan {scan_index} of {len(scans)}")
    scan = scans[scan_index]
    points_el = scan.find(_tag("points"))
    rec_count = int(points_el.get("recordCount"))
    section_phys = int(points_el.get("fileOffset"))
    proto = points_el.find(_tag("prototype"))
    fields = [_parse_field(el) for el in proto]

    # CompressedVector section header (32 bytes).
    sec_log = _phys_to_logical(section_phys)
    sec_id = logical[sec_log]
    if sec_id != 1:
        raise ValueError(f"bad CompressedVector section id {sec_id}")
    (_sec_len, data_phys, _index_phys) = struct.unpack_from(
        "<QQQ", logical, sec_log + 8
    )

    streams: list[list[bytes]] = [[] for _ in fields]
    counts = np.zeros(len(fields), np.int64)
    pos = _phys_to_logical(data_phys)
    while counts.min() < rec_count:
        ptype = logical[pos]
        if ptype == 0:  # index packet — skip
            (length_m1,) = struct.unpack_from("<H", logical, pos + 2)
            pos += length_m1 + 1
            continue
        if ptype != 1:
            raise ValueError(f"unexpected e57 packet type {ptype}")
        flags = logical[pos + 1]
        if flags & 0x02:
            raise NotImplementedError("zLib-compressed e57 packets")
        (length_m1,) = struct.unpack_from("<H", logical, pos + 2)
        (stream_count,) = struct.unpack_from("<H", logical, pos + 4)
        if stream_count != len(fields):
            raise ValueError(
                f"packet has {stream_count} bytestreams, prototype has "
                f"{len(fields)} fields"
            )
        byte_counts = struct.unpack_from(f"<{stream_count}H", logical, pos + 6)
        data_start = pos + 6 + 2 * stream_count
        off = data_start
        for s, bc in enumerate(byte_counts):
            streams[s].append(logical[off : off + bc])
            bits = _field_bits(fields[s])
            counts[s] += (bc * 8) // bits if bits else rec_count
            off += bc
        pos += length_m1 + 1

    cols = {}
    for f, parts in zip(fields, streams):
        cols[f["name"]] = _unpack_stream(b"".join(parts), f, rec_count)

    for ax in ("cartesianX", "cartesianY", "cartesianZ"):
        if ax not in cols:
            raise NotImplementedError(
                f"e57 prototype lacks {ax} (spherical-only scans are not "
                "supported)"
            )
    pts = np.stack(
        [cols["cartesianX"], cols["cartesianY"], cols["cartesianZ"]], axis=1
    )[:rec_count]
    colors = None
    if all(f"color{c}" in cols for c in ("Red", "Green", "Blue")):
        colors = np.stack(
            [cols["colorRed"], cols["colorGreen"], cols["colorBlue"]], axis=1
        )[:rec_count].astype(np.uint8)
    return PointCloud(points=pts, colors=colors)


def _paginate(logical: bytes) -> bytes:
    n_pages = -(-len(logical) // _PAYLOAD)
    buf = np.zeros(n_pages * _PAYLOAD, np.uint8)
    buf[: len(logical)] = np.frombuffer(logical, np.uint8)
    pages = buf.reshape(n_pages, _PAYLOAD)
    crcs = _crc32c_pages(pages)
    out = np.zeros((n_pages, _PAGE), np.uint8)
    out[:, :_PAYLOAD] = pages
    out[:, _PAYLOAD:] = crcs.astype("<u4").view(np.uint8).reshape(n_pages, 4)
    return out.tobytes()


def _physical_length(logical_len: int) -> int:
    return (-(-logical_len // _PAYLOAD)) * _PAGE


def write_e57(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Write one Data3D scan with Float(double) cartesian coordinates
    (+ optional 8-bit Integer colors)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    fields = ["cartesianX", "cartesianY", "cartesianZ"]
    streams = [points[:, 0].tobytes(), points[:, 1].tobytes(),
               points[:, 2].tobytes()]
    proto_xml = "".join(
        f'<{f} type="Float" precision="double"/>' for f in fields
    )
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        for i, c in enumerate(("colorRed", "colorGreen", "colorBlue")):
            fields.append(c)
            streams.append(np.ascontiguousarray(colors[:, i]).tobytes())
            proto_xml += f'<{c} type="Integer" minimum="0" maximum="255"/>'

    # Data packets: chunk records so each packet stays < 64 KiB logical.
    bytes_per_rec = [len(s) // max(n, 1) for s in streams]
    per_packet = max(
        1, (0xFFFF - 6 - 2 * len(streams) - 8) // max(sum(bytes_per_rec), 1)
    )
    packets = bytearray()
    for start in range(0, max(n, 1), per_packet):
        cnt = min(per_packet, n - start) if n else 0
        parts = [
            s[start * bpr : (start + cnt) * bpr]
            for s, bpr in zip(streams, bytes_per_rec)
        ]
        body = bytearray()
        body += struct.pack("<H", len(streams))
        for p in parts:
            body += struct.pack("<H", len(p))
        for p in parts:
            body += p
        length = 4 + len(body)
        pad = (-length) % 4  # packets are 4-byte aligned
        body += b"\x00" * pad
        length += pad
        packets += struct.pack("<BBH", 1, 0, length - 1) + body

    # CompressedVector section: 32-byte header + packets.
    header_log = 48
    section_log = header_log  # binary section directly after the header
    data_log = section_log + 32
    section = struct.pack(
        "<B7xQQQ",
        1,
        32 + len(packets),
        _logical_to_phys(data_log),
        0,
    ) + bytes(packets)

    xml_log = section_log + len(section)
    section_phys = _logical_to_phys(section_log)

    xml = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<e57Root type="Structure" xmlns="{_NS}">'
        f'<formatName type="String"><![CDATA[ASTM E57 3D Imaging Data File]]></formatName>'
        f'<guid type="String"><![CDATA[{{F4L-0000}}]]></guid>'
        f'<versionMajor type="Integer">1</versionMajor>'
        f'<versionMinor type="Integer">0</versionMinor>'
        f'<data3D type="Vector" allowHeterogeneousChildren="1">'
        f'<vectorChild type="Structure">'
        f'<guid type="String"><![CDATA[{{F4L-0001}}]]></guid>'
        f'<points type="CompressedVector" fileOffset="{section_phys}" '
        f'recordCount="{n}">'
        f'<prototype type="Structure">{proto_xml}</prototype>'
        f'<codecs type="Vector" allowHeterogeneousChildren="1"/>'
        f"</points>"
        f"</vectorChild>"
        f"</data3D>"
        f"</e57Root>"
    ).encode("utf-8")

    total_logical = xml_log + len(xml)
    header = _SIGNATURE + struct.pack(
        "<IIQQQQ",
        1,
        0,
        _physical_length(total_logical),
        _logical_to_phys(xml_log),
        len(xml),
        _PAGE,
    )
    physical = _paginate(header + section + xml)
    with open(path, "wb") as fh:
        fh.write(physical)
