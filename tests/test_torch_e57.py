"""The port's E57 reader and writer (``io/e57.py``) against the JAX
package's: files written by either read bit-equal in the other, the JAX
tests' four cases (points only, colours, file structure, garbage
rejected) hold in the port, the refusals keep their messages, and
``read_point_cloud`` hands ``.e57`` epochs to the tiler.

Tolerance: arrays and files bit-equal."""

import struct

import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.io import e57 as je
from fusion4landslide_tpu_torch.io import e57 as te


def cloud(rng, n, colors):
    pts = rng.uniform(-50, 50, size=(n, 3))
    cols = rng.integers(0, 256, size=(n, 3)).astype(np.uint8) if colors else None
    return pts, cols


@pytest.mark.parametrize("n, colors", [(3777, False), (1234, True), (1, True), (0, False)])
def test_files_cross_read_bit_equal(tmp_path, n, colors):
    pts, cols = cloud(np.random.default_rng(n), n, colors)
    te.write_e57(str(tmp_path / "port.e57"), pts, cols)
    je.write_e57(str(tmp_path / "jax.e57"), pts, cols)
    assert (tmp_path / "port.e57").read_bytes() == (tmp_path / "jax.e57").read_bytes()
    for writer in ("port", "jax"):
        path = str(tmp_path / f"{writer}.e57")
        a, b = te.read_e57(path), je.read_e57(path)
        np.testing.assert_array_equal(a.points.reshape(-1, 3), pts.reshape(-1, 3))
        np.testing.assert_array_equal(a.points, b.points)
        assert a.points.dtype == b.points.dtype == np.float64
        if colors:
            np.testing.assert_array_equal(a.colors, cols)
            np.testing.assert_array_equal(a.colors, b.colors)
        else:
            assert a.colors is None and b.colors is None


def test_e57_roundtrip_points_only(tmp_path, rng):
    pts = rng.uniform(-50, 50, size=(3777, 3))  # odd count: packet chunking
    path = str(tmp_path / "cloud.e57")
    te.write_e57(path, pts)
    c = te.read_e57(path)
    np.testing.assert_array_equal(c.points, pts)
    assert c.colors is None


def test_e57_roundtrip_with_colors(tmp_path, rng):
    pts = rng.uniform(-5, 5, size=(1234, 3))
    cols = rng.integers(0, 256, size=(1234, 3)).astype(np.uint8)
    path = str(tmp_path / "cloud_rgb.e57")
    te.write_e57(path, pts, cols)
    c = te.read_e57(path)
    np.testing.assert_array_equal(c.points, pts)
    np.testing.assert_array_equal(c.colors, cols)


def test_e57_file_structure(tmp_path, rng):
    """Signature, a whole number of pages, the header's physical length
    and page size, a CRC-32C on every page (checked against the scalar
    reference), and the XML section at the header's offset."""
    pts = rng.uniform(0, 1, size=(2000, 3))
    path = tmp_path / "s.e57"
    te.write_e57(str(path), pts)
    raw = path.read_bytes()
    assert raw[:8] == b"ASTM-E57"
    assert len(raw) % te._PAGE == 0
    (_, _, phys_len, xml_phys, xml_len, page) = struct.unpack_from("<IIQQQQ", raw, 8)
    assert phys_len == len(raw) and page == te._PAGE
    for p in range(len(raw) // te._PAGE):
        body = raw[p * te._PAGE:p * te._PAGE + te._PAYLOAD]
        (crc,) = struct.unpack_from("<I", raw, p * te._PAGE + te._PAYLOAD)
        assert crc == te._crc32c(body) == je._crc32c(body)
    logical = te._delogical(raw)
    xml = logical[te._phys_to_logical(xml_phys):te._phys_to_logical(xml_phys) + xml_len]
    assert xml.startswith(b"<?xml") and xml.endswith(b"</e57Root>")


def test_e57_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.e57")
    open(path, "wb").write(b"definitely not an e57 file" * 10)
    with pytest.raises(ValueError, match="not an E57 file"):
        te.read_e57(path)


def test_refusals_keep_the_jax_messages(tmp_path, rng):
    """zLib packets, a spherical-only prototype and an unknown field type
    raise as in the JAX reader."""
    pts = rng.uniform(0, 1, size=(10, 3))
    path = tmp_path / "c.e57"
    te.write_e57(str(path), pts)
    logical = bytearray(te._delogical(path.read_bytes()))
    xml_phys, xml_len = struct.unpack_from("<QQ", logical, 24)
    xml_at = te._phys_to_logical(xml_phys)
    xml = bytes(logical[xml_at:xml_at + xml_len])

    def rewrite(name, data_flags=0, xml_new=None):
        buf = bytearray(logical)
        buf[48 + 32 + 1] = data_flags  # the first data packet's flag byte
        x = xml if xml_new is None else xml_new
        buf = buf[:xml_at] + x
        struct.pack_into("<QQQ", buf, 16, te._physical_length(len(buf)),
                         te._logical_to_phys(xml_at), len(x))
        out = tmp_path / name
        out.write_bytes(te._paginate(bytes(buf)))
        return str(out)

    cases = [
        (rewrite("z.e57", data_flags=0x02), NotImplementedError, "zLib"),
        (rewrite("sph.e57", xml_new=xml.replace(b"cartesianZ", b"sphericalRange")),
         NotImplementedError, "cartesianZ"),
        (rewrite("str.e57", xml_new=xml.replace(b'<cartesianY type="Float" precision="double"/>',
                                               b'<cartesianY type="String"/>')),
         NotImplementedError, "String"),
    ]
    for path_, exc, msg in cases:
        with pytest.raises(exc, match=msg):
            je.read_e57(path_)
        with pytest.raises(exc, match=msg):
            te.read_e57(path_)


def test_tiler_reads_e57_epochs(tmp_path):
    """``tile_point_clouds`` on E57 epochs writes the tiles it writes from
    the same epochs as PLY files, byte for byte."""
    from fusion4landslide_tpu_torch.io import read_point_cloud
    from fusion4landslide_tpu_torch.io.ply import write_ply
    from fusion4landslide_tpu_torch.synth import synth_epoch_pair
    from fusion4landslide_tpu_torch.tiling import tile_point_clouds

    src, tgt, _ = synth_epoch_pair(24, 10, density=40.0, seed=2, offset=(2.6e6, 1.2e6, 500.0))
    rgb = np.random.default_rng(0).integers(0, 256, size=(len(src), 3)).astype(np.uint8)
    for ext, write in (("ply", write_ply), ("e57", te.write_e57)):
        write(str(tmp_path / f"s.{ext}"), src, rgb)
        write(str(tmp_path / f"t.{ext}"), tgt, rgb[:len(tgt)])
        pc = read_point_cloud(str(tmp_path / f"s.{ext}"))
        np.testing.assert_array_equal(pc.points, read_point_cloud(str(tmp_path / "s.ply")).points)
        n = tile_point_clouds(str(tmp_path / f"s.{ext}"), str(tmp_path / f"t.{ext}"), 3000, 100,
                              True, 0.1, 0.0, -1, str(tmp_path / ext), halo=2.0)
        assert n >= 2
    files = sorted(p.relative_to(tmp_path / "ply") for p in (tmp_path / "ply").rglob("*.ply"))
    assert len(files) == 4 * n
    for f in files:
        assert (tmp_path / "ply" / f).read_bytes() == (tmp_path / "e57" / f).read_bytes()
