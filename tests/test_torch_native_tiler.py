"""The port's native tiler binding (``tiling/native.py``) against the JAX
package's: the port builds ``cpp/tiler.cpp`` into a temporary build
directory, and its tile files are byte-equal to those of JAX's
``tile_point_clouds_native`` (the prebuilt ``cpp/libf4lhost.so``) on the
same epochs; the numpy tiler's tiling is held as JAX's test holds it.
Skipped only where no ``g++`` is installed, as JAX's test skips when it
cannot build.

Tolerance: files byte-equal."""

import shutil

import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.io.ply import read_ply, write_ply
from fusion4landslide_tpu_torch.tiling import native as tn


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build cpp/tiler.cpp")
    monkeypatch.setattr(tn, "BUILD", tmp_path / "_build")
    return tmp_path / "_build"


def make_pair(rng, n=4000, extent=200.0):
    src = rng.uniform(0, extent, size=(n, 3))
    src[:, 2] *= 0.05
    return src, src + np.array([0.1, -0.05, 0.02])


def tile_files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*.ply"))


@pytest.mark.parametrize("n, extent, max_pts, rgb", [(4000, 200.0, 800, False),
                                                      (1000, 50.0, 5000, True),
                                                      (6000, 120.0, 700, True)])
def test_tiles_byte_equal_jax(tmp_path, build_dir, n, extent, max_pts, rgb):
    from fusion4landslide_tpu.tiling import native as jn

    assert jn.native_available()
    assert not tn.native_available()
    rng = np.random.default_rng(n)
    src, tgt = make_pair(rng, n, extent)
    cols = rng.integers(0, 256, size=(n, 3)).astype(np.uint8) if rgb else None
    write_ply(str(tmp_path / "src.ply"), src, cols)
    write_ply(str(tmp_path / "tgt.ply"), tgt, cols)
    args = (str(tmp_path / "src.ply"), str(tmp_path / "tgt.ply"), max_pts, 5)
    n_t = tn.tile_point_clouds_native(*args, str(tmp_path / "port"))
    n_j = jn.tile_point_clouds_native(*args, str(tmp_path / "jax"))
    assert n_t == n_j >= 1
    assert tn.native_available() and len(list(build_dir.glob("libf4lhost-*.so"))) == 1
    files = tile_files(tmp_path / "port")
    assert files == tile_files(tmp_path / "jax") and len(files) == 4 * n_t
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    if rgb:
        assert read_ply(str(tmp_path / "port" / files[0])).colors.shape[1] == 3


def test_native_matches_the_numpy_tiler(tmp_path, build_dir):
    """JAX's ``tests/test_native_tiler.py`` case: equal tile counts and the
    same union of core source points."""
    from fusion4landslide_tpu_torch.tiling import tile_point_clouds

    src, tgt = make_pair(np.random.default_rng(0))
    write_ply(str(tmp_path / "src.ply"), src)
    write_ply(str(tmp_path / "tgt.ply"), tgt)
    n_py = tile_point_clouds(str(tmp_path / "src.ply"), str(tmp_path / "tgt.ply"), max_pts=800,
                             min_pts=5, voxel_flag=False, voxel_size=0.0, overlap=0.0,
                             proj_dir=-1, save_dir=str(tmp_path / "py"))
    n_cc = tn.tile_point_clouds_native(str(tmp_path / "src.ply"), str(tmp_path / "tgt.ply"),
                                       max_pts=800, min_pts=5, save_dir=str(tmp_path / "cc"))
    assert n_cc == n_py

    def gather(root):
        pts = [read_ply(str(root / f"non_overlap/source_tile_{i}.ply")).points
               for i in range(n_py)]
        return np.sort(np.vstack(pts).round(6).view("f8,f8,f8"), axis=0)

    np.testing.assert_array_equal(gather(tmp_path / "py"), gather(tmp_path / "cc"))


def test_errors_raise(tmp_path, build_dir, monkeypatch):
    """A bad PLY raises the native message; a failed build raises the
    compiler's, with no hand-over to the numpy tiler."""
    (tmp_path / "bad.ply").write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match="not a PLY"):
        tn.tile_point_clouds_native(str(tmp_path / "bad.ply"), str(tmp_path / "bad.ply"),
                                    max_pts=100, min_pts=2, save_dir=str(tmp_path / "o"))
    broken = tmp_path / "tiler.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", broken)
    assert not tn.build_native()
    with pytest.raises(RuntimeError, match="failed"):
        tn.tile_point_clouds_native(str(tmp_path / "bad.ply"), str(tmp_path / "bad.ply"),
                                    max_pts=100, min_pts=2, save_dir=str(tmp_path / "o2"))
    assert not (tmp_path / "o2").exists()
