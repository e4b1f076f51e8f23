"""The port's superpoint partition (``ops/superpoint.py``,
``ops/partition_io.py``) and its 3-d k-NN vs the JAX package, on the CPU.

Tolerances: k-NN indices and distances equal (the port rounds distances
as the JAX CPU build does and breaks ties to the lower index); features
atol 1e-5; level 1 equal up to relabelling; levels 2-3 up to relabelling
with at most 2% of the points in another region (``_region_merge`` sorts
edge costs with an unstable ``np.argsort``, so a one-ulp difference in a
region mean can reorder near-tie merges).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.checks import partition_differing as _differing
from fusion4landslide_tpu_torch.ops import partition_io as tio
from fusion4landslide_tpu_torch.ops import superpoint as tsp
from fusion4landslide_tpu_torch.ops.knn import knn as tknn


def _cloud(seed=0, n=2500):
    """``tests/test_superpoint.py``'s two-plane cloud."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 12, size=(n, 2))
    z = np.where(xy[:, 0] < 6, 0.0, 0.8 * (xy[:, 0] - 6))
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("k", [15, 30])
def test_knn_3d_matches_jax_with_duplicates(k, local, monkeypatch):
    """Brute force, and the block-local search (forced here with 512-row
    blocks; the port takes it above 2^28 pairs)."""
    from fusion4landslide_tpu.ops.knn import knn

    import fusion4landslide_tpu_torch.ops.knn as tk

    if local:
        monkeypatch.setattr(tk, "_LOCAL_PAIRS", 0)
        monkeypatch.setattr(tk, "_LOCAL_BLOCK", 512)

    rng = np.random.default_rng(3)
    p = rng.uniform(-4, 4, size=(3000, 3)).astype(np.float32)
    p[1500:1800] = p[:300]  # exact duplicates: ties broken by index
    p[2000:2100] = p[100:200]
    mask = np.ones(3000, bool)
    mask[::97] = False
    for m in (None, mask):
        jd, ji = knn(jnp.asarray(p), jnp.asarray(p), k, None if m is None else jnp.asarray(m))
        td, ti = tknn(torch.from_numpy(p), torch.from_numpy(p), k,
                      None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_geometric_features_match_jax():
    from fusion4landslide_tpu.ops.superpoint import geometric_features

    p = _cloud(1, 2000)
    p = p - p.mean(0)
    mask = np.arange(len(p)) % 11 != 0
    for k, m in ((30, None), (20, mask)):
        jf = np.asarray(geometric_features(jnp.asarray(p), k, None if m is None else
                                           jnp.asarray(m)))
        tf = tsp.geometric_features(torch.from_numpy(p), k,
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tf.numpy(), jf, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(base_resolution=1.5, coarsening=3.0),
                                dict(base_resolution=None)])
def test_superpoint_hierarchy_matches_jax(kw):
    from fusion4landslide_tpu.ops.superpoint import superpoint_hierarchy

    pts = _cloud(0)
    jl = superpoint_hierarchy(pts, levels=3, **kw)
    tl = tsp.superpoint_hierarchy(pts, levels=3, device="cpu", **kw)
    assert _differing(tl[0], jl[0]) == 0
    for lv in (1, 2):
        assert _differing(tl[lv], jl[lv]) <= 0.02 * len(pts)
        assert abs(int(tl[lv].max()) - int(jl[lv].max())) <= 1
    counts = [int(lab.max()) + 1 for lab in tl]
    assert counts[0] > counts[1] > counts[2] >= 1


def test_partition_tables_interchange(tmp_path):
    from fusion4landslide_tpu.ops import partition_io as jio

    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 8, size=(400, 3)).astype(np.float32) + 1000.0
    levels = [rng.integers(0, 40, 400), rng.integers(0, 10, 400), rng.integers(0, 3, 400)]
    for write, read in ((tio.write_superpoint_partition, jio.read_superpoint_partition),
                        (jio.write_superpoint_partition, tio.read_superpoint_partition)):
        path = str(tmp_path / "partition_of_input_src_tile_0.txt")
        write(path, pts, levels)
        for lv in (1, 2, 3):
            rp, lab = read(path, lv)
            np.testing.assert_allclose(rp, pts, atol=1e-3)
            np.testing.assert_array_equal(lab, levels[lv - 1])
        with open(path) as f:
            port_or_jax = f.read()
        (tio.write_superpoint_partition if write is jio.write_superpoint_partition
         else jio.write_superpoint_partition)(path, pts, levels)
        with open(path) as f:
            assert f.read() == port_or_jax
    for write, read in ((tio.write_supervoxel_txt, jio.read_supervoxel_txt),
                        (jio.write_supervoxel_txt, tio.read_supervoxel_txt)):
        path = str(tmp_path / "sv.txt")
        write(path, pts, levels[0])
        rp, lab = read(path)
        np.testing.assert_array_equal(lab, levels[0])
    with pytest.raises(ValueError):
        tio.read_superpoint_partition(path, 3)


def test_load_or_generate_partition_labels_matches_jax(tmp_path):
    from fusion4landslide_tpu.ops import partition_io as jio

    pts = _cloud(2, 1500) + np.float32(500.0)
    with pytest.raises(ValueError, match="out of range"):
        tio.load_or_generate_partition_labels(str(tmp_path), "superpoint", 0, "src", pts, [0, 1])
    with pytest.raises(ValueError, match="out of range"):
        jio.load_or_generate_partition_labels(str(tmp_path), "superpoint", 0, "src", pts, [4])
    # Absent: each generates and writes the table; the other reads it back.
    timings = {}
    tl = tio.load_or_generate_partition_labels(str(tmp_path / "t"), "superpoint", 3, "tgt", pts,
                                               [1, 2, 3], device="cpu", timings=timings)
    assert set(timings) == {"superpoint_knn", "superpoint_features", "superpoint_vccs",
                            "superpoint_merge"}
    jl = jio.load_or_generate_partition_labels(str(tmp_path / "j"), "superpoint", 3, "tgt", pts,
                                               [1, 2, 3])
    assert _differing(tl[0], jl[0]) == 0
    for root, want in (("t", tl), ("j", jl)):
        path = tmp_path / root / "superpoint_partition" / "partition_of_input_tgt_tile_3.txt"
        assert os.path.exists(path)
        got_j = jio.load_or_generate_partition_labels(str(tmp_path / root), "superpoint", 3,
                                                      "tgt", pts, [3, 1])
        got_t = tio.load_or_generate_partition_labels(str(tmp_path / root), "superpoint", 3,
                                                      "tgt", pts, [3, 1])
        for a, b, w in zip(got_j, got_t, (want[2], want[0])):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)
