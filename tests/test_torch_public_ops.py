"""The port's remaining public functions against their JAX twins, on the
same numpy-seeded inputs: ``radius_neighbors``, ``segment_mean``,
``transformation_residuals``, ``rt_to_transform``,
``lrf_patches_from_samples``, ``filter_correspondences``,
``gather_superpoint_buckets``, ``aggregate_superpoints`` (at its new home,
``models.aggregation``) and ``supervoxel_segmentation_pair``, each
exported from ``ops`` / ``models`` as the JAX package exports it.

Tolerances: indices, masks and labels equal (partitions against JAX up to
relabelling, as in ``test_torch_ops.py``; the batched segmentation equal
to the per-cloud calls bit for bit); distances, residuals, means and
centroids 1e-5 absolute; LRF patches 1e-4 (the float32 LRF is
ill-conditioned at the 3e-5 level, ``test_torch_dips_branches.py``);
network outputs (filter scores, superpoint features) 1e-5 and the
filter's transforms 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

import fusion4landslide_tpu.models as jmodels
import fusion4landslide_tpu.ops as jops
import fusion4landslide_tpu_torch.models as tmodels
import fusion4landslide_tpu_torch.ops as tops
from fusion4landslide_tpu_torch.models.convert import filter_from_flax, state_dict_from_flax


def _t(a):
    return torch.from_numpy(np.array(a))


def _terrain(n, seed, extent=8.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = np.sin(xy[:, 0] * 0.7) * 0.6 + np.cos(xy[:, 1] * 0.4) + rng.normal(scale=0.02, size=n)
    return (np.column_stack([xy, z]) - [extent / 2, extent / 2, 0]).astype(np.float32)


def _rotations(rng, b):
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)


def test_public_names_mirror_jax():
    """Every public name of the JAX package's ``ops`` / ``models`` is the
    port's, but for the Flax-tree converters (the port loads torch
    checkpoints into torch modules) and ``ops.knn``, which stays the
    submodule in the port (``ops.knn.knn`` is the function)."""
    import types

    for jmod, tmod in ((jops, tops), (jmodels, tmodels)):
        missing = [n for n in jmod.__all__ if n not in tmod.__all__
                   and n not in ("torch_to_dips_params", "torch_to_filtering_params",
                                 "torch_to_aggregation_params", "knn")]
        assert not missing, missing
    assert isinstance(tops.knn, types.ModuleType) and callable(tops.knn.knn)
    from fusion4landslide_tpu_torch.pipelines import fusion

    assert fusion.aggregate_superpoints is tmodels.aggregate_superpoints


@pytest.mark.parametrize("own_cloud", [False, True])
def test_radius_neighbors_matches_jax(own_cloud):
    """Queries from another cloud, and the reference cloud itself (each
    query its own nearest neighbour at distance 0)."""
    pts = _terrain(1500, 0)
    q = pts if own_cloud else _terrain(400, 1)
    mask = np.ones(len(pts), bool)
    mask[::9] = False
    ji, jv, jd = jops.radius_neighbors(q, pts, 0.45, 24, jnp.asarray(mask))
    ti, tv, td = tops.radius_neighbors(_t(q), _t(pts), 0.45, 24, _t(mask))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert 0.2 < tv.double().mean() < 0.95  # the radius cuts rows short
    np.testing.assert_array_equal(np.asarray(ji)[np.asarray(jv)], ti.numpy()[tv.numpy()])
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-5)
    assert np.isinf(td.numpy()[~tv.numpy()]).all()


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(500, 4)).astype(np.float32)
    seg = rng.integers(0, 40, 500).astype(np.int32)
    seg[seg == 7] = 8  # one empty segment
    jm, jc = jops.segment_mean(jnp.asarray(vals), jnp.asarray(seg), 45)
    tm, tc = tops.segment_mean(_t(vals), _t(seg), 45)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_allclose(np.asarray(jm), tm.numpy(), atol=1e-5)
    assert (tm[7] == 0).all() and (tm[40:] == 0).all()


def test_residuals_and_transform_match_jax():
    rng = np.random.default_rng(3)
    R = _rotations(rng, 6).reshape(2, 3, 3, 3)
    t = rng.normal(size=(2, 3, 3)).astype(np.float32)
    x1 = rng.normal(size=(2, 3, 50, 3)).astype(np.float32)
    x2 = (x1 + rng.normal(scale=0.1, size=x1.shape)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jops.transformation_residuals(x1, x2, R, t)),
                               tops.transformation_residuals(_t(x1), _t(x2), _t(R), _t(t)).numpy(),
                               atol=1e-5)
    jT = np.asarray(jops.rt_to_transform(jnp.asarray(R), jnp.asarray(t)))
    tT = tops.rt_to_transform(_t(R), _t(t)).numpy()
    assert tT.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(jT, tT)


def test_lrf_patches_from_samples_matches_jax():
    from fusion4landslide_tpu.ops.lrf import lrf_patches_from_samples as jlrf
    from fusion4landslide_tpu_torch.ops.lrf import lrf_patches_from_samples as tlrf

    pts = _terrain(2000, 4)
    q = pts[::10]
    ti, tv, _ = tops.radius_neighbors(_t(q), _t(pts), 0.8, 64, exclude_self=True)
    idx, valid = ti.numpy(), tv.numpy()
    want = np.asarray(jlrf(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(idx),
                           jnp.asarray(valid), 0.8))
    got = tlrf(_t(q), _t(pts), _t(idx), _t(valid), 0.8).numpy()
    assert got.shape == (len(q), 64, 3) and np.abs(got).max() > 0.1
    np.testing.assert_allclose(want, got, atol=1e-4)


@pytest.mark.parametrize("rockfall, scrambled", [(False, False), (True, False), (False, True)])
def test_filter_correspondences_matches_jax(rockfall, scrambled):
    """A rigid motion with outliers (the robust re-fit), and scrambled
    targets (no robust estimate)."""
    from fusion4landslide_tpu.models.filtering import FilteringNetwork

    rng = np.random.default_rng(5)
    n = 96
    src = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    R = _rotations(rng, 1)[0]
    tgt = src @ R.T + [0.3, -0.1, 0.05]
    tgt[::4] += rng.normal(scale=0.8, size=tgt[::4].shape)  # outliers
    if scrambled:
        tgt = rng.permutation(tgt)
    corr = (np.hstack([src, tgt]) + [10.0, 5.0, 1.0] * 2).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-9:] = False
    # Two blocks keep JAX's compile short; the port counts them from the tree.
    net = FilteringNetwork(num_layers=2)
    params = jax.tree.map(np.asarray, net.init(
        jax.random.PRNGKey(2), np.zeros((8, 6), np.float32), np.ones(8, bool)))
    want = jmodels.filter_correspondences(params, jnp.asarray(corr), jnp.asarray(mask),
                                          rockfall=rockfall, model=net)
    with torch.no_grad():
        got = tmodels.filter_correspondences(filter_from_flax(params), _t(corr), _t(mask),
                                             rockfall=rockfall)
    assert set(got) == {"scores", "R", "t", "robust_estimate"}
    np.testing.assert_allclose(np.asarray(want["scores"]), got["scores"].numpy(), atol=1e-5)
    assert bool(want["robust_estimate"]) == bool(got["robust_estimate"]) == (not scrambled)
    np.testing.assert_allclose(np.asarray(want["R"]), got["R"].numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(want["t"]), got["t"].numpy(), atol=1e-4)


def test_superpoint_buckets_and_aggregation_match_jax():
    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet as JAgg
    from fusion4landslide_tpu_torch.models.aggregation import ClusterFeatureNet

    rng = np.random.default_rng(6)
    feats = rng.normal(size=(300, 64)).astype(np.float32)
    coords = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
    idx = rng.integers(0, 300, size=(10, 16)).astype(np.int32)
    mask = rng.random((10, 16)) > 0.3
    mask[4] = False  # an empty bucket
    jf, jc, jcent = jmodels.aggregation.gather_superpoint_buckets(feats, coords, idx, mask)
    tf, tc, tcent = tmodels.gather_superpoint_buckets(_t(feats), _t(coords), _t(idx), _t(mask))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_allclose(np.asarray(jcent), tcent.numpy(), atol=1e-5)

    ja = jax.tree.map(np.asarray, JAgg().init(jax.random.PRNGKey(1), feats[None, :8],
                                              np.ones((1, 8), bool)))
    agg = ClusterFeatureNet()
    agg.load_state_dict(state_dict_from_flax(ja))
    want_f, want_c = jmodels.aggregate_superpoints(ja, feats, coords, idx, mask)
    with torch.no_grad():
        got_f, got_c = tmodels.aggregate_superpoints(agg, _t(feats), _t(coords), _t(idx),
                                                     _t(mask), agg_max_points=16, s_chunk=4)
    live = mask.any(1)
    np.testing.assert_allclose(np.asarray(want_f)[live], got_f.numpy()[live], atol=1e-5)
    np.testing.assert_allclose(np.asarray(want_c), got_c.numpy(), atol=1e-5)


def test_supervoxel_segmentation_pair_equals_per_cloud_calls():
    """Two clouds of one shape, one with masked rows: the batched result
    is the per-cloud calls' bit for bit (every field), and the partitions
    equal JAX's ``supervoxel_segmentation_pair`` up to relabelling."""
    from fusion4landslide_tpu.ops.normals import pca_normals as jnormals
    from fusion4landslide_tpu.ops.supervoxel import (
        supervoxel_graph as jgraph,
        supervoxel_segmentation_pair as jpair,
    )
    from fusion4landslide_tpu_torch.ops.normals import pca_normals
    from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_graph

    n = 1200
    clouds = [_terrain(n, 7, extent=6.0), _terrain(n, 8, extent=6.0)]
    valids = [np.arange(n) < 1100, np.ones(n, bool)]
    res = np.float32(0.6)
    graphs, singles, jgraphs = [], [], []
    for p, v in zip(clouds, valids):
        gi, gm, _ = supervoxel_graph(_t(p), torch.tensor(res), _t(v), k_neighbors=15)
        nr = pca_normals(_t(p), _t(v), neigh_idx=gi, neigh_mask=gm)
        graphs.append((gi, gm, nr))
        singles.append(tops.supervoxel_segmentation(_t(p), torch.tensor(res), _t(v),
                                                    neigh_idx=gi, neigh_mask=gm, normals=nr))
        ji, jm = jgraph(jnp.asarray(p), res, jnp.asarray(v), k_neighbors=15)
        jgraphs.append((ji, jm, jnormals(jnp.asarray(p), 15, jnp.asarray(v), neigh_idx=ji,
                                         neigh_mask=jm)))
    pair = tops.supervoxel_segmentation_pair(
        _t(np.stack(clouds)), torch.tensor(res), _t(np.stack(valids)),
        *(torch.stack([g[i] for g in graphs]) for i in range(3)))
    for b, one in enumerate(singles):
        assert int(one.n_supervoxels) > 10
        for field in ("labels", "n_supervoxels", "seed_idx", "normals"):
            a, c = getattr(pair, field)[b], getattr(one, field)
            assert a.dtype == c.dtype and torch.equal(a, c), field
    jres = jpair(jnp.stack(clouds), res, jnp.stack(valids),
                 *(jnp.stack([g[i] for g in jgraphs]) for i in range(3)))
    for b, v in enumerate(valids):
        jl, tl = np.asarray(jres.labels[b]), pair.labels[b].numpy()
        assert int(jres.n_supervoxels[b]) == int(pair.n_supervoxels[b])
        pairs = set(zip(jl[v].tolist(), tl[v].tolist()))
        assert len(pairs) == len(set(jl[v].tolist())) == len(set(tl[v].tolist()))
        np.testing.assert_array_equal(jl[~v], tl[~v])
