"""Ops and models of the PyTorch port vs the JAX package, same numpy inputs.

Where the JAX function reaches a Pallas kernel, it runs the TPU branch
emulated on the CPU (``pallas_available`` patched, kernels in interpret
mode) — the branch the port follows. Float tolerances are relative to the
coordinate scale (a few metres); discrete outputs must match exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models import aggregation as tagg
from fusion4landslide_tpu_torch.models import dips as tdips
from fusion4landslide_tpu_torch.models.convert import params_from_flax, seeded_models


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def tpu_branch(monkeypatch):
    """The JAX package's TPU branch on the CPU: Pallas kernels in
    interpret mode; traces cached by other tests are dropped first."""
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    monkeypatch.setattr(knn_pallas, "pallas_available", lambda: True)
    for mod, name in (
        (hashgrid_pallas, "radius_sample_window"),
        (hashgrid_pallas, "hash_grid_knn_window"),
        (knn_pallas, "knn_pallas"),
    ):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    yield
    jax.clear_caches()


def _terrain(n, seed, extent=8.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = np.sin(xy[:, 0] * 0.7) * 0.6 + np.cos(xy[:, 1] * 0.4) + rng.normal(scale=0.02, size=n)
    return (np.column_stack([xy, z]) - [extent / 2, extent / 2, 0]).astype(np.float32)


def test_bucket_size_ladder():
    from fusion4landslide_tpu.ops.segments import bucket_size as jb
    from fusion4landslide_tpu_torch.ops.segments import bucket_size as tb

    for n in [1, 64, 65, 8192, 8193, 32769, 40000, 300000, 489362, 524289, 1_250_000]:
        assert jb(n) == tb(n)


def test_label_members_and_compaction():
    from fusion4landslide_tpu.ops.segments import label_counts as jlc
    from fusion4landslide_tpu.ops.segments import label_members as jlm
    from fusion4landslide_tpu.pipelines.f2s3_device import drop_small_and_compact as jdrop
    from fusion4landslide_tpu_torch.ops.segments import label_counts as tlc
    from fusion4landslide_tpu_torch.ops.segments import label_members as tlm
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import drop_small_and_compact as tdrop

    rng = np.random.default_rng(0)
    labels = rng.integers(-1, 40, size=900).astype(np.int32)
    valid = rng.random(900) > 0.1
    jl, jn = jdrop(labels, valid, 12)
    tl, tn = tdrop(_t(labels), _t(valid), 12)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert int(jn) == int(tn)
    np.testing.assert_array_equal(np.asarray(jlc(np.asarray(jl), 40)), tlc(tl, 40).numpy())
    ji, jm = jlm(np.asarray(jl), 32, 24)
    ti, tm = tlm(tl, 32, 24)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def test_voxel_downsample_matches_jax():
    from fusion4landslide_tpu.ops.voxel import voxel_downsample as jvd
    from fusion4landslide_tpu_torch.ops.voxel import voxel_downsample as tvd

    pts = _terrain(5000, 1)
    mask = np.ones(5000, bool)
    mask[::9] = False
    origin = pts.min(0) - np.float32(0.013)
    for org in (None, origin):
        jc, jp, jn_, jv = jvd(pts, 0.07, mask, origin=org)
        tc, tp, tn_, tv = tvd(_t(pts), 0.07, _t(mask), origin=None if org is None else _t(org))
        assert int(jv) == int(tv)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jn_), tn_.numpy())
        np.testing.assert_allclose(np.asarray(jc), tc.numpy(), atol=1e-5)


def test_supervoxel_graph_kernel_branch_matches_jax(tpu_branch):
    """n ~ 10 000 (bucket 16384): the radius-sampler branch."""
    from fusion4landslide_tpu.ops.supervoxel import supervoxel_graph as jgraph
    from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_graph as tgraph

    pts = _terrain(10000, 2, extent=10.0)
    valid = np.ones(10000, bool)
    valid[-300:] = False
    res = np.float32(0.35)
    ji, jm = jgraph(jnp.asarray(pts), res, jnp.asarray(valid), k_neighbors=15)
    ti, tm, t_ov = tgraph(_t(pts), torch.tensor(res), _t(valid), k_neighbors=15)
    assert int(t_ov) == 0
    ji, jm = np.asarray(ji), np.asarray(jm)
    assert jm.mean() > 0.5
    # Rows agree exactly except at radius / tie borderlines.
    rows_equal = (ji == ti.numpy()).all(1) & (jm == tm.numpy()).all(1)
    assert rows_equal.mean() >= 0.999, rows_equal.mean()


def test_supervoxel_graph_brute_branch_and_segmentation_match_jax():
    from fusion4landslide_tpu.ops.normals import pca_normals as jnormals
    from fusion4landslide_tpu.ops.supervoxel import (
        supervoxel_graph as jgraph,
        supervoxel_segmentation as jseg,
    )
    from fusion4landslide_tpu_torch.ops.normals import pca_normals as tnormals
    from fusion4landslide_tpu_torch.ops.supervoxel import (
        supervoxel_graph as tgraph,
        supervoxel_segmentation as tseg,
    )

    pts = _terrain(3000, 3)
    valid = np.ones(3000, bool)
    valid[::17] = False
    res = np.float32(0.6)
    ji, jm = jgraph(jnp.asarray(pts), res, jnp.asarray(valid), k_neighbors=15)
    ti, tm, _ = tgraph(_t(pts), torch.tensor(res), _t(valid), k_neighbors=15)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    jn = np.asarray(jnormals(pts, 15, valid, neigh_idx=ji, neigh_mask=jm))
    tn = tnormals(_t(pts), _t(valid), neigh_idx=ti, neigh_mask=tm).numpy()
    np.testing.assert_allclose(np.abs((jn * tn).sum(1))[valid], 1.0, atol=1e-5)
    js = jseg(pts, res, valid, neigh_idx=ji, neigh_mask=jm, normals=jn)
    ts = tseg(_t(pts), torch.tensor(res), _t(valid), neigh_idx=ti, neigh_mask=tm,
              normals=_t(jn))
    jl, tl = np.asarray(js.labels), ts.labels.numpy()
    assert int(js.n_supervoxels) == int(ts.n_supervoxels) > 5
    # Partitions equal up to relabelling.
    pairs = set(zip(jl[valid].tolist(), tl[valid].tolist()))
    assert len(pairs) == len(set(jl[valid].tolist())) == len(set(tl[valid].tolist()))
    np.testing.assert_array_equal(jl[~valid], tl[~valid])


def test_gated_feature_nn1_matches_jax():
    from fusion4landslide_tpu.ops.gated_match import gated_feature_nn1 as jg
    from fusion4landslide_tpu_torch.ops.gated_match import gated_feature_nn1 as tg

    rng = np.random.default_rng(4)
    qx, rx = _terrain(2500, 5, extent=30.0), _terrain(3000, 6, extent=30.0)
    qf = rng.normal(size=(2500, 64)).astype(np.float32)
    rf = rng.normal(size=(3000, 64)).astype(np.float32)
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    rf /= np.linalg.norm(rf, axis=1, keepdims=True)
    qv = rng.random(2500) > 0.05
    rv = rng.random(3000) > 0.05
    kw = dict(query_block=512, chunk=1024)
    jd, ji, jv = jg(qf, rf, qx, rx, 4.0, qv, rv, **kw)
    td, ti, tv = tg(_t(qf), _t(rf), _t(qx), _t(rx), 4.0, _t(qv), _t(rv), **kw)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-5)


def test_weighted_kabsch_and_icp_match_jax():
    from fusion4landslide_tpu.ops.icp import icp_point2point as jicp
    from fusion4landslide_tpu.ops.kabsch import weighted_kabsch as jk
    from fusion4landslide_tpu_torch.ops.icp import icp_point2point as ticp
    from fusion4landslide_tpu_torch.ops.kabsch import weighted_kabsch as tk

    rng = np.random.default_rng(7)
    B, n = 6, 64
    x1 = rng.uniform(-1, 1, size=(B, n, 3)).astype(np.float32)
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    x2 = (x1 @ R.T + np.float32(0.03) + rng.normal(scale=1e-3, size=x1.shape)).astype(np.float32)
    w = (rng.random((B, n)) > 0.2).astype(np.float32)
    w[-1] = 0.0  # degenerate: identity, invalid
    jR, jt, _, jv = jax.vmap(jk)(x1, x2, w)
    tR, tt, _, tv = tk(_t(x1), _t(x2), _t(w))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(np.asarray(jR), tR.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)

    mask = w > 0
    tgt = x2[:, rng.permutation(n)]
    jres = jax.vmap(lambda s, t, m: jicp(s, t, 0.2, m, m, max_iter=15))(x1, tgt, mask)
    tres = ticp(_t(x1), _t(tgt), 0.2, _t(mask), _t(mask), max_iter=15)
    np.testing.assert_allclose(np.asarray(jres.R), tres.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jres.t), tres.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jres.inlier_rmse), tres.inlier_rmse.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jres.n_inliers), tres.n_inliers.numpy())


def test_pointnet_and_cluster_net_match_flax():
    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet as JAgg
    from fusion4landslide_tpu.models.dips import PointNetFeature as JDips

    rng = np.random.default_rng(8)
    patches = rng.normal(scale=0.3, size=(5, 128, 3)).astype(np.float32)
    jp = JDips().init(jax.random.PRNGKey(0), patches[:2])
    # Non-trivial BatchNorm statistics, so the bridge maps every field.
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * np.float32(len(str(path)) % 7) if "mean" in str(path) else a,
        _np(jp),
    )
    feats = rng.normal(size=(4, 12, 64)).astype(np.float32)
    fmask = rng.random((4, 12)) > 0.3
    fmask[2] = False  # an empty bucket
    ja = _np(JAgg().init(jax.random.PRNGKey(1), feats, fmask))
    sd_d, sd_a = params_from_flax(jp, ja)
    td, ta = tdips.PointNetFeature(), tagg.ClusterFeatureNet()
    td.load_state_dict(sd_d)
    ta.load_state_dict(sd_a)
    with torch.no_grad():
        np.testing.assert_allclose(
            np.asarray(JDips().apply(jp, patches)), td(_t(patches)).numpy(), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(JAgg().apply(ja, feats, fmask)), ta(_t(feats), _t(fmask)).numpy(),
            atol=1e-5,
        )


def test_seeded_models_are_reproducible():
    a, _ = seeded_models(3, "cpu")
    b, _ = seeded_models(3, "cpu")
    c, _ = seeded_models(4, "cpu")
    x = torch.randn(2, 128, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))
        assert not torch.equal(a(x), c(x))


def test_dips_features_match_jax(tpu_branch):
    """compute_dips_features: one sort + block ranges (port) vs the whole
    cloud sampler + chunked network (JAX), rows below n_core."""
    from fusion4landslide_tpu.models.dips import PointNetFeature as JDips
    from fusion4landslide_tpu.pipelines.f2s3_device import dips_features_device as jdf
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import dips_features_device as tdf

    sup = _terrain(3000, 9, extent=6.0)
    smask = np.ones(3000, bool)
    smask[-100:] = False
    query = np.concatenate([sup[:1200:2], np.zeros((424, 3), np.float32)])
    n_core = 600
    jp = _np(JDips().init(jax.random.PRNGKey(2), np.zeros((2, 128, 3), np.float32)))
    radius = np.float32(0.5)
    jf = np.asarray(jdf(jp, query, sup, smask, radius, jax.random.PRNGKey(0),
                        patch_points=128, chunk=256, query_count=n_core))
    td = tdips.PointNetFeature()
    td.load_state_dict(params_from_flax(jp, {"params": {}})[0])
    tf, t_ov = tdf(td.eval(), _t(query), _t(sup), _t(smask), torch.tensor(radius),
                   patch_points=128, chunk=256, query_count=n_core)
    tf = tf.numpy()
    assert int(t_ov) == 0
    err = np.abs(jf[:n_core] - tf[:n_core]).max(1)
    assert (err < 1e-4).mean() >= 0.99, (err >= 1e-4).sum()
    np.testing.assert_array_equal(tf[n_core:], 0.0)


def test_metrics_match_jax():
    """``utils/metrics.py`` on tensors against the JAX functions, within
    1e-6: the inlier ratio with and without a mask, the median DVF error
    for odd and even row counts (the mean of the two middle values)."""
    from fusion4landslide_tpu.ops.kabsch import weighted_kabsch as jkabsch
    from fusion4landslide_tpu.utils import metrics as jm
    from fusion4landslide_tpu_torch.utils import metrics as tm

    rng = np.random.default_rng(5)
    src = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    tgt = (src + [0.2, -0.1, 0.05] + rng.normal(0, 0.08, (500, 3))).astype(np.float32)
    R, t, _, _ = jkabsch(jnp.asarray(src), jnp.asarray(tgt))
    R, t = np.asarray(R), np.asarray(t)
    mask = rng.random(500) < 0.7
    for thr in (0.05, 0.1, 0.2):
        for m in (None, mask):
            j = jm.compute_inlier_ratio(jnp.asarray(src), jnp.asarray(tgt), R, t, thr,
                                        None if m is None else jnp.asarray(m))
            p = tm.compute_inlier_ratio(_t(src), _t(tgt), _t(R), _t(t), thr,
                                        None if m is None else _t(m))
            assert abs(float(j) - float(p)) <= 1e-6 and 0 < float(p) < 1
    for n in (499, 500):
        a = np.hstack([src[:n], tgt[:n]])
        b = a + np.hstack([np.zeros((n, 3)), rng.normal(0, 0.01, (n, 3))]).astype(np.float32)
        j = jm.median_displacement_error(jnp.asarray(a), jnp.asarray(b))
        p = tm.median_displacement_error(_t(a), _t(b))
        assert abs(float(j) - float(p)) <= 1e-6 and float(p) > 0


def test_nested_levels_false_segments_each_level_afresh(monkeypatch):
    """``fusion3d_tile_step(nested_levels=False)`` segments both voxel
    clouds afresh at each level's radius (base radius x 2^(level - 1)) on
    the first level's graph and normals, as JAX ``fusion_device.py:776``
    does; each level's partition equals JAX's ``supervoxel_segmentation``
    on the same inputs up to relabelling. Nested (the default) segments
    the voxel clouds at the first level only, then the centroids."""
    from fusion4landslide_tpu.ops.supervoxel import supervoxel_segmentation as jseg
    from fusion4landslide_tpu_torch.pipelines import fusion_device as fd
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.synth import synth_split_tile

    src, tgt, _, _ = synth_split_tile(600, 1.0, 1.0, halo=2.0)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - src.mean(0)
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - src.mean(0)
    td, ta = seeded_models(0, "cpu")
    calls = []
    real = fd.supervoxel_segmentation

    def spy(points, resolution, mask=None, **kw):
        out = real(points, resolution, mask, **kw)
        calls.append((points, resolution, mask, kw, out.labels))
        return out

    monkeypatch.setattr(fd, "supervoxel_segmentation", spy)
    kw = dict(levels=(1, 2, 3), patch_points=128, chunk=512, k_neighbors=8, sv_cap=256,
              member_cap=128, agg_max_points=64, small_patch=3, icp_max_iter=4,
              fine_max_matches=64, device="cpu")
    args = (td, ta, _t(sb), _t(np.arange(N) < n), _t(tb), _t(np.arange(M) < m), 5.0, 0.1, 0.1)
    out = fd.fusion3d_tile_step(*args, nested_levels=False, **kw)
    assert len(calls) == 6 and torch.isfinite(out.moved).all()
    base = float(calls[0][1])
    for i, (points, res, mask, skw, labels) in enumerate(calls):
        assert float(res) == pytest.approx(base * 2.0 ** (i // 2), rel=1e-6)
        js = jseg(points.numpy(), res.numpy(), mask.numpy(),
                  **{k: v.numpy() for k, v in skw.items()})
        jl, tl, v = np.asarray(js.labels), labels.numpy(), mask.numpy()
        pairs = set(zip(jl[v].tolist(), tl[v].tolist()))
        assert len(pairs) == len(set(jl[v].tolist())) == len(set(tl[v].tolist()))
        np.testing.assert_array_equal(jl[~v], tl[~v])
    counts = [int(c[4].max()) + 1 for c in calls[0::2]]  # source segments per level
    assert counts[0] > counts[1] >= counts[2] >= 1
    assert all(c[0].shape[0] == (N if i % 2 == 0 else M) and "normals" in c[3]
               for i, c in enumerate(calls))
    # Nested: levels 2 and 3 segment the level below's centroids.
    calls.clear()
    fd.fusion3d_tile_step(*args, **kw)
    assert len(calls) == 6 and all(c[0].shape[0] < N and "normals" not in c[3]
                                   for c in calls[2:])


def _txt_table(case: str) -> tuple[np.ndarray, str]:
    rng = np.random.default_rng(3)
    if case == "dvfs":
        return rng.normal(size=(1000, 6)) * 100.0, "%.6f"
    if case == "float32":
        return (rng.normal(size=(500, 4)) * 50.0).astype(np.float32), "%.6f"
    if case == "special":
        t = rng.normal(size=(40, 4))
        t[0] = [-0.0, np.nan, np.inf, -np.inf]
        t[1] = [1e20, -1e-9, 5e-7, -5e-7]
        return t, "%.6f"
    if case == "one_d":
        return rng.normal(size=300), "%.6f"
    if case == "empty":
        return np.zeros((0, 4)), "%.6f"
    # The partition tables' row format: float coordinates, integer colours
    # and labels in one float array.
    cols = [rng.normal(size=(200, 3)) * 30.0, rng.integers(0, 256, size=(200, 3)),
            rng.integers(-1, 40, size=(200, 1))]
    return np.column_stack(cols), "%.6f %.6f %.6f %d %d %d %d"


@pytest.mark.parametrize("case", ["dvfs", "float32", "special", "one_d", "empty", "row_fmt"])
@pytest.mark.parametrize("rows", [1 << 16, 7])
def test_save_txt_writes_the_bytes_of_np_savetxt(tmp_path, monkeypatch, case, rows):
    """The table writer formats blocks of ``rows`` rows at a time and
    writes the bytes ``np.savetxt`` writes (the JAX package's writer)."""
    from fusion4landslide_tpu.io.results import save_txt as jax_save_txt
    from fusion4landslide_tpu_torch.io import results

    monkeypatch.setattr(results, "_TXT_ROWS", rows)
    table, fmt = _txt_table(case)
    results.save_txt(str(tmp_path / "port.txt"), table, fmt=fmt)
    jax_save_txt(str(tmp_path / "jax.txt"), table, fmt=fmt)
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert len(got) > 0 or case == "empty"
