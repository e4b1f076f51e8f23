"""The port's F2S3 pieces vs the JAX package: the FilteringNetwork, the
per-supervoxel filter, the device tile step and its runner.

The JAX step runs its TPU branch emulated on the CPU (Pallas kernels in
interpret mode); the port runs on the CPU with its kernels' plain
versions. Same numpy inputs and the same (bridged) weights on both sides.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models import dips as tdips
from fusion4landslide_tpu_torch.models.convert import filter_from_flax, state_dict_from_flax
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.synth import synth_split_tile

#: ``f2s3_brienz.yaml``-shaped statics, cut down for the CPU: patch 128,
#: chunk 512, member cap 256 (sv_cap = bucket(N / 16) as the runner derives).
STATICS = dict(
    patch_points=128,
    chunk=512,
    k_neighbors=30,
    sv_cap=256,
    member_cap=256,
    rockfall=False,
    refine_results=True,
    small_patch_removal=True,
    with_c2c=True,
)
MAX_DISP, VOXEL = 5.0, 0.1


def _flax_filter(seed=2, num_layers=12):
    from fusion4landslide_tpu.models.filtering import FilteringNetwork

    tree = FilteringNetwork(num_layers=num_layers).init(
        jax.random.PRNGKey(seed), np.zeros((2, 8, 6), np.float32), np.ones((2, 8), bool)
    )
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    from fusion4landslide_tpu.models.dips import PointNetFeature

    dips = PointNetFeature().init(jax.random.PRNGKey(0), np.zeros((2, 128, 3), np.float32))
    dips = jax.tree.map(np.asarray, dips)
    td = tdips.PointNetFeature()
    td.load_state_dict(state_dict_from_flax(dips))
    filt = _flax_filter()
    return dips, filt, td.eval(), filter_from_flax(filt)


@pytest.fixture(scope="module")
def tile():
    # Equal margins: both epochs hold the same points, the moving half
    # shifted. Random-init descriptors still match only ~15% of the static
    # points to themselves, so the filter keeps ~2% of the points.
    src, tgt, _, _ = synth_split_tile(1000, 1.5, 1.5, halo=2.0)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    return dict(src=src, tgt=tgt, n=n, m=m, sb=sb, tb=tb,
                sm=np.arange(N) < n, tm=np.arange(M) < m)


@pytest.fixture
def tpu_branch(monkeypatch):
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


def test_filtering_network_matches_flax():
    from fusion4landslide_tpu.models.filtering import FilteringNetwork

    tree = _flax_filter(seed=5, num_layers=4)
    net = filter_from_flax(tree)
    assert net.num_layers == 4
    rng = np.random.default_rng(0)
    corr = rng.normal(size=(5, 37, 6)).astype(np.float32)
    mask = np.arange(37)[None, :] < np.array([37, 20, 11, 0, 3])[:, None]
    want = np.asarray(FilteringNetwork(num_layers=4).apply(tree, corr, mask))
    with torch.inference_mode():
        got = net(torch.from_numpy(corr), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[~mask] == 0).all() and (got[mask] >= 0).all()


def _synthetic_buckets(seed, n_sv=40, S=256, P=128):
    """Correspondences in n_sv supervoxels: a rigid motion plus noise, with
    a per-supervoxel outlier share from 0 to 90% (outliers up to 3 m off),
    and the member table of their labels."""
    from fusion4landslide_tpu_torch.ops.segments import label_members

    rng = np.random.default_rng(seed)
    sizes = rng.integers(8, P + 20, size=n_sv)
    labels = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]).astype(np.int32)
    n = labels.size
    centres = rng.uniform(-3, 3, size=(n_sv, 3))
    src = centres[labels] + rng.normal(scale=0.4, size=(n, 3))
    ang = rng.uniform(-0.05, 0.05, size=3)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]]) @ np.array(
        [[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]]
    )
    tgt = src @ R.T + [0.05, -0.02, 0.01] + rng.normal(scale=0.005, size=(n, 3))
    outlier = rng.uniform(size=n) < np.linspace(0.0, 0.9, n_sv)[labels]
    tgt[outlier] += rng.uniform(-3, 3, size=(int(outlier.sum()), 3))
    corr = np.hstack([src, tgt]).astype(np.float32)
    mi, mm = label_members(torch.from_numpy(labels), S, P)
    return corr, labels, mi.numpy(), mm.numpy()


@pytest.mark.parametrize("rockfall", [False, True])
def test_filter_supervoxel_buckets_matches_jax(params, rockfall):
    """Scores within 1e-5 on >= 99.9% of the entries and within 2e-5 on
    all: two float32 evaluations of the 25-layer network (the port's, and
    Flax's at HIGHEST precision) differ by up to ~1.2e-5 from their matmul
    summation orders, while each is ~3e-5 from a float64 evaluation.
    Robust / keep equal (the data keeps every residual median and score
    off the decision thresholds, checked below); new targets within
    1e-5 m on member rows. S = 256 with 40 live supervoxels: the port
    skips the member-less chunks, and every output the step reads is
    unchanged."""
    from fusion4landslide_tpu.pipelines.f2s3 import filter_supervoxel_buckets as jfilter
    from fusion4landslide_tpu_torch.ops.kabsch import weighted_kabsch
    from fusion4landslide_tpu_torch.pipelines.f2s3 import filter_supervoxel_buckets

    _, filt, _, tfilt = params
    corr, _, mi, mm = _synthetic_buckets(1 + rockfall)
    j_new, j_keep, j_sc, j_rob = map(
        np.asarray, jfilter(filt, corr, mi, mm, num_layers=12, rockfall=rockfall)
    )
    t_new, t_keep, t_sc, t_rob = (
        x.numpy() for x in filter_supervoxel_buckets(
            tfilt, torch.from_numpy(corr), torch.from_numpy(mi), torch.from_numpy(mm),
            rockfall=rockfall,
        )
    )
    err = np.abs(t_sc - j_sc)
    assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 2e-5, err.max()
    live = mm.any(1)
    # Residual medians of the first fit, away from the 0.5 m threshold.
    c = torch.from_numpy(corr)[torch.from_numpy(mi[live]).long()]
    m = torch.from_numpy(mm[live])
    _, _, res, _ = weighted_kabsch(c[..., :3], c[..., 3:], torch.from_numpy(t_sc[live]), mask=m)
    med = np.array([np.sort(r[k])[(k.sum() - 1) // 2] for r, k in zip(res.numpy(), mm[live])])
    assert (np.abs(med - 0.5) > 1e-6).all()
    assert 0 < t_rob.sum() < live.sum()
    np.testing.assert_array_equal(t_rob, j_rob)
    near = np.abs(t_sc - 0.99999) <= 2e-5
    np.testing.assert_array_equal(t_keep[~near], j_keep[~near])
    np.testing.assert_allclose(t_new[mm], j_new[mm], atol=1e-5)
    assert not t_keep[~mm].any() and (t_sc[~mm] == 0).all() and not t_rob[~live].any()


def _jax_step(tile, dips, filt, **kw):
    from fusion4landslide_tpu.pipelines.f2s3_device import f2s3_tile_step

    out = f2s3_tile_step(
        dips, filt, tile["sb"], tile["sm"], tile["tb"], tile["tm"], jax.random.PRNGKey(0),
        MAX_DISP, VOXEL, num_layers=12, **kw,
    )
    return jax.tree.map(np.asarray, out)


def _port_step(tile, td, tf, **kw):
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step

    return f2s3_tile_step(
        td, tf, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
        torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), MAX_DISP, VOXEL,
        device="cpu", **kw,
    )


def _near_tie_rows(td, tile, radius, gap=5e-5):
    """Source rows whose two nearest target descriptors (port features)
    lie within ``gap`` in descriptor distance: the two sides' float32
    PointNets give descriptors up to ~5e-5 apart (L2, unit-norm
    descriptors), which can swap such a pair."""
    from fusion4landslide_tpu_torch.ops.knn import knn
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import dips_features_device

    s, t = torch.from_numpy(tile["sb"]), torch.from_numpy(tile["tb"])
    sm, tm = torch.from_numpy(tile["sm"]), torch.from_numpy(tile["tm"])
    kw = dict(patch_points=STATICS["patch_points"], chunk=STATICS["chunk"])
    fs, _ = dips_features_device(td, s, s, sm, radius, query_count=tile["n"], **kw)
    ft, _ = dips_features_device(td, t, t, tm, radius, query_count=tile["m"], **kw)
    d, _ = knn(fs, ft, 2, tm)
    return (torch.sqrt(d[:, 1]) - torch.sqrt(d[:, 0]) <= gap).numpy()


@pytest.fixture(scope="module")
def port_out(tile, params):
    _, _, td, tf = params
    return _port_step(tile, td, tf, **STATICS)


def test_f2s3_tile_step_matches_emulated_jax(tile, params, port_out, tpu_branch):
    dips, filt, td, _ = params
    jo = _jax_step(tile, dips, filt, **STATICS)
    to = port_out
    n = tile["n"]

    assert abs(float(jo.median_res) - float(to.median_res)) <= 1e-6 * float(jo.median_res)
    assert to.overflow == 0
    np.testing.assert_array_equal(jo.labels, to.labels.numpy())
    assert int(jo.n_dropped) == int(to.n_dropped)
    radius = torch.sqrt(torch.tensor(3.0)) * 10.0 * to.median_res
    tie = _near_tie_rows(td, tile, radius)[:n]
    nn_same = (jo.nn_tgt[:n] == to.nn_tgt[:n].numpy()).all(1)
    assert (nn_same | tie).all(), int((~nn_same & ~tie).sum())
    assert tie.mean() < 0.03
    # A swapped near-tie match changes the context-normalised scores of its
    # whole supervoxel: keep and new targets are compared on the points
    # whose supervoxel saw the same correspondences on both sides.
    lab = to.labels[:n].numpy()
    same = ~np.isin(lab, lab[~nn_same & (lab >= 0)])
    assert same.mean() > 0.9
    kj, kt = jo.keep[:n] & same, to.keep[:n].numpy() & same
    assert kj.sum() > 0.01 * n
    assert (kj & kt).sum() >= 0.99 * max(kj.sum(), kt.sum())
    both = kj & kt
    gap = np.linalg.norm(jo.new_tgt[:n][both] - to.new_tgt[:n].numpy()[both], axis=1)
    assert np.median(gap) < 1e-4
    assert (gap > 0.01).mean() <= 0.01
    # C2C distances within 1e-5 m except where kernel 2's uncentred score
    # (|r|^2 - 2 q.r + |q|^2, rounded at the ulp of |r|^2: up to 3.8e-6
    # m^2 for the ~50 m^2 corners of this tile) sits near 0: an exact
    # duplicate across the epochs reads 0 on one side and
    # sqrt(2.4e-7) = 4.9e-4 m on the other. Squared distances agree within
    # two such ulps everywhere.
    cj, ct = jo.c2c[:n].astype(np.float64), to.c2c[:n].numpy().astype(np.float64)
    assert (np.abs(cj - ct) <= 1e-5).mean() >= 0.995
    np.testing.assert_allclose(cj**2, ct**2, atol=8e-6)


def test_unported_f2s3_options_raise(tile, params):
    """bf16 descriptors and patch sizes off the multiples of 128 are
    ported: they run (``test_torch_dips_branches.py`` and
    ``test_torch_dips_bf16.py`` hold them to JAX). A descriptor dtype the
    port has no trunk for still raises."""
    _, _, td, tf = params
    n = tile["n"]
    out = _port_step(tile, td, tf, **{**STATICS, "feat_dtype": "bfloat16", "patch_points": 64})
    assert out.keep[:n].any() and torch.isfinite(out.new_tgt[:n]).all()
    with pytest.raises(ValueError, match="feat_dtype"):
        _port_step(tile, td, tf, **{**STATICS, "feat_dtype": "float16"})
