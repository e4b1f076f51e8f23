"""The port's DIPs grid branches vs the JAX package: the traced sampler
``radius_sample_grid``, the gather join beyond kernel 2's k <= 32, the LRF
patches from a kNN table, ``dips_features_device`` 'knn' / 'random' and
``compute_dips_features`` at a patch size that is not a multiple of 128,
and the tile steps and the host fusion tile that run them.

The JAX package draws the branches' randomness with ``jax.random``; the
tests draw it there and hand the draws to the port (``DipsDraws``). Whole
steps run the JAX step's TPU branch emulated on the CPU (Pallas kernels in
interpret mode), as the other step tests do: at patch 96 the DIPs stage
takes its grid branch there as on a TPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.ops import hashgrid as thg
from fusion4landslide_tpu_torch.ops.hashgrid_cuda import hash_priority
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.pipelines.f2s3 import DipsDraws
from fusion4landslide_tpu_torch.synth import synth_split_tile

#: Descriptor tolerance. The patches differ where the float32 LRF is
#: ill-conditioned (``test_lrf_float32_gap_is_conditioning``: a weakly
#: weighted in-plane axis), and the descriptors with them: measured up to
#: 2.2e-5 apart. Held to 1e-4 on every row and to 1e-5 on >= 99% of them.
FEAT_ATOL, FEAT_ROW_ATOL = 1e-4, 1e-5


def assert_descriptors_close(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want).max(axis=1)
    print(f"descriptors: max {err.max():.3g}, rows within {FEAT_ROW_ATOL}: "
          f"{(err <= FEAT_ROW_ATOL).mean():.4f}")
    assert err.max() <= FEAT_ATOL, err.max()
    assert (err <= FEAT_ROW_ATOL).mean() >= 0.99, np.sort(err)[-10:]


def _surface(n: int, side: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, side, size=(n, 2))
    z = 0.3 * np.sin(xy[:, 0] / 2.0) + 0.02 * rng.normal(size=n)
    return np.column_stack([xy, z]).astype(np.float32)


def _hash_tie_cloud(seed: int = 5):
    """A sparse surface in which two points whose 24-bit hash priorities
    are equal sit 1 cm apart, with a query beside them: every query keeps
    all its in-radius points (fewer than the patch), so the two tied
    priorities decide the order of the output rows."""
    pts = _surface(12000, 60.0, 0)
    pri = hash_priority(torch.arange(len(pts)), seed).numpy()
    vals, first, counts = np.unique(pri, return_index=True, return_counts=True)
    assert (counts > 1).any()
    i = int(first[np.argmax(counts > 1)])
    j = int(np.where(pri == pri[i])[0][1])
    pts[j] = pts[i] + np.float32([0.01, 0.0, 0.0])
    query = np.concatenate([pts[::7], pts[i:i + 1] + np.float32([0.004, 0.003, 0.0])])
    return pts, query, (i, j)


@pytest.mark.parametrize("priority", ["random", "distance"])
def test_radius_sample_grid_rows_equal_jax(priority):
    """Rows equal to JAX's, coordinates bit for bit, on the same grid and
    seed. 'random': a cloud with a planted hash-priority tie inside a
    query's ball. 'distance': every point twice, so every kept squared
    distance ties with its duplicate's."""
    from fusion4landslide_tpu.ops import hashgrid as jhg

    seed, r = 5, 0.6
    if priority == "random":
        pts, query, (i, j) = _hash_tie_cloud(seed)
    else:
        base = _surface(3000, 12.0, 1)
        pts = np.concatenate([base, base])
        query = base[::5] + np.float32([0.01, -0.01, 0.0])
    jgrid = jhg.build_hash_grid(jnp.asarray(pts), r)
    kw = dict(num_samples=96, cap=48 if priority == "random" else 12, query_block=128,
              priority=priority)
    jc, jv = map(np.asarray, jhg.radius_sample_grid(jnp.asarray(query), jgrid, r, seed, **kw))
    tgrid = thg.build_hash_grid(torch.from_numpy(pts), r)
    tc, tv, ov = thg.radius_sample_grid(torch.from_numpy(query), tgrid, r, seed, **kw)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert jv.any(1).mean() > 0.9
    if priority == "random":
        assert int(ov) == 0 and jv.sum(1).max() < 96
        last = tc[-1].numpy()
        assert {tuple(pts[i]), tuple(pts[j])} <= {tuple(p) for p in last[tv[-1].numpy()]}
    else:
        assert int(ov) > 0  # the doubled runs exceed the cap: truncated alike


@pytest.fixture(scope="module")
def dense():
    """A surface at 200 points / m^2: ~630 points within 1 m."""
    pts = _surface(20000, 10.0, 2)
    return pts, pts[::10] + np.float32([0.003, -0.002, 0.0])


@pytest.mark.parametrize("k", [64, 512])
def test_grid_knn_beyond_kernel_matches_jax(dense, k):
    """``hash_grid_knn`` (k > 32: the gather join) and ``knn_grid_traced``
    equal JAX's: indices equal, squared distances within 1e-6 (equal
    +inf slots)."""
    from fusion4landslide_tpu.ops import hashgrid as jhg

    pts, query = dense
    r = 0.8
    jgrid = jhg.build_hash_grid(jnp.asarray(pts), r)
    jd, ji, jov = map(np.asarray, jhg.hash_grid_knn(jnp.asarray(query), jgrid, r, k, cap=64,
                                                    query_block=512, use_pallas=False))
    tgrid = thg.build_hash_grid(torch.from_numpy(pts), r)
    td, ti, tov = thg.hash_grid_knn(torch.from_numpy(query), tgrid, r, k, cap=64,
                                    query_block=512)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6)
    assert int(tov) == int(jov) > 0
    assert np.isfinite(jd).sum(1).min() >= 50
    jd2, ji2 = map(np.asarray, jhg.knn_grid_traced(jnp.asarray(query), jnp.asarray(pts), k,
                                                   r_max=1.2, cap=48))
    td2, ti2, _ = thg.knn_grid_traced(torch.from_numpy(query), torch.from_numpy(pts), k,
                                      r_max=1.2, cap=48)
    np.testing.assert_array_equal(ti2.numpy(), ji2)
    np.testing.assert_allclose(td2.numpy(), jd2, atol=1e-6)
    assert np.isfinite(jd2).sum(1).mean() > min(0.5 * k, 100)


def test_lrf_patches_from_knn_match_jax(dense):
    """``extract_lrf_patches`` and ``lrf_patches_from_knn`` fed JAX's
    ``jax.random.uniform`` priorities: patches within 1e-5 (the selected
    subsets equal)."""
    from fusion4landslide_tpu.ops import lrf as jlrf
    from fusion4landslide_tpu.ops.knn import knn as jknn
    from fusion4landslide_tpu_torch.ops import lrf as tlrf

    pts, query = dense
    q, r = query[:300], 0.9
    mask = np.arange(len(pts)) % 11 != 0
    key = jax.random.PRNGKey(3)
    pri = np.array(jax.random.uniform(key, (len(q), 128)))
    jp = np.asarray(jlrf.extract_lrf_patches(jnp.asarray(q), jnp.asarray(pts), r, key, k_max=128,
                                             num_points=96, support_mask=jnp.asarray(mask)))
    tp = tlrf.extract_lrf_patches(torch.from_numpy(q), torch.from_numpy(pts), r,
                                  torch.from_numpy(pri), k_max=128, num_points=96,
                                  support_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(tp == 0, jp == 0)
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    # From one table (JAX's), the whole ball kept (r beyond the 128th).
    sqd, idx = map(np.array, jknn(jnp.asarray(q), jnp.asarray(pts), 128))
    jp = np.asarray(jlrf.lrf_patches_from_knn(jnp.asarray(q), jnp.asarray(pts), sqd, idx, 2.0,
                                              key, num_points=96))
    tp = tlrf.lrf_patches_from_knn(torch.from_numpy(q), torch.from_numpy(pts),
                                   torch.from_numpy(sqd), torch.from_numpy(idx), 2.0,
                                   torch.from_numpy(pri), num_points=96).numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    assert (np.abs(tp).sum(-1) > 0).all()


@pytest.fixture(scope="module")
def models():
    from fusion4landslide_tpu.models.dips import PointNetFeature
    from fusion4landslide_tpu_torch.models import dips as tdips
    from fusion4landslide_tpu_torch.models.convert import state_dict_from_flax

    params = PointNetFeature().init(jax.random.PRNGKey(0), np.zeros((2, 96, 3), np.float32))
    params = jax.tree.map(np.asarray, params)
    td = tdips.PointNetFeature()
    td.load_state_dict(state_dict_from_flax(params))
    return params, td.eval()


def jax_draws(key, priority: str, n: int, m: int, chunk: int, k_max: int) -> DipsDraws:
    """The JAX DIPs branches' draws from ``key`` as the port's input:
    'knn' one ``uniform(key_c, (chunk, k_max))`` per chunk of
    ``split(key, n_chunks)``; 'random' ``split(key)`` into the support
    permutation and the sampler seed."""
    if priority == "knn":
        keys = jax.random.split(key, -(-n // chunk))
        pri = np.concatenate([np.array(jax.random.uniform(k, (chunk, k_max))) for k in keys])
        return DipsDraws(priorities=torch.from_numpy(pri))
    k_perm, k_seed = jax.random.split(key)
    perm = np.array(jax.random.permutation(k_perm, m))
    seed = jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max).astype(jnp.uint32)
    return DipsDraws(perm=torch.from_numpy(perm), seed=int(seed))


@pytest.fixture(scope="module")
def small_tile():
    src, _, _, _ = synth_split_tile(600, 1.0, 1.5, halo=1.5)
    c = src.mean(0)
    n = len(src)
    N = bucket_size(n)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    return sb, np.arange(N) < n, n


@pytest.mark.parametrize("priority", ["knn", "random"])
def test_dips_features_device_grid_branches_match_jax(models, small_tile, priority):
    """Patch 96 on a padded cloud: descriptors held to JAX's
    (``assert_descriptors_close``), given JAX's draws; rows past
    ``query_count`` zero on both."""
    from fusion4landslide_tpu.pipelines.f2s3_device import dips_features_device as jdips
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import dips_features_device

    params, td = models
    sb, sm, n = small_tile
    radius = np.float32(0.9)
    kw = dict(k_max=256, patch_points=96, chunk=256, sample_cap=48, sample_priority=priority)
    key = jax.random.PRNGKey(7)
    jf = np.asarray(jdips(params, jnp.asarray(sb), jnp.asarray(sb), jnp.asarray(sm), radius, key,
                          query_count=n, precision="highest", **kw))
    draws = jax_draws(key, priority, len(sb), len(sb), 256, 256)
    tf, ov = dips_features_device(td, torch.from_numpy(sb), torch.from_numpy(sb),
                                  torch.from_numpy(sm), torch.tensor(radius), query_count=n,
                                  draws=draws, **kw)
    tf = tf.numpy()
    assert (tf[n:] == 0).all() and (jf[n:] == 0).all()
    assert_descriptors_close(tf, jf)
    assert np.abs(np.linalg.norm(tf[:n], axis=1) - 1).max() < 1e-5


def test_compute_dips_features_knn_branch_matches_jax(models, small_tile):
    """The host function's exact-kNN branch at patch 96 (JAX's branch on
    its CPU backend), given JAX's per-chunk draws, held as above."""
    from fusion4landslide_tpu.pipelines.f2s3 import compute_dips_features as jcompute
    from fusion4landslide_tpu_torch.pipelines.f2s3 import compute_dips_features

    params, td = models
    sb, sm, n = small_tile
    core, halo = sb[:400], sb[:n]
    key = jax.random.PRNGKey(11)
    kw = dict(k_max=200, patch_points=96, chunk=128)
    jf = np.asarray(jcompute(params, jnp.asarray(core), jnp.asarray(halo), 0.9, key,
                             precision="highest", **kw))
    draws = jax_draws(key, "knn", len(core), len(halo), 128, 200)
    tf, ov = compute_dips_features(td, torch.from_numpy(core), torch.from_numpy(halo), 0.9,
                                   draws=draws, **kw)
    assert ov == 0
    assert_descriptors_close(tf.numpy(), jf)


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


def _padded(src, tgt):
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    return dict(n=n, m=m, sb=sb, tb=tb, sm=np.arange(N) < n, tm=np.arange(M) < m)


@pytest.fixture(scope="module")
def step_tile():
    src, tgt, _, _ = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    return dict(src=src, tgt=tgt, **_padded(src, tgt))


def _step_draws(key, priority, tile, chunk, k_max):
    """The JAX steps' key split into the two clouds' draws."""
    k_s, k_t = jax.random.split(key)
    N, M = len(tile["sb"]), len(tile["tb"])
    return (jax_draws(k_s, priority, N, N, min(chunk, N), k_max),
            jax_draws(k_t, priority, M, M, min(chunk, M), k_max))


#: The small fusion step of ``tests/test_torch_step.py`` at patch 96.
FUSION_STATICS = dict(levels=(1, 2), patch_points=96, chunk=512, k_neighbors=8, sv_cap=256,
                      member_cap=128, agg_max_points=64, small_patch=3, icp_max_iter=8,
                      fine_max_matches=64, with_sparse=True, with_tgt2src=True)
FUSION_SCALARS = (5.0, 0.1, 0.1, 10, 10, 0.5, 0.15)


def _fusion_models():
    from test_torch_step import params

    return params.__wrapped__()


def test_fusion3d_tile_step_knn_branch_matches_emulated_jax(step_tile, tpu_branch):
    """The fusion step at patch 96, 'knn' (k_max 512), given JAX's draws,
    scored as ``tools/parity_check.py`` scores two paths: equal voxel
    counts, >= 99% overlap of the assigned points, median DVF gap < 0.1 mm
    and <= 1% of them over 10 mm."""
    from fusion4landslide_tpu.pipelines.fusion_device import fusion3d_tile_step as jstep
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

    dips, agg, td, ta = _fusion_models()
    t = step_tile
    key = jax.random.PRNGKey(0)
    jo = jax.tree.map(np.asarray, jstep(dips, agg, t["sb"], t["sm"], t["tb"], t["tm"], key,
                                        *FUSION_SCALARS, **FUSION_STATICS))
    to = fusion3d_tile_step(
        td, ta, *(torch.from_numpy(t[k]) for k in ("sb", "sm", "tb", "tm")), *FUSION_SCALARS,
        device="cpu", dips_draws=_step_draws(key, "knn", t, 512, 512), **FUSION_STATICS)
    n = t["n"]
    assert int(jo.n_vox_src) == int(to.n_vox_src) and int(jo.n_vox_tgt) == int(to.n_vox_tgt)
    assert to.overflow_by_source["sampler"] > 0  # truncated cell runs, as in JAX
    vj, vt = jo.valid[:n], to.valid[:n].numpy()
    assert vj.sum() > 0.05 * n  # random weights at patch 96 assign ~9% (JAX and port)
    common = vj & vt
    assert common.sum() >= 0.99 * max(vj.sum(), vt.sum())
    gap = np.linalg.norm(jo.moved[:n][common] - to.moved[:n].numpy()[common], axis=1)
    assert np.median(gap) < 1e-4
    assert (gap > 0.01).mean() <= 0.01


def test_f2s3_tile_step_random_branch_matches_emulated_jax(step_tile, tpu_branch):
    """The F2S3 step at patch 96, 'random', given JAX's draws: equal
    labels, >= 99% overlap of the kept points, new targets a median
    < 0.1 mm apart and <= 1% over 10 mm."""
    from fusion4landslide_tpu.models.filtering import FilteringNetwork
    from fusion4landslide_tpu.pipelines.f2s3_device import f2s3_tile_step as jstep
    from fusion4landslide_tpu_torch.models.convert import filter_from_flax
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step

    dips, _, td, _ = _fusion_models()
    filt = jax.tree.map(np.asarray, FilteringNetwork(num_layers=12).init(
        jax.random.PRNGKey(2), np.zeros((2, 8, 6), np.float32), np.ones((2, 8), bool)))
    t = step_tile
    kw = dict(patch_points=96, chunk=512, k_neighbors=30, sv_cap=256, member_cap=256,
              sample_priority="random")
    key = jax.random.PRNGKey(0)
    jo = jax.tree.map(np.asarray, jstep(dips, filt, t["sb"], t["sm"], t["tb"], t["tm"], key,
                                        5.0, 0.1, num_layers=12, **kw))
    to = f2s3_tile_step(td, filter_from_flax(filt),
                        *(torch.from_numpy(t[k]) for k in ("sb", "sm", "tb", "tm")), 5.0, 0.1,
                        device="cpu", dips_draws=_step_draws(key, "random", t, 512, 512), **kw)
    n = t["n"]
    np.testing.assert_array_equal(jo.labels, to.labels.numpy())
    kj, kt = jo.keep[:n], to.keep[:n].numpy()
    assert kj.sum() > 0.01 * n
    assert (kj & kt).sum() >= 0.99 * max(kj.sum(), kt.sum())
    both = kj & kt
    gap = np.linalg.norm(jo.new_tgt[:n][both] - to.new_tgt[:n].numpy()[both], axis=1)
    assert np.median(gap) < 1e-4
    assert (gap > 0.01).mean() <= 0.01


def test_host_fusion_tile_patch96_from_yaml_matches_emulated_jax(tpu_branch, monkeypatch,
                                                                tmp_path):
    """``run_fusion3d_tile`` with a YAML config of ``feat_patch_points:
    96``: both packages take the exact-kNN branch (k_max 512), the port
    with JAX's per-chunk draws; scored by ``score_host_parity``
    (``tests/test_torch_fusion_host.py``, parity_check's scoring)."""
    import yaml

    from fusion4landslide_tpu.pipelines.fusion import run_fusion3d_tile as j_run
    from fusion4landslide_tpu_torch.config import load_yaml
    from fusion4landslide_tpu_torch.pipelines import fusion as tfusion
    from test_torch_fusion_host import CFG, flax_and_torch_models, score_host_parity

    path = tmp_path / "fusion_patch96.yaml"
    path.write_text(yaml.safe_dump({**CFG, "feat_patch_points": 96, "feat_k_max": 512}))
    cfg = dict(load_yaml(str(path)))
    dips, agg, td, ta = flax_and_torch_models()
    src, tgt, _, _ = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    jo = j_run({**cfg, "output_dir": str(tmp_path / "jax")}, dips, agg, src, tgt, tile_id=2)
    jax.clear_caches()
    chunk = cfg["feat_chunk"]
    k_s, k_t = jax.random.split(jax.random.PRNGKey(0))
    nv_s, nv_t = (jo["interim"][k].shape[0] for k in ("src_vox", "tgt_vox"))
    draws = (jax_draws(k_s, "knn", nv_s, 0, chunk, 512), jax_draws(k_t, "knn", nv_t, 0, chunk, 512))
    calls, orig = [], tfusion.fine_match_pairs

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(tfusion, "fine_match_pairs", rec)
    to = tfusion.run_fusion3d_tile({**cfg, "output_dir": str(tmp_path / "port")}, td, ta, src,
                                   tgt, tile_id=2, device="cpu", dips_draws=draws)
    readings = score_host_parity(jo, to, src, calls, min_assigned=0.05)
    assert readings["overlap"] >= 0.99


def test_lrf_float32_gap_is_conditioning(small_tile):
    """Why ``FEAT_ATOL`` is not 1e-5: on the small tile's 200-NN tables,
    JAX's and the port's float32 patches are each up to ~6e-5 from a
    float64 LRF on the same table and draws, and up to ~1.2e-4 apart: the
    float32 LRF's own conditioning. Held: both within 1e-4 of float64,
    and the port no further from it than JAX (x1.5)."""
    from fusion4landslide_tpu.ops.lrf import extract_lrf_patches as jextract
    from fusion4landslide_tpu_torch.ops.knn import knn
    from fusion4landslide_tpu_torch.ops.lrf import lrf_patches_from_knn

    sb, _, n = small_tile
    q, halo = torch.from_numpy(sb[:256]), torch.from_numpy(sb[:n])
    key = jax.random.PRNGKey(1)
    pri = torch.from_numpy(np.array(jax.random.uniform(key, (256, 200))))
    jp = np.asarray(jextract(jnp.asarray(q.numpy()), jnp.asarray(halo.numpy()), 0.9, key,
                             k_max=200, num_points=96))
    sqd, idx = knn(q, halo, 200)
    tp = lrf_patches_from_knn(q, halo, sqd, idx, 0.9, pri, num_points=96).numpy()
    p64 = lrf_patches_from_knn(q.double(), halo.double(), sqd.double(), idx, 0.9, pri.double(),
                               num_points=96).numpy()
    gap, ej, et = (float(np.abs(a - b).max()) for a, b in ((jp, tp), (jp, p64), (tp, p64)))
    print(f"float32 patches: JAX vs port {gap:.3g}, JAX vs float64 {ej:.3g}, "
          f"port vs float64 {et:.3g}")
    assert max(ej, et) <= 1e-4
    assert et <= 1.5 * ej + 1e-6
