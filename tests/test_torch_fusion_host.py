"""The port's host fusion tile (``pipelines.fusion.run_fusion3d_tile`` /
``run_fusion_tile``, what ``main_fusion`` runs per tile on one device) and
its helpers vs the JAX package's, with the JAX side on its TPU branch
emulated on the CPU (Pallas kernels in interpret mode) and the same
(bridged) random weights.

Whole tiles are scored as ``tools/parity_check.py`` scores two paths
(equal voxel counts, median resolution within 1e-6, >= 99% overlap of the
assigned points, median DVF gap < 0.1 mm, <= 1% of points over 10 mm), on
the points outside the superpoints where the two sides meet one of the
known divergences of ROADMAP.md section 3, which are left out of the DVF
score and counted: a global 3D match that differs between the sides must
be a float near-tie of the descriptors (distance gap <= 5e-5, the two
sides' descriptor discrepancy), and it moves its superpoint's whole fine
solve; and a fine pair whose first ICP refit has a rank-1
cross-covariance has an undetermined rotation, which LAPACK (JAX) and
torch complete differently.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models import aggregation as tagg
from fusion4landslide_tpu_torch.models import dips as tdips
from fusion4landslide_tpu_torch.models.convert import params_from_flax
from fusion4landslide_tpu_torch.synth import SMALL_IMG_SIZE, synth_small_rgb_tile, synth_split_tile

#: ``fusion_3d_brienz.yaml`` at a small tile's size.
CFG = {
    "level_of_superpoint": [1, 2], "feat_patch_points": 128, "feat_chunk": 512,
    "agg_max_points": 64, "num_min_matches_for_small_patch": 3, "fine_max_matches": 64,
    "max_magnitude": 5.0, "icp_threshold": 0.1, "voxel_size_init": 0.1,
    "output_tgt2src": True, "dataset": "brienz_tls", "save_interim": False,
    "output_folder": "run", "return_interim": True,
}
#: The RGB channel of ``fusion_brienz.yaml`` on the small tile's camera.
RGB_CFG = {
    "use_2d_matches": True, "image_size": list(SMALL_IMG_SIZE), "pixel_thres": 5,
    "lifting_type": "nn_search", "matches_from_2d_type": "nn_src_only",
    "coarse_matching_fusion": True, "fine_matching_fusion": True,
}


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


def flax_and_torch_models():
    """(Flax DIPs params, Flax aggregation params, port PointNetFeature,
    port ClusterFeatureNet) with the same random weights."""
    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet
    from fusion4landslide_tpu.models.dips import PointNetFeature

    dips = PointNetFeature().init(jax.random.PRNGKey(0), np.zeros((2, 128, 3), np.float32))
    agg = ClusterFeatureNet().init(
        jax.random.PRNGKey(1), np.zeros((2, 8, 64), np.float32), np.ones((2, 8), bool)
    )
    dips, agg = jax.tree.map(np.asarray, dips), jax.tree.map(np.asarray, agg)
    sd_d, sd_a = params_from_flax(dips, agg)
    td, ta = tdips.PointNetFeature(), tagg.ClusterFeatureNet()
    td.load_state_dict(sd_d)
    ta.load_state_dict(sd_a)
    return dips, agg, td.eval(), ta.eval()


@pytest.fixture
def fine_calls(monkeypatch):
    """The port host tile's ``fine_match_pairs`` calls: (args, kw, out)."""
    from fusion4landslide_tpu_torch.pipelines import fusion as tf

    calls, orig = [], tf.fine_match_pairs

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(tf, "fine_match_pairs", rec)
    return calls


def _first_refit_singular_values(a, kw, k: int) -> np.ndarray:
    """Singular values (float64) of fine pair k's first ICP refit
    cross-covariance: its matched correspondences on both channels in the
    solver's order (the first ``fine_max_matches``), the Kabsch seed, the
    1-NN inliers within ``icp_threshold`` under the seed."""
    mem, mm, tl, idx1, ok1, lab_t, sv, tv = (x.numpy() for x in a[:8])
    sv, tv = sv.astype(np.float64), tv.astype(np.float64)
    members = mem[k]
    channels = [(idx1, ok1)]
    if kw.get("corres2_tgt_idx") is not None:
        channels.append((kw["corres2_tgt_idx"].numpy(), kw["corres2_valid"].numpy()))
    src_i, tgt_i = [], []
    for idx, ok in channels:
        w = idx[members]
        sel = mm[k] & ok[members] & (lab_t[w] == tl[k])
        src_i.append(members[sel])
        tgt_i.append(w[sel])
    x = sv[np.concatenate(src_i)][: kw["fine_max_matches"]]
    y = tv[np.concatenate(tgt_i)][: kw["fine_max_matches"]]
    if len(x) == 0:
        return np.zeros(3)
    cx, cy = x.mean(0), y.mean(0)
    u, _, vt = np.linalg.svd((x - cx).T @ (y - cy))
    rot = vt.T @ np.diag([1.0, 1.0, np.sign(np.linalg.det(vt.T @ u.T))]) @ u.T
    moved = x @ rot.T + (cy - rot @ cx)
    d2 = ((moved[:, None] - y[None]) ** 2).sum(-1)
    inl = d2.min(1) <= kw["icp_threshold"] ** 2
    if not inl.any():
        return np.zeros(3)
    xi, yi = x[inl], y[d2.argmin(1)[inl]]
    return np.linalg.svd((xi - xi.mean(0)).T @ (yi - yi.mean(0)), compute_uv=False)


def rank1_refit_voxels(calls) -> np.ndarray:
    """Source voxels of the valid fine pairs whose first ICP refit has a
    rank-1 cross-covariance (second singular value <= 1e-6 x the first)."""
    out = []
    for a, kw, res in calls:
        for k in np.where(res.valid.numpy())[0]:
            sv = _first_refit_singular_values(a, kw, int(k))
            if 0 < sv[0] and sv[1] <= 1e-6 * sv[0]:
                out.append(a[0][k][a[1][k]].numpy())
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def written(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def score_host_parity(jo: dict, to: dict, src: np.ndarray, calls,
                      min_assigned: float = 0.2) -> dict:
    """Hold a port host tile ``to`` to the JAX one ``jo`` (both run with
    ``return_interim``; ``calls``: the port tile's fine calls); returns the
    readings."""
    ij, it = jo["interim"], to["interim"]
    assert ij["src_vox"].shape == it["src_vox"].shape
    assert ij["tgt_vox"].shape == it["tgt_vox"].shape
    assert abs(ij["median_res"] - it["median_res"]) <= 1e-6 * ij["median_res"]
    assert to["overflow"] == 0
    np.testing.assert_array_equal(ij["s_p2v"], it["s_p2v"])
    fs, ft = it["src_feat"], it["tgt_feat"]
    assert np.abs(np.asarray(ij["src_feat"]) - fs).max() < 1e-4
    differ = (np.asarray(ij["g_idx"]) != it["g_idx"]) & (ij["g_valid"] | it["g_valid"])
    differ |= np.asarray(ij["g_valid"]) != it["g_valid"]
    for r in np.where(differ)[0]:
        dj = np.linalg.norm(fs[r] - ft[ij["g_idx"][r]])
        dt = np.linalg.norm(fs[r] - ft[it["g_idx"][r]])
        assert abs(dj - dt) <= 5e-5, (r, dj, dt)
    n = src.shape[0]
    p2v = it["s_p2v"]
    inside = p2v < it["src_vox"].shape[0]
    tainted = inside & np.isin(p2v, rank1_refit_voxels(calls))
    assert len(ij["levels"]) == len(it["levels"])
    for lj, lt in zip(ij["levels"], it["levels"]):
        np.testing.assert_array_equal(lj["lab_s"], lt["lab_s"])
        np.testing.assert_array_equal(lj["lab_t"], lt["lab_t"])
        lab = lt["lab_s"]
        bad = np.unique(lab[differ & (lab >= 0)])
        tainted |= inside & np.isin(lab[np.clip(p2v, 0, len(lab) - 1)], bad)
    s = (src - ij["center"]).astype(np.float32)
    vj, vt = jo["valid"] & ~tainted, to["valid"] & ~tainted
    assert jo["valid"].sum() > min_assigned * n
    common = vj & vt
    moved_j = np.einsum("nij,nj->ni", jo["R"], s) + jo["t"]
    moved_t = np.einsum("nij,nj->ni", to["R"], s) + to["t"]
    gap = np.linalg.norm(moved_j[common] - moved_t[common], axis=1)
    readings = {
        "differing_global_matches": int(differ.sum()),
        "rank1_refit_voxels": int(rank1_refit_voxels(calls).size),
        "tainted_frac": float(tainted[jo["valid"]].mean()),
        "overlap": float(common.sum()) / max(vj.sum(), vt.sum(), 1),
        "median_gap_m": float(np.median(gap)),
        "frac_gt_10mm": float((gap > 0.01).mean()),
    }
    assert readings["tainted_frac"] <= 0.5, readings
    assert readings["overlap"] >= 0.99, readings
    assert readings["median_gap_m"] < 1e-4, readings
    assert readings["frac_gt_10mm"] <= 0.01, readings
    return readings


def test_run_fusion3d_tile_matches_emulated_jax(tpu_branch, fine_calls, tmp_path):
    from fusion4landslide_tpu.pipelines.fusion import run_fusion3d_tile as j_run
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile

    dips, agg, td, ta = flax_and_torch_models()
    src, tgt, _, _ = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    jo = j_run({**CFG, "output_dir": str(tmp_path / "jax")}, dips, agg, src, tgt, tile_id=2)
    jax.clear_caches()
    timings: dict = {}
    to = run_fusion3d_tile({**CFG, "output_dir": str(tmp_path / "port")}, td, ta, src, tgt,
                           tile_id=2, device="cpu", timings=timings)
    score_host_parity(jo, to, src, fine_calls)
    assert jo["per_level"] == to["per_level"]
    assert written(tmp_path / "jax") == written(tmp_path / "port")
    table = np.loadtxt(tmp_path / "port" / "run" / "results" / "c2f_dvfs_src2tgt_tile_2.txt")
    np.testing.assert_allclose(table, to["dvfs"], atol=1e-5)
    assert {"median_resolution", "dips_features", "global_3d_matches", "partition_l1",
            "match_l2", "dense_output", "sparse_assign"} <= set(timings)


def test_run_fusion_tile_matches_emulated_jax(tpu_branch, fine_calls, tmp_path):
    from fusion4landslide_tpu.pipelines.fusion import run_fusion_tile as j_run
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion_tile

    dips, agg, td, ta = flax_and_torch_models()
    src, tgt, core, _, pix, K, E, _ = synth_small_rgb_tile()
    cfg = {**CFG, **RGB_CFG}
    img = np.zeros((*SMALL_IMG_SIZE, 3), np.uint8)
    jo = j_run({**cfg, "output_dir": str(tmp_path / "jax")}, dips, agg, src, tgt, img, img,
               K, E, E, corres_2d=pix, tile_id=0)
    jax.clear_caches()
    to = run_fusion_tile({**cfg, "output_dir": str(tmp_path / "port")}, td, ta, src, tgt,
                         None, None, K, E, E, corres_2d=pix, tile_id=0, device="cpu")
    assert to["n_2d_matches"] == jo["n_2d_matches"] > 0
    score_host_parity(jo, to, src, fine_calls, min_assigned=0.5)
    assert written(tmp_path / "jax") == written(tmp_path / "port")
    # The 2D vote channel assigns nearly all of the core.
    assert to["valid"][core].mean() > 0.9


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_coarse_matchers_match_jax():
    from fusion4landslide_tpu.pipelines import fusion as jf
    from fusion4landslide_tpu_torch.pipelines import fusion as tf

    rng = np.random.default_rng(3)
    S, Q = 300, 260
    fs = rng.normal(size=(S, 64)).astype(np.float32)
    ft = np.concatenate([fs[:200] + 0.05 * rng.normal(size=(200, 64)),
                         rng.normal(size=(Q - 200, 64))]).astype(np.float32)
    cs = rng.uniform(0, 20, size=(S, 3)).astype(np.float32)
    ct = (np.concatenate([cs[:200], rng.uniform(0, 20, size=(Q - 200, 3))]) + 0.3).astype(np.float32)
    vs, vt = np.arange(S) < 280, np.arange(Q) < 250
    for mutual in (True, False):
        ji, jv = jf.coarse_match_superpoints(fs, cs, vs, ft, ct, vt, 5.0, mutual=mutual)
        ti, tv = tf.coarse_match_superpoints(*map(torch.from_numpy, (fs, cs, vs, ft, ct, vt)),
                                             5.0, chunk=64, mutual=mutual)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(ji)[np.asarray(jv)], ti.numpy()[tv.numpy()])
        assert tv.sum() > 50
    lab_s = rng.integers(-1, 30, size=2000)
    lab_t = rng.integers(-1, 25, size=1800)
    c2d = rng.integers(0, 1800, size=2000)
    ok = rng.random(2000) < 0.7
    jb, jok = jf.coarse_match_2d_votes(lab_s, lab_t, c2d, ok, 30, 25)
    tb, tok = tf.coarse_match_2d_votes(lab_s, lab_t, c2d, ok, 30, 25)
    np.testing.assert_array_equal(jb, tb)
    np.testing.assert_array_equal(jok, tok)
    labels = rng.integers(-1, 40, size=500)
    for got, ref in zip(tf._compact_labels(labels, 10), jf._compact_labels(labels, 10)):
        np.testing.assert_array_equal(got, ref)


def test_lift_and_chain_match_jax():
    from fusion4landslide_tpu.image import geometry as jg
    from fusion4landslide_tpu_torch.image import geometry as tg

    src, tgt, _, _, pix, K, E, _ = synth_small_rgb_tile()
    size = SMALL_IMG_SIZE
    uv_s, dep_s, pv_s = tg.project_points(torch.from_numpy(src.astype(np.float32)),
                                          torch.from_numpy(E), torch.from_numpy(K), size)
    uv_t, dep_t, pv_t = tg.project_points(torch.from_numpy(tgt.astype(np.float32)),
                                          torch.from_numpy(E), torch.from_numpy(K), size)
    c2 = torch.from_numpy(pix)
    for mode in ("nn_src_only", "nn_mutual", "nn_union"):
        ji, jv = jg.chain_2d_matches_to_3d(_jnp(pix), _jnp(uv_s.numpy()), _jnp(uv_t.numpy()), 5.0,
                                           src_valid=_jnp(pv_s.numpy()),
                                           tgt_valid=_jnp(pv_t.numpy()), mode=mode)
        ti, tv = tg.chain_2d_matches_to_3d(c2, uv_s, uv_t, 5.0, src_valid=pv_s, tgt_valid=pv_t,
                                           mode=mode)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(ji)[np.asarray(jv)], ti.numpy()[tv.numpy()])
        assert tv.sum() > 100
    with pytest.raises(ValueError):
        tg.chain_2d_matches_to_3d(c2, uv_s, uv_t, 5.0, mode="nn_both")
    dm_s, _ = tg.rasterize_depth(uv_s, dep_s, pv_s, size)
    dm_t, _ = tg.rasterize_depth(uv_t, dep_t, pv_t, size)
    Et, Kt = torch.from_numpy(E), torch.from_numpy(K)
    jp, jok = jg.lift_matches_to_3d(_jnp(pix), _jnp(dm_s.numpy()), _jnp(dm_t.numpy()), _jnp(E),
                                    _jnp(E), _jnp(K), size)
    tp, tok = tg.lift_matches_to_3d(c2, dm_s, dm_t, Et, Et, Kt, size)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tok.sum() > 100
    np.testing.assert_allclose(np.asarray(jp)[tok.numpy()], tp.numpy()[tok.numpy()], atol=1e-5)


def test_merge_by_priority_matches_jax():
    from fusion4landslide_tpu.ops.merge import merge_correspondences_by_priority as j_merge
    from fusion4landslide_tpu_torch.ops.merge import merge_correspondences_by_priority

    rng = np.random.default_rng(5)
    a = rng.uniform(0, 5, size=(400, 6))
    b = np.concatenate([a[:150] + 1e-4, rng.uniform(0, 5, size=(300, 6))])
    c = np.concatenate([b[:50], rng.uniform(0, 5, size=(100, 6))])
    lists = [a, np.zeros((0, 6)), b, c]
    for thr in (1e-3, 0.05):
        got = merge_correspondences_by_priority(lists, distance_threshold=thr, device="cpu")
        ref = j_merge(lists, distance_threshold=thr)
        assert got.shape == ref.shape and got.shape[0] < 850
        np.testing.assert_allclose(got, ref, atol=1e-12)
    assert merge_correspondences_by_priority([], device="cpu").shape == (0, 6)


@pytest.mark.parametrize("extra, item", [
    ({"feat_dtype": "bfloat16"}, "item 3"),
    ({"feat_patch_points": 100}, "item 10"),
])
def test_unported_host_options_raise(tmp_path, extra, item):
    """The options of ROADMAP items 3 (bf16 descriptors) and 10 (patch
    sizes off the multiples of 128) are ported: the tile runs with them
    (``test_torch_dips_branches.py`` and ``test_torch_dips_bf16.py`` hold
    them to JAX). A descriptor dtype the port has no trunk for still
    raises, before tile work."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile, run_fusion_tile

    dips, agg = seeded_models(0, "cpu")
    pts = np.random.default_rng(0).uniform(0, 2, size=(50, 3))
    out = run_fusion3d_tile({**CFG, "output_dir": str(tmp_path / "run"), **extra}, dips, agg,
                            pts, pts, device="cpu")
    assert out["interim"]["src_feat"].shape == (out["interim"]["src_vox"].shape[0], 64)
    assert np.isfinite(out["interim"]["src_feat"]).all()
    cfg = {**CFG, "output_dir": str(tmp_path / "raise"), **extra, "feat_dtype": "float16"}
    K, E = np.eye(3), np.eye(4)
    with pytest.raises(ValueError, match="feat_dtype"):
        if extra.get("use_2d_matches"):
            corres = None if extra.get("no_matches") else np.zeros((4, 4), np.float32)
            run_fusion_tile(cfg, dips, agg, pts, pts, None, None, K, E, E, corres_2d=corres,
                            device="cpu")
        else:
            run_fusion3d_tile(cfg, dips, agg, pts, pts, device="cpu")
