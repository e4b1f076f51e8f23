"""The port's rgb_guided method against the JAX package's on the CPU:
``refine_supervoxels_rigid`` (with more members than its 1 024-row cap,
and independent of the ICP chunk size), the host tile
``run_rgb_guided_tile`` on a textured small scene (the recipe of
``tests/test_rgb_guided.py``, supervoxel and HDBSCAN segmentation, the
matcher inside the tile or precomputed matches), the device step
``rgb_guided_tile_step`` on a padded tile, its single-GPU runner, and
``hdbscan_labels``.

Tolerances: discrete outputs (matched flags, kept and quality
supervoxels, labels, table rows) equal; rigid transforms within 2e-5 and
table coordinates within 2e-6 m (float32 sums in another order; tables
are written to 1e-6 m)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.pipelines import rgb_guided as tr
from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT, synth_epoch_pair, synth_textured_images

H, W = 240, 320
K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]])
R_TOL, XYZ_TOL = 2e-5, 2e-6


def refine_inputs(rng, S, P, fill, n_pts, curved: bool = False, outliers: float = 0.5):
    """Member tables of S segments (``fill`` members each, the rest
    masked) over n_pts points: planar patches (``curved``: curved in both
    directions, so a point-to-plane fit is well posed) moved by a
    per-segment rigid motion, with noise and gross outliers (a share
    uniform in [0, ``outliers``]); 85% of points matched."""
    pts = np.zeros((n_pts, 3), np.float32)
    tgt = np.zeros((n_pts, 3), np.float32)
    members = np.zeros((S, P), np.int32)
    mask = np.zeros((S, P), bool)
    perm = rng.permutation(n_pts)
    for s in range(S):
        rows = perm[s * fill:(s + 1) * fill]
        xy = rng.uniform(-1, 1, (fill, 2))
        z = 0.1 * np.sin(3 * xy[:, 0])
        if curved:
            z = (0.3 * np.sin(3 * xy[:, 0]) + 0.3 * np.cos(2.5 * xy[:, 1])
                 + 0.2 * xy[:, 0] * xy[:, 1])
        p = np.column_stack([xy, z]) + rng.normal(0, 5, 3)
        a = rng.normal(0, 0.02, 3)
        Rm = np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]])
        q = p @ Rm.T + rng.normal(0, 0.05, 3) + rng.normal(0, 0.003, p.shape)
        out = rng.random(fill) < rng.uniform(0.0, outliers)
        q[out] += rng.normal(0, 0.5, (int(out.sum()), 3))
        pts[rows], tgt[rows] = p, q
        members[s, :fill] = rows
        mask[s, :fill] = True
    matched = rng.random(n_pts) < 0.85
    return members, mask, matched, pts, tgt


def j_refine(members, mask, matched, pts, tgt, **kw):
    from fusion4landslide_tpu.pipelines.rgb_guided import refine_supervoxels_rigid

    return refine_supervoxels_rigid(jnp.asarray(members), jnp.asarray(mask),
                                    jnp.asarray(matched), jnp.asarray(pts), jnp.asarray(tgt), **kw)


def t_refine(members, mask, matched, pts, tgt, **kw):
    return tr.refine_supervoxels_rigid(torch.from_numpy(members), torch.from_numpy(mask),
                                       torch.from_numpy(matched), torch.from_numpy(pts),
                                       torch.from_numpy(tgt), **kw)


def assert_refine_equal(j, t):
    np.testing.assert_array_equal(np.asarray(j.quality), t.quality.numpy())
    np.testing.assert_array_equal(np.asarray(j.n_matches), t.n_matches.numpy())
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=R_TOL)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=R_TOL)


@pytest.mark.parametrize("S,P,fill,icp_iter", [(40, 64, 50, 30), (20, 128, 100, 0),
                                               (3, 1280, 1200, 30)])
def test_refine_supervoxels_rigid_matches_jax(S, P, fill, icp_iter):
    """Above 1 024 columns the matched members come first, each group in
    member order (JAX's top_k of ``mv - arange * 1e-9`` in float32)."""
    rng = np.random.default_rng(S)
    inputs = refine_inputs(rng, S, P, fill, S * fill + 17)
    kw = dict(icp_threshold=0.1, icp_max_iter=icp_iter)
    t = t_refine(*inputs, **kw)
    assert_refine_equal(j_refine(*inputs, **kw), t)
    assert 0 < int(t.quality.sum()) < S or S == 3


@pytest.mark.parametrize("icp_type", ["point2plane", "generalized_icp"])
def test_refine_icp_types_match_jax(icp_type):
    """The refinement with the other ICP solvers (``icp_type``), against
    the JAX function on the same member tables. The patches are curved
    both ways and free of gross outliers: with outliers the inlier set
    within the ICP threshold can hinge on one rounding, and the
    point-to-plane normal equations of a contaminated patch (world
    coordinates, few inliers) are so ill-conditioned that the float32
    solves of the two packages part."""
    rng = np.random.default_rng(40)
    inputs = refine_inputs(rng, 40, 64, 50, 40 * 50 + 17, curved=True, outliers=0.0)
    kw = dict(icp_threshold=0.1, icp_max_iter=30, icp_type=icp_type)
    t = t_refine(*inputs, **kw)
    assert_refine_equal(j_refine(*inputs, **kw), t)
    assert int(t.quality.sum()) > 0


def test_icp_type_reaches_the_refinement_of_the_tile_and_the_step(tmp_path, monkeypatch):
    """``icp_type`` from the config (host tile) and the step's argument
    reach ``refine_supervoxels_rigid``, and a recorded call replayed gives
    the same answer. Parity with JAX is held on well-posed patches
    (``test_refine_icp_types_match_jax``): on this scene's small, nearly
    planar supervoxels the undamped point-to-plane and generalized steps
    of both packages wander tens of degrees from the Kabsch seed, where
    float32 rounding decides the path (a property of the reference's
    solvers, not of the port)."""
    from fusion4landslide_tpu_torch.pipelines import rgb_guided_device as td

    calls = []
    orig = tr.refine_supervoxels_rigid

    def record(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(tr, "refine_supervoxels_rigid", record)
    monkeypatch.setattr(td, "refine_supervoxels_rigid", record)
    args, (src, tgt, corres, Kc, Ec, _) = padded_step_inputs()
    cfg = {"image_size": [H, W], "pixel_thres": 4, "max_magnitude": 5.0, "icp_threshold": 0.1,
           "n_normals": 15, "voxel_size": 0.0, "dataset": "brienz_tls", "output_folder": "run",
           "output_dir": str(tmp_path), "icp_type": "point2plane"}
    img = np.zeros((H, W), np.float32)
    tr.run_rgb_guided_tile(cfg, src, tgt, img, img, Kc, Ec, Ec, corres_2d=corres, device="cpu")
    td.rgb_guided_tile_step(*args, 5.0, 5.0, 0.1, 0.0, image_size=(H, W), v_flip=True,
                            k_neighbors=15, sv_cap=256, member_cap=256,
                            icp_type="generalized", device="cpu")
    assert [k["icp_type"] for _, k, _ in calls] == ["point2plane", "generalized"]
    for a, k, out in calls:
        again = orig(*a, **k)
        for x, y in zip(again, out):
            assert torch.equal(x, y)
        assert int(out.quality.sum()) > 0
        assert not torch.equal(out.R, orig(*a, **{**k, "icp_type": "point2point"}).R)


def test_refine_is_independent_of_the_icp_chunk(monkeypatch):
    rng = np.random.default_rng(9)
    inputs = refine_inputs(rng, 37, 64, 60, 37 * 60)
    ref = t_refine(*inputs)
    for rows in (1, 5, 64):
        monkeypatch.setattr(tr, "_ICP_SLAB", rows * 64 * 64)
        got = t_refine(*inputs)
        for a, b in zip(ref, got):
            assert torch.equal(a, b)


def textured_scene(rng, n=4000):
    """``tests/test_rgb_guided.py``'s scene: terrain seen by a camera 8 m
    away, the half x > 0 moved 0.15 m, textured images rendered from a
    per-point random texture (no v-flip)."""
    from fusion4landslide_tpu.image.geometry import project_points, rasterize_depth

    xy = rng.uniform(-4, 4, size=(n, 2))
    z = np.sin(xy[:, 0] * 2) * 0.1 + np.cos(xy[:, 1] * 3) * 0.1
    src = np.column_stack([xy[:, 0], xy[:, 1], z + 8.0]).astype(np.float64)
    tgt = src.copy()
    tgt[src[:, 0] > 0] += [0.15, 0.0, 0.0]
    E = np.eye(4)
    tex = rng.uniform(50, 255, size=n).astype(np.float32)

    def render(pts):
        uv, d, v = project_points(pts.astype(np.float32), E.astype(np.float32),
                                  K.astype(np.float32), (H, W), v_flip=False)
        _, imap = rasterize_depth(uv, d, v, (H, W))
        imap = np.asarray(imap)
        img = np.zeros((H, W), np.float32)
        img[imap >= 0] = tex[imap[imap >= 0]]
        return img

    return src, tgt, render(src), render(tgt), E


def results_of(root):
    out = {}
    for f in sorted((root / "run" / "results").iterdir()):
        out[f.name] = np.loadtxt(f, ndmin=2)
    return out


@pytest.mark.parametrize("case", ["precomputed", "matcher", "hdbscan", "eloftr"])
def test_run_rgb_guided_tile_matches_jax(tmp_path, case):
    """``eloftr``: the shipped matcher with the repository's
    ``weights/eloftr_tiny.npz`` inside the tile on both sides, on a
    ``synth_textured_images`` pair (v-flipped camera); the matcher keeps no
    cell of the sparsely rendered scene of the other cases."""
    from fusion4landslide_tpu.image.matching import match_epoch_images
    from fusion4landslide_tpu.pipelines.rgb_guided import run_rgb_guided_tile as j_run

    rng = np.random.default_rng(0)
    cam, dataset = K, "rockfall_simulator"
    if case == "eloftr":
        src, tgt, _ = synth_epoch_pair(8, 6, density=80.0, seed=1)
        img0, img1, cam, E, _ = synth_textured_images(src, tgt, (H, W))
        dataset = "brienz_tls"
    else:
        src, tgt, img0, img1, E = textured_scene(rng)
    cfg = {"image_size": [H, W], "pixel_thres": 4, "max_magnitude": 2.0, "icp_threshold": 0.2,
           "n_normals": 15, "voxel_size": 0.0, "img_matching_type": "zncc",
           "dataset": dataset, "output_folder": "run"}
    corres = None
    if case == "precomputed":
        corres = match_epoch_images(img0, img1, matcher="zncc", grid_step=4, patch=12,
                                    search=10, min_score=0.5, min_texture=1.0)
    if case == "hdbscan":
        cfg.update(clustering_type="hdbscan", hdbscan_min_samples=20)
    if case == "eloftr":
        cfg["img_matching_type"] = "eloftr"
    jo = j_run(dict(cfg, output_dir=str(tmp_path / "jax")), src, tgt, img0, img1, cam, E, E,
               corres_2d=corres)
    to = tr.run_rgb_guided_tile(dict(cfg, output_dir=str(tmp_path / "port")), src, tgt, img0,
                                img1, cam, E, E, corres_2d=corres, device="cpu")
    assert to["n_matches"] == jo["n_matches"] > 200
    assert to["n_supervoxels"] == jo["n_supervoxels"] > 5
    np.testing.assert_allclose(to["corres_2d"], jo["corres_2d"], atol=1e-4)
    jt, tt = results_of(tmp_path / "jax"), results_of(tmp_path / "port")
    assert sorted(jt) == sorted(tt) and len(tt) == 4
    for name in jt:
        assert jt[name].shape == tt[name].shape, name
        np.testing.assert_allclose(tt[name], jt[name], atol=XYZ_TOL, rtol=0, err_msg=name)
    # Matched flags are the wo_refinement rows; quality supervoxels the
    # refined rows.
    wo = tt["rgb_guided_wo_refinement_dvfms_tile_0.txt"]
    assert len(wo) == int(to["matched"].sum()) and to["quality"].any()
    disp = to["dvfs"][:, 3:6] - to["dvfs"][:, :3]
    if case == "eloftr":
        mov = to["dvfs"][:, 1] > 3.0
        np.testing.assert_allclose(np.median(disp[mov], axis=0), PLANTED_SHIFT, atol=0.03)
        return
    mov = to["dvfs"][:, 0] > 0.5
    assert abs(np.median(disp[mov, 0]) - 0.15) < 0.08


def test_hdbscan_labels_match_jax():
    from fusion4landslide_tpu.ops.clustering import dbscan_labels as j_db
    from fusion4landslide_tpu.ops.clustering import hdbscan_labels as j_hdb
    from fusion4landslide_tpu_torch.ops.clustering import dbscan_labels, hdbscan_labels

    rng = np.random.default_rng(6)
    pts = np.concatenate([rng.normal(c, 0.3, (300, 3)) for c in ((0, 0, 0), (4, 0, 0), (0, 5, 1))])
    for kw in ({"min_samples": 1000}, {"min_samples": 15, "min_cluster_size": 30}):
        got = hdbscan_labels(pts, **kw)
        np.testing.assert_array_equal(got, j_hdb(pts, **kw))
    assert got.max() >= 2
    np.testing.assert_array_equal(dbscan_labels(pts, eps=0.4), j_db(pts, eps=0.4))


def padded_step_inputs(extra_tgt: int = 64):
    """A small textured epoch pair through ZNCC, padded to its buckets as
    the runner pads it (the target ``extra_tgt`` rows more)."""
    from fusion4landslide_tpu_torch.image.matching import match_epoch_images
    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    src, tgt, _ = synth_epoch_pair(8, 6, density=80.0, seed=1)
    img0, img1, Kc, Ec, _ = synth_textured_images(src, tgt, (H, W))
    corres = match_epoch_images(img0, img1, grid_step=4, patch=12, search=6, device="cpu")
    n = len(src)
    N, M = bucket_size(n), bucket_size(n) + extra_tgt
    c = src.mean(axis=0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:n] = tgt - c
    C = max(bucket_size(len(corres)), 64)
    c2 = np.zeros((C, 4), np.float32)
    c2[:len(corres)] = corres
    return (sb, np.arange(N) < n, tb, np.arange(M) < n, c.astype(np.float32), c2,
            np.arange(C) < len(corres), Ec, Ec, Kc, Kc), (src, tgt, corres, Kc, Ec, n)


@pytest.mark.parametrize("mode,member_cap", [("nn_src_only", 256), ("nn_mutual", 64)])
def test_rgb_guided_tile_step_matches_jax(mode, member_cap, monkeypatch):
    """The padded step (v-flipped camera, padded matches and clouds):
    matched and valid flags, the median resolution, the dropped count and
    the moved points. A member cap of 64 drops points.

    ``nn_mutual`` keeps only chains that map a static point back to its
    own copy, so whole supervoxels have exact correspondences: their
    Kabsch residuals are rounding noise (median < 1e-6 m) and the 2.5x
    median inlier rule compares noise, which the two SVDs round
    differently. Those supervoxels' points are counted, not compared."""
    from fusion4landslide_tpu.pipelines.rgb_guided_device import rgb_guided_tile_step as j_step
    from fusion4landslide_tpu_torch.ops.kabsch import weighted_kabsch
    from fusion4landslide_tpu_torch.pipelines import rgb_guided_device as td

    seen = {}

    def record(*a, **k):
        seen["args"] = a
        return tr.refine_supervoxels_rigid(*a, **k)

    monkeypatch.setattr(td, "refine_supervoxels_rigid", record)
    args, _ = padded_step_inputs()
    scal = (5.0, 5.0, 0.1, 0.0)
    kw = dict(image_size=(H, W), v_flip=True, k_neighbors=15, sv_cap=256,
              member_cap=member_cap, mode=mode)
    jo = j_step(*[jnp.asarray(a) for a in args], *scal, **kw)
    to = td.rgb_guided_tile_step(*args, *scal, **kw, device="cpu")
    jax.clear_caches()
    np.testing.assert_array_equal(to.matched.numpy(), np.asarray(jo.matched))
    assert float(to.median_res) == float(jo.median_res)
    assert int(to.n_dropped) == int(jo.n_dropped)
    assert (int(to.n_dropped) > 0) == (member_cap == 64)
    np.testing.assert_array_equal(to.tgt_match.numpy(), np.asarray(jo.tgt_match))
    assert to.overflow_by_source == {"sampler": 0, "grid_knn": 0}
    # Supervoxels whose matched residuals are rounding noise.
    members, mmask, matched, src, tgt_match = seen["args"]
    mv = mmask & matched[members.long()]
    _, _, res, _ = weighted_kabsch(src[members.long()], tgt_match[members.long()], mv.float())
    rs = torch.sort(torch.where(mv, res, torch.inf), dim=1).values
    med = rs[torch.arange(len(rs)), torch.clamp((mv.sum(1) - 1) // 2, min=0)]
    lab = to.labels.long()
    tie = ((lab >= 0) & (med < 1e-6)[torch.clamp(lab, 0, len(med) - 1)]).numpy()
    # At most the static half (identical in both epochs).
    assert tie.sum() < 0.5 * args[1].sum() and (tie.any() == (mode == "nn_mutual"))
    np.testing.assert_array_equal(to.valid.numpy()[~tie], np.asarray(jo.valid)[~tie])
    assert int(to.valid.sum()) > 0.3 * args[1].sum()
    both = ~tie[:, None] & np.asarray(jo.valid)[:, None]
    np.testing.assert_allclose(np.where(both, to.moved.numpy(), 0),
                               np.where(both, np.asarray(jo.moved), 0), atol=XYZ_TOL * 5)


def test_run_rgb_guided_tiles_writes_the_steps_tables(tmp_path):
    """The single-GPU runner: the step's outputs written as the JAX runner
    writes them (``parallel/pipeline.py:940-986``), for two tiles."""
    from fusion4landslide_tpu.io.results import dvf_magnitudes
    from fusion4landslide_tpu_torch.parallel.pipeline import run_rgb_guided_tiles
    from fusion4landslide_tpu_torch.pipelines.rgb_guided_device import rgb_guided_tile_step

    args, (src, tgt, corres, Kc, Ec, n) = padded_step_inputs(extra_tgt=0)
    cfg = {"image_size": [H, W], "n_normals": 15, "max_magnitude": 5.0, "dataset": "brienz_tls",
           "output_dir": str(tmp_path), "output_folder": "run"}
    res = run_rgb_guided_tiles(cfg, [("0", src, tgt), ("1", src[::2], tgt[::2])], None, None, Kc,
                               Ec, Ec, corres_2d=corres, device="cpu")
    out = rgb_guided_tile_step(*args, 5.0, 5.0, 0.1, 0.0, image_size=(H, W), k_neighbors=15,
                               sv_cap=256, member_cap=1024, device="cpu")
    tables = results_of(tmp_path)
    assert len(tables) == 8 and res["0"]["n_matches"] == int(out.matched.sum())
    valid = out.valid[:n].numpy()
    dvfs = np.hstack([src[valid], out.moved[:n].numpy()[valid] + src.mean(axis=0)])
    np.testing.assert_allclose(tables["rgb_guided_w_refinement_dvfs_src2tgt_tile_0.txt"], dvfs,
                               atol=1e-6)
    np.testing.assert_allclose(tables["rgb_guided_w_refinement_dvfms_src2tgt_tile_0.txt"][:, 3],
                               dvf_magnitudes(dvfs), atol=2e-6)
    assert len(tables["rgb_guided_wo_refinement_dvfms_tile_0.txt"]) == res["0"]["n_matches"]
    assert res["1"]["overflow_by_source"] == {"sampler": 0, "grid_knn": 0}
    assert 0 < res["1"]["valid"].sum() < len(src) // 2 + 1


@pytest.mark.parametrize("extra, item", [
    ({"save_img_matching_visualization": True}, "matplotlib"),
])
def test_unported_options_raise(tmp_path, monkeypatch, extra, item):
    """What the tile cannot run raises in its option check, naming what
    it lacks: the matching figures without matplotlib (the card's
    machine has none; ``tests/test_torch_visualization.py`` holds the
    figures themselves)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(1)
    src, tgt, img0, img1, E = textured_scene(rng, n=1500)
    cfg = {"image_size": [H, W], "pixel_thres": 4, "max_magnitude": 2.0, "n_normals": 15,
           "img_matching_type": "zncc", "dataset": "rockfall_simulator",
           "output_dir": str(tmp_path), "output_folder": "run", **extra}
    with pytest.raises(ImportError, match=item):
        tr.run_rgb_guided_tile(cfg, src, tgt, img0, img1, K, E, E, device="cpu")
    assert not (tmp_path / "run").exists()
