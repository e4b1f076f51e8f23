"""The plain reference agrees with the port's CPU path on a small tile,
piece by piece, with the same weights and inputs."""

import numpy as np
import pytest
import torch

import tiles
import weights
from reference import aggregation as ragg
from reference import chain as rchain
from reference import dips as rdips
from reference import filtering as rfilt
from reference import icp as ricp
from reference import knn as rknn
from reference import median as rmed
from reference import voxel as rvox

TRAFFIC = {"n_core": 1200, "density": 100.0, "src_margin": 1.0, "tgt_margin": 2.0}


@pytest.fixture(scope="module")
def cloud():
    t = tiles.make_tile(2**31 + 5, 1, TRAFFIC)
    c = t["src"].mean(axis=0)
    return torch.from_numpy((t["src"] - c).astype(np.float32)), \
        torch.from_numpy((t["tgt"] - c).astype(np.float32))


def test_tiles_repeat_from_their_seed_and_plant_a_shift():
    a = tiles.make_tile(2**31 + 9, 2, TRAFFIC)
    b = tiles.make_tile(2**31 + 9, 2, TRAFFIC)
    assert all(np.array_equal(a[k], b[k]) for k in ("src", "tgt", "truth"))
    assert not np.array_equal(a["src"], tiles.make_tile(2**31 + 9, 3, TRAFFIC)["src"])
    moving = a["truth"].any(axis=1)
    assert 0.3 < moving.mean() < 0.7
    assert np.allclose(a["truth"][moving], tiles.PLANTED_SHIFT)


def test_dips_descriptors_match_the_port(cloud):
    from fusion4landslide_tpu_torch.models.dips import PointNetFeature
    from fusion4landslide_tpu_torch.ops.knn import median_nn_distance
    from fusion4landslide_tpu_torch.pipelines.f2s3 import compute_dips_features

    s, _ = cloud
    raw = weights.make_weights("dips", 3, "cpu")
    net = weights.load_into(PointNetFeature(), raw)
    radius = float(np.sqrt(3) * 10 * float(median_nn_distance(s)))
    q = s[::9].contiguous()
    prog, _ = compute_dips_features(net, q, s, radius)
    ref = rdips.descriptors(raw, q, s, radius)
    gap = (prog.double() - ref).norm(dim=1)
    assert float(torch.quantile(gap, 0.99)) < 1e-4
    with torch.no_grad():
        ctl = rdips.descriptors(raw, q, s, radius, tf32=True)
    assert float(torch.quantile((ctl - ref).norm(dim=1), 0.99)) > 2e-4


def test_feature_and_gated_nearest_match_the_port(cloud):
    from fusion4landslide_tpu_torch.ops.gated_match import gated_feature_nn1
    from fusion4landslide_tpu_torch.ops.knn import nn1

    s, t = cloud
    g = torch.Generator().manual_seed(4)
    fs = torch.nn.functional.normalize(torch.randn(len(s), 64, generator=g), dim=1)
    ft = torch.nn.functional.normalize(torch.randn(len(t), 64, generator=g), dim=1)
    _, idx = nn1(fs, ft)
    ok = torch.ones(len(s), dtype=torch.bool)
    assert float(rknn.choice_gap(fs, ft, idx, ok).max()) < 1e-6
    _, gi, gv = gated_feature_nn1(fs, ft, s, t, np.float32(1.0))
    gate = (s, t, 1.0)
    assert float(rknn.choice_gap(fs, ft, gi, gv, gate=gate).max()) < 1e-6
    ci, cf = rknn.nearest(fs, ft, gate=gate)
    assert torch.equal(cf, gv) and float(rknn.choice_gap(fs, ft, ci, cf, gate=gate).max()) < 1e-12


def test_filter_scores_match_the_port(cloud):
    from fusion4landslide_tpu_torch.models.filtering import (FilteringNetwork,
                                                              filter_correspondences)

    s, _ = cloud
    raw = weights.make_weights("filter", 5, "cpu")
    net = weights.load_into(FilteringNetwork(), raw)
    g = torch.Generator().manual_seed(1)
    corr = torch.cat([s[:80], s[:80] + 0.05 + 0.01 * torch.randn(80, 3, generator=g)], dim=1)
    out = filter_correspondences(net, corr, torch.ones(80, dtype=torch.bool))
    ref = rfilt.scores(raw, corr)
    assert float((out["scores"].detach().double() - ref).abs().max()) < 1e-4
    assert float((rfilt.scores(raw, corr, tf32=True) - ref).abs().max()) > 1e-3


def test_icp_matches_the_port(cloud):
    from fusion4landslide_tpu_torch.ops.icp import icp_point2point

    s, _ = cloud
    src = s[:120][None]
    ang = 0.02
    R = torch.tensor([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     dtype=torch.float32)
    tgt = (src[0] @ R.T + torch.tensor([0.03, -0.01, 0.02]))[None]
    mask = torch.ones((1, 120), dtype=torch.bool)
    out = icp_point2point(src, tgt, 0.1, mask, mask, max_iter=30)
    R_ref, t_ref, n_in = ricp.icp(src[0], tgt[0], mask[0], torch.eye(3), torch.zeros(3), 0.1, 30)
    assert n_in >= ricp.MIN_INLIERS
    p = src[0].double()
    gap = (p @ out.R[0].double().T + out.t[0].double() - (p @ R_ref.T + t_ref)).norm(dim=1)
    assert float(gap.max()) < 1e-5


def test_voxel_centroids_match_the_port(cloud):
    from fusion4landslide_tpu_torch.ops.voxel import voxel_downsample

    s, t = cloud
    origin = torch.minimum(s.min(0).values, t.min(0).values)
    cen, _, _, nv = voxel_downsample(s, 0.2, origin=origin)
    nv = int(nv)
    gap = rvox.centroid_gap(s.numpy(), origin.numpy(), 0.2, cen[:nv].numpy(), nv)
    assert gap < 1e-5
    assert rvox.centroid_gap(s.numpy(), origin.numpy(), 0.2, cen[:nv].numpy() + 0.01, nv) > 5e-3
    assert rvox.centroid_gap(s.numpy(), origin.numpy(), 0.2, cen[:nv].numpy(), nv // 2) == np.inf


def test_voxel_point_near_a_face_leaves_both_cells_unjudged():
    """A point 1e-5 cells below a face, where float32 may put it in the
    cell above, merged there with that cell's point, is no fault; a
    centroid off in a cell that no such point touches still is."""
    size = 0.05
    u = np.array([[200.5, 808.99999, 62.5], [200.5, 809.5, 62.5], [100.5, 100.5, 10.5]])
    pts = (u * size).astype(np.float32)
    origin = np.zeros(3, np.float32)
    merged = np.stack([pts[:2].mean(axis=0), pts[2]])
    assert rvox.centroid_gap(pts, origin, size, merged, 2) == 0.0
    assert rvox.centroid_gap(pts, origin, size, merged + [[0, 0, 0], [0.01, 0, 0]], 2) > 5e-3


def test_median_resolution_matches_the_port(cloud):
    from fusion4landslide_tpu_torch.ops.knn import median_nn_distance

    s, t = cloud
    for c in (s, t):
        ref = rmed.median_nn(c)
        assert abs(float(median_nn_distance(c)) - ref) / ref < 1e-3
    assert abs(rmed.median_nn(s[::2]) - rmed.median_nn(s)) / rmed.median_nn(s) > 0.1


def test_pixel_chain_matches_the_port():
    from fusion4landslide_tpu_torch.image.geometry import (chain_2d_matches_to_3d,
                                                             project_points)

    size = (480, 640)
    tile = tiles.make_tile(2**31 + 6, 1, dict(TRAFFIC, camera={"focal_per_side": 1.1,
                                                                "match_every": 2}), size)
    K, E = torch.from_numpy(tile["K"]), torch.from_numpy(tile["E"])
    src = torch.from_numpy(tile["src"])
    tgt = torch.from_numpy(tile["tgt"][::3].copy())
    c2 = torch.from_numpy(tile["corres_2d"])
    (uv_s, _, ok_s), (uv_t, _, ok_t) = (project_points(p, E, K, size) for p in (src, tgt))
    idx, valid = chain_2d_matches_to_3d(c2, uv_s, uv_t, 5.0, src_valid=ok_s, tgt_valid=ok_t)
    (ru_s, e_s), (ru_t, e_t) = (rchain.project(p.double(), K, E, size) for p in (src, tgt))
    rows = torch.arange(0, len(src), 7)
    ends = c2.double()
    gap = rchain.chain_gap(ru_s, e_s, ru_t, e_t, ends, 5.0, rows, idx[rows], valid[rows])
    assert valid[rows].any() and float(gap.max()) < 1e-3
    ridx, rok = rchain.chain(ru_s, ru_t, e_t, ends, 5.0, rows)
    assert float(rchain.chain_gap(ru_s, e_s, ru_t, e_t, ends, 5.0, rows, ridx, rok).max()) < 1e-6
    bad = rchain.chain_gap(ru_s, e_s, ru_t, e_t, ends, 5.0, rows, torch.roll(idx[rows], 9),
                           valid[rows])
    assert float(bad.max()) > 1.0


def test_aggregation_matches_the_port():
    from fusion4landslide_tpu_torch.models.aggregation import (ClusterFeatureNet,
                                                                aggregate_superpoints)

    raw = weights.make_weights("agg", 6, "cpu")
    net = weights.load_into(ClusterFeatureNet(), raw)
    g = torch.Generator().manual_seed(2)
    feats = torch.nn.functional.normalize(torch.randn(300, 64, generator=g), dim=1)
    coords = torch.randn(300, 3, generator=g)
    idx = torch.randint(0, 300, (6, 40), generator=g, dtype=torch.int32)
    mask = torch.arange(40)[None] < torch.tensor([40, 33, 12, 1, 25, 40])[:, None]
    with torch.no_grad():
        out, _ = aggregate_superpoints(net, feats, coords, idx, mask, agg_max_points=16)
    ti, tm = ragg.thin(idx.long(), mask, 16)
    ref = ragg.features(raw, feats[ti], tm)
    assert float((out.double() - ref).norm(dim=1).max()) < 1e-5 * float(ref.norm(dim=1).median())
    ctl = ragg.features(raw, feats[ti], tm, tf32=True)
    assert float((ctl - ref).norm(dim=1).max()) > 1e-4 * float(ref.norm(dim=1).median())


def test_coarse_mutual_match_matches_the_port():
    from fusion4landslide_tpu_torch.pipelines.fusion import coarse_match_superpoints

    g = torch.Generator().manual_seed(3)
    fs, ft = torch.randn(50, 64, generator=g), torch.randn(70, 64, generator=g)
    cs, ct = 3 * torch.randn(50, 3, generator=g), 3 * torch.randn(70, 3, generator=g)
    vs, vt = torch.arange(50) < 45, torch.arange(70) < 66
    idx, ok = coarse_match_superpoints(fs, cs, vs, ft, ct, vt, 4.0)
    args = [x.double() if x.is_floating_point() else x for x in (fs, cs, vs, ft, ct, vt)]
    assert ok.any() and float(rknn.mutual_gap(*args, 4.0, idx, ok).max()) < 1e-5
    ridx, rok = rknn.mutual_nearest(*args, 4.0)
    assert torch.equal(rok, ok) and torch.equal(ridx[ok], idx[ok].long())
    assert float(rknn.mutual_gap(*args, 4.0, torch.roll(idx, 1), ok).max()) > 1e-2
