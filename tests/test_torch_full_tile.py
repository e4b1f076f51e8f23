"""The port at the shipped tile size, on the CPU: ``bench.py``'s ``e2e``
tile (a 1 000 000-point core, source margin 5 m, target margin 10 m, the
+-20 m halo, a 4096^2 nadir camera) and what scales with it.

- ``synth.synth_rgb_tile`` builds the tile ``bench.py`` builds
  (``synth_split_tile`` + ``synth_image_channel``, the latter projecting
  through the JAX package), on a 4 000-point core: clouds and masks
  bit-equal, pixel keep masks equal, pixel coordinates within 1e-3 px
  (measured 0 px: both sides round the same float32 products), camera
  and metres per pixel equal;
- ``bucket_size`` equals the JAX package's at the 1M tile's sizes (source
  1 210 554 -> 1 310 720, target 1 440 062 -> 1 572 864, pixel matches
  605 277 -> 655 360) and at the +-20 m overlap cloud's 1 960 000 ->
  2 097 152 (``BENCH_SPLIT=0``);
- the fusion runner's statics (``parallel.pipeline.fusion3d_statics``)
  equal those ``bench.py::bench_e2e`` hands the JAX step at those sizes,
  for ``chip_smoke.py``'s phase-7 configuration and for the shipped
  ``fusion_brienz.yaml``, but ``feat_dtype`` (bench.py runs bf16);
- the grid-window repair (ROADMAP queue 3, F4): at the 1M tile a query
  block that crosses from one x-slab of cells to the next spans four
  whole slabs, past the 32 768-position window (111 + 122 truncated DIPs
  blocks). ``fitted_window`` sizes the window; on a 4 m x 130 m strip at
  the production density and patch radius the fixed window truncates a
  block and leaves in-radius references unscanned, the fitted one scans
  every one of them; kernel 2's fitted window gives the exact 1-NN where
  the fixed one does not; and the main path's callers ask for the fitted
  window;
- the host tile's grid callers (ROADMAP queue 3, F6): its median
  resolution (``ops.knn.median_nn_distance``) and its sparse
  re-association (``pipelines.fusion.sparse_assign_core``) fit kernel 2's
  window too, so both are exact where a fixed window truncates a block,
  and bit-equal to the fixed window's where it holds;
- ``chip_smoke.py``'s phase-10 epoch (``FULL_TILE_EPOCH``): the shipped
  ``fusion_brienz.yaml``'s tiler and 0.1 m voxel filter keep it as one
  tile of 950 000-1 000 000 points a cloud, with pixel matches for half
  the source points from ``bench.py``'s recipe.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.ops.segments import bucket_size as jax_bucket_size
from fusion4landslide_tpu_torch.config import load_yaml
from fusion4landslide_tpu_torch.ops import hashgrid_cuda as hc
from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.parallel.pipeline import fusion3d_statics
from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT, synth_rgb_tile

ROOT = Path(__file__).resolve().parents[1]
#: The production density's patch radius, sqrt(3) * 10 * median
#: resolution (0.05599 m on the 1M tile).
PATCH_RADIUS = 0.9698
WINDOW, CHUNK = 32768, 2048


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _module("_bench_readonly", ROOT / "bench.py")


@pytest.fixture(scope="module")
def smoke():
    return _module("_chip_smoke_cfg", ROOT / "chip_smoke.py")


def test_rgb_tile_equals_bench_e2e_tile(bench):
    import jax.numpy as jnp

    from fusion4landslide_tpu.image.geometry import project_points as jax_project
    from fusion4landslide_tpu_torch.image.geometry import project_points

    n_core = 4000
    src, tgt, core, moving, pix, K, E, m_per_px = synth_rgb_tile(n_core, 5.0, 10.0, halo=20.0)
    b_src, b_tgt, b_core, b_moving = bench.synth_split_tile(n_core, 5.0, 10.0, halo=20.0,
                                                            density=100.0)
    for a, b in ((src, b_src), (tgt, b_tgt), (core, b_core), (moving, b_moving)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tgt_of_src = b_src.copy()
    tgt_of_src[b_moving] += bench.PLANTED_SHIFT
    assert np.array_equal(bench.PLANTED_SHIFT, PLANTED_SHIFT)
    b_pix, b_K, b_E, b_m_per_px = bench.synth_image_channel(b_src, tgt_of_src,
                                                            n_matches=len(b_src) // 2)
    np.testing.assert_array_equal(K, b_K)
    np.testing.assert_array_equal(E, b_E)
    assert m_per_px == b_m_per_px
    # The keep masks: both packages project the same subsampled rows.
    sub = np.arange(0, len(src), max(1, len(src) // (len(src) // 2)))
    keep = {}
    for side, pts in (("s", src[sub]), ("t", tgt_of_src[sub])):
        _, _, ok = project_points(torch.from_numpy(pts), torch.from_numpy(E),
                                  torch.from_numpy(K), bench.IMG_SIZE)
        _, _, j_ok = jax_project(jnp.asarray(pts), jnp.asarray(E), jnp.asarray(K),
                                 bench.IMG_SIZE, v_flip=True)
        keep[side] = (ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(keep["s"][0] & keep["t"][0], keep["s"][1] & keep["t"][1])
    assert pix.shape == b_pix.shape and 0.3 < len(pix) / len(src) < 0.6
    assert float(np.abs(pix - b_pix).max()) <= 1e-3


#: The 1M tile's sizes and buckets (source, target, pixel matches), the
#: +-20 m overlap cloud's, and each bucket's edges.
SIZES = (1_210_554, 1_440_062, 605_277, 1_960_000,
         1_310_720, 1_310_721, 1_572_864, 1_572_865, 655_360, 655_361, 2_097_152, 2_097_153)


@pytest.mark.parametrize("n", SIZES)
def test_bucket_size_at_the_shipped_tile(n):
    assert bucket_size(n) == jax_bucket_size(n)


def test_shipped_tile_buckets():
    assert [bucket_size(n) for n in (1_210_554, 1_440_062, 605_277, 1_960_000)] == [
        1_310_720, 1_572_864, 655_360, 2_097_152]


def _bench_statics(bench, monkeypatch, n_core: int, split: str) -> dict:
    """The statics ``bench.py::bench_e2e`` (RGB) passes to the JAX step,
    captured at its ``make_sharded_fusion3d_step`` call (nothing runs)."""
    import fusion4landslide_tpu.parallel as jpar

    captured = {}

    class Captured(Exception):
        pass

    def capture(mesh, dips, agg, **statics):
        captured.update(statics)
        raise Captured

    monkeypatch.setattr(jpar, "make_sharded_fusion3d_step", capture)
    monkeypatch.setattr(bench, "_models", lambda: (None, None))
    monkeypatch.setattr(bench, "_keepalive", lambda: None)
    monkeypatch.setenv("BENCH_SPLIT", split)
    with pytest.raises(Captured):
        bench.bench_e2e(n_core, with_rgb=True)
    return captured


STATIC_KEYS = ("sv_cap", "sv_cap_tgt", "member_cap", "agg_max_points", "k_max",
               "patch_points", "chunk", "levels", "small_patch", "with_sparse", "with_tgt2src")


@pytest.mark.parametrize("cfg_name", ["chip_smoke phase 7", "fusion_brienz.yaml"])
@pytest.mark.parametrize("split,buckets", [("1", (1_310_720, 1_572_864)),
                                           ("0", (2_097_152, 2_097_152))])
def test_runner_statics_equal_bench(bench, smoke, monkeypatch, cfg_name, split, buckets):
    want = _bench_statics(bench, monkeypatch, 1_000_000, split)
    if cfg_name == "fusion_brienz.yaml":
        cfg = load_yaml(str(ROOT / "configs" / "landslide" / "fusion_brienz.yaml"))
    else:
        cfg = dict(smoke.FUSION_CFG, **smoke.RGB_CFG)
    got = fusion3d_statics(cfg, *buckets, with_image=True)
    assert {k: got[k] for k in STATIC_KEYS} == {k: want[k] for k in STATIC_KEYS}
    assert want["feat_dtype"] == "bfloat16" and got["feat_dtype"] is None
    assert got["v_flip"] == want["v_flip"]
    if cfg_name != "fusion_brienz.yaml":
        assert got["image_size"] == want["image_size"] == (4096, 4096)


# ---- F4: the grid window at the shipped tile size ------------------------


@pytest.mark.parametrize("w_len_max,want", [
    (0, WINDOW), (27_530, WINDOW), (WINDOW, WINDOW), (WINDOW + 1, WINDOW + CHUNK),
    (44_000, 45_056), (49_152, 49_152), (55_000, 55_296), (2_097_152, 2_097_152),
])
def test_fitted_window_sizes(w_len_max, want):
    got = hc.fitted_window(w_len_max, WINDOW, CHUNK)
    assert got == want and got % CHUNK == 0 and got >= max(w_len_max, WINDOW)


def _strip(seed: int = 0, length: float = 130.0):
    """A 4 m x ``length`` strip of the synthetic slope at 100 points per
    m^2 (52 000 points at 130 m, centred): its x-slabs of patch-radius
    cells are a whole 130 m long, as a 1M tile's are."""
    rng = np.random.default_rng(seed)
    n = int(round(400 * length))
    xy = rng.uniform(0, [4.0, length], size=(n, 2))
    z = np.sin(xy[:, 0] * 0.31) * 2.0 + np.cos(xy[:, 1] * 0.17) * 3.0
    z = z + rng.normal(scale=0.02, size=n)
    pts = np.column_stack([xy, z]).astype(np.float32)
    return torch.from_numpy(pts - pts.mean(0))


def _unscanned_in_radius(win, pts, radius, b: int) -> int:
    """In-radius (query, reference) pairs of block ``b`` (radius shrunk by
    1e-4, clear of rounding at the cell edge) whose reference lies
    outside the positions the block scans."""
    m = len(pts)
    pos_of = torch.empty(m, dtype=torch.int64)
    pos_of[win.idxarr[:m].long()] = torch.arange(m)
    q = win.qpos[b * win.block:(b + 1) * win.block]
    _, ref = torch.nonzero(torch.cdist(q, pts) <= radius * (1 - 1e-4), as_tuple=True)
    lo = int(win.wmeta[0, b])
    scan = int(hc._scan_len(win.wmeta[1, b:b + 1], CHUNK, win.window)[0])
    pos = pos_of[ref]
    return int(((pos < lo) | (pos >= lo + scan)).sum())


def test_kernel1_window_holds_the_wide_block():
    pts = _strip()
    grid = build_hash_grid(pts, PATCH_RADIUS)
    fixed = hc.window_prologue(pts, grid, 512, WINDOW)
    fitted = hc.window_prologue(pts, grid, 512, WINDOW, fit_chunk=CHUNK)
    assert int(fixed.overflow) > 0 and int(fitted.overflow) == 0
    assert fitted.window > WINDOW and fitted.window % CHUNK == 0
    b = int(fitted.wmeta[1].argmax())  # a block crossing x-slabs mid-strip
    assert _unscanned_in_radius(fixed, pts, PATCH_RADIUS, b) > 0
    assert _unscanned_in_radius(fitted, pts, PATCH_RADIUS, b) == 0
    # Blocks within the fixed window scan the same positions.
    same = fitted.wmeta[1] <= WINDOW
    assert torch.equal(fixed.wmeta[:, same], fitted.wmeta[:, same])
    assert torch.equal(fixed.qpos, fitted.qpos) and torch.equal(fixed.qrow, fitted.qrow)
    # The truncated block samples differently; the fitted one keeps only
    # in-radius references (up to the block frame's rounding: this block
    # spans the strip's 130 m, so |q - c|^2 reaches ~4 200 m^2).
    r2 = torch.tensor(PATCH_RADIUS, dtype=torch.float32) ** 2
    (i_f, v_f, x_f), (i_x, v_x, _) = (
        hc.radius_sample_plain(w, hc.block_centres(w), r2, 128, 0, "distance", chunk=CHUNK,
                               blocks=[b]) for w in (fitted, fixed))
    assert not torch.equal(torch.where(v_f, i_f, -1), torch.where(v_x, i_x, -1))
    q = fitted.qpos[b * 512:(b + 1) * 512]
    d = torch.linalg.norm(x_f - q[:, None, :], dim=-1)
    assert float(d[v_f].max()) <= PATCH_RADIUS * (1 + 1e-3)


def test_kernel2_fitted_window_is_exact():
    """Kernel 2's plain version on the strip thinned to 12.5 points per
    m^2, radius 0.8 m and a 4 096-position window: the fixed window misses
    or misplaces nearest neighbours, the fitted one returns the exact
    in-radius 1-NN (float64 k-d tree; kernel 2's uncentred score rounds
    at ~ulp(|q|^2 + |r|^2), 1e-3 m^2 at these 65 m coordinates, so the
    chosen neighbour's squared distance is held to 2e-3 m^2 above the
    nearest's)."""
    from scipy.spatial import cKDTree

    pts = _strip()[::8].contiguous()
    radius = 0.8
    grid = build_hash_grid(pts, radius)
    p64 = pts.double().numpy()
    best, _ = cKDTree(p64).query(p64, k=2)
    best = best[:, 1]
    res = {}
    for fit in (False, True):
        d, i, ov = hc.hash_grid_knn_window(pts, grid, radius, 1, window=4096, chunk=512,
                                           exclude_self=True, fit=fit)
        found = torch.isfinite(d[:, 0]).numpy()
        got = np.linalg.norm(p64[i[:, 0].long().numpy()] - p64, axis=1)
        inside = best < radius - 1e-3
        wrong = (inside & ~found) | (found & (got ** 2 > best ** 2 + 2e-3))
        res[fit] = (int(ov), int(wrong.sum()), found, got)
    assert res[False][0] > 0 and res[False][1] > 0
    assert res[True][0] == 0 and res[True][1] == 0
    found = res[True][2]
    assert not (found & (best > radius + 1e-3)).any()


def test_main_path_callers_fit_their_windows(monkeypatch):
    """The fusion step's grid callers ask for a fitted window: the radius
    loops (kernel 2), the DIPs sampler and the supervoxel graph (kernel 1)."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.ops import hashgrid, supervoxel
    from fusion4landslide_tpu_torch.pipelines import f2s3

    seen = []
    orig = hc.window_prologue

    def spy(*a, **kw):
        seen.append(kw.get("fit_chunk"))
        return orig(*a, **kw)

    monkeypatch.setattr(hc, "window_prologue", spy)
    monkeypatch.setattr(f2s3, "window_prologue", spy)
    pts = _strip()[:9000].contiguous()
    mask = torch.ones(len(pts), dtype=torch.bool)
    hashgrid.median_nn_distance_traced(pts, mask)
    hashgrid.knn_grid_traced(pts[:600], pts, 1, r0=0.2, r_max=0.2, max_doublings=1)
    supervoxel.supervoxel_graph(pts, 0.3, mask)
    dips, _ = seeded_models(0, "cpu")
    f2s3.compute_dips_features(dips, pts[:600], pts, 0.3, patch_points=128, chunk=512)
    assert len(seen) >= 4 and all(c == CHUNK for c in seen), seen


# ---- F6: the host tile's grid callers ------------------------------------

#: A 4 m x 30 m piece of the strip (12 000 points within 15 m of the
#: origin, where kernel 2's uncentred score rounds at ~6e-5 m^2). Its
#: windows at the median's first radius (0.4 m) reach 5 004 positions;
#: the 32 768 of a real launch needs a strip of ~200 m, whose 100 m
#: coordinates round the score at the size of a neighbour's own d^2, so
#: the witness shrinks the window instead, as the kernel-2 test above does.
PIECE_M = 30.0
SHRUNK = dict(window=2048, chunk=512)


def _launch_window(monkeypatch, *, fixed: bool, **size):
    """Kernel 2's window behind ``ops.hashgrid.hash_grid_knn`` resized by
    ``size``; ``fixed`` drops the callers' ``fit``, as before the repair."""
    from fusion4landslide_tpu_torch.ops import hashgrid

    def launch(*a, fit=False, **kw):
        return hc.hash_grid_knn_window(*a, fit=fit and not fixed, **{**kw, **size})

    monkeypatch.setattr(hashgrid, "hash_grid_knn_window", launch)


def _uncentred_atol(*clouds: torch.Tensor) -> float:
    """Two ulps of the largest |r|^2 (``tests/test_torch_kernels.py``'s
    bound off the terrain): kernel 2 rounds its uncentred score there."""
    return 2 * 2.0**-23 * max(float((c.double() ** 2).sum(1).max()) for c in clouds)


def _jax_median(pts: torch.Tensor) -> float:
    """The JAX package's median resolution on the CPU: its exact
    brute-force 1-NN, no grid."""
    import jax.numpy as jnp

    from fusion4landslide_tpu.ops.knn import median_nn_distance

    return float(median_nn_distance(jnp.asarray(pts.numpy())))


def test_host_median_is_exact_past_the_window(monkeypatch):
    from fusion4landslide_tpu_torch.ops.knn import median_nn_distance

    pts = _strip(length=PIECE_M)
    exact, atol = _jax_median(pts), _uncentred_atol(pts)
    _launch_window(monkeypatch, fixed=False, **SHRUNK)
    got = float(median_nn_distance(pts))
    assert abs(got**2 - exact**2) <= atol

    from fusion4landslide_tpu_torch.ops.knn import median_nn_distance_counted

    assert median_nn_distance_counted(pts)[1] == 0
    _launch_window(monkeypatch, fixed=True, **SHRUNK)
    cut, cut_ov = median_nn_distance_counted(pts)
    # A truncated block misses in-radius neighbours: far past rounding.
    assert cut_ov > 0 and abs(float(cut) ** 2 - exact**2) > 10 * atol


def test_host_median_unchanged_where_the_window_holds(monkeypatch):
    from fusion4landslide_tpu_torch.ops.knn import median_nn_distance_counted

    pts = _strip(length=PIECE_M)
    got, ov = median_nn_distance_counted(pts)
    _launch_window(monkeypatch, fixed=True)
    before, before_ov = median_nn_distance_counted(pts)
    assert ov == before_ov == 0 and torch.equal(got, before)
    assert abs(float(got) ** 2 - _jax_median(pts) ** 2) <= _uncentred_atol(pts)


#: The re-association's radius: at the 1M tile its grid's cell grows to
#: 0.45-0.51 m whatever the radius (the cell table holds 2^21 cells).
REASSOC_RADIUS = 0.4


def _reassociation_case():
    """Moved points (another draw of the same slope) against the target
    piece, and the exact answer: the JAX gather join, with every cell run
    inside its cap."""
    import jax.numpy as jnp

    from fusion4landslide_tpu.ops import hashgrid as jhg

    tgt = _strip(length=PIECE_M)
    q = _strip(seed=1, length=PIECE_M)
    jgrid = jhg.build_hash_grid(jnp.asarray(tgt.numpy()), REASSOC_RADIUS)
    jd, ji, jov = jhg._hash_grid_knn_xla(jnp.asarray(q.numpy()), jgrid, REASSOC_RADIUS, 1,
                                         cap=64)
    assert int(jov) == 0
    return tgt, q, torch.from_numpy(np.array(jd)[:, 0]), torch.from_numpy(np.array(ji)[:, 0])


def _reassociation_misses(tgt, q, d2, idx, jd, ji, atol: float) -> int:
    """Rows whose pick is not the exact 1-NN: found where the join finds
    none or the reverse (away from the radius by more than ``atol``), or a
    neighbour farther (float64) than the join's by more than ``atol``."""
    p64, q64 = tgt.double(), q.double()
    d_got = ((p64[idx.long()] - q64) ** 2).sum(1)
    d_exact = ((p64[ji.long()] - q64) ** 2).sum(1)
    found, j_found = torch.isfinite(d2), torch.isfinite(jd)
    edge = (d_exact - REASSOC_RADIUS**2).abs() <= atol
    both = found & j_found
    return int(((found != j_found) & ~edge).sum() + (d_got[both] > d_exact[both] + atol).sum())


def test_sparse_reassociation_is_exact_past_the_window(monkeypatch):
    from fusion4landslide_tpu_torch.pipelines.fusion import sparse_assign_core

    tgt, q, jd, ji = _reassociation_case()
    atol = _uncentred_atol(tgt, q)
    _launch_window(monkeypatch, fixed=True, **SHRUNK)
    d2_cut, i_cut, cut_ov = sparse_assign_core(tgt, q, REASSOC_RADIUS)
    _launch_window(monkeypatch, fixed=False, **SHRUNK)
    d2, idx, ov = sparse_assign_core(tgt, q, REASSOC_RADIUS)
    assert cut_ov > 0 and ov == 0
    assert _reassociation_misses(tgt, q, d2_cut, i_cut, jd, ji, atol) > 100
    assert _reassociation_misses(tgt, q, d2, idx, jd, ji, atol) == 0


def test_sparse_reassociation_unchanged_where_the_window_holds(monkeypatch):
    from fusion4landslide_tpu_torch.pipelines.fusion import sparse_assign_core

    tgt, q, jd, ji = _reassociation_case()
    d2, idx, ov = sparse_assign_core(tgt, q, REASSOC_RADIUS)
    _launch_window(monkeypatch, fixed=True)
    d2_before, i_before, before_ov = sparse_assign_core(tgt, q, REASSOC_RADIUS)
    assert ov == before_ov == 0
    assert torch.equal(d2, d2_before) and torch.equal(idx, i_before)
    assert _reassociation_misses(tgt, q, d2, idx, jd, ji, _uncentred_atol(tgt, q)) == 0


# ---- phase 10's epoch: one tile at the shipped size ------------------------


def test_driver_epoch_is_one_shipped_size_tile(smoke, tmp_path):
    """The tiler and voxel filter ``main_fusion`` runs on phase 10's epoch
    files, with ``fusion_brienz.yaml``'s settings (no tile step)."""
    from fusion4landslide_tpu_torch.io.ply import read_ply
    from fusion4landslide_tpu_torch.synth import IMG_SIZE
    from fusion4landslide_tpu_torch.tiling import tile_point_clouds

    cfg = load_yaml(str(ROOT / "configs" / "landslide" / "fusion_brienz.yaml"))
    assert int(cfg["max_pts_per_tile"]) == 1_000_000
    src, _, pix, m_per_px = smoke.write_rgb_epoch(str(tmp_path), *smoke.FULL_TILE_EPOCH)
    raw = [str(tmp_path / "raw_pcd" / f"epoch{e}.ply") for e in (1, 2)]
    tiles = str(tmp_path / "tiles")
    n = tile_point_clouds(*raw, int(cfg["max_pts_per_tile"]), int(cfg["min_pts_per_tile"]),
                          True, float(cfg["voxel_size_init"]), 0.0, -1, tiles, halo=20.0)
    assert n == 1
    for side in ("source", "target"):
        k = len(read_ply(os.path.join(tiles, "non_overlap", f"{side}_tile_0.ply")).points)
        assert 950_000 <= k <= 1_000_000, (side, k)
    assert len(src) == 1_345_600 and 0.3 < len(pix) / len(src) < 0.6
    assert np.isfinite(pix).all() and (pix >= 0).all() and (pix < IMG_SIZE[0]).all()
    assert 0.02 < m_per_px < 0.05
    saved = np.loadtxt(tmp_path / "img_matching_results" / "pixel_matches.txt", ndmin=2)
    assert saved.shape == pix.shape and np.abs(saved - pix).max() <= 1e-6 + 1e-6 * IMG_SIZE[0]
