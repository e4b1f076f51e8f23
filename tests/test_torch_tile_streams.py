"""One tile stream per device entry (``parallel/pipeline.py``): the
runners with ``devices=["cpu", "cpu"]`` (two worker threads, each with
its own model copies) write and return exactly what their one-stream run
does; the F2S3 and piecewise runners on two streams stay within the
runner tolerances of the JAX package's ``run_*_tiles_sharded`` on a
2-device CPU mesh (the F2S3 step on its TPU branch, emulated); a
launch-counter and tile-order stress; and the drivers' ``use_mesh: auto``
choice under a patched device count.

Tolerances: two streams equal one stream exactly (arrays and table
bytes); against JAX, the F2S3 tables as ``tests/test_torch_f2s3_host.py``
scores the host tile (>= 97% of written rows shared, median DVF gap
< 1e-4 m, <= 1% over 10 mm) and piecewise within 1e-6 m."""

import functools
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.parallel import pipeline as tp
from fusion4landslide_tpu_torch.synth import synth_split_tile

CPU2 = ["cpu", "cpu"]


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


def tables(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def assert_results_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for tid in a:
        assert sorted(a[tid]) == sorted(b[tid])
        for k, v in a[tid].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[tid][k])
            else:
                assert v == b[tid][k], (tid, k)


def two_tiles(n_core=300):
    tiles = []
    for i, seed in enumerate((0, 1)):
        src, tgt, _, _ = synth_split_tile(n_core, 1.0, 1.0, halo=2.0, seed=seed)
        tiles.append((str(i), src + [40.0 * i, 0.0, 0.0], tgt + [40.0 * i, 0.0, 0.0]))
    return tiles


F2S3_CFG = {"output_folder": "run", "voxel_size": 0.1, "max_disp_magnitude": 5.0,
            "filter_median_magnitude": True, "fill_gaps_c2c": True, "refine_results": True,
            "n_normals": 30, "small_patch_removal": True, "feat_patch_points": 128,
            "feat_chunk": 512, "member_cap": 256}


def test_f2s3_two_streams_equal_one_and_hold_to_the_jax_mesh(tmp_path, tpu_branch):
    from fusion4landslide_tpu.models.dips import PointNetFeature
    from fusion4landslide_tpu.models.filtering import FilteringNetwork
    from fusion4landslide_tpu.parallel.mesh import tile_mesh
    from fusion4landslide_tpu.parallel.pipeline import run_f2s3_tiles_sharded
    from fusion4landslide_tpu_torch.models import dips as tdips
    from fusion4landslide_tpu_torch.models.convert import filter_from_flax, state_dict_from_flax

    dips = jax.tree.map(np.asarray, PointNetFeature().init(
        jax.random.PRNGKey(0), np.zeros((2, 128, 3), np.float32)))
    filt = jax.tree.map(np.asarray, FilteringNetwork().init(
        jax.random.PRNGKey(2), np.zeros((2, 8, 6), np.float32), np.ones((2, 8), bool)))
    td = tdips.PointNetFeature()
    td.load_state_dict(state_dict_from_flax(dips))
    tf = filter_from_flax(filt)
    tiles = two_tiles()
    runs = {}
    for name, kw in (("one", dict(device="cpu")), ("two", dict(devices=CPU2))):
        timings: dict = {}
        runs[name] = tp.run_f2s3_tiles({**F2S3_CFG, "output_dir": str(tmp_path / name)}, td, tf,
                                       iter(tiles), timings=timings, **kw)
        assert timings["dips_features"] > 0
    assert_results_equal(runs["one"], runs["two"])
    assert tables(tmp_path / "one") == tables(tmp_path / "two")
    assert len(tables(tmp_path / "one")) == 12

    jr = run_f2s3_tiles_sharded({**F2S3_CFG, "output_dir": str(tmp_path / "jax")}, dips, filt,
                                tiles, mesh=tile_mesh(2))
    assert sorted(jr) == ["0", "1"]
    assert sorted(tables(tmp_path / "jax")) == sorted(tables(tmp_path / "two"))
    # JAX's runner adds its tiles' float32 centres back (the port's are
    # float64), so rows pair by source point within 1e-5 m.
    from scipy.spatial import cKDTree

    for tid, _, _ in tiles:
        jt, tt = jr[tid]["dvfs"], runs["two"][tid]["dvfs"]
        dist, near = cKDTree(jt[:, :3]).query(tt[:, :3])
        rows = dist <= 1e-5
        assert len(tt) > 0 and rows.mean() >= 0.97 and len(jt) <= len(tt) / 0.97
        gap = np.linalg.norm(jt[near[rows], 3:] - tt[rows, 3:], axis=1)
        assert np.median(gap) < 1e-4 and (gap > 0.01).mean() <= 0.01


def test_piecewise_two_streams_equal_one_and_the_jax_mesh(tmp_path):
    from fusion4landslide_tpu.parallel.mesh import tile_mesh
    from fusion4landslide_tpu.parallel.pipeline import run_piecewise_tiles_sharded
    from test_torch_piecewise import epoch_pair

    rng = np.random.default_rng(8)
    tiles = []
    for i, (n, w) in enumerate(((3000, 30.0), (2000, 20.0), (2500, 25.0))):
        s, t = epoch_pair(rng, n=n, width=w, offset=(1000.0 * i, 0.0, 0.0))
        tiles.append((str(i), s, t[: n - 37 * i]))
    cfg = {"smax": 5.0, "number_points_min": 10, "dataset": "brienz_tls", "output_folder": "run"}
    one = tp.run_piecewise_tiles(dict(cfg, output_dir=str(tmp_path / "one")), tiles, device="cpu")
    two = tp.run_piecewise_tiles(dict(cfg, output_dir=str(tmp_path / "two")), tiles,
                                 devices=CPU2)
    assert_results_equal(one, two)
    assert tables(tmp_path / "one") == tables(tmp_path / "two")
    jr = run_piecewise_tiles_sharded(dict(cfg, output_dir=str(tmp_path / "jax")), tiles,
                                     mesh=tile_mesh(2))
    jax.clear_caches()
    assert list(two) == ["0", "1", "2"] and sorted(jr) == sorted(two)
    for tid in two:
        assert two[tid]["dvfs"].shape == jr[tid]["dvfs"].shape
        np.testing.assert_allclose(two[tid]["dvfs"], jr[tid]["dvfs"], atol=1e-6, rtol=0)


def test_fusion_and_rgb_guided_two_streams_equal_one(tmp_path):
    """The 3D-only fusion runner and the RGB-guided runner (its image
    matches copied to each stream)."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from test_torch_fusion_host import CFG
    from test_torch_rgb_guided import H, K, W, textured_scene

    dips, agg = seeded_models(0, "cpu")
    tiles = two_tiles(250)
    cfg = {**CFG, "return_interim": False}
    one = tp.run_fusion3d_tiles({**cfg, "output_dir": str(tmp_path / "f1")}, dips, agg, tiles,
                                device="cpu")
    two = tp.run_fusion3d_tiles({**cfg, "output_dir": str(tmp_path / "f2")}, dips, agg, tiles,
                                devices=CPU2)
    assert_results_equal(one, two)
    assert tables(tmp_path / "f1") == tables(tmp_path / "f2")
    assert all(r["valid"].any() for r in two.values())

    src, tgt, img0, img1, E = textured_scene(np.random.default_rng(1), n=1500)
    half = src[:, 1] > 0
    rg_tiles = [("0", src[half], tgt[half]), ("1", src[~half], tgt[~half])]
    cfg = {"image_size": [H, W], "pixel_thres": 4, "max_magnitude": 2.0, "n_normals": 15,
           "img_matching_type": "zncc", "dataset": "rockfall_simulator", "output_folder": "run"}
    runs = [tp.run_rgb_guided_tiles({**cfg, "output_dir": str(tmp_path / f"r{i}")}, rg_tiles,
                                    img0, img1, K, E, E, **kw)
            for i, kw in enumerate((dict(device="cpu"), dict(devices=CPU2)))]
    assert_results_equal(*runs)
    assert tables(tmp_path / "r0") == tables(tmp_path / "r1")
    assert all(r["n_matches"] > 0 for r in runs[1].values())


def test_streams_stress_order_counts_and_failure():
    """More streams than cores over many short tiles with a shortened
    switch interval: every tile once, results in tile order, no launch
    count lost; a failing tile stops the streams and raises."""
    from fusion4landslide_tpu_torch.ops import cuda_build

    seen, lock = [], threading.Lock()
    n_streams = 2 * (os.cpu_count() or 1) + 3
    before = cuda_build.LAUNCHES["grid_knn"]

    def run_tile(state, dev, tile, timings):
        for _ in range(50):
            cuda_build.count_launch("grid_knn")
        with lock:
            seen.append(tile[0])
        timings["work"] = timings.get("work", 0.0) + 1.0
        return {"id": tile[0], "state": state}

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        timings: dict = {}
        t0 = time.perf_counter()
        out = tp._run_streams(((i, None, None) for i in range(400)),
                              [torch.device("cpu")] * n_streams,
                              lambda dev, own: ("own" if own else "shared"), run_tile, timings)
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
        launched = cuda_build.LAUNCHES["grid_knn"] - before
        cuda_build.LAUNCHES["grid_knn"] = before
    assert list(out) == list(range(400)) and sorted(seen) == list(range(400))
    assert all(v == {"id": k, "state": "own"} for k, v in out.items())
    assert launched == 400 * 50 and timings == {"work": 400.0}

    def failing(state, dev, tile, timings):
        if tile[0] == 5:
            raise ValueError("tile 5 failed")
        time.sleep(0.001)
        return tile[0]

    pulled = []
    with pytest.raises(ValueError, match="tile 5"):
        tp._run_streams((pulled.append(i) or (i, None, None) for i in range(10_000)),
                        [torch.device("cpu")] * 4, lambda dev, own: None, failing, None)
    assert len(pulled) < 10_000


def test_resolve_devices(monkeypatch):
    assert tp.resolve_devices(None, "cpu") == [torch.device("cpu")]
    assert tp.resolve_devices(CPU2) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        tp.resolve_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.resolve_devices(["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tp.resolve_devices(["cuda", "cuda:1", "cuda:1"]) == [
        torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="2 CUDA device"):
        tp.resolve_devices(["cuda:0", "cuda:2"])


def test_drivers_auto_choice_follows_the_device_count(tmp_path, monkeypatch):
    """``stream_devices``: every GPU for ``cuda``, the one device
    otherwise. ``use_mesh: auto`` takes the runner over those devices
    where there are several devices and several tiles (JAX's condition),
    the host tiles otherwise."""
    from fusion4landslide_tpu_torch import main_f2s3, main_fusion, main_piecewise_icp
    from fusion4landslide_tpu_torch.pipelines import driver
    from test_torch_driver import SMALL, write_run

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert driver.stream_devices(torch.device("cuda")) == [torch.device("cuda", 0),
                                                          torch.device("cuda", 1)]
    assert driver.stream_devices(torch.device("cpu")) == [torch.device("cpu")]
    assert driver.stream_devices(torch.device("cuda", 1)) == [torch.device("cuda", 1)]

    cfg = write_run(tmp_path, "piecewise_icp_brienz.yaml", "pw1", None, smax=1.0,
                    number_points_min=5, max_pts_per_tile=3000, min_pts_per_tile=100,
                    tile_halo=2.0)
    host = main_piecewise_icp.main(["--config", cfg, "--device", "cpu"])
    assert len(host["tile_s"]) == 2 and "runner_s" not in host
    for mod in (main_piecewise_icp, main_f2s3, main_fusion):
        monkeypatch.setattr(mod, "stream_devices", lambda dev: [dev, dev])
    cfg = write_run(tmp_path, "piecewise_icp_brienz.yaml", "pw2", None, smax=1.0,
                    number_points_min=5, max_pts_per_tile=3000, min_pts_per_tile=100,
                    tile_halo=2.0)
    streams = main_piecewise_icp.main(["--config", cfg, "--device", "cpu"])
    assert not streams["tile_s"] and "runner_s" in streams
    res = [tmp_path / out / "demo_run" / "results" for out in ("pw1", "pw2")]
    assert tables(res[0]) == tables(res[1]) and len(tables(res[0])) == 6

    calls = []

    def fake_runner(cfg, *args, **kw):
        calls.append(kw["devices"])
        return {}

    monkeypatch.setattr(tp, "run_f2s3_tiles", fake_runner)
    monkeypatch.setattr(tp, "run_fusion3d_tiles", fake_runner)
    from fusion4landslide_tpu_torch.models.convert import (
        seeded_filter,
        seeded_models,
        write_reference_checkpoints,
    )

    weights = tmp_path / "w"
    dips, agg = seeded_models(0, "cpu")
    write_reference_checkpoints(str(weights), dips=dips, agg=agg, filt=seeded_filter(0, "cpu"))
    main_f2s3.main(["--config", write_run(tmp_path, "f2s3_brienz.yaml", "f", weights, **SMALL),
                    "--device", "cpu"])
    main_fusion.main(["--config", write_run(tmp_path, "fusion_3d_brienz.yaml", "g", weights,
                                            **SMALL), "--device", "cpu"])
    assert calls == [[torch.device("cpu")] * 2] * 2
