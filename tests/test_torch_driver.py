"""The port's driver layer vs the JAX package's: config loading, point-
cloud I/O, tiling, the tile plumbing of ``pipelines.driver``, camera
metadata, and the ``main_f2s3`` entry point end to end on a tiny two-tile
epoch (``--device cpu``); ``main_fusion`` against the JAX driver is in
``tests/test_torch_driver_fusion.py``.
"""

import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
import yaml

from fusion4landslide_tpu_torch.synth import synth_epoch_pair

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "configs" / "landslide" / "*.yaml")))


def test_load_yaml_matches_jax_and_safe_load():
    from fusion4landslide_tpu.config import load_yaml as j_load
    from fusion4landslide_tpu_torch.config import load_yaml

    assert len(CONFIGS) >= 6
    for path in CONFIGS:
        with open(path) as f:
            raw = yaml.safe_load(f)
        flat = {}
        for v in raw.values():
            flat.update(v)
        for keep in (False, True):
            cfg = load_yaml(path, keep_sub_directory=keep)
            assert cfg == j_load(path, keep_sub_directory=keep)
            assert {k: v for k, v in cfg.items() if k not in raw or not keep} == flat
        assert cfg.max_pts_per_tile == 1_000_000
        with pytest.raises(AttributeError):
            cfg.no_such_key


def test_ply_and_las_io_match_jax(tmp_path, rng):
    from fusion4landslide_tpu.io import read_point_cloud as j_read
    from fusion4landslide_tpu.io.ply import ply_vertex_count as j_count
    from fusion4landslide_tpu.io.ply import write_ply as j_write
    from fusion4landslide_tpu_torch.io import read_point_cloud
    from fusion4landslide_tpu_torch.io.ply import ply_vertex_count, write_ply

    sys.path.insert(0, str(ROOT / "tests"))
    from test_las import write_las12

    pts = rng.normal(size=(257, 3)) * 100
    rgb = rng.integers(0, 256, size=(257, 3)).astype(np.uint8)
    for kw in ({}, {"ascii_format": True}, {"coord_dtype": "f4"}):
        for colors in (None, rgb):
            a, b = tmp_path / "jax.ply", tmp_path / "port.ply"
            j_write(str(a), pts, colors, **kw)
            write_ply(str(b), pts, colors, **kw)
            assert a.read_bytes() == b.read_bytes()
            assert ply_vertex_count(str(b)) == j_count(str(a)) == 257
            pj, pt = j_read(str(a)), read_point_cloud(str(a))
            np.testing.assert_array_equal(pj.points, pt.points)
            assert (pj.colors is None) == (pt.colors is None)
            if colors is not None:
                np.testing.assert_array_equal(pj.colors, pt.colors)
    write_las12(str(tmp_path / "c.las"), pts, rgb=rgb.astype(np.uint16) * 257)
    lj, lt = j_read(str(tmp_path / "c.las")), read_point_cloud(str(tmp_path / "c.las"))
    np.testing.assert_array_equal(lj.points, lt.points)
    np.testing.assert_array_equal(lj.colors, lt.colors)
    np.testing.assert_array_equal(lj.extras["intensity"], lt.extras["intensity"])
    (tmp_path / "bad.ply").write_bytes(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        read_point_cloud(str(tmp_path / "bad.ply"))
    # E57 epochs read as the JAX package reads them (tests/test_torch_e57.py).
    from fusion4landslide_tpu_torch.io.e57 import write_e57

    write_e57(str(tmp_path / "epoch.e57"), pts, colors=rgb)
    ej, et = j_read(str(tmp_path / "epoch.e57")), read_point_cloud(str(tmp_path / "epoch.e57"))
    np.testing.assert_array_equal(ej.points, et.points)
    np.testing.assert_array_equal(ej.colors, et.colors)


def test_tiling_matches_jax(tmp_path):
    from fusion4landslide_tpu.tiling import tile_epoch_pair as j_tile
    from fusion4landslide_tpu.tiling import tile_point_clouds as j_files
    from fusion4landslide_tpu_torch.io.ply import write_ply
    from fusion4landslide_tpu_torch.tiling import tile_epoch_pair, tile_point_clouds

    src, tgt, _ = synth_epoch_pair(24, 10, density=40.0, seed=2, offset=(2.6e6, 1.2e6, 500.0))
    for voxel in (None, 0.1, 0.0):
        jt, *jrest = j_tile(src, tgt, 3000, 100, voxel_size=voxel, halo=2.0)
        tt, *trest = tile_epoch_pair(src, tgt, 3000, 100, voxel_size=voxel, halo=2.0)
        assert len(jt) == len(tt) >= 3
        for a, b in zip(jt, tt):
            for f in ("src_idx", "tgt_idx", "src_halo_idx", "tgt_halo_idx", "bbox_min",
                      "bbox_max"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(jrest[0], trest[0])
    write_ply(str(tmp_path / "s.ply"), src)
    write_ply(str(tmp_path / "t.ply"), tgt)
    nj = j_files(str(tmp_path / "s.ply"), str(tmp_path / "t.ply"), 3000, 100, True, 0.1, 0.0, -1,
                 str(tmp_path / "jax"), halo=2.0)
    nt = tile_point_clouds(str(tmp_path / "s.ply"), str(tmp_path / "t.ply"), 3000, 100, True, 0.1,
                           0.0, -1, str(tmp_path / "port"), halo=2.0)
    assert nj == nt >= 3
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.ply"))
    assert len(files) == 4 * nt
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


def _tiled_dir(tmp_path, n_tiles_min=2):
    """A tiled tiny epoch under ``tmp_path / 'tiles'`` (JAX tiler)."""
    from fusion4landslide_tpu.tiling import tile_point_clouds
    from fusion4landslide_tpu_torch.io.ply import write_ply

    src, tgt, _ = synth_epoch_pair(16, 8, density=60.0, seed=4)
    write_ply(str(tmp_path / "s.ply"), src)
    write_ply(str(tmp_path / "t.ply"), tgt)
    n = tile_point_clouds(str(tmp_path / "s.ply"), str(tmp_path / "t.ply"), 2500, 100, False,
                          0.0, 0.0, -1, str(tmp_path / "tiles"), halo=2.0)
    assert n >= n_tiles_min
    return str(tmp_path / "tiles")


def test_driver_plumbing_matches_jax(tmp_path):
    import logging

    from fusion4landslide_tpu.pipelines import driver as jd
    from fusion4landslide_tpu_torch.pipelines import driver as td

    log = logging.getLogger("test_torch_driver")
    for cfg in ({}, {"max_magnitude": 5}, {"max_magnitude": 0.5, "tile_halo": 2.0},
                {"max_disp_magnitude": 1.0, "tile_halo": 2.0}, {"halo_src_margin": 1.0},
                {"max_magnitude": 1.0, "halo_query_split": False},
                {"max_magnitude": 0.4, "halo_tgt_margin": 0.3, "tile_halo": 2.0}):
        assert td.halo_split_spec(cfg) == jd.halo_split_spec(cfg)
    for args in ((1000, 5000, 20.0, 5.0), (1000, 900, 20.0, 5.0), (500, 4000, 2.0, 0.5),
                 (10, 4000, 0.0, 0.5)):
        assert td._split_count_estimate(*args) == jd._split_count_estimate(*args)

    from fusion4landslide_tpu_torch.config import Config

    tdir = _tiled_dir(tmp_path)
    cfg = Config(tile_dir=tdir, output_root=str(tmp_path / "out"))
    tiles = td.list_tiles(cfg)
    assert tiles == jd.list_tiles(cfg) and len(tiles) >= 2
    assert td.list_tiles(cfg, overlap=False) == jd.list_tiles(cfg, overlap=False)
    split = (0.5, 1.0)
    for sp in (None, split):
        assert td.tile_size_buckets(tiles, split=sp, halo=2.0) == \
            jd.tile_size_buckets(tiles, split=sp, halo=2.0)
    budgets = td.tile_size_buckets(tiles, split=split, halo=2.0)
    for kw in ({}, {"split": split}, {"split": split, "budgets": budgets},
               {"split": split, "budgets": (64, 64)}):
        got = list(td.iter_tile_clouds(tiles, logger=log, **kw))
        ref = list(jd.iter_tile_clouds(tiles, logger=log, **kw))
        assert [g[0] for g in got] == [r[0] for r in ref]
        for (_, gs, gt), (_, rs, rt) in zip(got, ref):
            np.testing.assert_array_equal(gs.points, rs.points)
            np.testing.assert_array_equal(gt.points, rt.points)
    cloud = got[0][1]
    lo, hi = cloud.points.min(0) + 1.0, cloud.points.max(0) - 1.0
    for margin, budget in ((0.3, None), (0.3, 50), (5.0, None), (0.0, 10)):
        a = td.crop_cloud_to_core(cloud, lo, hi, margin, budget)
        b = jd.crop_cloud_to_core(cloud, lo, hi, margin, budget)
        np.testing.assert_array_equal(a.points, b.points)

    res = tmp_path / "out" / "results"
    res.mkdir(parents=True)
    (res / f"c2f_dvfms_src2tgt_tile_{tiles[0][0]}.txt").write_text("")
    marker = "c2f_dvfms_src2tgt_tile_{tile}.txt"
    for extra in ({}, {"overwrite_results": True}, {"continue_tile": 1},
                  {"tile_shard_count": 2, "tile_shard_index": 1}):
        c = Config({**cfg, **extra})
        assert td.skip_completed_tiles(c, tiles, marker, log) == \
            jd.skip_completed_tiles(c, tiles, marker, log)

    calls = []

    def compute():
        calls.append(1)
        return {"src_feat": torch.arange(6.0).reshape(3, 2), "tgt_feat": np.ones((2, 2))}

    c = {"output_root": str(tmp_path / "out"), "save_interim": True}
    first = td.load_or_compute_features(c, 7, "features", compute, log)
    cached = td.load_or_compute_features({**c, "point_feat_compute": False}, 7, "features",
                                         compute, log)
    assert len(calls) == 1
    np.testing.assert_array_equal(cached["src_feat"], first["src_feat"].numpy())
    ref = jd.load_or_compute_features({**c, "point_feat_compute": False}, 7, "features",
                                      compute, log)
    np.testing.assert_array_equal(ref["tgt_feat"], cached["tgt_feat"])


def test_camera_metadata_matches_jax(tmp_path):
    from fusion4landslide_tpu.image import cameras as jc
    from fusion4landslide_tpu_torch.image import cameras as tc

    rng = np.random.default_rng(7)
    tdir = tmp_path / "image" / "transformations"
    tdir.mkdir(parents=True)
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    np.savetxt(tmp_path / "image" / "camera_intrinsic.txt", K, delimiter=" ")
    poses = []
    for i in range(4):
        pose = np.eye(4)
        pose[:3, :3] = jc.quaternion_to_rotation_matrix(rng.normal(size=4))
        pose[:3, 3] = rng.normal(size=3) * 10
        poses.append(pose)
    np.savetxt(tdir / "pose_epoch1.txt", poses[0], delimiter=" ")
    np.savetxt(tdir / "pose_epoch2.txt", poses[1], delimiter=" ")
    for e in (1, 2):
        np.savetxt(tdir / f"camera_extrinsic_epoch_{e}.txt", rng.normal(size=7)[None])
    with open(tdir / "Images_used.txt", "w") as f:
        for i, pose in enumerate(poses):
            f.write(f"2002{i}_img.jpg\n" + " ".join(map(str, pose[:3, 3])) + "\n")
            for row in pose[:3, :3]:
                f.write(" ".join(map(str, row)) + "\n")
    root = str(tmp_path)
    np.testing.assert_array_equal(tc.load_intrinsic(root), jc.load_intrinsic(root))
    for a, b in zip(tc.load_intrinsic_pair(root), jc.load_intrinsic_pair(root)):
        np.testing.assert_array_equal(a, b)
    for ds in ("brienz_tls", "rockfall_simulator"):
        kw = dict(src_pose="pose_epoch1.txt", tgt_pose="pose_epoch2.txt")
        for a, b in zip(tc.load_extrinsics(root, ds, **kw), jc.load_extrinsics(root, ds, **kw)):
            np.testing.assert_allclose(a, b, atol=1e-12)
    with pytest.raises(NotImplementedError):
        tc.load_extrinsics(root, "mattertal")
    entries_t, entries_j = tc.load_images_used(root), jc.load_images_used(root)
    assert [n for n, _ in entries_t] == [n for n, _ in entries_j]
    for (_, a), (_, b) in zip(entries_t, entries_j):
        np.testing.assert_allclose(a, b, atol=1e-12)
    # Cameras looking down at a patch from 4 places: in-frame counts.
    pts = rng.uniform(-5, 5, size=(3000, 3))
    exts = []
    for dx in (0.0, 3.0, 6.0, 20.0):
        E = np.eye(4)
        E[:3, 3] = [-dx, 0.0, 15.0]
        exts.append(E)
    exts = np.stack(exts)
    got = tc.count_in_frame(pts, exts, K, (512, 512), device="cpu")
    np.testing.assert_array_equal(got, jc.count_in_frame(pts, exts, K, (512, 512)))
    assert got[0] > got[3]
    entries = [(f"cam{i}", e) for i, e in enumerate(exts)]
    assert [n for n, _ in tc.select_best_images(pts, entries, K, (512, 512), num=2,
                                                device="cpu")] == \
        [n for n, _ in jc.select_best_images(pts, entries, K, (512, 512), num=2)]


#: Small-tile statics and a tiny tiling (two tiles) on top of a shipped config.
SMALL = {
    "level_of_superpoint": [1, 2], "feat_patch_points": 128, "feat_chunk": 512,
    "agg_max_points": 64, "num_min_matches_for_small_patch": 3, "fine_max_matches": 64,
    "max_pts_per_tile": 3000, "min_pts_per_tile": 100, "tile_halo": 2.0,
    "halo_src_margin": 1.0, "halo_tgt_margin": 1.5,
}


def write_run(tmp_path, shipped: str, out_name: str, weight_dir, epoch=(10.0, 6.0),
              **overrides) -> str:
    """A config file: ``configs/landslide/<shipped>`` with the data, output
    and weight paths pointed into ``tmp_path`` and ``overrides`` on top;
    the data an ``epoch`` (width, height) m epoch pair, written once."""
    data = tmp_path / "data"
    if not (data / "raw_pcd").exists():
        from fusion4landslide_tpu_torch.io.ply import write_ply

        (data / "raw_pcd").mkdir(parents=True)
        src, tgt, _ = synth_epoch_pair(*epoch, seed=3, offset=(2.6e6, 1.17e6, 600.0))
        write_ply(str(data / "raw_pcd" / "epoch1.ply"), src)
        write_ply(str(data / "raw_pcd" / "epoch2.ply"), tgt)
    with open(ROOT / "configs" / "landslide" / shipped) as f:
        raw = yaml.safe_load(f)
    raw["overrides"] = {
        "input_root": str(data), "data_dir": str(data), "output_dir": str(tmp_path / out_name),
        "weight_dir": str(weight_dir), "src_pcd": "epoch1.ply", "tgt_pcd": "epoch2.ply",
        "src_name": "epoch1.ply", "tgt_name": "epoch2.ply", **overrides,
    }
    path = tmp_path / f"{out_name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


def _files(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if not f.endswith(".log"))


@pytest.fixture
def seeded_weights(tmp_path):
    """(weight_dir, (port dips, agg, filter)) with reference-format
    checkpoints of seeded random modules."""
    from fusion4landslide_tpu_torch.models.convert import (
        seeded_filter,
        seeded_models,
        write_reference_checkpoints,
    )

    dips, agg = seeded_models(0, "cpu")
    filt = seeded_filter(0, "cpu")
    write_reference_checkpoints(str(tmp_path / "weights"), dips=dips, agg=agg, filt=filt)
    return tmp_path / "weights"


def test_main_f2s3_runs_as_a_module(tmp_path, seeded_weights):
    """``python -m fusion4landslide_tpu_torch.main_f2s3 --device cpu``: both
    tiles' ``f2s3_*`` tables, then a second run that skips them."""
    cfg = write_run(tmp_path, "f2s3_brienz.yaml", "port", seeded_weights, epoch=(6.0, 4.0),
                    **{**{k: v for k, v in SMALL.items() if k.startswith(("min", "tile", "halo"))},
                       "max_pts_per_tile": 1000})
    cmd = [sys.executable, "-m", "fusion4landslide_tpu_torch.main_f2s3", "--config", cfg,
           "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT), env=env)
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    results = tmp_path / "port" / "demo_run" / "results"
    tiles = sorted(p.name for p in (tmp_path / "port" / "demo_run" / "tiled_data" / "overlap")
                   .glob("source_tile_*"))
    assert len(tiles) == 2
    for tid in range(2):
        for name in (f"f2s3_dvfs_of_tile_{tid}.txt", f"f2s3_dvfms_of_tile_{tid}.txt",
                     f"f2s3_dvfms_without_pruning_of_tile_{tid}.txt"):
            assert (results / name).exists(), name
        assert np.isfinite(np.loadtxt(results / f"f2s3_dvfms_of_tile_{tid}.txt")).all()
    assert "run summary:" in first.stdout
    again = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT),
                           env=env)
    assert again.returncode == 0
    assert again.stdout.count("already complete; skipping") == 2


@pytest.mark.parametrize("method", ["fusion", "fusion_rgb", "f2s3"])
def test_use_mesh_true_takes_the_runner(tmp_path, seeded_weights, monkeypatch, method):
    from fusion4landslide_tpu_torch import main_f2s3, main_fusion
    from fusion4landslide_tpu_torch.parallel import pipeline

    calls = []

    def fake_runner(cfg, a, b, tiles, **kw):
        calls.append(([t[0] for t in tiles], kw))
        return {}

    name = "run_f2s3_tiles" if method == "f2s3" else "run_fusion3d_tiles"
    monkeypatch.setattr(pipeline, name, fake_runner)
    shipped = {"fusion": "fusion_3d_brienz.yaml", "fusion_rgb": "fusion_brienz.yaml",
               "f2s3": "f2s3_brienz.yaml"}[method]
    cfg = write_run(tmp_path, shipped, "port", seeded_weights, use_mesh=True, **SMALL)
    if method == "fusion_rgb":
        # The fixed image pair: camera files and precomputed pixel matches.
        image = tmp_path / "data" / "image"
        (image / "transformations").mkdir(parents=True)
        np.savetxt(image / "camera_intrinsic.txt", np.diag([1000.0, 1000.0, 1.0]), delimiter=" ")
        for name in ("pose_epoch1.txt", "pose_epoch2.txt"):
            np.savetxt(image / "transformations" / name, np.eye(4), delimiter=" ")
        (tmp_path / "data" / "img_matching_results").mkdir()
        np.savetxt(tmp_path / "data" / "img_matching_results" / "m.txt", np.ones((70, 4)))
    (main_f2s3 if method == "f2s3" else main_fusion).main(["--config", cfg, "--device", "cpu"])
    assert len(calls) == 1
    tiles, kw = calls[0]
    assert tiles == ["0", "1"] and kw["n_bucket"] >= 64 and kw["m_bucket"] >= kw["n_bucket"]
    if method == "fusion_rgb":
        kit = kw["image_kit_fn"]("0", None, None)
        assert kw["pix_cap"] == 128 and kit["pix"][0].shape == (70, 4)


def test_camera_selection_reaches_the_matcher_and_raises(tmp_path, seeded_weights):
    """``Images_used.txt``: the RGB driver selects each tile's cameras and
    reads their images, then raises at the image matcher: ``loftr`` probes
    the E-LoFTR paths, finds the repository's ``weights/eloftr_tiny.npz``
    and hands it to ``torch.load``, which raises the JAX matcher's
    ``RuntimeError``.
    ``fusion_brienz.yaml``'s own ``eloftr`` runs (``tests/test_torch_matching.py``)."""
    from PIL import Image

    from fusion4landslide_tpu_torch import main_fusion

    cfg = write_run(tmp_path, "fusion_brienz.yaml", "port", seeded_weights,
                    img_matching_type="loftr", **SMALL)
    image = tmp_path / "data" / "image"
    (image / "transformations").mkdir(parents=True)
    np.savetxt(image / "camera_intrinsic.txt", np.diag([1000.0, 1000.0, 1.0]), delimiter=" ")
    names = ("epoch1.ply_a.jpg", "epoch1.ply_b.jpg", "epoch2.ply_a.jpg")
    with open(image / "transformations" / "Images_used.txt", "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name}\n0 0 {50 + i}\n1 0 0\n0 1 0\n0 0 1\n")
    for name in names:
        side = "src" if name.startswith("epoch1") else "tgt"
        (image / "raw_images" / f"{side}_images").mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.zeros((64, 64), np.uint8)).save(
            image / "raw_images" / f"{side}_images" / name)
    with pytest.raises(RuntimeError, match="hasRecord"):
        main_fusion.main(["--config", cfg, "--device", "cpu"])
