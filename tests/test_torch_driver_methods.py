"""The port's ``main_rgb_guided`` and ``main_piecewise_icp`` against the
JAX package's drivers, end to end on the CPU: the same epoch files,
cameras, images and config, the JAX driver in-process, the port's with
``--device cpu``; host tiles (``use_mesh: false``) and the runners
(``use_mesh: true``: the JAX mesh runner on 8 virtual CPU devices, the
port's single-GPU runner). Both read tiny two-tile epochs; the tiles stay
under the brute-force thresholds (4 096 points for the median resolution,
8 192 for the supervoxel graph), where the JAX package's CPU path is its
accelerator path.

Tolerance: the same tiles and files, every table's rows equal in number
and within 3e-6 m (tables are written to 1e-6 m; float32 transforms
round differently in the last written digits). The port's ZNCC matcher
is held to the JAX matcher in ``tests/test_torch_matching.py`` (flows
within 1e-4 px); flows that differ by ~1e-5 px flip near-tie pixel chains
(4 of ~1 500 chained points on this epoch) and with them a supervoxel's
fit, so the rgb_guided comparison feeds the JAX matcher's matches to the
port's driver; the HDBSCAN run keeps the port's own matcher."""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from fusion4landslide_tpu_torch.io.ply import write_ply
from fusion4landslide_tpu_torch.synth import (
    PLANTED_SHIFT,
    synth_epoch_pair,
    synth_textured_images,
    write_camera_files,
)

ROOT = Path(__file__).resolve().parents[1]
IMAGE = (240, 320)
TABLE_TOL = 3e-6


def write_config(tmp_path, shipped: str, name: str, data: Path, **changes) -> str:
    """``configs/landslide/<shipped>`` with paths, file names and
    ``changes`` set where the shipped file has each key (new keys go to
    its last section)."""
    with open(ROOT / "configs" / "landslide" / shipped) as f:
        raw = yaml.safe_load(f)
    changes = {"input_root": str(data), "output_dir": str(tmp_path / name),
               "src_pcd": "epoch1.ply", "tgt_pcd": "epoch2.ply", "tile_halo": 2.0,
               "max_pts_per_tile": 2500, "min_pts_per_tile": 100, **changes}
    sections = [s for s in raw.values() if isinstance(s, dict)]
    for key, val in changes.items():
        hits = [s for s in sections if key in s] or sections[-1:]
        for s in hits:
            s[key] = val
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


def rgb_epoch(tmp_path) -> Path:
    """An 8 m x 6 m epoch pair at 80 pts/m^2 (zero offset: the cameras
    project world coordinates in float32), its textured image pair and
    camera files in the drivers' layout."""
    data = tmp_path / "data"
    src, tgt, _ = synth_epoch_pair(8.0, 6.0, density=80.0, seed=1)
    (data / "raw_pcd").mkdir(parents=True)
    write_ply(str(data / "raw_pcd" / "epoch1.ply"), src)
    write_ply(str(data / "raw_pcd" / "epoch2.ply"), tgt)
    img0, img1, K, E, _ = synth_textured_images(src, tgt, IMAGE)
    write_camera_files(str(data), K, E, (img0, img1))
    return data


def tables(root: Path) -> dict:
    res = root / "demo_run" / "results"
    return {f.name: np.loadtxt(f, ndmin=2) for f in sorted(res.iterdir())}


def assert_same_tables(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].shape == b[name].shape, name
        np.testing.assert_allclose(b[name], a[name], atol=TABLE_TOL, rtol=0, err_msg=name)


def run_jax_driver(module: str, cfg: str, monkeypatch) -> None:
    sys.path.insert(0, str(ROOT))
    j_main = __import__(module)
    jax.clear_caches()
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", [f"{module}.py", "--config", cfg])
        j_main.main()
    jax.clear_caches()


def jax_matcher(monkeypatch):
    """The port matches images with the JAX package's matcher: every port
    module's ``match_epoch_images`` is replaced."""
    from fusion4landslide_tpu.image import matching as jm
    from fusion4landslide_tpu_torch.image import matching as tm

    def match(img0, img1, *, device=None, **kw):
        return jm.match_epoch_images(img0, img1, **kw)

    orig = tm.match_epoch_images
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("fusion4landslide_tpu_torch")
                and getattr(mod, "match_epoch_images", None) is orig):
            monkeypatch.setattr(mod, "match_epoch_images", match)


RGB_CHANGES = dict(src_image="epoch1.png", tgt_image="epoch2.png", img_matching_type="zncc",
                   image_size=list(IMAGE), crop_size=[120, 160], overlap_size=[60, 80])


@pytest.mark.parametrize("use_mesh", [False, True])
def test_main_rgb_guided_matches_jax_driver(tmp_path, monkeypatch, use_mesh):
    """``rgb_guided_brienz.yaml`` with paths, names, ``img_matching_type:
    zncc`` and the small camera changed: the JAX driver's tables, tile
    for tile; the planted shift recovered on the moving half. Then a
    second run skips both tiles."""
    from fusion4landslide_tpu_torch import main_rgb_guided

    data = rgb_epoch(tmp_path)
    kw = dict(RGB_CHANGES, use_mesh=use_mesh)
    j_cfg = write_config(tmp_path, "rgb_guided_brienz.yaml", "jax", data, **kw)
    t_cfg = write_config(tmp_path, "rgb_guided_brienz.yaml", "port", data, **kw)
    run_jax_driver("main_rgb_guided", j_cfg, monkeypatch)
    jax_matcher(monkeypatch)
    summary = main_rgb_guided.main(["--config", t_cfg, "--device", "cpu"])
    jt, tt = tables(tmp_path / "jax"), tables(tmp_path / "port")
    assert len(tt) == 8  # four tables a tile, two tiles
    assert_same_tables(jt, tt)
    assert summary["overflow"] == {"sampler": 0, "grid_knn": 0}
    assert bool(summary["tile_s"]) != use_mesh and ("runner_s" in summary) == use_mesh
    rows = np.concatenate([v for k, v in tt.items() if k.startswith("rgb_guided_w_refinement_dvfs_")])
    disp = rows[:, 3:6] - rows[:, :3]
    moving = rows[:, 1] > 3.0
    assert np.linalg.norm(np.median(disp[moving], axis=0) - PLANTED_SHIFT) < 0.02
    again = main_rgb_guided.main(["--config", t_cfg, "--device", "cpu"])
    assert not again["tile_s"] and "runner_s" not in again


def test_main_rgb_guided_runs_the_shipped_matcher(tmp_path, monkeypatch):
    """``rgb_guided_brienz.yaml`` with its own ``img_matching_type:
    eloftr`` (``weights/eloftr_tiny.npz``), paths, names and the small
    camera changed: the port's matcher in the driver against the JAX
    driver's, tile for tile; the planted shift recovered on the moving
    half."""
    from fusion4landslide_tpu_torch import main_rgb_guided

    data = rgb_epoch(tmp_path)
    kw = {k: v for k, v in RGB_CHANGES.items() if k != "img_matching_type"}
    j_cfg = write_config(tmp_path, "rgb_guided_brienz.yaml", "jax", data, **kw)
    t_cfg = write_config(tmp_path, "rgb_guided_brienz.yaml", "port", data, **kw)
    run_jax_driver("main_rgb_guided", j_cfg, monkeypatch)
    summary = main_rgb_guided.main(["--config", t_cfg, "--device", "cpu"])
    jt, tt = tables(tmp_path / "jax"), tables(tmp_path / "port")
    assert len(tt) == 8 and sorted(summary["tile_s"]) == ["0", "1"]
    assert_same_tables(jt, tt)
    rows = np.concatenate([v for k, v in tt.items() if k.startswith("rgb_guided_w_refinement_dvfs_")])
    disp = rows[:, 3:6] - rows[:, :3]
    moving = rows[:, 1] > 3.0
    assert np.linalg.norm(np.median(disp[moving], axis=0) - PLANTED_SHIFT) < 0.02


def test_main_rgb_guided_hdbscan_takes_the_host_tiles(tmp_path):
    """``clustering_type: hdbscan`` with ``use_mesh: true`` falls back to
    the serial host tiles, with the port's own matcher; the density
    clusters span both halves here, so only the moving half's median
    displacement is held to the planted shift."""
    from fusion4landslide_tpu_torch import main_rgb_guided

    data = rgb_epoch(tmp_path)
    cfg = write_config(tmp_path, "rgb_guided_brienz.yaml", "port", data, use_mesh=True,
                       clustering_type="hdbscan", hdbscan_min_samples=20, **RGB_CHANGES)
    summary = main_rgb_guided.main(["--config", cfg, "--device", "cpu"])
    assert sorted(summary["tile_s"]) == ["0", "1"] and "runner_s" not in summary
    rows = np.concatenate([v for k, v in tables(tmp_path / "port").items()
                           if k.startswith("rgb_guided_w_refinement_dvfs_")])
    disp = rows[:, 3:6] - rows[:, :3]
    moving = rows[:, 1] > 3.0
    assert np.isfinite(rows).all() and len(rows) > 1000
    assert np.linalg.norm(np.median(disp[moving], axis=0) - PLANTED_SHIFT) < 0.02


@pytest.mark.parametrize("use_mesh", [False, True])
def test_main_piecewise_icp_matches_jax_driver(tmp_path, monkeypatch, use_mesh):
    """``piecewise_icp_brienz.yaml`` with paths and names changed, on a
    two-tile epoch at national-grid offsets."""
    from fusion4landslide_tpu_torch import main_piecewise_icp

    data = tmp_path / "data"
    src, tgt, _ = synth_epoch_pair(12.0, 8.0, density=50.0, seed=4,
                                   offset=(2.6e6, 1.17e6, 600.0))
    (data / "raw_pcd").mkdir(parents=True)
    write_ply(str(data / "raw_pcd" / "epoch1.ply"), src)
    write_ply(str(data / "raw_pcd" / "epoch2.ply"), tgt)
    kw = dict(use_mesh=use_mesh, smax=1.0, number_points_min=5)
    j_cfg = write_config(tmp_path, "piecewise_icp_brienz.yaml", "jax", data, **kw)
    t_cfg = write_config(tmp_path, "piecewise_icp_brienz.yaml", "port", data, **kw)
    run_jax_driver("main_piecewise_icp", j_cfg, monkeypatch)
    summary = main_piecewise_icp.main(["--config", t_cfg, "--device", "cpu"])
    jt, tt = tables(tmp_path / "jax"), tables(tmp_path / "port")
    assert len(tt) == 6
    assert_same_tables(jt, tt)
    assert summary["launches"] == {k: 0 for k in summary["launches"]}
    assert summary["overflow"] == {"sampler": 0, "grid_knn": 0}
    again = main_piecewise_icp.main(["--config", t_cfg, "--device", "cpu"])
    assert not again["tile_s"] and "runner_s" not in again


def test_drivers_run_as_modules(tmp_path):
    """``python -m fusion4landslide_tpu_torch.main_piecewise_icp --device
    cpu`` prints its run summary."""
    import subprocess

    data = tmp_path / "data"
    src, tgt, _ = synth_epoch_pair(6.0, 4.0, density=50.0, seed=2)
    (data / "raw_pcd").mkdir(parents=True)
    write_ply(str(data / "raw_pcd" / "epoch1.ply"), src)
    write_ply(str(data / "raw_pcd" / "epoch2.ply"), tgt)
    cfg = write_config(tmp_path, "piecewise_icp_brienz.yaml", "port", data, smax=1.0)
    out = subprocess.run([sys.executable, "-m", "fusion4landslide_tpu_torch.main_piecewise_icp",
                          "--config", cfg, "--device", "cpu"], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "run summary:" in out.stdout and '"overflow"' in out.stdout
