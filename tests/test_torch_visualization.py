"""The port's figure writers (``utils/visualization.py``) against the JAX
package's: the same inputs through both give images with equal pixel
arrays (PNG, and JPG decoded by PIL); the host fusion tile, the RGB+3D
host tile and the rgb_guided host tile write the figures their configs
ask for, under the JAX package's names; a figure option without
matplotlib raises ``ImportError`` naming it before any tile work.

Tolerance: pixel arrays equal (both packages drive one matplotlib)."""

import sys

import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.utils import visualization as jv
from fusion4landslide_tpu_torch.utils import visualization as tv


def pixels(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def assert_same_image(a, b):
    pa, pb = pixels(a), pixels(b)
    assert pa.shape == pb.shape and pa.size > 0
    np.testing.assert_array_equal(pa, pb)


def match_inputs(rng, n=40, h=64, w=96, gray=True):
    shape = (h, w) if gray else (h, w, 3)
    img0 = rng.integers(0, 255, shape, np.uint8)
    img1 = rng.integers(0, 255, shape, np.uint8)
    m = np.column_stack([rng.uniform(0, w, n), rng.uniform(0, h, n),
                         rng.uniform(0, w, n), rng.uniform(0, h, n)]).astype(np.float32)
    return img0, img1, m


@pytest.mark.parametrize("n, gray, ext", [(40, True, "jpg"), (0, True, "jpg"),
                                          (1200, False, "png")])
def test_matching_figure_equals_jax(tmp_path, n, gray, ext):
    """Gray and colour images; no match; more matches than ``max_lines``
    (the seeded subsample)."""
    img0, img1, m = match_inputs(np.random.default_rng(n), n=n, gray=gray)
    a = jv.save_matching_figure(img0, img1, m, str(tmp_path / "j" / f"m.{ext}"), text="t")
    b = tv.save_matching_figure(img0, img1, m, str(tmp_path / "t" / f"m.{ext}"), text="t")
    assert b == str(tmp_path / "t" / f"m.{ext}")
    assert_same_image(a, b)


@pytest.mark.parametrize("small_region, background", [(50.0, 500), (None, 70_000)])
def test_patch_figures_equal_jax(tmp_path, small_region, background):
    """The patch figure (cropped to ``small_region``, or uncropped over
    more points than ``max_background``) and the within-patch figure."""
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 10, (background, 3))
    tgt = src + [0.1, 0, 0]
    p_s, p_t = src[:40], tgt[:40]
    kw = dict(offset=(75, 75, 75), small_region=small_region)
    a = jv.save_patch_match_figure(src, tgt, p_s, p_t, str(tmp_path / "j.png"), **kw)
    b = tv.save_patch_match_figure(src, tgt, p_s, p_t, str(tmp_path / "t.png"), **kw)
    assert_same_image(a, b)
    corr_s = rng.uniform(0, 10, (400, 3))
    a = jv.save_matches_within_patch_figure(p_s, p_t, corr_s, corr_s + 0.2,
                                            str(tmp_path / "jw.png"))
    b = tv.save_matches_within_patch_figure(p_s, p_t, corr_s, corr_s + 0.2,
                                            str(tmp_path / "tw.png"))
    assert_same_image(a, b)


def test_patch_visualization_requests_equal_jax():
    for cfg, n in (({}, 100), ({"visualize_patch": True, "num_of_visualize_samples": 5}, 100),
                   ({"visualize_patch": True, "num_of_visualize_samples": 10,
                     "random_choice": True}, 4),
                   ({"visualize_patch": True, "random_choice": True}, 50),
                   ({"visualize_patch": True}, 0)):
        np.testing.assert_array_equal(tv.patch_visualization_requests(cfg, n, seed=2),
                                      jv.patch_visualization_requests(cfg, n, seed=2))


FIG_CFG = {"visualize_patch": True, "visualize_matches_within_patch": True,
           "num_of_visualize_samples": 2, "offset": [75, 75, 75], "small_region": 50}


def test_host_fusion_tiles_write_the_figures(tmp_path):
    """``visualize_patch`` on the 3D-only host tile; the RGB+3D host tile
    with ``save_img_matching_visualization`` writes the matching figure of
    its one image pair, pixel for pixel the JAX writer's on the same
    inputs."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile, run_fusion_tile
    from fusion4landslide_tpu_torch.synth import SMALL_IMG_SIZE, synth_small_rgb_tile
    from test_torch_fusion_host import CFG, RGB_CFG

    dips, agg = seeded_models(0, "cpu")
    src, tgt, _, _, pix, K, E, _ = synth_small_rgb_tile()
    cfg = {**CFG, **FIG_CFG, "output_dir": str(tmp_path / "3d")}
    run_fusion3d_tile(cfg, dips, agg, src, tgt, tile_id=4, device="cpu")
    vis = tmp_path / "3d" / "run" / "visualization"
    names = sorted(p.name for p in vis.iterdir())
    patches = [n for n in names if n.startswith("patch_match_tile_4_l")]
    within = [n for n in names if n.startswith("matches_within_patch_tile_4_l")]
    assert patches and sorted(n.replace("patch_match", "") for n in patches) == sorted(
        n.replace("matches_within_patch", "") for n in within)
    assert all((vis / n).stat().st_size > 1000 for n in names)

    rng = np.random.default_rng(0)
    img0 = rng.integers(0, 255, SMALL_IMG_SIZE, np.uint8)
    img1 = rng.integers(0, 255, SMALL_IMG_SIZE, np.uint8)
    cfg = {**CFG, **RGB_CFG, "save_img_matching_visualization": True,
           "output_dir": str(tmp_path / "rgb")}
    run_fusion_tile(cfg, dips, agg, src, tgt, img0, img1, K, E, E, corres_2d=pix, tile_id=2,
                    device="cpu")
    got = tmp_path / "rgb" / "run" / "img_matching_results" / "visualization"
    assert sorted(p.name for p in got.iterdir()) == ["src_0_tgt_0_tile_2.jpg"]
    want = jv.save_matching_figure(img0, img1, np.asarray(pix), str(tmp_path / "j.jpg"),
                                   text="tile 2 src img 0 x tgt img 0")
    assert_same_image(got / "src_0_tgt_0_tile_2.jpg", want)
    assert not (tmp_path / "rgb" / "run" / "visualization").exists()


def test_rgb_guided_tile_writes_the_matching_figure(tmp_path):
    from fusion4landslide_tpu_torch.pipelines.rgb_guided import run_rgb_guided_tile
    from test_torch_rgb_guided import K, H, W, textured_scene

    src, tgt, img0, img1, E = textured_scene(np.random.default_rng(1), n=1500)
    corres = match_inputs(np.random.default_rng(2), n=300, h=H, w=W)[2]
    cfg = {"image_size": [H, W], "pixel_thres": 4, "max_magnitude": 2.0, "n_normals": 15,
           "dataset": "rockfall_simulator", "output_dir": str(tmp_path), "output_folder": "run",
           "save_img_matching_visualization": True}
    run_rgb_guided_tile(cfg, src, tgt, img0, img1, K, E, E, corres_2d=corres, tile_id=3,
                        device="cpu")
    got = tmp_path / "run" / "img_matching_results" / "visualization" / "tile_3.jpg"
    want = jv.save_matching_figure(img0, img1, corres, str(tmp_path / "j.jpg"), text="tile 3")
    assert_same_image(got, want)


@pytest.mark.parametrize("key", ["visualize_patch", "save_img_matching_visualization"])
def test_figures_without_matplotlib_raise_before_tile_work(tmp_path, monkeypatch, key):
    """The card's machine has no matplotlib: each host tile refuses its
    figure options in its option check, before any stage runs."""
    from fusion4landslide_tpu_torch.pipelines import fusion, rgb_guided

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    stages = []
    monkeypatch.setattr(fusion, "median_nn_distance_counted", lambda *a: stages.append(a))
    monkeypatch.setattr(rgb_guided, "project_points", lambda *a, **k: stages.append(a))
    pts = np.random.default_rng(0).uniform(0, 2, size=(50, 3))
    K, E = np.eye(3), np.eye(4)
    cfg = {"output_dir": str(tmp_path), key: True, "image_size": [8, 8]}
    calls = [lambda: fusion.run_fusion_tile(cfg, None, None, pts, pts, None, None, K, E, E,
                                            corres_2d=np.zeros((4, 4)), device="cpu")]
    if key == "visualize_patch":
        calls.append(lambda: fusion.run_fusion3d_tile(cfg, None, None, pts, pts, device="cpu"))
    else:
        calls.append(lambda: rgb_guided.run_rgb_guided_tile(cfg, pts, pts, None, None, K, E, E,
                                                            device="cpu"))
    for call in calls:
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    assert not stages
    # A 3D-only tile draws no matching figure: that option needs nothing.
    if key == "save_img_matching_visualization":
        tv.require_matplotlib(cfg, ("visualize_patch",))
