"""The hard synthetic scenes on the port (the twin of
``tests/test_synth_hard.py``): the scanner-like 2x density gradient with a
rotating moving disc (``synth.make_epoch_pair_hard``), and an oblique
camera with hidden-surface removal (``synth.oblique_camera``,
``synth.render_image_occluded``).

- The port's scene code is bit-equal to ``tools/synth_scene.py`` on the
  same seeds.
- The port's host fusion tile (``run_fusion3d_tile``, the JAX test's
  configuration: patch 16, ``feat_k_max`` 16, levels [1, 2]; seeded
  weights) recovers the planted field with the JAX test's bars: more than
  0.7 of the source points assigned, static median error under 5 mm,
  moving under 10 mm; on a 6 000-point pair here, on the JAX test's
  20 000-point pair under ``slow``, where the port also holds to JAX's
  tile on JAX's weights and draws (``score_host_parity`` of
  ``test_torch_fusion_host.py``).
- ZNCC on the oblique, occluded pair is held to the analytic flow with the
  JAX test's bars and to JAX's ``zncc_grid_match``: the same kept centres,
  flows within 1e-4 px (``test_torch_matching.py``'s tolerance) on 99.9%
  of the rows and within 1e-3 px on all (the parabola's vertex on a flat
  correlation peak moves by ~2e-4 px with the float32 summation order: 1
  of 7 402 flow values at 480 x 640); at 240 x 320 here, at the JAX
  test's 480 x 640 under ``slow``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch import synth
from test_torch_fusion_host import tpu_branch  # noqa: F401 (fixture)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import synth_scene  # noqa: E402

HARD_CFG = synth.HARD_TILE_CFG
HARD_PAIR = {k: v for k, v in synth.HARD_PAIR.items() if k != "n"}


def test_scene_code_is_bit_equal_to_the_tool():
    for kw in (dict(rot_deg=1.0), HARD_PAIR):
        want = synth_scene.make_epoch_pair_hard(8000, **kw)
        got = synth.make_epoch_pair_hard(8000, **kw)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
    src, tgt, extent, moving, disp = got
    # The JAX test's checks on the pair: a 2x density gradient, a rotating
    # block, exactly static elsewhere.
    near = (src[:, 0] < extent / 2) & (src[:, 1] < extent / 2)
    far = (src[:, 0] > extent / 2) & (src[:, 1] > extent / 2)
    assert near.sum() > 1.6 * far.sum()
    assert disp[moving].std(axis=0).max() > 5e-3
    np.testing.assert_array_equal(disp[~moving], 0.0)
    np.testing.assert_array_equal(synth.terrain_z(src[:, 0], src[:, 1]),
                                  synth_scene.terrain_z(src[:, 0], src[:, 1]))
    xy = src[:500, :2]
    np.testing.assert_array_equal(synth.texture(xy[:, 0], xy[:, 1]),
                                  synth_scene.texture(xy[:, 0], xy[:, 1]))
    for cam in ("nadir_camera", "oblique_camera"):
        K, E, c = getattr(synth, cam)(40.0, (60, 80))
        for a, b in zip((K, E, c), getattr(synth_scene, cam)(40.0, (60, 80))):
            np.testing.assert_array_equal(a, b)
        render = "render_image" if cam == "nadir_camera" else "render_image_occluded"
        for shift in (None, (0.6, -0.2, 0.0)):
            np.testing.assert_array_equal(
                getattr(synth, render)((60, 80), K, E, 40.0, shift=shift),
                getattr(synth_scene, render)((60, 80), K, E, 40.0, shift=shift))
        uv = np.random.default_rng(0).uniform(0, 60, size=(200, 2))
        np.testing.assert_array_equal(synth.planted_flow(uv, (60, 80), K, E, 40.0, (0.6, 0, 0)),
                                      synth_scene.planted_flow(uv, (60, 80), K, E, 40.0,
                                                               (0.6, 0, 0)))
    pts = np.column_stack([xy, synth.terrain_z(xy[:, 0], xy[:, 1])])
    np.testing.assert_array_equal(synth.visible_in_view(pts, K, E, 40.0),
                                  synth_scene.visible_in_view(pts, K, E, 40.0))


def assert_hard_bars(rec: dict) -> None:
    assert rec["assigned"] > 0.7, rec
    assert rec["static_err_m"] < 5e-3, rec
    assert rec["moving_err_m"] < 1e-2, rec


def test_host_tile_recovers_the_rotating_block(tmp_path):
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile

    src, tgt, _, moving, true_disp = synth.make_epoch_pair_hard(6000, **HARD_PAIR)
    dips, agg = seeded_models(0, "cpu")
    out = run_fusion3d_tile({**HARD_CFG, "output_dir": str(tmp_path)}, dips, agg, src, tgt,
                            tile_id="hard", device="cpu")
    table = np.loadtxt(tmp_path / "run" / "results" / "c2f_dvfs_src2tgt_tile_hard.txt")
    np.testing.assert_allclose(table, out["dvfs"], atol=1e-5)
    assert out["overflow"] == 0
    assert_hard_bars(synth.hard_tile_readings(out, moving, true_disp))


@pytest.mark.slow
def test_host_tile_on_the_jax_test_pair_matches_jax(tpu_branch, monkeypatch, tmp_path):
    """The JAX test's 20 000-point pair: the port's host tile on JAX's
    weights and JAX's per-chunk draws against JAX's emulated tile
    (``score_host_parity``), and both against the bars."""
    import jax.random as jr

    from fusion4landslide_tpu.pipelines.fusion import run_fusion3d_tile as j_run
    from fusion4landslide_tpu_torch.pipelines import fusion as tfusion
    from test_torch_dips_branches import jax_draws
    from test_torch_fusion_host import flax_and_torch_models, score_host_parity

    src, tgt, _, moving, true_disp = synth.make_epoch_pair_hard(**synth.HARD_PAIR)
    cfg = {**HARD_CFG, "return_interim": True}
    dips, agg, td, ta = flax_and_torch_models()
    jo = j_run({**cfg, "output_dir": str(tmp_path / "jax")}, dips, agg, src, tgt, tile_id="hard")
    k_s, k_t = jr.split(jr.PRNGKey(0))
    draws = tuple(jax_draws(k, "knn", jo["interim"][v].shape[0], 0, cfg["feat_chunk"],
                            cfg["feat_k_max"])
                  for k, v in ((k_s, "src_vox"), (k_t, "tgt_vox")))
    calls, orig = [], tfusion.fine_match_pairs

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(tfusion, "fine_match_pairs", rec)
    to = tfusion.run_fusion3d_tile({**cfg, "output_dir": str(tmp_path / "port")}, td, ta, src,
                                   tgt, tile_id="hard", device="cpu", dips_draws=draws)
    readings = score_host_parity(jo, to, src, calls)
    assert readings["overlap"] >= 0.99, readings
    for out in (jo, to):
        assert_hard_bars(synth.hard_tile_readings(out, moving, true_disp))


@pytest.mark.parametrize("image_size", [
    (240, 320), pytest.param((480, 640), marks=pytest.mark.slow)])
def test_zncc_on_the_oblique_occluded_pair(image_size):
    """The JAX test's oblique view (25 degrees elevation over the 40 m
    scene, a 0.6 m shift): occlusion exists, and ZNCC's flow holds to the
    analytic flow with the JAX test's bars and to JAX's matcher."""
    from fusion4landslide_tpu.image.matching import zncc_grid_match as jzncc
    from fusion4landslide_tpu_torch.image.matching import zncc_grid_match

    extent, shift = 40.0, (0.6, 0.0, 0.0)
    K, E, _ = synth.oblique_camera(extent, image_size, elev_deg=25.0)
    img0 = synth.render_image_occluded(image_size, K, E, extent).astype(np.float32)
    img1 = synth.render_image_occluded(image_size, K, E, extent, shift=shift).astype(np.float32)
    assert img0.max() > 100
    xy = np.random.default_rng(0).uniform(2.0, extent - 2.0, size=(4000, 2))
    vis = synth.visible_in_view(np.column_stack([xy, synth.terrain_z(xy[:, 0], xy[:, 1])]), K,
                                E, extent)
    assert 0.05 < (~vis).mean() < 0.7
    kw = dict(grid_step=8, search=24, min_score=0.75, min_texture=2.0)
    m = zncc_grid_match(img0, img1, device="cpu", **kw)
    assert m.shape[0] > 300
    err = np.linalg.norm(m[:, 2:4] - synth.planted_flow(m[:, :2], image_size, K, E, extent,
                                                        shift), axis=1)
    assert np.median(err) < 1.5
    assert (err < 3.0).mean() > 0.6
    want = np.asarray(jzncc(img0, img1, **kw))
    assert want.shape == m.shape
    np.testing.assert_array_equal(want[:, :2], m[:, :2])
    gap = np.abs(want[:, 2:] - m[:, 2:]).max(axis=1)
    assert gap.max() <= 1e-3 and (gap <= 1e-4).mean() >= 0.999, gap.max()
