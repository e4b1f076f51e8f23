"""The port's image matcher (``fusion4landslide_tpu_torch.image.matching``)
against the JAX package's on the CPU: the ZNCC grid matcher on seeded
textures, the crop loop with cross crops and ``max_flow_px``, and the
learned matchers' fallback and refusal.

Tolerance: the same kept grid centres, and flows within 1e-4 px (float32
correlations summed in another order move the parabola's vertex by
~1e-5 px)."""

import logging

import jax
import numpy as np
import pytest

from fusion4landslide_tpu.image import matching as jm
from fusion4landslide_tpu_torch.image import matching as tm
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

H, W = 240, 320
FLOW_TOL_PX = 1e-4


def textured_image(rng, h=H, w=W, channels=0):
    """Band-limited random texture (``tests/test_rgb_guided.py``'s), grey
    or with ``channels`` colour channels."""
    base = rng.normal(size=(h // 4, w // 4))
    img = np.kron(base, np.ones((4, 4))) + 0.5 * rng.normal(size=(h, w))
    img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.float32)
    if channels:
        img = np.stack([img, 0.5 * img + 20.0, 255.0 - img][:channels], axis=-1)
    return img


def assert_same_matches(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and a.shape[1] == 4
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=FLOW_TOL_PX)


@pytest.mark.parametrize("kw", [
    dict(grid_step=16, patch=16, search=12, min_score=0.7),
    dict(grid_step=8, patch=12, search=6, min_score=0.3, min_texture=50.0),
    dict(grid_step=5, patch=15, search=9),
])
@pytest.mark.parametrize("channels", [0, 3])
def test_zncc_grid_match_matches_jax(kw, channels):
    rng = np.random.default_rng(11)
    img0 = textured_image(rng, channels=channels)
    img1 = np.roll(np.roll(img0, 3, axis=0), -5, axis=1)
    img1 = img1 + rng.normal(scale=4.0, size=img1.shape).astype(np.float32)
    ref = jm.zncc_grid_match(img0, img1, **kw)
    got = tm.zncc_grid_match(img0, img1, device="cpu", **kw)
    assert len(got) > 50
    assert_same_matches(ref, got)
    assert abs(np.median(got[:, 2] - got[:, 0]) + 5.0) < 0.3
    assert abs(np.median(got[:, 3] - got[:, 1]) - 3.0) < 0.3


def test_zncc_flat_image_emits_nothing():
    img = np.full((H, W), 128.0, np.float32)
    assert tm.zncc_grid_match(img, img, grid_step=16, patch=16, search=8,
                              device="cpu").shape == (0, 4)
    assert jm.zncc_grid_match(img, img, grid_step=16, patch=16, search=8).shape == (0, 4)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(cross_crops=True),
    dict(max_flow_px=20.0),  # widens the search and turns cross pairing on
    dict(overlap_size=None),
])
def test_match_epoch_images_matches_jax(opts):
    rng = np.random.default_rng(5)
    img0 = textured_image(rng, channels=3)
    img1 = np.roll(img0, 2, axis=1)
    kw = dict(matcher="zncc", crop_size=(128, 160), overlap_size=(32, 40), grid_step=16,
              patch=16, search=8, min_score=0.7)
    kw.update(opts)
    ref = jm.match_epoch_images(img0, img1, **kw)
    got = tm.match_epoch_images(img0, img1, device="cpu", **kw)
    assert len(got) > 30 and got[:, 0].max() > 160
    assert_same_matches(ref, got)
    # Deduplicated by the (u0, v0) pixel cell.
    key = got[:, 1].round() * (W + 1) + got[:, 0].round()
    assert len(np.unique(key)) == len(got)


def test_near_bound_warning(caplog):
    rng = np.random.default_rng(2)
    img0 = textured_image(rng)
    img1 = np.roll(img0, 7, axis=1)
    log = logging.getLogger("test_torch_matching")
    with caplog.at_level(logging.WARNING, logger=log.name):
        m = tm.match_epoch_images(img0, img1, grid_step=16, patch=16, search=8,
                                  logger=log, device="cpu")
    assert len(m) and "search bound" in caplog.text


def test_learned_matchers_fall_back_or_raise(tmp_path, monkeypatch, caplog):
    """Where the weights resolve (here the repository's
    ``weights/eloftr_tiny.npz``) E-LoFTR runs over the crops and returns
    JAX's matches (the same (u0, v0) cells, the flows within 1e-3 px:
    ``tests/test_torch_eloftr.py``'s tolerance); ``loftr`` hands the same
    file to ``torch.load`` and raises JAX's ``RuntimeError``. Without
    provisioned weights a learned matcher falls back to ZNCC with a
    warning, as in the JAX package, and RoMa with ``allow_random`` refuses
    to run without weights, as JAX's does."""
    rng = np.random.default_rng(3)
    img0 = textured_image(rng)
    img1 = np.roll(img0, 1, axis=0)
    kw = dict(grid_step=16, patch=16, search=6)
    assert tm.resolve_learned_weights() == jm.resolve_learned_weights()
    assert tm.resolve_learned_weights() is not None
    crops = dict(crop_size=(128, 160), overlap_size=(32, 40))
    ref = jm.match_epoch_images(img0, img1, matcher="eloftr", **crops)
    got = tm.match_epoch_images(img0, img1, matcher="eloftr", device="cpu", **crops)
    assert got.shape == ref.shape and len(got) > 100 and got[:, 0].max() > 160
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 2:], ref[:, 2:], atol=1e-3)
    for fn, dev in ((tm.match_epoch_images, {"device": "cpu"}), (jm.match_epoch_images, {})):
        with pytest.raises(RuntimeError, match="hasRecord"):
            fn(img0, img1, matcher="loftr", **dev, **kw)
    with pytest.raises(FileNotFoundError):
        tm.resolve_learned_weights(str(tmp_path / "missing.npz"))
    with pytest.raises(NotImplementedError, match="not available"):
        tm.get_matcher("sift")
    assert sorted(tm.MATCHERS) == sorted(jm.MATCHERS)
    # Nothing provisioned: the ZNCC fallback, the same matches as JAX's.
    for mod in (tm, jm):
        monkeypatch.setattr(mod, "WEIGHT_SEARCH_PATHS", ("weights/none_here",))
        monkeypatch.setattr(mod, "ROMA_WEIGHT_SEARCH_PATHS", ("weights/none_here",))
    log = logging.getLogger("test_torch_matching.fallback")
    for matcher in ("eloftr", "loftr", "roma"):
        with caplog.at_level(logging.WARNING, logger=log.name):
            got = tm.match_epoch_images(img0, img1, matcher=matcher, logger=log,
                                        device="cpu", **kw)
        assert "falling back to the ZNCC matcher" in caplog.text
        assert_same_matches(jm.match_epoch_images(img0, img1, matcher=matcher, **kw), got)
        caplog.clear()
    for mod, dev in ((tm, {"device": "cpu"}), (jm, {})):
        with pytest.raises(FileNotFoundError, match="RoMa weights"):
            mod.match_epoch_images(img0, img1, matcher="roma", allow_random=True, **dev, **kw)
    jax.clear_caches()


@pytest.mark.parametrize("image_size, crop, overlap", [
    ((100, 140), (40, 60), (10, 20)),
    ((64, 96), (32, 48), (16, 24)),
    ((30, 50), (40, 60), (10, 20)),  # crop larger than the image
    ((960, 1280), (960, 1280), (480, 640)),
])
def test_crop_boxes_and_crops_match_jax(tmp_path, image_size, crop, overlap):
    """``image.crop``: the same boxes, crops and written files as JAX's."""
    from PIL import Image

    from fusion4landslide_tpu.image import crop as jc
    from fusion4landslide_tpu_torch.image import crop as tc

    assert tc.grid_crop_boxes(image_size, crop, overlap) == jc.grid_crop_boxes(image_size, crop,
                                                                               overlap)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, size=image_size + (3,)).astype(np.uint8)
    got, ref = tc.crop_image(img, crop, overlap), jc.crop_image(img, crop, overlap)
    assert [pos for pos, _ in got] == [pos for pos, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    if image_size[0] > 200:
        return
    path = tmp_path / "epoch1.png"
    Image.fromarray(img).save(path)
    written = tc.crop_and_save(str(path), str(tmp_path / "port"), crop, overlap)
    expected = jc.crop_and_save(str(path), str(tmp_path / "jax"), crop, overlap)
    assert [p.split("port")[1] for p in written] == [p.split("jax")[1] for p in expected]
    for a, b in zip(written, expected):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
