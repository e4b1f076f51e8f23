"""The port's classic LoFTR (``image/loftr_classic.py``), the compact
``LoFTRMatcher`` and the ``loftr`` matcher (``image/loftr.py``,
``image/matching.py``) vs the JAX package, with the same weights.

Both packages load one seeded upstream-layout state dict
(``tests/test_loftr_classic.py``'s ``TorchLoFTR``, BatchNorm statistics
perturbed so the folding is exercised). Tolerances: coarse tokens 1e-4
relative to their scale, the confidence matrix atol 1e-5, the kept cells
equal and their uv within 1e-3 px; the compact matcher from the JAX
package's Flax params: kept cells equal, uv within 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.image import loftr as tl
from fusion4landslide_tpu_torch.image import loftr_classic as tc
from fusion4landslide_tpu_torch.image import matching as tm

UV_TOL_PX = 1e-3


def _textured(rng, h, w):
    """A smooth random texture in [0, 1] (features the coarse stage can
    tell apart)."""
    g = rng.uniform(0, 1, size=(h // 4 + 2, w // 4 + 2)).astype(np.float32)
    g = np.kron(g, np.ones((4, 4), np.float32))[:h, :w]
    return (0.5 * g + 0.5 * np.roll(g, (2, 3), axis=(0, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def upstream():
    """(upstream state dict as numpy, JAX params, JAX config)."""
    from fusion4landslide_tpu.image.loftr_classic import convert_classic_loftr

    from test_loftr_classic import TorchLoFTR

    torch.manual_seed(0)
    model = TorchLoFTR().eval()
    gen = torch.Generator().manual_seed(1)
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.uniform_(-0.2, 0.2, generator=gen)
            mod.running_var.uniform_(0.5, 1.5, generator=gen)
            mod.weight.data.uniform_(0.5, 1.5, generator=gen)
            mod.bias.data.uniform_(-0.2, 0.2, generator=gen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, cfg = convert_classic_loftr(sd)
    return sd, params, cfg


def _dense_jax(params, cfg, g0, g1, thr):
    from fusion4landslide_tpu.image.loftr_classic import ClassicLoFTR, _classic_core

    out = _classic_core(params, jnp.asarray(g0), jnp.asarray(g1), ClassicLoFTR(cfg), thr)
    return [np.asarray(x) for x in out]


def test_classic_loftr_matches_jax(upstream):
    from fusion4landslide_tpu.image.loftr_classic import ClassicLoFTR as JClassic

    sd, params, cfg = upstream
    model = tc.classic_from_upstream(sd, device="cpu")
    rng = np.random.default_rng(0)
    g0 = rng.uniform(0, 1, size=(64, 64)).astype(np.float32)
    g1 = np.roll(g0, 3, axis=1) + rng.uniform(0, 0.05, size=g0.shape).astype(np.float32)

    # Coarse tokens and the dual-softmax confidence.
    jt0, jt1, *_ = JClassic(cfg).apply(params, jnp.asarray(g0), jnp.asarray(g1))
    with torch.inference_mode():
        tt0, tt1, *_ = model(torch.from_numpy(g0), torch.from_numpy(g1))
    for a, b in ((tt0, jt0), (tt1, jt1)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max())

    def conf(t0, t1):
        sim = (t0[0] / 16.0) @ (t1[0] / 16.0).T / 0.1
        e0 = np.exp(sim - sim.max(0, keepdims=True))
        e1 = np.exp(sim - sim.max(1, keepdims=True))
        return e0 / e0.sum(0, keepdims=True) * (e1 / e1.sum(1, keepdims=True))

    np.testing.assert_allclose(conf(tt0.numpy().astype(np.float64), tt1.numpy()),
                               conf(np.asarray(jt0, np.float64), np.asarray(jt1)), atol=1e-5)

    # The whole match: equal kept cells, sub-pixel uv.
    for thr in (0.0,):
        ju0, jv0, ju1, jv1, jc, jok = _dense_jax(params, cfg, g0, g1, thr)
        tu0, tv0, tu1, tv1, tconf, tok = (x.numpy() for x in tc.classic_loftr_core(
            model, torch.from_numpy(g0), torch.from_numpy(g1), thr))
        np.testing.assert_array_equal(tok, jok)
        assert tok.sum() > 0
        uv_t = np.stack([tu0, tv0, tu1, tv1], 1)[tok]
        uv_j = np.stack([ju0, jv0, ju1, jv1], 1)[jok]
        np.testing.assert_allclose(uv_t, uv_j, atol=UV_TOL_PX)
        np.testing.assert_allclose(tconf[tok], jc[jok], atol=1e-5)


def test_classic_loftr_match_and_loaders(upstream, tmp_path):
    """``classic_loftr_match`` (RGB 0..255 input) equals JAX's, and the
    module from the JAX params (``classic_from_flax``) and from the
    port's own upstream export equal the one from the state dict."""
    from fusion4landslide_tpu.image.loftr_classic import ClassicLoFTR as JClassic
    from fusion4landslide_tpu.image.loftr_classic import classic_loftr_match

    sd, params, cfg = upstream
    model = tc.classic_from_upstream(sd, device="cpu")
    rng = np.random.default_rng(1)
    g0 = rng.uniform(0, 1, size=(64, 64)).astype(np.float32)
    img0 = (np.stack([g0] * 3, -1) * 255).astype(np.float32)
    img1 = np.roll(img0, 3, axis=1)
    juv, jconf = classic_loftr_match(params, img0, img1, model=JClassic(cfg), match_threshold=0.0)
    tuv, tconf = tc.classic_loftr_match(model, img0, img1, match_threshold=0.0)
    np.testing.assert_array_equal(tuv[:, :2], juv[:, :2])
    np.testing.assert_allclose(tuv, juv, atol=UV_TOL_PX)
    for other in (tc.classic_from_flax(jax.tree.map(np.asarray, params), device="cpu"),
                  tc.classic_from_upstream(tc.classic_to_upstream(model), device="cpu")):
        for key, val in other.state_dict().items():
            np.testing.assert_allclose(val.numpy(), model.state_dict()[key].numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=key)
    assert tc.is_classic_loftr_state_dict(sd)
    with pytest.raises(ValueError, match="unconsumed"):
        tc.classic_from_upstream({**sd, "extra.weight": np.zeros(1)}, device="cpu")
    with pytest.raises(KeyError):
        tc.classic_from_upstream({"backbone.conv1.weight": np.zeros((1,))}, device="cpu")


def test_compact_loftr_matcher_from_flax_matches_jax():
    from fusion4landslide_tpu.image.loftr import LoFTRMatcher, loftr_match

    model_j = LoFTRMatcher(layers=2)
    dummy = np.zeros((64, 64), np.float32)
    params = model_j.init(jax.random.PRNGKey(0), dummy, dummy)
    model = tl.loftr_from_flax(jax.tree.map(np.asarray, params), device="cpu", layers=2)
    rng = np.random.default_rng(2)
    img0 = (_textured(rng, 64, 80) * 255).astype(np.float32)
    img1 = np.roll(img0, (0, 8), axis=(0, 1))
    for thr in (0.0, 0.01):
        juv, jconf = loftr_match(params, img0, img1, model=model_j, match_threshold=thr)
        tuv, tconf = tl.loftr_match(model, img0, img1, match_threshold=thr)
        assert len(tuv) > 0
        np.testing.assert_array_equal(tuv[:, :2], juv[:, :2])
        np.testing.assert_allclose(tuv, juv, atol=UV_TOL_PX)
        np.testing.assert_allclose(tconf, jconf, atol=1e-5)


def test_load_torch_loftr_dispatches_on_layout(upstream, tmp_path, monkeypatch):
    from fusion4landslide_tpu.image.loftr import load_torch_loftr as jload

    from fusion4landslide_tpu_torch.image import eloftr as te

    sd, _, _ = upstream
    path = str(tmp_path / "outdoor_ds.ckpt")
    torch.save({"state_dict": {f"matcher.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               path)
    model = tl.load_torch_loftr(path, device="cpu")
    assert isinstance(model, tc.ClassicLoFTR)
    _, cfg_j = jload(path)
    assert type(cfg_j).__name__ == "ClassicLoFTRConfig"

    seen = []
    monkeypatch.setattr(te, "load_torch_eloftr", lambda s, device=None: seen.append(sorted(s)))
    tl.load_torch_loftr({"matcher.efficientloftr.backbone.x": torch.zeros(1)}, device="cpu")
    assert seen == [["efficientloftr.backbone.x"]]

    unknown = str(tmp_path / "unknown.ckpt")
    torch.save({"encoder.weight": torch.zeros(2)}, unknown)
    with pytest.raises(NotImplementedError):
        tl.load_torch_loftr(unknown, device="cpu")
    with pytest.raises(NotImplementedError):
        jload(unknown)


def test_loftr_matcher_paths_match_jax(upstream, tmp_path):
    """``img_matching_type: loftr``: an explicit upstream checkpoint runs
    classic LoFTR as in JAX; ``match_epoch_images`` on this repository's
    weights probes ``weights/eloftr_tiny.npz`` and raises JAX's
    ``RuntimeError``; without weights the compact model runs (seeded)."""
    from fusion4landslide_tpu.image.matching import get_matcher as jget
    from fusion4landslide_tpu.image.matching import match_epoch_images as jmatch

    sd, _, _ = upstream
    path = str(tmp_path / "outdoor_ds.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    rng = np.random.default_rng(3)
    g0 = rng.uniform(0, 255, size=(64, 64)).astype(np.float32)
    g1 = np.roll(g0, 2, axis=1)
    juv = jget("loftr")(g0, g1, weights=path, match_threshold=0.0)
    tuv = tm.get_matcher("loftr")(g0, g1, weights=path, match_threshold=0.0, device="cpu")
    np.testing.assert_array_equal(tuv[:, :2], juv[:, :2])
    np.testing.assert_allclose(tuv, juv, atol=UV_TOL_PX)
    model = tc.classic_from_upstream(sd, device="cpu")
    via_params = tm.get_matcher("loftr")(g0, g1, params=model, match_threshold=0.0, device="cpu")
    np.testing.assert_array_equal(via_params, tuv)

    for fn, kw in ((jmatch, {}), (tm.match_epoch_images, {"device": "cpu"})):
        for extra in ({}, {"allow_random": True}):
            with pytest.raises(RuntimeError, match="hasRecord"):
                fn(g0, g1, matcher="loftr", **extra, **kw)

    with pytest.warns(UserWarning, match="random weights"):
        uv = tm._loftr_matcher(g0, g1, device="cpu", match_threshold=0.0)
    assert uv.shape[1] == 4 and len(uv) > 0
    seeded = tl.seeded_loftr(0, "cpu")
    np.testing.assert_array_equal(uv, tl.loftr_match(seeded, g0, g1, match_threshold=0.0)[0])
