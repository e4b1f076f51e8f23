"""The port's E-LoFTR (``fusion4landslide_tpu_torch.image.eloftr``) against
the JAX package's on the CPU, with the same weights on both sides: the
``tests/test_eloftr.py`` ``TINY`` architecture with numpy-seeded weights
(``seeded_eloftr``, handed to JAX through the flat Flax tree), and the
shipped ``weights/eloftr_tiny.npz`` read by each side's own loader.

Tolerances: backbone maps, coarse (transformer) output and fine maps
within 1e-4 of the largest magnitude (float32 convolutions and reductions
summed in another order: measured ~7e-7); the kept cells equal, and
[u0 v0 u1 v1] within 1e-3 px on every coarse cell (measured 4e-6 px), the
kept cells' confidences (a product of two softmaxes) within 1e-4
(measured 1.2e-5).
Cells whose fine argmax is a near tie could move a match by a window
pixel; each test counts the cells over 1e-3 px and requires none on these
inputs. ``load_torch_eloftr`` folds a ``transformers`` checkpoint to the
same parameters as JAX's within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from flax.traverse_util import flatten_dict, unflatten_dict

from fusion4landslide_tpu.image import eloftr as je
from fusion4landslide_tpu_torch.image import eloftr as te

TINY = te.ELoFTRConfig(stage_num_blocks=(1, 1, 2, 2), out_features=(8, 8, 16, 32),
                       stage_stride=(2, 1, 2, 2), hidden_size=32, num_attention_layers=2,
                       num_attention_heads=8, fine_kernel_size=8, fine_matching_slice_dim=4)
MAP_RTOL, UV_TOL_PX = 1e-4, 1e-3
SHIPPED = "weights/eloftr_tiny.npz"


def textured(rng, h, w):
    """Band-limited random texture in [0, 1]."""
    base = rng.normal(size=(h // 4, w // 4))
    img = np.kron(base, np.ones((4, 4))) + 0.5 * rng.normal(size=(h, w))
    return ((img - img.min()) / np.ptp(img)).astype(np.float32)


def jax_side(model: te.EfficientLoFTR):
    """(Flax params, EfficientLoFTRFlax) holding the port module's weights."""
    flat = te.eloftr_to_flax(model)
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return params, je.EfficientLoFTRFlax(je.ELoFTRConfig(**dataclasses.asdict(model.cfg)))


@pytest.fixture(scope="module", params=["tiny_seeded", "shipped"])
def models(request):
    if request.param == "tiny_seeded":
        model = te.seeded_eloftr(TINY, 0, "cpu")
        params, jm = jax_side(model)
    else:
        model = te.load_eloftr_weights(SHIPPED, "cpu")
        params, cfg = je.load_eloftr_weights(SHIPPED)
        jm = je.EfficientLoFTRFlax(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(model.cfg)
    return request.param, model, params, jm


def rel_close(a, b, rtol=MAP_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * np.abs(a).max(), np.abs(a - b).max() / np.abs(a).max()


def test_backbone_coarse_and_fine_maps_match_jax(models):
    _, model, params, jm = models
    rng = np.random.default_rng(3)
    img0 = textured(rng, 64, 96)
    img1 = np.roll(img0, 8, axis=1)
    (cj, fj), inter = jm.apply(params, jnp.asarray(img0), jnp.asarray(img1),
                               capture_intermediates=True)
    feats_j = inter["intermediates"]["backbone"]["__call__"][0]
    with torch.no_grad():
        feats_t = model.backbone(torch.from_numpy(np.stack([img0, img1]))[:, None])
        ct, ft = model(torch.from_numpy(img0), torch.from_numpy(img1))
    assert len(feats_t) == len(feats_j) == 3
    for a, b in zip(feats_j, feats_t):
        rel_close(np.asarray(a).transpose(0, 3, 1, 2), b.numpy())
    rel_close(np.asarray(cj).transpose(0, 3, 1, 2), ct.numpy())
    rel_close(np.asarray(fj).transpose(0, 3, 1, 2), ft.numpy())
    assert ft.shape == (2, model.cfg.fine_fusion_dims[-1], 64, 96)


def dense(out):
    """((S, 4) [u0 v0 u1 v1], (S,) scores, (S,) ok) as numpy."""
    return (np.stack([np.asarray(x) for x in out[:4]], axis=1), np.asarray(out[4]),
            np.asarray(out[5]))


@pytest.mark.parametrize("shift", [0, 8])
def test_eloftr_core_matches_jax(models, shift):
    """Dense per-coarse-cell outputs, the kept cells and their scores. The
    shipped weights keep cells on this pair; random weights keep none at
    the 0.2 threshold, so for them every cell's outputs are compared."""
    name, model, params, jm = models
    rng = np.random.default_rng(7)
    img0 = textured(rng, 128, 192)
    img1 = np.roll(img0, shift, axis=1)
    uj, sj, okj = dense(je._eloftr_core(params, jnp.asarray(img0), jnp.asarray(img1), jm))
    ut, st, okt = dense([x.numpy() for x in te.eloftr_core(model, torch.from_numpy(img0),
                                                           torch.from_numpy(img1))])
    np.testing.assert_array_equal(okt, okj)
    if name == "shipped":
        assert okt.sum() > 50
    gap = np.abs(ut - uj).max(axis=1)
    assert int((gap > UV_TOL_PX).sum()) == 0, np.sort(gap)[-5:]
    np.testing.assert_allclose(st[okt], sj[okj], atol=1e-4)


def test_eloftr_match_matches_jax():
    """``eloftr_match`` on an RGB crop in 0..255 that is not a multiple of
    32: channel 0, the /255 rule and the padding, as in JAX."""
    rng = np.random.default_rng(11)
    g = textured(rng, 120, 180) * 255.0
    img0 = np.stack([g, 0.5 * g, 255.0 - g], axis=-1)
    img1 = np.roll(img0, (3, 5), axis=(0, 1))
    params, cfg = je.load_eloftr_weights(SHIPPED)
    mj, cj = je.eloftr_match(params, img0, img1, model=je.EfficientLoFTRFlax(cfg))
    mt, ct = te.eloftr_match(te.load_eloftr_weights(SHIPPED, "cpu"), img0, img1)
    assert mt.shape == mj.shape and len(mt) > 20
    np.testing.assert_allclose(mt, mj, atol=UV_TOL_PX)
    np.testing.assert_allclose(ct, cj, atol=1e-4)
    jax.clear_caches()


def test_checkpoint_roundtrip_through_the_jax_loader(tmp_path):
    """The port writes the JAX package's ``.npz`` format: JAX reads the
    seeded weights the port wrote, and the shipped file reads to the same
    leaves on both sides."""
    model = te.seeded_eloftr(TINY, 3, "cpu")
    path = str(tmp_path / "eloftr.npz")
    te.save_eloftr_weights(path, model)
    params, cfg = je.load_eloftr_weights(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(TINY)
    flat = te.eloftr_to_flax(model)
    for key, val in flat.items():
        leaf = params
        for part in key.split("/"):
            leaf = leaf[part]
        np.testing.assert_array_equal(np.asarray(leaf), val)
    shipped = np.load(SHIPPED)
    port = te.eloftr_to_flax(te.load_eloftr_weights(SHIPPED, "cpu"))
    assert sorted(port) == sorted(k for k in shipped.files if k != "__cfg__")
    for key, val in port.items():
        np.testing.assert_array_equal(val, shipped[key])


@pytest.fixture(scope="module")
def hf_state_dict():
    """A random ``transformers`` EfficientLoFTRForKeypointMatching at the
    ``TINY`` widths, re-initialised like a trained network
    (``tests/test_eloftr.py``'s recipe)."""
    pytest.importorskip("transformers")
    from transformers.models.efficientloftr import (
        EfficientLoFTRConfig,
        EfficientLoFTRForKeypointMatching,
    )

    torch.manual_seed(0)
    cfg = EfficientLoFTRConfig(**{k: list(v) if isinstance(v, tuple) else v
                                  for k, v in dataclasses.asdict(TINY).items()
                                  if k in ("stage_num_blocks", "out_features", "stage_stride",
                                           "hidden_size", "num_attention_layers",
                                           "num_attention_heads", "fine_kernel_size",
                                           "fine_matching_slice_dim")},
                               attn_implementation="eager")
    model = EfficientLoFTRForKeypointMatching(cfg)
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            torch.nn.init.kaiming_normal_(m.weight, generator=gen)
            if m.bias is not None:
                torch.nn.init.normal_(m.bias, 0.0, 0.05, generator=gen)
        elif isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.normal_(m.weight, 1.0, 0.1, generator=gen)
            torch.nn.init.normal_(m.bias, 0.0, 0.05, generator=gen)
            m.running_mean.normal_(0.0, 0.05, generator=gen)
            m.running_var.uniform_(0.8, 1.2, generator=gen)
        elif isinstance(m, torch.nn.LayerNorm):
            torch.nn.init.normal_(m.weight, 1.0, 0.1, generator=gen)
            torch.nn.init.normal_(m.bias, 0.0, 0.05, generator=gen)
    return model.eval()


def test_load_torch_eloftr_folds_as_jax(hf_state_dict, tmp_path):
    """The folded RepVGG / BatchNorm parameters equal JAX's within 1e-6,
    from the state dict, a ``.pt`` file and a ``save_pretrained``
    directory (``model.safetensors``)."""
    sd = hf_state_dict.state_dict()
    base = je.ELoFTRConfig(fine_matching_slice_dim=4)
    params, cfg_j = je.load_torch_eloftr(sd, cfg=base)
    ref = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}
    torch.save(sd, tmp_path / "eloftr.pt")
    hf_state_dict.save_pretrained(str(tmp_path / "efficientloftr"))
    pbase = te.ELoFTRConfig(fine_matching_slice_dim=4)
    for src in (sd, str(tmp_path / "eloftr.pt"), str(tmp_path / "efficientloftr")):
        model = te.load_torch_eloftr(src, cfg=pbase, device="cpu")
        assert dataclasses.asdict(model.cfg) == dataclasses.asdict(cfg_j)
        got = te.eloftr_to_flax(model)
        assert sorted(got) == sorted(ref)
        for key, val in got.items():
            np.testing.assert_allclose(val, ref[key], atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(3)
    img0 = textured(rng, 64, 96)
    uj, _, okj = dense(je._eloftr_core(params, jnp.asarray(img0), jnp.asarray(img0),
                                       je.EfficientLoFTRFlax(cfg_j)))
    ut, _, okt = dense([x.numpy() for x in te.eloftr_core(model, torch.from_numpy(img0),
                                                          torch.from_numpy(img0))])
    np.testing.assert_array_equal(okt, okj)
    assert int((np.abs(ut - uj).max(axis=1) > UV_TOL_PX).sum()) == 0
    jax.clear_caches()
