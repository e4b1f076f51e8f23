"""The port's RoMa matcher (``fusion4landslide_tpu_torch.image.roma`` and
``image.matching.roma_crop_match``) against the JAX package's on the CPU,
with the shipped ``weights/roma_tiny.npz`` read by each side's loader, at
``work_size`` 64.

Tolerances, and why:
- encoder maps within 1e-4 of the largest magnitude (measured ~9e-7);
- the GP posterior: its Gram matrix has a condition number of ~6e4 here,
  so any float32 solve is ~3e-4 (relative) from the float64 answer. The
  port's posterior is held within 2x JAX's own distance from a float64
  solve of the same system, and within 2e-3 of JAX's;
- what follows the solve carries its error: decoder and refiner warps,
  the final warp within 5e-3 (normalised units, 0.16 px at 64 px;
  measured 1.8e-3), certainty within 5e-3 (measured 1.8e-3 on the logit,
  4e-4 after the sigmoid);
- the forward-backward error: the consistent set (<= 6 px) may differ in
  pixels on the threshold (at most 0.5% of them; measured 1 of 4 096), and
  the certainty-weighted consistent fraction within 1e-3;
- ``roma_sample`` fed JAX's drawn indices returns JAX's matches within
  1e-6, and ``roma_crop_match`` fed JAX's draws returns JAX's matcher
  output within 0.05 px (measured 7.5e-3 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from flax.traverse_util import flatten_dict

from fusion4landslide_tpu.image import matching as jmm
from fusion4landslide_tpu.image import roma as jr
from fusion4landslide_tpu_torch.image import matching as tm
from fusion4landslide_tpu_torch.image import roma as tr

SHIPPED = "weights/roma_tiny.npz"
WS = 64


def textured(rng, h, w):
    """Band-limited random texture in 0..255."""
    base = rng.normal(size=(h // 4, w // 4))
    img = np.kron(base, np.ones((4, 4))) + 0.5 * rng.normal(size=(h, w))
    return ((img - img.min()) / np.ptp(img) * 255.0).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    params, cfg = jr.load_roma_weights(SHIPPED)
    return params, jr.RoMaMatcher(cfg), tr.load_roma_weights(SHIPPED, "cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    img0 = textured(rng, WS, WS) / 255.0
    return img0, np.roll(img0, 3, axis=1)


def test_forward_stages_match_jax(models, pair):
    params, jm, model = models
    img0, img1 = pair
    (wj, cj), inter = jm.apply(params, jnp.asarray(img0), jnp.asarray(img1),
                               capture_intermediates=True)
    ji = inter["intermediates"]
    it: dict = {}
    with torch.no_grad():
        wt, ct = model(torch.from_numpy(img0), torch.from_numpy(img1), intermediates=it)
    for a, b in zip(ji["encoder"]["__call__"][0], it["fa"]):
        a = np.asarray(a)
        assert a.shape == b.shape
        assert np.abs(a - b.numpy()).max() <= 1e-4 * np.abs(a).max()
    # The GP solve, held against a float64 solve of the port's own system.
    gp_j = np.asarray(ji["gp"]["__call__"][0])
    with torch.no_grad():
        g = model.gp
        a = tr._unit(g.proj(it["fa"][-1]).reshape(-1, model.cfg.gp_dim)).double()
        b = tr._unit(g.proj_b(it["fb"][-1]).reshape(-1, model.cfg.gp_dim)).double()
        tau = 0.02 + torch.nn.functional.softplus(torch.exp(g.log_temp.double()))
        hb, wb = it["fb"][-1].shape[:2]
        emb = tr._fourier_embed(tr._coord_grid(hb, wb).double(), model.cfg.coord_freqs)
        k_bb = torch.exp((b @ b.T - 1.0) / tau) + model.cfg.gp_noise * torch.eye(len(b))
        mu64 = (torch.exp((a @ b.T - 1.0) / tau) @ torch.linalg.solve(
            k_bb, emb.reshape(hb * wb, -1))).numpy().reshape(gp_j.shape)
    scale = np.abs(mu64).max()
    err_port = np.abs(it["gp"].numpy() - mu64).max() / scale
    err_jax = np.abs(gp_j - mu64).max() / scale
    assert err_port <= 2.0 * err_jax + 1e-6, (err_port, err_jax)
    assert np.abs(it["gp"].numpy() - gp_j).max() <= 2e-3 * np.abs(gp_j).max()
    dec_w, dec_c, _ = ji["decoder"]["__call__"][0]
    np.testing.assert_allclose(it["coarse_warp"].numpy(), np.asarray(dec_w), atol=5e-3)
    np.testing.assert_allclose(it["coarse_cert"].numpy(), np.asarray(dec_c), atol=5e-3)
    for li in range(2):
        np.testing.assert_allclose(it[f"warp_s{li}"].numpy(),
                                   np.asarray(ji[f"refiner_{li}"]["__call__"][0][0]), atol=5e-3)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=5e-3)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=5e-3)
    assert wt.shape == (WS, WS, 2) and ct.shape == (WS, WS)


def test_forward_backward_error_matches_jax(models, pair):
    params, jm, model = models
    img0, img1 = (x * 255.0 for x in pair)  # the /255 rule on both sides
    _, cj, ej = jr.roma_fb_error_px(params, img0, img1, model=jm)
    _, ct, et = tr.roma_fb_error_px(model, img0, img1)
    cons_j, cons_t = np.asarray(ej) <= 6.0, et.numpy() <= 6.0
    assert (cons_j != cons_t).mean() <= 0.005
    frac_j = float((np.asarray(cj) * cons_j).sum() / np.asarray(cj).sum())
    frac_t = float((ct.numpy() * cons_t).sum() / ct.numpy().sum())
    assert abs(frac_j - frac_t) <= 1e-3
    assert 0.0 < frac_t < 1.0


def test_roma_sample_fed_jax_draws_gives_jax_matches(models, pair):
    params, jm, _ = models
    wj, cj = jr.roma_match(params, *pair, model=jm)
    key = jax.random.PRNGKey(0)
    mj, mcj = jr.roma_sample(wj, cj, num=3000, key=key)
    p = np.asarray(cj).reshape(-1)
    idx = jax.random.choice(key, p.size, shape=(3000,), replace=True, p=jnp.asarray(p / p.sum()))
    mt, mct, it = tr.roma_sample(torch.from_numpy(np.asarray(wj)), torch.from_numpy(np.asarray(cj)),
                                 3000, idx=torch.from_numpy(np.asarray(idx)))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    np.testing.assert_allclose(mct.numpy(), np.asarray(mcj), atol=1e-6)
    ka_j, kb_j = jr.roma_to_pixel_coordinates(mj, 48, 64, 96, 80)
    ka_t, kb_t = tr.roma_to_pixel_coordinates(mt, 48, 64, 96, 80)
    np.testing.assert_allclose(ka_t.numpy(), np.asarray(ka_j), atol=1e-5)
    np.testing.assert_allclose(kb_t.numpy(), np.asarray(kb_j), atol=1e-5)
    # The port's own draws: reproducible from a generator, only where p > 0.
    zero = torch.from_numpy(np.asarray(cj)).clone()
    zero[: WS // 2] = 0.0
    draws = [tr.roma_sample(torch.from_numpy(np.asarray(wj)), zero, 500,
                            generator=torch.Generator().manual_seed(4))[2] for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and bool((draws[0] >= WS // 2 * WS).all())


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(2)
    fmap = rng.normal(size=(12, 17, 5)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(40, 9, 2)).astype(np.float32)
    got = tr.grid_sample(torch.from_numpy(fmap), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, np.asarray(jr.grid_sample(jnp.asarray(fmap),
                                                              jnp.asarray(coords))), atol=1e-6)


@pytest.mark.parametrize("shape", [(96, 128), (64, 64)])
def test_roma_crop_match_fed_jax_draws_matches_jax(models, shape):
    """The matcher on one crop pair (grey by the channel mean, antialiased
    resize to ``work_size``, self-check, sample, pixel coordinates), with
    the self-check threshold below this pair's consistent fraction."""
    params, jm, model = models
    rng = np.random.default_rng(5)
    g = textured(rng, *shape)
    img0 = np.stack([g, 0.8 * g, g], axis=-1)
    img1 = np.roll(img0, 3, axis=1)
    kw = dict(work_size=WS, fb_min_frac=0.01, min_certainty=0.0, num_matches=2000)
    mj = jmm._roma_matcher(img0, img1, params=(params, jm.cfg), **kw)
    # JAX's draws, from JAX's own p, computed as its matcher computes it.
    r0, r1 = (jax.image.resize(jnp.mean(jnp.asarray(x), axis=-1), (WS, WS), "bilinear")
              for x in (img0, img1))
    _, cj, ej = jr.roma_fb_error_px(params, r0, r1, model=jm)
    p = np.asarray(cj * (ej <= 6.0)).reshape(-1)
    idx = jax.random.choice(jax.random.PRNGKey(0), p.size, shape=(2000,), replace=True,
                            p=jnp.asarray(p / p.sum()))
    res = tm.roma_crop_match(model, img0, img1, sample_idx=torch.from_numpy(np.asarray(idx)), **kw)
    assert res.passed and mj.shape == res.matches.shape == (2000, 4)
    np.testing.assert_allclose(res.matches, mj, atol=0.05)
    assert abs(res.fb_frac - float(p.sum() / np.asarray(cj).sum())) <= 1e-3


def test_roma_self_check_failure_falls_back_to_zncc_like_jax():
    """At the default work size these crops fail the self-check on both
    sides; ``match_epoch_images`` then matches the pair by ZNCC."""
    rng = np.random.default_rng(5)
    img0 = textured(rng, 240, 320)
    img1 = np.roll(img0, 2, axis=1)
    kw = dict(matcher="roma", crop_size=(128, 160), overlap_size=(32, 40), grid_step=16,
              patch=16, search=8, min_score=0.7)
    with pytest.warns(UserWarning, match="self-check failed"):
        got = tm.match_epoch_images(img0, img1, device="cpu", **kw)
    ref = jmm.match_epoch_images(img0, img1, **kw)
    assert got.shape == ref.shape and len(got) > 50
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 2:], ref[:, 2:], atol=1e-4)
    jax.clear_caches()


def test_checkpoint_roundtrip_through_the_jax_loader(models, tmp_path):
    params, jm, model = models
    path = str(tmp_path / "roma.npz")
    tr.save_roma_weights(path, model)
    params2, cfg2 = jr.load_roma_weights(path)
    assert cfg2 == jm.cfg
    ref = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}
    got = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params2).items()}
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(got[key], val)


def gp_conditioning(crop: tuple[int, int] = (960, 1280)) -> None:
    """Print, for the first crop of the rendered ``RGB_EPOCH`` image pair
    at the shipped 1920 x 2560, the GP Gram matrix's condition number and
    how far JAX's and the port's float32 posteriors lie from a float64
    solve (relative to its largest magnitude), at ``work_size`` 64 and
    224. Run as ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_roma.py``."""
    from fusion4landslide_tpu_torch.synth import synth_epoch_pair, synth_textured_images

    params, cfg = jr.load_roma_weights(SHIPPED)
    model = tr.load_roma_weights(SHIPPED, "cpu")
    src, tgt, _ = synth_epoch_pair(70.0, 70.0)
    img0, img1, _, _, _ = synth_textured_images(src, tgt, (1920, 2560))
    c0, c1 = (torch.from_numpy(x[:crop[0], :crop[1]].astype(np.float32) / 255.0)
              for x in (img0, img1))
    for ws in (64, 224):
        r0, r1 = tm._resize(c0, ws), tm._resize(c1, ws)
        _, inter = jr.RoMaMatcher(cfg).apply(params, jnp.asarray(r0.numpy()),
                                             jnp.asarray(r1.numpy()), capture_intermediates=True)
        it: dict = {}
        with torch.no_grad():
            model(r0, r1, intermediates=it)
            g = model.gp
            a = tr._unit(g.proj(it["fa"][-1]).reshape(-1, cfg.gp_dim)).double()
            b = tr._unit(g.proj_b(it["fb"][-1]).reshape(-1, cfg.gp_dim)).double()
            tau = 0.02 + torch.nn.functional.softplus(torch.exp(g.log_temp.double()))
            hb, wb = it["fb"][-1].shape[:2]
            emb = tr._fourier_embed(tr._coord_grid(hb, wb).double(), cfg.coord_freqs)
            k_bb = torch.exp((b @ b.T - 1.0) / tau) + cfg.gp_noise * torch.eye(len(b))
            mu64 = (torch.exp((a @ b.T - 1.0) / tau) @ torch.linalg.solve(
                k_bb, emb.reshape(hb * wb, -1))).numpy()
        scale = np.abs(mu64).max()
        gp_j = np.asarray(inter["intermediates"]["gp"]["__call__"][0]).reshape(mu64.shape)
        print(f"work_size {ws}: cond {float(torch.linalg.cond(k_bb)):.3g}, JAX "
              f"{np.abs(gp_j - mu64).max() / scale:.3g}, port "
              f"{np.abs(it['gp'].numpy().reshape(mu64.shape) - mu64).max() / scale:.3g} "
              "from float64")


if __name__ == "__main__":
    gp_conditioning()
