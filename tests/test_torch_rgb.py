"""The port's RGB 2D-match channel, function by function, vs the JAX step's
helpers (``fusion4landslide_tpu.pipelines.fusion_device``).

Every function gets the JAX side's projected pixel coordinates, so indices
and masks must agree exactly. The JAX grid kNN runs its TPU branch
emulated on the CPU (the Pallas window kernel in interpret mode); the
port's runs kernel 2's plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.image import geometry as jgeo
from fusion4landslide_tpu.pipelines import fusion as jfusion
from fusion4landslide_tpu.pipelines import fusion_device as jfd
from fusion4landslide_tpu_torch.pipelines import fusion as tfusion
from fusion4landslide_tpu_torch.pipelines import fusion_device as tfd
from fusion4landslide_tpu_torch.synth import synth_rgb_tile

IMG = (512, 512)


@pytest.fixture
def emulated(monkeypatch):
    """The JAX grid kNN on its TPU branch: Pallas window kernel, interpret
    mode, with a window that holds these small clouds."""
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    monkeypatch.setattr(knn_pallas, "pallas_available", lambda: True)
    monkeypatch.setattr(
        hashgrid_pallas, "hash_grid_knn_window",
        functools.partial(hashgrid_pallas.hash_grid_knn_window, interpret=True),
    )
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def scene():
    """A small RGB tile: the clouds stand in for voxel clouds, projected by
    the JAX side; pixel matches padded to a bucket with a count."""
    src, tgt, _, _, pix, K, E, _ = synth_rgb_tile(
        1000, 1.0, 1.5, halo=2.0, image_size=IMG, focal=500.0
    )
    c = src.mean(0).astype(np.float32)
    n, m = len(src), len(tgt)
    N, M, P = 4096, 4096, 2048
    sc = np.zeros((N, 3), np.float32)
    sc[:n] = src - c
    tc = np.zeros((M, 3), np.float32)
    tc[:m] = tgt - c
    vs, vt = np.arange(N) < n, np.arange(M) < m
    pixb = np.zeros((P, 4), np.float32)
    pixb[: len(pix)] = pix
    pmask = np.arange(P) < len(pix)
    proj = {}
    for side, cl, v in (("s", sc, vs), ("t", tc, vt)):
        uv, dep, pv = jgeo.project_points(
            jnp.asarray(cl + c), jnp.asarray(E), jnp.asarray(K), IMG, mask=jnp.asarray(v)
        )
        proj[side] = tuple(np.asarray(a) for a in (uv, dep, pv))
    return dict(sc=sc, tc=tc, vs=vs, vt=vt, pix=pixb, pmask=pmask, K=K, E=E, c=c, proj=proj)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_pixel_nn1_matches_jax(scene, emulated):
    uv_s, _, pv_s = scene["proj"]["s"]
    ji, jok = jfd._pixel_nn1(
        jnp.asarray(uv_s), jnp.asarray(pv_s), jnp.asarray(scene["pix"][:, :2]),
        jnp.asarray(scene["pmask"]), 5.0,
    )
    ti, tok, ov = tfd._pixel_nn1(*_t(uv_s, pv_s, scene["pix"][:, :2], scene["pmask"]), 5.0)
    jok = np.asarray(jok)
    assert int(ov) == 0
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(ti.numpy()[jok], np.asarray(ji)[jok])
    assert 0.2 < jok.mean() < 0.9


@pytest.mark.parametrize("mode", ["nn_src_only", "nn_mutual", "nn_union"])
def test_chain_2d_matches_jax(scene, emulated, mode):
    uv_s, _, pv_s = scene["proj"]["s"]
    uv_t, _, pv_t = scene["proj"]["t"]
    args = (uv_s, pv_s, uv_t, pv_t, scene["pix"], scene["pmask"])
    ji, jok = jfd._chain_2d_device(*[jnp.asarray(a) for a in args], 5.0, mode)
    ti, tok, ov = tfd._chain_2d_device(*_t(*args), 5.0, mode)
    jok = np.asarray(jok)
    assert int(ov) == 0
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(ti.numpy()[jok], np.asarray(ji)[jok])
    assert jok.mean() > 0.1
    with pytest.raises(ValueError):
        tfd._chain_2d_device(*_t(*args), 5.0, "nn_bogus")


def test_lift_2d_matches_jax(scene, emulated):
    """Depth-map lifting; source rows matched by several pixel matches keep
    the last valid row."""
    uv_s, dep_s, pv_s = scene["proj"]["s"]
    uv_t, dep_t, pv_t = scene["proj"]["t"]
    pix = scene["pix"].copy()
    n_pix = int(scene["pmask"].sum())
    pix[n_pix - 50:n_pix] = pix[:50]  # duplicated match rows
    args = (scene["sc"], scene["vs"], scene["tc"], scene["vt"], uv_s, dep_s, pv_s, uv_t,
            dep_t, pv_t, pix, scene["pmask"], scene["E"], scene["E"], scene["K"], scene["c"])
    med = np.float32(0.08)
    ji, jok = jfd._lift_2d_device(*[jnp.asarray(a) for a in args], jnp.asarray(med), IMG, True)
    ti, tok, ov = tfd._lift_2d_device(*_t(*args), torch.tensor(med), IMG, True)
    jok = np.asarray(jok)
    assert int(ov) == 0
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(ti.numpy()[jok], np.asarray(ji)[jok])
    assert jok.sum() > 200


def _labels(rng, V, n_lab, frac_none=0.1):
    lab = rng.integers(0, n_lab + 3, V).astype(np.int32)  # some labels past the cap
    lab[rng.uniform(size=V) < frac_none] = -1
    return lab


@pytest.mark.parametrize("seed", [0, 1])
def test_vote_2d_matches_jax(seed):
    """Majority votes with many tied counts, labels past the caps and
    invalid votes: the same winner (smallest label on a tie) and count."""
    rng = np.random.default_rng(seed)
    V, S, T = 3000, 64, 48
    lab_s, lab_t = _labels(rng, V, S), _labels(rng, V, T)
    c2d = rng.integers(0, V, V).astype(np.int32)
    ok = rng.uniform(size=V) < 0.7
    jv, jc = jfd._vote_2d_device(*[jnp.asarray(a) for a in (lab_s, lab_t, c2d, ok)], S, T)
    tv, tc = tfd._vote_2d_device(*_t(lab_s, lab_t, c2d, ok), S, T)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (np.asarray(jc) > 1).sum() > 10


def _jax_extras(vote_tgt, vote_cnt, svalid, tgt_of_src, pair_valid, E_l):
    """The JAX step's extras-table expressions (fusion_device.py:853-864)."""
    vote_ok = (vote_cnt >= 1) & svalid
    extra_valid = vote_ok & ~(pair_valid & (tgt_of_src == vote_tgt))
    order = jnp.argsort(~extra_valid)
    sel = order[:E_l].astype(jnp.int32)
    sel_ok = jnp.take(extra_valid, sel)
    n_over = jnp.sum(extra_valid) - jnp.sum(sel_ok)
    tgt_e = jnp.where(sel_ok, jnp.take(vote_tgt, sel), -1)
    return sel, sel_ok, tgt_e, n_over


@pytest.mark.parametrize("cap", [16, 64])
def test_extras_table_matches_jax(cap):
    """Valid-first stable order, the cap's overflow count, and the voted
    targets (a cap of 16 overflows)."""
    rng = np.random.default_rng(3)
    S, T = 128, 96
    vote_tgt = rng.integers(0, T, S).astype(np.int32)
    vote_cnt = rng.integers(0, 3, S).astype(np.int32)
    svalid = np.arange(S) < 110
    tgt_of_src = np.where(rng.uniform(size=S) < 0.5, vote_tgt, rng.integers(0, T, S)).astype(np.int32)
    pair_valid = rng.uniform(size=S) < 0.6
    args = (vote_tgt, vote_cnt, svalid, tgt_of_src, pair_valid)
    js, jok, jt, jn = _jax_extras(*[jnp.asarray(a) for a in args], cap)
    ext = tfd._extras_table(*_t(*args), cap)
    np.testing.assert_array_equal(ext.sel.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ext.sel_ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ext.tgt.numpy(), np.asarray(jt))
    assert int(ext.n_over) == int(jn)
    assert (int(jn) > 0) == (cap == 16)


@pytest.mark.parametrize("weighting", [False, True])
def test_fine_match_pairs_second_channel_matches_jax(weighting):
    """Two correspondence channels per pair (3D matches, then 2D-lifted
    ones), compacted to the matched ones in list order, optionally
    weighted n3/(n3+n2) in the Kabsch seed."""
    rng = np.random.default_rng(4)
    Pairs, P = 24, 48
    Vs = Vt = Pairs * P
    src = rng.uniform(-2, 2, (Vs, 3)).astype(np.float32)
    R = np.array([[0.999, -0.04, 0], [0.04, 0.999, 0], [0, 0, 1]], np.float32)
    tgt = (src @ R.T + [0.05, -0.02, 0.01] + rng.normal(0, 0.003, (Vs, 3))).astype(np.float32)
    tgt_lab = (np.arange(Vt) // P).astype(np.int32)
    members = (np.arange(Pairs)[:, None] * P + np.arange(P)[None]).astype(np.int32)
    mmask = np.arange(P)[None] < rng.integers(5, P + 1, Pairs)[:, None]
    pair_lab = np.where(rng.uniform(size=Pairs) < 0.9, np.arange(Pairs), -1).astype(np.int32)
    c1 = np.where(rng.uniform(size=Vs) < 0.9, np.arange(Vs), rng.integers(0, Vt, Vs)).astype(np.int32)
    v1 = rng.uniform(size=Vs) < 0.8
    c2 = np.where(rng.uniform(size=Vs) < 0.8, np.arange(Vs), rng.integers(0, Vt, Vs)).astype(np.int32)
    v2 = rng.uniform(size=Vs) < 0.6
    kw = dict(num_min_quality=5, num_min_fine=5, icp_threshold=0.05, icp_max_iter=5,
              fine_max_matches=40)
    args = (members, mmask, pair_lab, c1, v1, tgt_lab, src, tgt)
    jo = jfusion.fine_match_pairs(
        *[jnp.asarray(a) for a in args], corres2_tgt_idx=jnp.asarray(c2),
        corres2_valid=jnp.asarray(v2), weighting=weighting, **kw,
    )
    to = tfusion.fine_match_pairs(
        *_t(*args), corres2_tgt_idx=torch.from_numpy(c2), corres2_valid=torch.from_numpy(v2),
        weighting=weighting, **kw,
    )
    np.testing.assert_array_equal(to.n_matches.numpy(), np.asarray(jo.n_matches))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_allclose(to.R.numpy(), np.asarray(jo.R), atol=2e-5)
    np.testing.assert_allclose(to.t.numpy(), np.asarray(jo.t), atol=2e-5)
    np.testing.assert_allclose(to.rmse.numpy(), np.asarray(jo.rmse), atol=2e-5)
    assert np.asarray(jo.valid).sum() >= Pairs // 2
    assert (np.asarray(jo.n_matches) > 40).any()  # the compaction cap bites
