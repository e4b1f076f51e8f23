"""The port's RGB+3D fusion tile step and runner vs the JAX package.

A small tile seen by a nadir camera with pixel matches for half its source
points (``synth_small_rgb_tile``, a 512^2 image at focal 500). The JAX step runs
its TPU branch emulated on the CPU (Pallas kernels in interpret mode); the
port runs on the CPU with its kernels' plain versions. Scored as
``tools/parity_check.py`` scores mesh vs host.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models import aggregation as tagg
from fusion4landslide_tpu_torch.models import dips as tdips
from fusion4landslide_tpu_torch.models.convert import params_from_flax
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.synth import SMALL_IMG_SIZE, synth_small_rgb_tile

IMG = SMALL_IMG_SIZE
STATICS = dict(
    levels=(1, 2),
    patch_points=128,
    chunk=512,
    k_neighbors=8,
    sv_cap=256,
    member_cap=128,
    agg_max_points=64,
    small_patch=3,
    icp_max_iter=8,
    fine_max_matches=64,
    with_sparse=True,
    with_tgt2src=True,
    image_size=IMG,
)
SCALARS = (5.0, 0.1, 0.1, 10, 10, 0.5, 0.15)


@pytest.fixture(scope="module")
def tile():
    src, tgt, core, _, pix, K, E, _ = synth_small_rgb_tile()
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    pixb = np.zeros((1, bucket_size(len(pix)), 4), np.float32)
    pixb[0, : len(pix)] = pix
    images = dict(
        pix_matches=pixb, pix_count=np.array([len(pix)], np.int32), intrinsic=K,
        src_extrinsics=E[None], tgt_extrinsics=E[None], center=c.astype(np.float32),
        pixel_thres=5.0,
    )
    return dict(src=src, tgt=tgt, n=n, m=m, sb=sb, tb=tb, sm=np.arange(N) < n,
                tm=np.arange(M) < m, core=core, pix=pix, K=K, E=E, images=images)


@pytest.fixture(scope="module")
def params():
    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet
    from fusion4landslide_tpu.models.dips import PointNetFeature

    dips = PointNetFeature().init(jax.random.PRNGKey(0), np.zeros((2, 128, 3), np.float32))
    agg = ClusterFeatureNet().init(
        jax.random.PRNGKey(1), np.zeros((2, 8, 64), np.float32), np.ones((2, 8), bool)
    )
    dips, agg = jax.tree.map(np.asarray, dips), jax.tree.map(np.asarray, agg)
    sd_d, sd_a = params_from_flax(dips, agg)
    td, ta = tdips.PointNetFeature(), tagg.ClusterFeatureNet()
    td.load_state_dict(sd_d)
    ta.load_state_dict(sd_a)
    return dips, agg, td.eval(), ta.eval()


def _port_step(tile, td, ta, statics=STATICS, **kw):
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

    images = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in tile["images"].items()}
    return fusion3d_tile_step(
        td, ta, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
        torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *SCALARS,
        device="cpu", **images, **{**statics, **kw},
    )


def _emulated_jax_step(tile, params, monkeypatch, **kw):
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    monkeypatch.setattr(knn_pallas, "pallas_available", lambda: True)
    for mod, name in (
        (hashgrid_pallas, "radius_sample_window"),
        (hashgrid_pallas, "hash_grid_knn_window"),
        (knn_pallas, "knn_pallas"),
    ):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    from fusion4landslide_tpu.pipelines.fusion_device import fusion3d_tile_step

    dips, agg, _, _ = params
    jo = fusion3d_tile_step(
        dips, agg, tile["sb"], tile["sm"], tile["tb"], tile["tm"],
        jax.random.PRNGKey(0), *SCALARS, **tile["images"], **{**STATICS, **kw},
    )
    jo = jax.tree.map(np.asarray, jo)
    jax.clear_caches()
    return jo


@pytest.mark.parametrize("lifting,coarse_2d_mode", [
    ("nn_search", "fusion"),
    ("nn_search", "only_2d"),
])
def test_rgb_tile_step_matches_emulated_jax(tile, params, monkeypatch, lifting, coarse_2d_mode):
    """The ``interpolation`` lifting's case is in
    ``tests/test_torch_rgb_step_interp.py``."""
    check_rgb_step(tile, params, monkeypatch, lifting, coarse_2d_mode)


def check_rgb_step(tile, params, monkeypatch, lifting, coarse_2d_mode):
    """The port's step against the emulated JAX step on ``tile``, scored
    as ``tools/parity_check.py`` scores two paths."""
    kw = dict(lifting=lifting, coarse_2d_mode=coarse_2d_mode)
    jo = _emulated_jax_step(tile, params, monkeypatch, **kw)
    _, _, td, ta = params
    to = _port_step(tile, td, ta, **kw)
    n, m = tile["n"], tile["m"]
    assert int(jo.n_vox_src) == int(to.n_vox_src)
    assert int(jo.n_vox_tgt) == int(to.n_vox_tgt)
    assert abs(float(jo.median_res) - float(to.median_res)) <= 1e-6 * float(jo.median_res)
    assert to.overflow == 0
    assert int(jo.n_c2d) == int(to.n_c2d) > 0
    assert int(jo.n_dropped) == int(to.n_dropped)
    vj, vt = jo.valid[:n], to.valid[:n].numpy()
    # The 2D channel assigns most of the tile, as bench.py's RGB target.
    assert vj[tile["core"]].mean() > 0.9
    common = vj & vt
    assert common.sum() >= 0.99 * max(vj.sum(), vt.sum())
    gap = np.linalg.norm(jo.moved[:n][common] - to.moved[:n].numpy()[common], axis=1)
    assert np.median(gap) < 1e-4
    assert (gap > 0.01).mean() <= 0.01
    sj, st = jo.sparse_ok[:n], to.sparse_ok[:n].numpy()
    assert (sj & st).sum() >= 0.99 * max(sj.sum(), st.sum())
    tj, tt = jo.t2s_valid[:m], to.t2s_valid[:m].numpy()
    assert (tj & tt).sum() >= 0.99 * max(tj.sum(), tt.sum())
    both = tj & tt
    t2s_gap = np.linalg.norm(jo.t2s_src_est[:m][both] - to.t2s_src_est[:m].numpy()[both], axis=1)
    assert np.median(t2s_gap) < 1e-4
