"""The port's 3D-only fusion tile step and runner vs the JAX package.

The JAX step runs its TPU branch emulated on the CPU (Pallas kernels in
interpret mode); the port runs on the CPU with its kernels' plain
versions. Scored as ``tools/parity_check.py`` scores mesh vs host.
"""

import functools
import os.path as osp

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models import aggregation as tagg
from fusion4landslide_tpu_torch.models import dips as tdips
from fusion4landslide_tpu_torch.models.convert import params_from_flax
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.synth import synth_split_tile

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
)
SCALARS = (5.0, 0.1, 0.1, 10, 10, 0.5, 0.15)


@pytest.fixture(scope="module")
def tile():
    src, tgt, _, _ = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    return dict(src=src, tgt=tgt, n=n, m=m, sb=sb, tb=tb,
                sm=np.arange(N) < n, tm=np.arange(M) < m)


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


def _port_step(tile, td, ta, **kw):
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

    return fusion3d_tile_step(
        td, ta, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
        torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *SCALARS,
        device="cpu", **kw,
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
        jax.random.PRNGKey(0), *SCALARS, **STATICS, **kw,
    )
    jo = jax.tree.map(np.asarray, jo)
    jax.clear_caches()
    return jo


def _assert_step_parity(jo, to, tile):
    """``tools/parity_check.py``'s scoring of two paths."""
    n, m = tile["n"], tile["m"]
    assert int(jo.n_vox_src) == int(to.n_vox_src)
    assert int(jo.n_vox_tgt) == int(to.n_vox_tgt)
    assert abs(float(jo.median_res) - float(to.median_res)) <= 1e-6 * float(jo.median_res)
    assert to.overflow == 0
    vj, vt = jo.valid[:n], to.valid[:n].numpy()
    assert vj.sum() > 0.2 * n
    common = vj & vt
    assert common.sum() >= 0.99 * max(vj.sum(), vt.sum())
    gap = np.linalg.norm(jo.moved[:n][common] - to.moved[:n].numpy()[common], axis=1)
    assert np.median(gap) < 1e-4
    assert (gap > 0.01).mean() <= 0.01
    # The other outputs, on the common assigned points.
    sj, st = jo.sparse_ok[:n], to.sparse_ok[:n].numpy()
    assert (sj & st).sum() >= 0.99 * max(sj.sum(), st.sum())
    tj, tt = jo.t2s_valid[:m], to.t2s_valid[:m].numpy()
    assert (tj & tt).sum() >= 0.99 * max(tj.sum(), tt.sum())
    both = tj & tt
    t2s_gap = np.linalg.norm(jo.t2s_src_est[:m][both] - to.t2s_src_est[:m].numpy()[both], axis=1)
    assert np.median(t2s_gap) < 1e-4


def test_fusion3d_tile_step_matches_emulated_jax(tile, params, monkeypatch):
    jo = _emulated_jax_step(tile, params, monkeypatch)
    _, _, td, ta = params
    _assert_step_parity(jo, _port_step(tile, td, ta, **STATICS), tile)


def test_runner_writes_the_step_tables(tile, params, tmp_path):
    from fusion4landslide_tpu_torch.parallel.pipeline import (
        fusion3d_statics,
        run_fusion3d_tiles,
    )

    _, _, td, ta = params
    cfg = {
        "output_dir": str(tmp_path), "output_folder": "run",
        "level_of_superpoint": [1, 2], "feat_patch_points": 128, "feat_chunk": 512,
        "sv_cap": 256, "member_cap": 128, "agg_max_points": 64,
        "num_min_matches_for_small_patch": 3, "fine_max_matches": 64,
        "max_magnitude": 5.0, "icp_threshold": 0.1, "voxel_size_init": 0.1,
        "output_tgt2src": True, "dataset": "brienz_tls",
    }
    src, tgt = tile["src"], tile["tgt"]
    res = run_fusion3d_tiles(cfg, td, ta, [(7, src, tgt)], device="cpu")
    N, M = tile["sb"].shape[0], tile["tb"].shape[0]
    statics = fusion3d_statics(cfg, N, M)
    assert statics["levels"] == (1, 2) and statics["chunk"] == 512
    out = _port_step(tile, td, ta, **statics)
    n = tile["n"]
    valid = out.valid[:n].numpy()
    want = np.hstack([src[valid], out.moved[:n].numpy()[valid] + src.mean(0)])
    results = osp.join(tmp_path, "run", "results")
    got = np.loadtxt(osp.join(results, "c2f_dvfs_src2tgt_tile_7.txt")).reshape(-1, 6)
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_array_equal(res[7]["valid"], valid)
    for name in ("c2f_dvfms_src2tgt_tile_7.txt", "c2f_dvfms_tgt2src_tile_7.txt"):
        assert osp.exists(osp.join(results, name))


def test_unported_options_raise(tile, params):
    """bf16 descriptors and patch sizes off the multiples of 128 are
    ported: they run (``test_torch_dips_branches.py`` and
    ``test_torch_dips_bf16.py`` hold them to JAX). A descriptor dtype the
    port has no trunk for still raises."""
    _, _, td, ta = params
    n = tile["n"]
    out = _port_step(tile, td, ta, **{**STATICS, "feat_dtype": "bfloat16", "patch_points": 64})
    assert out.valid[:n].any() and torch.isfinite(out.moved[:n]).all()
    with pytest.raises(ValueError, match="feat_dtype"):
        _port_step(tile, td, ta, **{**STATICS, "feat_dtype": "float16"})


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    from fusion4landslide_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
