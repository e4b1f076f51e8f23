"""The port's host F2S3 tile (``pipelines.f2s3.run_f2s3_tile``, what
``main_f2s3.py`` runs on one device) vs the JAX package's, with the JAX
side on its TPU branch emulated on the CPU (Pallas kernels in interpret
mode) and the same (bridged) random weights. Scored as the device step
is (``tests/test_torch_f2s3.py``).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models import dips as tdips
from fusion4landslide_tpu_torch.models.convert import filter_from_flax, state_dict_from_flax
from fusion4landslide_tpu_torch.synth import synth_split_tile

CFG = {
    "output_folder": "run", "voxel_size": 0.1, "max_disp_magnitude": 5.0,
    "filter_median_magnitude": True, "fill_gaps_c2c": True, "refine_results": True,
    "n_normals": 30, "small_patch_removal": True,
}


@pytest.fixture
def tpu_branch(monkeypatch):
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    monkeypatch.setattr(knn_pallas, "pallas_available", lambda: True)
    for mod, name in (
        (hashgrid_pallas, "radius_sample_window"),
        (hashgrid_pallas, "hash_grid_knn_window"),
        (knn_pallas, "knn_pallas"),
    ):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    yield
    jax.clear_caches()


def _written(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def test_host_f2s3_tile_matches_emulated_jax(tpu_branch, tmp_path):
    from fusion4landslide_tpu.models.dips import PointNetFeature
    from fusion4landslide_tpu.models.filtering import FilteringNetwork
    from fusion4landslide_tpu.pipelines.f2s3 import run_f2s3_tile as j_run
    from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile

    dips = jax.tree.map(np.asarray, PointNetFeature().init(
        jax.random.PRNGKey(0), np.zeros((2, 128, 3), np.float32)))
    filt = jax.tree.map(np.asarray, FilteringNetwork().init(
        jax.random.PRNGKey(2), np.zeros((2, 8, 6), np.float32), np.ones((2, 8), bool)))
    td = tdips.PointNetFeature()
    td.load_state_dict(state_dict_from_flax(dips))
    src, tgt, _, _ = synth_split_tile(400, 1.0, 1.0, halo=2.0)
    jo = j_run({**CFG, "output_dir": str(tmp_path / "jax")}, dips, filt, src, tgt, tile_id=1)
    jax.clear_caches()
    to = run_f2s3_tile({**CFG, "output_dir": str(tmp_path / "port")}, td.eval(),
                       filter_from_flax(filt), src, tgt, tile_id=1, device="cpu")
    n = len(src)

    assert _written(tmp_path / "jax") == _written(tmp_path / "port")
    np.testing.assert_array_equal(jo["labels"], to["labels"])
    assert np.abs(jo["src_feat"] - to["src_feat"]).max() < 1e-4
    assert np.abs(jo["tgt_feat"] - to["tgt_feat"]).max() < 1e-4
    # Feature 1-NN rows that differ are near-ties (descriptor distance gap
    # within 5e-5, the two sides' descriptor discrepancy); a swapped match
    # changes its whole supervoxel's scores, so keep is compared on the
    # supervoxels that saw the same correspondences.
    from fusion4landslide_tpu_torch.ops.knn import knn

    fs, ft = torch.from_numpy(to["src_feat"]), torch.from_numpy(to["tgt_feat"])
    d, i = knn(fs, ft, 2)
    _, ji = knn(*(torch.from_numpy(np.array(jo[k])) for k in ("src_feat", "tgt_feat")), 1)
    same_nn = (i[:, 0] == ji[:, 0]).numpy()
    tie = (torch.sqrt(d[:, 1]) - torch.sqrt(d[:, 0]) <= 5e-5).numpy()
    assert (same_nn | tie).all()
    lab = to["labels"]
    same = ~np.isin(lab, lab[~same_nn & (lab >= 0)])
    assert same.mean() > 0.9
    kj, kt = jo["keep"] & same, to["keep"] & same
    assert kj.sum() > 0.01 * n
    assert (kj & kt).sum() >= 0.99 * max(kj.sum(), kt.sum())
    # The written tables of the points kept on both sides.
    def table(side, name, cols):
        return np.loadtxt(tmp_path / side / "run" / "results" / name).reshape(-1, cols)

    jt = table("jax", "f2s3_dvfs_of_tile_1.txt", 6)
    tt = table("port", "f2s3_dvfs_of_tile_1.txt", 6)
    jkeys = {tuple(r) for r in np.round(jt[:, :3], 5)}
    rows = np.array([tuple(r) in jkeys for r in np.round(tt[:, :3], 5)])
    assert rows.mean() >= 0.97
    jmap = {tuple(r[:3]): r[3:] for r in np.round(jt, 5)}
    gap = np.linalg.norm(
        np.array([jmap[tuple(r[:3])] for r in np.round(tt[rows], 5)]) - np.round(tt[rows, 3:], 5), axis=1
    )
    assert np.median(gap) < 1e-4 and (gap > 0.01).mean() <= 0.01
    c2c_name = os.path.join("combined_with_c2c", "f2s3_dvfms_combined_with_c2c_of_tile_1.txt")
    jc, tc = table("jax", c2c_name, 4), table("port", c2c_name, 4)
    np.testing.assert_allclose(jc[:, :3], tc[:, :3], atol=2e-6)
    assert (np.abs(jc[:, 3] - tc[:, 3])[same] <= 1e-5).mean() >= 0.99


def test_host_tile_options_not_ported_raise(tmp_path):
    from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
    from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile

    dips, _ = seeded_models(0, "cpu")
    filt = seeded_filter(0, "cpu")
    src = np.zeros((10, 3), np.float32)
    # The feature cache (feat_compute, save_interim) is ported:
    # tests/test_torch_f2s3_cache.py holds it. So are bf16 descriptors
    # (tests/test_torch_dips_bf16.py); a dtype without a trunk raises
    # before tile work.
    with pytest.raises(ValueError, match="feat_dtype"):
        run_f2s3_tile({**CFG, "output_dir": str(tmp_path), "feat_dtype": "float16"}, dips,
                      filt, src, src, device="cpu")
    assert not os.listdir(tmp_path)
