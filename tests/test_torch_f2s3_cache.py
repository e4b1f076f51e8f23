"""The host F2S3 tile's feature cache (``pipelines.f2s3.run_f2s3_tile``
with ``save_interim`` / ``feat_compute``) against the JAX package's: a
cache hit skips DIPs and writes the computing run's tables byte for byte,
and a cache written by either package loads in the other.

Tolerance: tables byte-equal within the port; loaded descriptors equal
exactly across the packages; the pre-pruning tables of the two packages
on one cache agree on the feature 1-NN rows that are not near-ties
(descriptor distance gap over 1e-5)."""

import os
import shutil

import jax
import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.pipelines import f2s3 as tf2s3
from fusion4landslide_tpu_torch.synth import synth_split_tile

CFG = {
    "output_folder": "run", "voxel_size": 0.1, "max_disp_magnitude": 5.0,
    "filter_median_magnitude": True, "fill_gaps_c2c": True, "refine_results": True,
    "n_normals": 30, "small_patch_removal": True,
}


@pytest.fixture(scope="module")
def models():
    from fusion4landslide_tpu.models.dips import PointNetFeature
    from fusion4landslide_tpu.models.filtering import FilteringNetwork
    from fusion4landslide_tpu_torch.models import dips as tdips
    from fusion4landslide_tpu_torch.models.convert import filter_from_flax, state_dict_from_flax

    dips = jax.tree.map(np.asarray, PointNetFeature().init(
        jax.random.PRNGKey(0), np.zeros((2, 128, 3), np.float32)))
    filt = jax.tree.map(np.asarray, FilteringNetwork().init(
        jax.random.PRNGKey(2), np.zeros((2, 8, 6), np.float32), np.ones((2, 8), bool)))
    td = tdips.PointNetFeature()
    td.load_state_dict(state_dict_from_flax(dips))
    return dips, filt, td.eval(), filter_from_flax(filt)


@pytest.fixture(scope="module")
def tile():
    src, tgt, _, _ = synth_split_tile(250, 1.0, 1.0, halo=2.0)
    return src, tgt


def written(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def cache_path(out, tile_id):
    return os.path.join(out, "run", "features", f"features_tile_{tile_id}.npz")


def test_cache_hit_writes_the_computing_runs_tables(tmp_path, models, tile, monkeypatch):
    _, _, td, tf = models
    src, tgt = tile
    out = str(tmp_path)
    computing: dict = {}
    first = tf2s3.run_f2s3_tile({**CFG, "output_dir": out, "save_interim": True}, td, tf, src,
                                tgt, tile_id=7, device="cpu", timings=computing)
    with np.load(cache_path(out, 7)) as z:
        assert sorted(z.files) == ["src_feat", "tgt_feat"]
        np.testing.assert_array_equal(z["src_feat"], first["src_feat"])
        np.testing.assert_array_equal(z["tgt_feat"], first["tgt_feat"])
    tables = written(os.path.join(out, "run", "results"))
    shutil.rmtree(os.path.join(out, "run", "results"))

    def no_dips(*a, **k):
        raise AssertionError("DIPs ran on a cache hit")

    monkeypatch.setattr(tf2s3, "compute_dips_features", no_dips)
    hit: dict = {}
    again = tf2s3.run_f2s3_tile({**CFG, "output_dir": out, "feat_compute": False}, td, tf, src,
                                tgt, tile_id=7, device="cpu", timings=hit)
    assert "dips_features" in computing and "dips_features" not in hit and "feature_cache" in hit
    assert written(os.path.join(out, "run", "results")) == tables and len(tables) >= 5
    for key in ("keep", "labels", "src_feat", "tgt_feat", "dvfs"):
        np.testing.assert_array_equal(again[key], first[key])

    # feat_compute: false without a cache file computes (and save_interim
    # unset writes none).
    monkeypatch.undo()
    other = str(tmp_path / "other")
    cold = tf2s3.run_f2s3_tile({**CFG, "output_dir": other, "feat_compute": False}, td, tf, src,
                               tgt, tile_id=7, device="cpu")
    np.testing.assert_array_equal(cold["src_feat"], first["src_feat"])
    assert not os.path.exists(cache_path(other, 7))


def test_caches_interchange_with_jax(tmp_path, models, tile):
    from fusion4landslide_tpu.pipelines.f2s3 import run_f2s3_tile as j_run
    from fusion4landslide_tpu_torch.ops.knn import knn
    import torch

    dips, filt, td, tf = models
    src, tgt = tile
    # JAX writes, the port reads.
    jdir = str(tmp_path / "jax")
    jo = j_run({**CFG, "output_dir": jdir, "save_interim": True}, dips, filt, src, tgt, tile_id=2)
    name = os.path.join(jdir, "run", "results", "f2s3_dvfms_without_pruning_of_tile_2.txt")
    j_table = np.loadtxt(name)
    to = tf2s3.run_f2s3_tile({**CFG, "output_dir": jdir, "feat_compute": False,
                              "output_folder": "run"}, td, tf, src, tgt, tile_id=2, device="cpu")
    np.testing.assert_array_equal(to["src_feat"], np.asarray(jo["src_feat"]))
    np.testing.assert_array_equal(to["tgt_feat"], np.asarray(jo["tgt_feat"]))
    # The port writes, JAX reads.
    pdir = str(tmp_path / "port")
    po = tf2s3.run_f2s3_tile({**CFG, "output_dir": pdir, "save_interim": True}, td, tf, src, tgt,
                             tile_id=2, device="cpu")
    jp = j_run({**CFG, "output_dir": pdir, "feat_compute": False}, dips, filt, src, tgt, tile_id=2)
    jax.clear_caches()
    np.testing.assert_array_equal(np.asarray(jp["src_feat"]), po["src_feat"])
    np.testing.assert_array_equal(np.asarray(jp["tgt_feat"]), po["tgt_feat"])
    np.testing.assert_array_equal(np.asarray(jp["labels"]), po["labels"])
    # On one cache the two packages' feature 1-NN agree but on near-ties,
    # read from their pre-pruning tables: JAX's CPU 1-NN scores the
    # expanded |q|^2 + |r|^2 - 2 q.r, whose rounding moves a descriptor
    # distance by up to ~1e-5 here.
    a, b = j_table, np.loadtxt(name)
    assert a.shape == b.shape == (len(src), 4)
    d, _ = knn(torch.from_numpy(to["src_feat"]), torch.from_numpy(to["tgt_feat"]), 2)
    tie = (torch.sqrt(d[:, 1]) - torch.sqrt(d[:, 0]) <= 1e-5).numpy()
    same = np.abs(a - b).max(axis=1) <= 2e-6
    assert (same | tie).all() and same.mean() > 0.99
