"""``partition_type: superpoint`` through the port's host fusion tile vs
the JAX package's (its TPU branch emulated on the CPU), on
``tests/test_torch_fusion_options.py``'s tile, weights and shared
partition tables. A file of its own so that the parallel test run can
place it beside the other option tests.
"""

import os.path as osp

import jax
import numpy as np
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.pipelines import fusion as tf
from test_torch_fusion_host import CFG, score_host_parity, written
from test_torch_fusion_options import (  # noqa: F401 (fixtures)
    MAX_MAG,
    _record,
    _with_tables,
    models,
    tile,
)


def test_host_tile_superpoint_matches_emulated_jax(models, tile, tmp_path, monkeypatch):
    import functools

    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas
    from fusion4landslide_tpu.pipelines.fusion import run_fusion3d_tile as j_run

    dips, agg, td, ta = models
    src, tgt = tile["src"], tile["tgt"]
    cfg = {**CFG, "partition_type": "superpoint", "level_of_superpoint": [1, 2, 3],
           "max_magnitude": MAX_MAG}
    for side in ("jax", "port"):
        _with_tables(tile, tmp_path / side / "run")
    calls = _record(monkeypatch, tf)
    jax.clear_caches()
    with monkeypatch.context() as m:
        m.setattr(knn_pallas, "pallas_available", lambda: True)
        for mod, name in ((hashgrid_pallas, "radius_sample_window"),
                          (hashgrid_pallas, "hash_grid_knn_window"), (knn_pallas, "knn_pallas")):
            m.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        jo = j_run({**cfg, "output_dir": str(tmp_path / "jax")}, dips, agg, src, tgt, tile_id=5)
    jax.clear_caches()
    timings: dict = {}
    to = tf.run_fusion3d_tile({**cfg, "output_dir": str(tmp_path / "port")}, td, ta, src, tgt,
                              tile_id=5, device="cpu", timings=timings)
    readings = score_host_parity(jo, to, src, calls)
    assert jo["per_level"] == to["per_level"] and len(to["per_level"]) == 3
    assert all(n_s > 0 for _, n_s, _ in to["per_level"])
    assert "partition_tables" in timings and "superpoint_knn" not in timings
    assert written(tmp_path / "jax") == written(tmp_path / "port")
    # The per-level dedup: each written table as JAX's, rows within 1e-5 m.
    res = osp.join("run", "results")
    for name in ("c2f_dvfs_src2tgt_tile_5.txt", "c2f_dvfms_tgt2src_tile_5.txt",
                 "c2f_dvfms_src2tgt_discrete_visualize_tile_5.txt"):
        a = np.loadtxt(tmp_path / "port" / res / name, ndmin=2)
        b = np.loadtxt(tmp_path / "jax" / res / name, ndmin=2)
        assert abs(len(a) - len(b)) <= 0.01 * len(b) + readings["rank1_refit_voxels"], name
