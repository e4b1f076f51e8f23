"""The port's ``main_fusion`` vs the JAX driver in-process on
``tests/test_torch_driver.py``'s two-tile epoch (the JAX TPU branch
emulated on the CPU, the port with ``--device cpu``). A file of its own
so that the parallel test run can place it beside the other driver tests.
"""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
import functools
import sys

import jax
import numpy as np

from test_torch_driver import (  # noqa: F401 (fixtures)
    ROOT,
    SMALL,
    _files,
    seeded_weights,
    write_run,
)


def test_main_fusion_matches_jax_driver(tmp_path, seeded_weights, monkeypatch):
    """JAX ``main_fusion.main()`` (TPU branch emulated) and the port's
    ``main`` with ``--device cpu`` on the same epoch, checkpoints and
    config (``use_mesh: false`` on both): the same tiles and file set, and
    each tile's tables held as ``tests/test_torch_fusion_host.py`` holds
    the host tile."""
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas
    from fusion4landslide_tpu_torch import main_fusion as t_main
    from fusion4landslide_tpu_torch.pipelines import fusion as tf

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_fusion_host import score_host_parity

    import main_fusion as j_main

    kw = dict(SMALL, use_mesh=False, return_interim=True)
    j_cfg = write_run(tmp_path, "fusion_3d_brienz.yaml", "jax", seeded_weights, **kw)
    t_cfg = write_run(tmp_path, "fusion_3d_brienz.yaml", "port", seeded_weights, **kw)
    jax_tiles, port_tiles, fine = {}, {}, []

    def record(store, fn):
        def run(cfg, dips, agg, src, tgt, *, tile_id, **k):
            out = fn(cfg, dips, agg, src, tgt, tile_id=tile_id, **k)
            store[tile_id] = (out, src, len(fine))
            return out
        return run

    orig_fine = tf.fine_match_pairs

    def rec_fine(*a, **k):
        out = orig_fine(*a, **k)
        fine.append((a, k, out))
        return out

    jax.clear_caches()
    with monkeypatch.context() as mp:
        mp.setattr(knn_pallas, "pallas_available", lambda: True)
        for mod, name in ((hashgrid_pallas, "radius_sample_window"),
                          (hashgrid_pallas, "hash_grid_knn_window"), (knn_pallas, "knn_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        mp.setattr(j_main, "run_fusion3d_tile", record(jax_tiles, j_main.run_fusion3d_tile))
        mp.setattr(sys, "argv", ["main_fusion.py", "--config", j_cfg])
        j_main.main()
    jax.clear_caches()
    monkeypatch.setattr(tf, "fine_match_pairs", rec_fine)
    monkeypatch.setattr(tf, "run_fusion3d_tile", record(port_tiles, tf.run_fusion3d_tile))
    summary = t_main.main(["--config", t_cfg, "--device", "cpu"])

    assert sorted(port_tiles) == sorted(jax_tiles) and len(port_tiles) == 2
    run = "demo_run"
    assert _files(tmp_path / "jax" / run) == _files(tmp_path / "port" / run)
    for rel in _files(tmp_path / "jax" / run / "tiled_data"):
        assert (tmp_path / "jax" / run / "tiled_data" / rel).read_bytes() == \
            (tmp_path / "port" / run / "tiled_data" / rel).read_bytes()
    start = 0
    for tid in sorted(port_tiles):
        to, src, end = port_tiles[tid]
        jo, jsrc, _ = jax_tiles[tid]
        np.testing.assert_array_equal(src, jsrc)
        score_host_parity(jo, to, src, fine[start:end], min_assigned=0.1)
        start = end
        table = np.loadtxt(tmp_path / "port" / run / "results" / f"c2f_dvfs_src2tgt_tile_{tid}.txt")
        np.testing.assert_allclose(table, to["dvfs"], atol=1e-5)
    assert set(summary["tile_s"]) == set(port_tiles)
    assert {"tiling_s", "read_tiles_s", "load_weights_s", "launches"} <= set(summary)

    # A second run skips both tiles (resume).
    port_tiles.clear()
    t_main.main(["--config", t_cfg, "--device", "cpu"])
    assert port_tiles == {}
