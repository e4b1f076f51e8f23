"""The port's F2S3 runner writes its step's tables
(``tests/test_torch_f2s3.py``'s tile, weights and statics). A file of its
own so that the parallel test run can place it beside the F2S3 step
parity test.
"""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
import os.path as osp

import numpy as np

from test_torch_f2s3 import (  # noqa: F401 (fixtures)
    MAX_DISP,
    STATICS,
    VOXEL,
    params,
    port_out,
    tile,
)


def test_f2s3_runner_writes_the_step_tables(tile, params, port_out, tmp_path):
    from fusion4landslide_tpu_torch.parallel.pipeline import f2s3_statics, run_f2s3_tiles

    _, _, td, tf = params
    cfg = {
        "output_dir": str(tmp_path), "output_folder": "run", "voxel_size": VOXEL,
        "max_disp_magnitude": MAX_DISP, "filter_median_magnitude": True,
        "fill_gaps_c2c": True, "refine_results": True, "n_normals": 30,
        "feat_patch_points": 128, "feat_chunk": 512, "member_cap": 256,
    }
    src, tgt = tile["src"], tile["tgt"]
    res = run_f2s3_tiles(cfg, td, tf, [(3, src, tgt)], device="cpu")
    N, M = tile["sb"].shape[0], tile["tb"].shape[0]
    statics = f2s3_statics(cfg, N, M)
    # The JAX runner's DIPs options, at their defaults.
    assert statics == {**STATICS, "feat_dtype": None, "k_max": 512, "sample_cap": 48,
                       "sample_priority": "knn"}
    out = port_out
    n, c = tile["n"], src.mean(0)
    keep = out.keep[:n].numpy()
    s = tile["sb"][:n]
    results = osp.join(tmp_path, "run", "results")

    def load(name, cols):
        return np.loadtxt(osp.join(results, name)).reshape(-1, cols)

    want = np.hstack([s[keep] + c, out.new_tgt[:n].numpy()[keep] + c])
    np.testing.assert_allclose(load("f2s3_dvfs_of_tile_3.txt", 6), want, atol=2e-6)
    np.testing.assert_array_equal(res[3]["keep"], keep)
    mags = out.mag[:n].numpy()[keep]
    np.testing.assert_allclose(load("f2s3_dvfms_of_tile_3.txt", 4)[:, 3], mags, atol=2e-6)
    mag0 = np.linalg.norm(out.nn_tgt[:n].numpy() - s, axis=1)
    np.testing.assert_allclose(load("f2s3_dvfms_without_pruning_of_tile_3.txt", 4)[:, 3], mag0, atol=2e-6)
    c2c = out.c2c[:n].numpy().copy()
    c2c[keep] = mags
    np.testing.assert_allclose(
        load(osp.join("combined_with_c2c", "f2s3_dvfms_combined_with_c2c_of_tile_3.txt"), 4)[:, 3],
        c2c, atol=2e-6,
    )
    for name in ("f2s3_dvfms_of_tile_3_visualize_0_5.txt",
                 osp.join("filtered_by_magnitude", "f2s3_dvfms_filtered_by_median_mag_of_tile_3.txt")):
        assert osp.exists(osp.join(results, name)), name


def test_f2s3_runner_seeds_each_tile_by_its_place(tile, params, port_out, tmp_path,
                                                  monkeypatch):
    """The i-th tile's step gets ``rng_seed + i``, whichever of two
    streams runs it (the step itself is replaced by its recorded output;
    tile i drops its last i source points, so the step's source mask
    names the tile)."""
    from fusion4landslide_tpu_torch.parallel import pipeline as tp

    seen = {}

    def step(*args, rng_seed, **kw):
        seen[tile["n"] - int(args[3].sum())] = rng_seed
        return port_out

    monkeypatch.setattr(tp, "f2s3_tile_step", step)
    _, _, td, tf = params
    cfg = {"output_dir": str(tmp_path), "output_folder": "run", "voxel_size": VOXEL,
           "max_disp_magnitude": MAX_DISP, "feat_patch_points": 96, "feat_chunk": 512,
           "feat_sample_priority": "random"}
    src, tgt = tile["src"], tile["tgt"]
    tiles = [(10 + i, src[:len(src) - i], tgt) for i in range(3)]
    tp.run_f2s3_tiles(cfg, td, tf, tiles, devices=["cpu", "cpu"], rng_seed=7,
                      n_bucket=tile["sb"].shape[0], m_bucket=tile["tb"].shape[0])
    assert seen == {0: 7, 1: 8, 2: 9}
