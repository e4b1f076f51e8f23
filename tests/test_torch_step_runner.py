"""The port's 3D-only fusion runner (``run_fusion3d_tiles``) writes the
step's tables: ``tests/test_torch_step.py``'s tile, weights and step. A
file of its own so that the parallel test run can place it beside the
other step tests.
"""

import os.path as osp

import numpy as np
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from test_torch_step import _port_step, params, tile  # noqa: F401 (fixtures)


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
