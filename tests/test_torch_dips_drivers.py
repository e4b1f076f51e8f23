"""The port's drivers with the DIPs options of ROADMAP items 3 and 10:
``main_fusion`` and ``main_f2s3`` run a YAML config with
``feat_patch_points: 192`` (the exact-kNN branch in the host fusion tile,
the 'random' grid branch in the F2S3 runner's step) and / or
``feat_dtype: bfloat16`` on the CPU, and write their result tables. The
two-tile epoch and the seeded checkpoints are
``tests/test_torch_driver.py``'s."""

import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from test_torch_driver import SMALL, seeded_weights, write_run  # noqa: F401 (fixture)

TILING = {k: v for k, v in SMALL.items() if k.startswith(("min", "tile", "halo"))}


@pytest.mark.parametrize("method, options", [
    ("fusion", {"feat_patch_points": 192, "feat_k_max": 512, "feat_dtype": "bfloat16"}),
    ("f2s3", {"feat_patch_points": 192, "feat_sample_priority": "random", "use_mesh": True}),
    ("f2s3", {"feat_dtype": "bfloat16"}),
])
def test_drivers_run_the_dips_options(tmp_path, seeded_weights, method, options):
    from fusion4landslide_tpu_torch import main_f2s3, main_fusion

    shipped = "f2s3_brienz.yaml" if method == "f2s3" else "fusion_3d_brienz.yaml"
    small = SMALL if method == "fusion" else TILING
    cfg = write_run(tmp_path, shipped, "port", seeded_weights, epoch=(6.0, 4.0),
                    **{**small, "max_pts_per_tile": 1000, **options})
    driver = main_f2s3 if method == "f2s3" else main_fusion
    summary = driver.main(["--config", cfg, "--device", "cpu"])
    results = tmp_path / "port" / "demo_run" / "results"
    name = "f2s3_dvfms_of_tile_{}.txt" if method == "f2s3" else "c2f_dvfms_src2tgt_tile_{}.txt"
    for tid in range(2):
        table = np.loadtxt(results / name.format(tid), ndmin=2)
        assert table.shape[1] == 4 and np.isfinite(table).all()
    assert summary is not None
