"""``main_f2s3`` with ``feat_patch_points: 192`` and
``feat_sample_priority: random`` through the runner (``use_mesh: true``),
as ``tests/test_torch_dips_drivers.py`` runs the other options. A file of
its own so that the parallel test run can place it beside the other
driver tests.
"""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from test_torch_dips_drivers import run_driver_with_options, seeded_weights  # noqa: F401


def test_f2s3_driver_runs_the_random_branch_on_the_runner(tmp_path, seeded_weights):
    run_driver_with_options(tmp_path, seeded_weights, "f2s3",
                            {"feat_patch_points": 192, "feat_sample_priority": "random",
                             "use_mesh": True})
