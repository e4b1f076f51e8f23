"""The port's RGB+3D fusion step with ``lifting_type: interpolation`` vs
the JAX package (``tests/test_torch_rgb_step.py``'s tile, weights and
score). A file of its own so that the parallel test run can place it
beside the other RGB step cases.
"""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
import pytest

from test_torch_rgb_step import check_rgb_step, params, tile  # noqa: F401 (fixtures)


@pytest.mark.parametrize("lifting,coarse_2d_mode", [("interpolation", "fusion")])
def test_rgb_tile_step_matches_emulated_jax(tile, params, monkeypatch, lifting,  # noqa: F811
                                            coarse_2d_mode):
    check_rgb_step(tile, params, monkeypatch, lifting, coarse_2d_mode)
