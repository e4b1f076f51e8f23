"""The port's 3D-only fusion step with ``global_matching_gated: false``
vs the JAX package (``tests/test_torch_step.py``'s tile, weights and
score; the JAX step's TPU branch emulated on the CPU). A file of its own
so that the parallel test run can place it beside the other step tests.
"""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from test_torch_step import (  # noqa: F401 (fixtures)
    STATICS,
    _assert_step_parity,
    _emulated_jax_step,
    _port_step,
    params,
    tile,
)


def test_fusion3d_ungated_global_match_matches_emulated_jax(tile, params, monkeypatch):
    """``global_matching_gated: false``: the search-then-gate feature 1-NN
    through kernel 3 (``knn_pallas`` in the JAX step)."""
    jo = _emulated_jax_step(tile, params, monkeypatch, global_gated=False)
    _, _, td, ta = params
    _assert_step_parity(jo, _port_step(tile, td, ta, **STATICS, global_gated=False), tile)
