"""The port's F2S3 step with bf16 descriptors and a patch size off the
multiples of 128 (``tests/test_torch_f2s3.py``'s tile, weights and
statics). A file of its own so that the parallel test run can place it
beside the other F2S3 tests.
"""

import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from test_torch_f2s3 import STATICS, _port_step, params, tile  # noqa: F401 (fixtures)


def test_unported_f2s3_options_raise(tile, params):
    """bf16 descriptors and patch sizes off the multiples of 128 are
    ported: they run (``test_torch_dips_branches.py`` and
    ``test_torch_dips_bf16.py`` hold them to JAX). A descriptor dtype the
    port has no trunk for still raises."""
    _, _, td, tf = params
    n = tile["n"]
    out = _port_step(tile, td, tf, **{**STATICS, "feat_dtype": "bfloat16", "patch_points": 64})
    assert out.keep[:n].any() and torch.isfinite(out.new_tgt[:n]).all()
    with pytest.raises(ValueError, match="feat_dtype"):
        _port_step(tile, td, tf, **{**STATICS, "feat_dtype": "float16"})
