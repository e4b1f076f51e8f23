"""The port's F2S3 step at patch 96 with the 'random' grid branch vs the
JAX package's (its TPU branch emulated on the CPU), given JAX's draws, on
``tests/test_torch_dips_branches.py``'s tile and weights. A file of its
own so that the parallel test run can place it beside the other DIPs
branch tests.
"""

import jax
import numpy as np
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from test_torch_dips_branches import (  # noqa: F401 (fixtures)
    _fusion_models,
    _step_draws,
    step_tile,
    tpu_branch,
)


def test_f2s3_tile_step_random_branch_matches_emulated_jax(step_tile, tpu_branch):
    """The F2S3 step at patch 96, 'random', given JAX's draws: equal
    labels, >= 99% overlap of the kept points, new targets a median
    < 0.1 mm apart and <= 1% over 10 mm."""
    from fusion4landslide_tpu.models.filtering import FilteringNetwork
    from fusion4landslide_tpu.pipelines.f2s3_device import f2s3_tile_step as jstep
    from fusion4landslide_tpu_torch.models.convert import filter_from_flax
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step

    dips, _, td, _ = _fusion_models()
    filt = jax.tree.map(np.asarray, FilteringNetwork(num_layers=12).init(
        jax.random.PRNGKey(2), np.zeros((2, 8, 6), np.float32), np.ones((2, 8), bool)))
    t = step_tile
    kw = dict(patch_points=96, chunk=512, k_neighbors=30, sv_cap=256, member_cap=256,
              sample_priority="random")
    key = jax.random.PRNGKey(0)
    jo = jax.tree.map(np.asarray, jstep(dips, filt, t["sb"], t["sm"], t["tb"], t["tm"], key,
                                        5.0, 0.1, num_layers=12, **kw))
    to = f2s3_tile_step(td, filter_from_flax(filt),
                        *(torch.from_numpy(t[k]) for k in ("sb", "sm", "tb", "tm")), 5.0, 0.1,
                        device="cpu", dips_draws=_step_draws(key, "random", t, 512, 512), **kw)
    n = t["n"]
    np.testing.assert_array_equal(jo.labels, to.labels.numpy())
    kj, kt = jo.keep[:n], to.keep[:n].numpy()
    assert kj.sum() > 0.01 * n
    assert (kj & kt).sum() >= 0.99 * max(kj.sum(), kt.sum())
    both = kj & kt
    gap = np.linalg.norm(jo.new_tgt[:n][both] - to.new_tgt[:n].numpy()[both], axis=1)
    assert np.median(gap) < 1e-4
    assert (gap > 0.01).mean() <= 0.01
