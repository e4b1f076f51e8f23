"""The port's registration solvers (``ops/registration.py``) vs the JAX
package on the CPU, with the same inputs.

Tolerances: R and t within 1e-4, inlier counts within +-1 (the solvers
iterate on float32 normal equations whose summation order differs); the
RANSAC run fed JAX's ``jax.random.choice`` samples gives equal inlier
sets; ``fine_match_pairs`` with each ``icp_type`` as in
``tests/test_icp_wiring.py``, transforms within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from scipy.spatial.transform import Rotation

from fusion4landslide_tpu_torch.ops import registration as treg


def _pairs(seed=0, B=3, n=192):
    """B planar-ish surface patches, each moved by its own small rigid
    motion, with noise, partial overlap and masked rows."""
    rng = np.random.default_rng(seed)
    src, tgt, Rs, ts = [], [], [], []
    for b in range(B):
        xy = rng.uniform(0, 3, size=(n, 2))
        z = 0.3 * np.sin(1.7 * xy[:, 0] + b) + 0.2 * np.cos(1.3 * xy[:, 1])
        p = np.column_stack([xy, z]).astype(np.float32)
        R = Rotation.from_rotvec(rng.normal(scale=0.02, size=3)).as_matrix().astype(np.float32)
        t = rng.normal(scale=0.03, size=3).astype(np.float32)
        q = p @ R.T + t + rng.normal(scale=0.002, size=p.shape).astype(np.float32)
        src.append(p)
        tgt.append(q[rng.permutation(n)])
        Rs.append(R)
        ts.append(t)
    src, tgt = np.stack(src), np.stack(tgt)
    smask = rng.random((B, n)) > 0.1
    tmask = rng.random((B, n)) > 0.1
    return src, tgt, smask, tmask, np.stack(Rs), np.stack(ts)


def _assert_icp_close(jr, tr, b):
    np.testing.assert_allclose(tr.R[b].numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t[b].numpy(), np.asarray(jr.t), atol=1e-4)
    assert abs(int(tr.n_inliers[b]) - int(jr.n_inliers)) <= 1
    np.testing.assert_allclose(float(tr.inlier_rmse[b]), float(jr.inlier_rmse), atol=1e-4)


@pytest.mark.parametrize("solver", ["icp_point2plane", "icp_generalized"])
def test_icp_variants_match_jax(solver):
    from fusion4landslide_tpu.ops import registration as jreg

    src, tgt, smask, tmask, _, _ = _pairs()
    R0 = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    R0[1] = Rotation.from_rotvec([0.01, 0.0, -0.01]).as_matrix()
    t0 = np.zeros((3, 3), np.float32)
    t0[2] = [0.01, 0.0, 0.0]
    tr = getattr(treg, solver)(torch.from_numpy(src), torch.from_numpy(tgt), 0.2,
                               torch.from_numpy(smask), torch.from_numpy(tmask),
                               R_init=torch.from_numpy(R0), t_init=torch.from_numpy(t0))
    for b in range(3):
        jr = getattr(jreg, solver)(jnp.asarray(src[b]), jnp.asarray(tgt[b]), 0.2,
                                   jnp.asarray(smask[b]), jnp.asarray(tmask[b]),
                                   R_init=jnp.asarray(R0[b]), t_init=jnp.asarray(t0[b]))
        _assert_icp_close(jr, tr, b)


def test_stopped_pairs_keep_their_state():
    """Batching does not change a pair's answer: each pair alone equals
    the pair inside the batch (the JAX function is vmapped the same way)."""
    src, tgt, smask, tmask, _, _ = _pairs(1)
    for solver in (treg.icp_point2plane, treg.icp_generalized):
        full = solver(torch.from_numpy(src), torch.from_numpy(tgt), 0.2,
                      torch.from_numpy(smask), torch.from_numpy(tmask), max_iter=12)
        for b in range(3):
            one = solver(torch.from_numpy(src[b:b + 1]), torch.from_numpy(tgt[b:b + 1]), 0.2,
                         torch.from_numpy(smask[b:b + 1]), torch.from_numpy(tmask[b:b + 1]),
                         max_iter=12)
            np.testing.assert_allclose(one.R[0].numpy(), full.R[b].numpy(), atol=1e-6)
            assert int(one.n_inliers[0]) == int(full.n_inliers[b])


def test_color_gradients_and_colored_icp_match_jax():
    from fusion4landslide_tpu.ops import registration as jreg
    from fusion4landslide_tpu.ops.normals import pca_normals

    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 0.6, size=(900, 2))
    src = np.column_stack([xy, 0.02 * np.sin(8 * xy[:, 0])]).astype(np.float32)
    shade = 0.5 + 0.4 * np.sin(20 * xy[:, 0]) * np.cos(15 * xy[:, 1])
    col = (np.stack([shade] * 3, 1) * 255).astype(np.float32)
    tgt = (src + np.array([0.006, -0.004, 0.0], np.float32)).astype(np.float32)

    nrm = np.array(pca_normals(jnp.asarray(src), 16))
    jg = np.asarray(jreg.color_gradients(jnp.asarray(src), jnp.asarray(shade, jnp.float32),
                                         jnp.asarray(nrm), k=16))
    tg = treg.color_gradients(torch.from_numpy(src), torch.from_numpy(shade.astype(np.float32)),
                              torch.from_numpy(nrm), k=16)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * np.abs(jg).max())

    kw = dict(voxel_scales=(0.04, 0.02), max_iters=(20, 10))
    jr = jreg.colored_icp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(col), jnp.asarray(col),
                          **kw)
    tr = treg.colored_icp(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(col),
                          torch.from_numpy(col), **kw)
    _assert_icp_close(jr, tr, 0)


def test_ransac_with_jax_samples_matches_jax():
    from fusion4landslide_tpu.ops import registration as jreg

    rng = np.random.default_rng(7)
    n = 300
    src = rng.normal(size=(n, 3)).astype(np.float32)
    R = Rotation.from_rotvec([0.1, 0.05, -0.08]).as_matrix().astype(np.float32)
    tgt = src @ R.T + np.array([0.3, -0.1, 0.2], np.float32)
    bad = rng.random(n) < 0.4
    tgt[bad] += rng.normal(scale=2.0, size=(bad.sum(), 3)).astype(np.float32)
    mask = rng.random(n) > 0.05
    key = jax.random.PRNGKey(3)
    K = 128
    probs = jnp.asarray(mask, jnp.float32) / mask.sum()
    samples = np.asarray(jax.random.choice(key, n, shape=(K, 3), replace=True, p=probs))
    jr = jreg.ransac_registration(jnp.asarray(src), jnp.asarray(tgt), key, num_hypotheses=K,
                                  mask=jnp.asarray(mask))
    tr = treg.ransac_registration(torch.from_numpy(src), torch.from_numpy(tgt),
                                  torch.from_numpy(samples), num_hypotheses=K,
                                  mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.best_score) == int(jr.best_score)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    # Without samples the port draws from a seeded generator.
    drawn = treg.ransac_registration(torch.from_numpy(src), torch.from_numpy(tgt),
                                     num_hypotheses=K, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(drawn.R.numpy(), R, atol=1e-2)


def test_icp_by_type_dispatch():
    src, tgt, smask, tmask, _, _ = _pairs(2, B=2, n=64)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    with pytest.raises(ValueError, match="unknown icp_type"):
        treg.icp_by_type("fancy_icp", s, t, 0.1)
    for name, fn in (("point2point", treg.icp_point2point), ("point2plane", treg.icp_point2plane),
                     ("generalized_icp", treg.icp_generalized),
                     ("generalized", treg.icp_generalized)):
        a = treg.icp_by_type(name, s, t, 0.2, max_iter=5)
        b = fn(s, t, 0.2, max_iter=5)
        np.testing.assert_array_equal(a.R.numpy(), b.R.numpy())


@pytest.mark.parametrize("icp_type", ["point2point", "point2plane", "generalized_icp"])
def test_fine_match_pairs_icp_type_matches_jax(icp_type):
    """``tests/test_icp_wiring.py``'s case, plus a second pair with a
    rotation, through both packages' ``fine_match_pairs``."""
    from fusion4landslide_tpu.pipelines.fusion import fine_match_pairs as jfine

    from fusion4landslide_tpu_torch.pipelines.fusion import fine_match_pairs as tfine

    rng = np.random.default_rng(0)
    P = 64
    vox_s = rng.uniform(0, 4, size=(2 * P, 3)).astype(np.float32)
    vox_s[:, 2] *= 0.05
    R = Rotation.from_rotvec([0.0, 0.0, 0.03]).as_matrix().astype(np.float32)
    vox_t = np.concatenate([vox_s[:P] + np.array([0.2, -0.1, 0.05], np.float32),
                            vox_s[P:] @ R.T + np.array([0.05, 0.0, 0.0], np.float32)])
    args = (np.arange(2 * P, dtype=np.int32).reshape(2, P), np.ones((2, P), bool),
            np.arange(2, dtype=np.int32), np.arange(2 * P, dtype=np.int32),
            np.ones(2 * P, bool), np.repeat(np.arange(2, dtype=np.int32), P), vox_s, vox_t)
    kw = dict(icp_threshold=0.3, num_min_fine=10, icp_type=icp_type)
    jr = jfine(*args, **kw)
    tr = tfine(*(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    np.testing.assert_allclose(tr.t[0].numpy(), [0.2, -0.1, 0.05], atol=2e-3)
