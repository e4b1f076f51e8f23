"""The port's camera geometry (``fusion4landslide_tpu_torch.image``) vs
``fusion4landslide_tpu.image.geometry`` on the same seeded inputs.

Projection and lifting are float32 products summed in another order than
XLA's, so coordinates agree to 1e-4 relative and ``valid`` may differ
only for a point within 1e-3 px of an image border; the z-buffer and the
depth lookups are compared exactly on the JAX side's pixel coordinates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.image import geometry as jgeo
from fusion4landslide_tpu_torch.image import geometry as tgeo

H, W = 96, 128


def _camera(rng):
    K = np.array([[110.0, 0, W / 2], [0, 105.0, H / 2], [0, 0, 1.0]], np.float32)
    a = rng.uniform(-0.2, 0.2, 3)
    cx, sx = np.cos(a), np.sin(a)
    Rx = np.array([[1, 0, 0], [0, cx[0], -sx[0]], [0, sx[0], cx[0]]])
    Ry = np.array([[cx[1], 0, sx[1]], [0, 1, 0], [-sx[1], 0, cx[1]]])
    Rz = np.array([[cx[2], -sx[2], 0], [sx[2], cx[2], 0], [0, 0, 1]])
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = Rz @ Ry @ Rx
    E[:3, 3] = rng.uniform(-1, 1, 3) + [0, 0, 6.0]
    return K, E


def _points(rng, n):
    # Mostly in front of the camera and inside the image; some behind it
    # and some outside the frame.
    p = rng.uniform([-4, -3, -2], [4, 3, 2], size=(n, 3)).astype(np.float32)
    p[: n // 20, 2] = -9.0
    return p


@pytest.mark.parametrize("v_flip", [True, False])
def test_project_points_matches_jax(v_flip):
    rng = np.random.default_rng(0)
    K, E = _camera(rng)
    pts = _points(rng, 4000)
    mask = rng.uniform(size=4000) > 0.1
    juv, jz, jv = jgeo.project_points(
        jnp.asarray(pts), jnp.asarray(E), jnp.asarray(K), (H, W), mask=jnp.asarray(mask),
        v_flip=v_flip,
    )
    tuv, tz, tv = tgeo.project_points(
        torch.from_numpy(pts), torch.from_numpy(E), torch.from_numpy(K), (H, W),
        mask=torch.from_numpy(mask), v_flip=v_flip,
    )
    juv, jz, jv = np.asarray(juv), np.asarray(jz), np.asarray(jv)
    np.testing.assert_allclose(tuv.numpy(), juv, rtol=1e-4, atol=1e-4 * W)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-4, atol=1e-6)
    border = (
        (np.abs(juv[:, 0]) < 1e-3) | (np.abs(juv[:, 0] - W) < 1e-3)
        | (np.abs(juv[:, 1]) < 1e-3) | (np.abs(juv[:, 1] - H) < 1e-3)
    )
    differ = tv.numpy() != jv
    assert not (differ & ~border).any()
    assert 0.3 < jv.mean() < 0.95


def test_rasterize_depth_matches_jax():
    """Many points per pixel, exact depth ties included (duplicated rows):
    the same depth map and winner map from the same pixel coordinates."""
    rng = np.random.default_rng(1)
    n = 6000
    uv = np.column_stack([rng.uniform(-2, W + 2, n), rng.uniform(-2, H + 2, n)]).astype(np.float32)
    uv[::50] = uv[1::50]
    depth = rng.uniform(1, 5, n).astype(np.float32)
    depth[::7] = np.round(depth[::7])  # exact ties across rows
    depth[::50] = depth[1::50]
    valid = rng.uniform(size=n) > 0.2
    jd, ji = jgeo.rasterize_depth(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(valid), (H, W))
    td, ti = tgeo.rasterize_depth(
        torch.from_numpy(uv), torch.from_numpy(depth), torch.from_numpy(valid), (H, W)
    )
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (np.asarray(jd) >= 0).mean() > 0.2


@pytest.mark.parametrize("bilinear", [False, True])
def test_bilinear_depth_matches_jax(bilinear):
    rng = np.random.default_rng(2)
    dmap = rng.uniform(1, 5, (H, W)).astype(np.float32)
    dmap[rng.uniform(size=(H, W)) < 0.3] = -1.0
    uv = np.column_stack([rng.uniform(-3, W + 3, 3000), rng.uniform(-3, H + 3, 3000)]).astype(np.float32)
    uv[:40] = np.floor(uv[:40])  # on pixel corners
    jd, jv = jgeo.bilinear_depth(jnp.asarray(dmap), jnp.asarray(uv), bilinear=bilinear)
    td, tv = tgeo.bilinear_depth(torch.from_numpy(dmap), torch.from_numpy(uv), bilinear=bilinear)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if bilinear:
        ok = np.asarray(jv)
        np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], rtol=1e-6)
    else:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("v_flip", [True, False])
def test_lift_pixels_to_world_matches_jax(v_flip):
    """Back-projection inverts projection, and agrees with the JAX lift."""
    rng = np.random.default_rng(3)
    K, E = _camera(rng)
    pts = _points(rng, 3000)
    uv, z, valid = tgeo.project_points(
        torch.from_numpy(pts), torch.from_numpy(E), torch.from_numpy(K), (H, W), v_flip=v_flip
    )
    jw = np.asarray(jgeo.lift_pixels_to_world(
        jnp.asarray(uv.numpy()), jnp.asarray(z.numpy()), jnp.asarray(E), jnp.asarray(K), (H, W),
        v_flip=v_flip,
    ))
    tw = tgeo.lift_pixels_to_world(
        uv, z, torch.from_numpy(E), torch.from_numpy(K), (H, W), v_flip=v_flip
    ).numpy()
    scale = np.abs(jw).max()
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-4 * scale)
    ok = valid.numpy()
    np.testing.assert_allclose(tw[ok], pts[ok], atol=1e-4 * scale)
