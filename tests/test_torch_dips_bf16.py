"""bf16 DIPs descriptors (``feat_dtype: bfloat16``) against the JAX
package's ``PointNetFeature(dtype='bfloat16')`` on the same Flax
parameters, and what bf16 does to matches and recovery against the
float32 run. The readings (ROADMAP item 3) and their bounds:

- descriptors, port bf16 vs Flax bf16 on 600 LRF patches of a small
  tile: measured max 1.7e-3, min cosine 0.999986, 78% of the rows within
  1e-5 (a bf16 rounding that falls the other way in one activation moves
  its row by up to ~1e-3); held to max 5e-3, cosine >= 0.9999 and >= 60%
  of the rows within 1e-5;
- the 1-NN sets (source -> target descriptors): port bf16 equals Flax
  bf16 on >= 93% of the rows (measured 98.5%); bf16 keeps the float32
  run's 1-NN on >= 75% (measured 90.2%);
- recovery on the small split tile, the port's fusion step in bf16 against
  float32: the assigned core fraction within 0.1 of float32's, and the
  median error against the planted shift no more than 10% (+ 2 mm) above
  float32's. Random weights do not recover the shift on a 1 000-point
  tile (both runs read ~2.4 m, 39% assigned); the production tile's floors
  are read on the card (``chip_smoke.py`` phase (u)).
"""

import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.ops.lrf import extract_lrf_patches
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT, synth_split_tile
from test_torch_step import SCALARS, STATICS, params  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def split_tile():
    src, tgt, core, moving = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    c = src.mean(0)
    return src - c, tgt - c, core, moving


def _nn(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.argmin(((a[:, None] - b[None]) ** 2).sum(-1), axis=1)


def test_bf16_descriptors_match_flax_bf16(params, split_tile):
    from fusion4landslide_tpu.models.dips import PointNetFeature

    dips, _, td, _ = params
    s, t, _, _ = split_tile
    g = torch.Generator().manual_seed(0)
    patches = [
        extract_lrf_patches(torch.from_numpy(x[:600].astype(np.float32)),
                            torch.from_numpy(x.astype(np.float32)), 1.0, k_max=256,
                            num_points=128, generator=g)
        for x in (s, t)
    ]
    j16 = [np.asarray(PointNetFeature(dtype="bfloat16").apply(dips, p.numpy())) for p in patches]
    with torch.inference_mode():
        t16 = [td(p, torch.bfloat16).numpy() for p in patches]
        t32 = [td(p).numpy() for p in patches]
    err = np.abs(t16[0] - j16[0]).max(1)
    cos = (t16[0] * j16[0]).sum(1)
    assert t16[0].dtype == np.float32
    assert err.max() <= 5e-3, err.max()
    assert cos.min() >= 0.9999, cos.min()
    assert (err <= 1e-5).mean() >= 0.6, (err <= 1e-5).mean()
    nn16 = _nn(*t16)
    same_j, same_32 = (nn16 == _nn(*j16)).mean(), (nn16 == _nn(*t32)).mean()
    print(f"bf16 descriptors: max {err.max():.3g}, min cos {cos.min():.6f}, "
          f"rows within 1e-5 {(err <= 1e-5).mean():.3f}; 1-NN = Flax bf16 {same_j:.3f}, "
          f"= float32 {same_32:.3f}")
    assert same_j >= 0.93
    assert same_32 >= 0.75


def _step(td, ta, tile, **kw):
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

    s, t = tile[0], tile[1]
    N, M = bucket_size(len(s)), bucket_size(len(t))
    sb = np.zeros((N, 3), np.float32)
    sb[:len(s)] = s
    tb = np.zeros((M, 3), np.float32)
    tb[:len(t)] = t
    return fusion3d_tile_step(td, ta, torch.from_numpy(sb), torch.from_numpy(np.arange(N) < len(s)),
                              torch.from_numpy(tb), torch.from_numpy(np.arange(M) < len(t)),
                              *SCALARS, device="cpu", **STATICS, **kw)


def test_bf16_recovery_against_float32(params, split_tile):
    _, _, td, ta = params
    s, _, core, moving = split_tile
    n = len(s)
    truth = np.where(moving[:, None], PLANTED_SHIFT[None], 0.0)
    readings = {}
    for name, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        out = _step(td, ta, split_tile, feat_dtype=dtype)
        valid = out.valid[:n].numpy() & core
        disp = out.moved[:n].numpy() - s.astype(np.float32)
        err = np.linalg.norm(disp[valid] - truth[valid], axis=1)
        readings[name] = (valid.sum() / core.sum(), float(np.median(err)))
    (f_frac, f_err), (b_frac, b_err) = readings["float32"], readings["bfloat16"]
    assert f_frac > 0.2 and b_frac > 0.2, readings
    assert abs(b_frac - f_frac) <= 0.1, readings
    assert b_err <= 1.1 * f_err + 2e-3, readings
    print("recovery readings (assigned core fraction, median error m):", readings)
