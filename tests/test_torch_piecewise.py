"""The port's piecewise-ICP method against the JAX package's on the CPU:
``suggest_max_cells``, ``piecewise_icp_core`` on padded, masked clouds
(a leaf size on an exact power of two, and one an ulp above it),
``run_piecewise_icp`` and the single-GPU runner ``run_piecewise_tiles``
against the JAX mesh runner (8 virtual CPU devices).

Tolerance: kept and stable flags and cell counts equal; displacements
within 1e-6 m (float32 centroids summed in the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.pipelines import piecewise_icp as jp
from fusion4landslide_tpu_torch.pipelines import piecewise_icp as tp


def epoch_pair(rng, n=6000, width=40.0, offset=(0.0, 0.0, 0.0)):
    """Terrain over [0, width]^2 whose half y > width / 2 moves by
    (0.3, -0.1, 0.05) m, with 1 cm of noise on the target; both clouds
    hold the box's corners, so the joint extent is exactly ``width``."""
    xy = rng.uniform(0, width, (n, 2))
    xy[:4] = [[0, 0], [width, 0], [0, width], [width, width]]
    src = np.column_stack([xy, 0.5 * np.sin(xy[:, 0] * 0.3)])
    tgt = src.copy()
    tgt[src[:, 1] > width / 2] += [0.3, -0.1, 0.05]
    tgt[4:] += rng.normal(0, 0.01, (n - 4, 3))
    return src + offset, tgt + offset


def test_suggest_max_cells_matches_jax():
    for args in ((40.0, 5.0, 6000, 10), (40.0, 5.0, 100, 1), (0.5, 5.0, 10, 3),
                 (1000.0, 0.05, 2_000_000, 10), (7.3, 1.1, 50_000, 0)):
        assert tp.suggest_max_cells(*args) == jp.suggest_max_cells(*args)


@pytest.mark.parametrize("smax,n_min", [(5.0, 10), (40.0 / 8.000001, 5), (2.5, 3), (1.3, 1)])
def test_piecewise_icp_core_matches_jax(smax, n_min):
    """smax 5 puts extent / smax on 8 exactly (log2 as JAX forms it, log(x)
    / log(2) in float32: 3, no rounding up); 40 / 8.000001 an ulp past
    it."""
    rng = np.random.default_rng(int(smax * 10))
    src, tgt = epoch_pair(rng)
    n, m = len(src), len(tgt) - 500
    N, M = 8192, 6144
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt[:m]
    tb[m:len(tgt)] = tgt[m:] + 100.0  # masked rows far away
    sm, tm = np.arange(N) < n, np.arange(M) < m
    max_cells = jp.suggest_max_cells(40.0, smax, N, n_min)
    jo = jp.piecewise_icp_core(jnp.asarray(sb), jnp.asarray(tb), jnp.asarray(sm), jnp.asarray(tm),
                               smax, n_min, max_cells=max_cells)
    to = tp.piecewise_icp_core(torch.from_numpy(sb), torch.from_numpy(tb), torch.from_numpy(sm),
                               torch.from_numpy(tm), smax, n_min, max_cells=max_cells)
    jax.clear_caches()
    np.testing.assert_array_equal(to.out_mask.numpy(), np.asarray(jo.out_mask))
    np.testing.assert_array_equal(to.stable_point.numpy(), np.asarray(jo.stable_point))
    assert int(to.n_cells_src) == int(jo.n_cells_src) > 0
    assert int(to.n_stable) == int(jo.n_stable) > 0
    np.testing.assert_allclose(to.displacement.numpy(), np.asarray(jo.displacement), atol=1e-6)
    assert to.out_mask.any() and not to.stable_point.all()


def test_run_piecewise_icp_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    src, tgt = epoch_pair(rng, offset=(2.6e6, 1.17e6, 600.0))
    for smax, n_min in ((5.0, 10), (2.0, 4)):
        jd = jp.run_piecewise_icp(src, tgt, smax=smax, number_points_min=n_min,
                                  output_dir=str(tmp_path / "jax"), tile_id=3,
                                  dataset="brienz_tls")
        td = tp.run_piecewise_icp(src, tgt, smax=smax, number_points_min=n_min,
                                  output_dir=str(tmp_path / "port"), tile_id=3,
                                  dataset="brienz_tls", device="cpu")
        assert td.shape == jd.shape and len(td) > 0.5 * len(src)
        np.testing.assert_allclose(td, jd, atol=1e-6, rtol=0)
        for name in ("piecewise_icp_dvfs_of_tile_3.txt", "piecewise_icp_dvfms_of_tile_3.txt",
                     "piecewise_dvfms_visualize_of_tile_3.txt"):
            a = np.loadtxt(tmp_path / "jax" / "results" / name)
            b = np.loadtxt(tmp_path / "port" / "results" / name)
            np.testing.assert_allclose(b, a, atol=2e-6, rtol=0)
    jax.clear_caches()


def test_run_piecewise_tiles_matches_the_jax_mesh_runner(tmp_path):
    from fusion4landslide_tpu.parallel.pipeline import run_piecewise_tiles_sharded
    from fusion4landslide_tpu_torch.parallel.pipeline import run_piecewise_tiles

    rng = np.random.default_rng(8)
    tiles = []
    for i, (n, w) in enumerate(((3000, 30.0), (2000, 20.0), (2500, 25.0))):
        s, t = epoch_pair(rng, n=n, width=w, offset=(1000.0 * i, 0.0, 0.0))
        tiles.append((str(i), s, t[: n - 37 * i]))
    cfg = {"smax": 5.0, "number_points_min": 10, "dataset": "brienz_tls",
           "output_folder": "run"}
    jr = run_piecewise_tiles_sharded(dict(cfg, output_dir=str(tmp_path / "jax")), tiles)
    tr = run_piecewise_tiles(dict(cfg, output_dir=str(tmp_path / "port")), tiles, device="cpu")
    jax.clear_caches()
    assert sorted(tr) == sorted(jr) == ["0", "1", "2"]
    for tid in tr:
        assert tr[tid]["dvfs"].shape == jr[tid]["dvfs"].shape
        np.testing.assert_allclose(tr[tid]["dvfs"], jr[tid]["dvfs"], atol=1e-6, rtol=0)
    files = sorted(p.name for p in (tmp_path / "port" / "run" / "results").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax" / "run" / "results").iterdir())
    assert len(files) == 9
