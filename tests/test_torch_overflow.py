"""Grid-window overflow in the port: the exact gather join and
``nn1_spatial``'s rerun (an overflowed radius step reruns every query
through the join, as the JAX package's eager call does), and the overflow
counts that the host tiles, the supervoxel segmentation and the drivers'
run summary report.

The witness: 200 000 targets uniform over 50 m x 50 m with 2 cm of height
noise and 3 000 uniform sources, centred on the target mean (seed 0). Its
first radius overflows six query blocks; without the rerun 227 of the
3 000 1-NN rows were wrong, by up to 28.45 m."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.ops import hashgrid as th


@pytest.fixture
def tpu_branch(monkeypatch):
    """The JAX package's TPU branch, emulated: the grid-window kernels in
    interpret mode."""
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    monkeypatch.setattr(knn_pallas, "pallas_available", lambda: True)
    for name in ("hash_grid_knn_window", "radius_sample_window"):
        monkeypatch.setattr(hashgrid_pallas, name,
                            functools.partial(getattr(hashgrid_pallas, name), interpret=True))
    yield
    jax.clear_caches()


def witness():
    rng = np.random.default_rng(0)
    t = np.column_stack([rng.uniform(0, 50, (200_000, 2)),
                         rng.normal(0, 0.02, 200_000)]).astype(np.float32)
    s = np.column_stack([rng.uniform(0, 50, (3000, 2)),
                         rng.normal(0, 0.02, 3000)]).astype(np.float32)
    c = t.mean(axis=0)
    return s - c, t - c


def test_nn1_spatial_matches_jax_on_the_witness(tpu_branch):
    """Equal indices and distances within 1e-6 m of JAX's (TPU branch
    emulated), and no row more than 1 mm farther than the exact nearest
    target (float64 brute force over a k-d tree)."""
    from scipy.spatial import cKDTree

    from fusion4landslide_tpu.ops.hashgrid import nn1_spatial as j_nn1

    s, t = witness()
    g = th.build_hash_grid(torch.from_numpy(t), 4.0 * float(np.sqrt(2500.0 / 200_000)))
    assert int(th.hash_grid_knn(torch.from_numpy(s), g, float(g.cell), 1)[2]) > 0
    td, ti = th.nn1_spatial(torch.from_numpy(s), torch.from_numpy(t))
    jd, ji = j_nn1(jnp.asarray(s), jnp.asarray(t))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(np.sqrt(td.numpy()), np.sqrt(np.asarray(jd)), atol=1e-6, rtol=0)
    best, _ = cKDTree(t.astype(np.float64)).query(s.astype(np.float64))
    got = np.linalg.norm(t[ti.numpy()].astype(np.float64) - s, axis=1)
    assert int((got - best > 1e-3).sum()) == 0


@pytest.mark.parametrize("k,exclude_self", [(1, False), (3, False), (1, True), (4, True)])
def test_hash_grid_knn_join_matches_jax(k, exclude_self):
    """The gather join bit for bit against the JAX ``_hash_grid_knn_xla``,
    on a cloud whose dense cells run past the 32-point cap."""
    from fusion4landslide_tpu.ops.hashgrid import _hash_grid_knn_xla, build_hash_grid

    rng = np.random.default_rng(4)
    ref = np.concatenate([rng.uniform(-3, 3, (6000, 3)),
                          rng.normal(0, 0.05, (800, 3))]).astype(np.float32)
    ref[:, 2] *= 0.2
    # exclude_self: the queries are the reference rows themselves.
    query = ref if exclude_self else rng.uniform(-3, 3, (2500, 3)).astype(np.float32)
    radius = 0.35
    jd, ji, _ = _hash_grid_knn_xla(jnp.asarray(query), build_hash_grid(jnp.asarray(ref), radius),
                                   radius, k, exclude_self=exclude_self)
    grid = th.build_hash_grid(torch.from_numpy(ref), radius)
    td, ti, to = th.hash_grid_knn_join(torch.from_numpy(query), grid, radius, k,
                                       exclude_self=exclude_self)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(to) > 0  # the dense blob's cells run past the cap


def test_supervoxel_segmentation_reports_its_graph_overflow():
    """The segmentation passes its kNN graph's window overflow up (0 on a
    caller's graph); above 8192 points the graph is kernel 1's."""
    from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_graph, supervoxel_segmentation

    rng = np.random.default_rng(1)
    pts = torch.from_numpy(np.column_stack([rng.uniform(0, 12, (9000, 2)),
                                            rng.normal(0, 0.02, 9000)]).astype(np.float32))
    seg = supervoxel_segmentation(pts, 0.5, k_neighbors=8)
    ni, nm, ov = supervoxel_graph(pts, 0.5, k_neighbors=8)
    assert int(seg.overflow) == int(ov) == 0
    again = supervoxel_segmentation(pts, 0.5, k_neighbors=8, neigh_idx=ni, neigh_mask=nm)
    assert again.overflow == 0
    assert torch.equal(again.labels, seg.labels)


def test_run_summary_sums_overflow_by_kernel(caplog):
    from fusion4landslide_tpu_torch.pipelines.run_summary import RunSummary

    log = logging.getLogger("test_torch_overflow")
    summary = RunSummary(torch.device("cpu"))
    summary.add_overflow({"overflow_by_source": {"sampler": 2, "grid_knn": 0}},
                         {"overflow_by_source": {"sampler": 1, "grid_knn": 5}})
    summary.add_overflow({"overflow_by_source": {"sampler": 0, "grid_knn": 1}})
    with caplog.at_level(logging.INFO, logger=log.name):
        out = summary.finish(log, "out")
    assert out["overflow"] == {"sampler": 3, "grid_knn": 6}
    assert '"overflow": {"sampler": 3, "grid_knn": 6}' in caplog.text
