"""The fusion method's partition and ICP options through the port's host
tile, step and runner vs the JAX package (its TPU branch emulated on the
CPU), with the same weights and one shared partition file.

- ``partition_type: superpoint`` with ``level_of_superpoint`` [1, 2, 3]:
  the host tile reads the table both packages are given (generated by the
  port's ``ops/superpoint.py`` on the tile cloud), transfers labels to
  voxels and dedups the per-level tables; the step takes the same labels
  as ``sp_lab_src`` / ``sp_lab_tgt``; the runner reads them from the file
  (and writes the file when it is absent). Scored as
  ``tools/parity_check.py`` scores two paths
  (``tests/test_torch_fusion_host.py::score_host_parity``,
  ``tests/test_torch_step.py``'s step score).
- ``icp_type``: each type reaches the host tile's and the step's fine
  stage, which is the recorded call replayed. The solvers are held to JAX
  where their normal equations are well posed
  (``tests/test_torch_registration.py``): on these random-weight tiles the
  fine pairs hold few ICP inliers, and a pair whose matched target set is
  within the 16-neighbourhood of each of its points gets one normal for
  all of them, so the point-to-plane system is rank 3 and float32 rounding
  steers it, in both packages.
"""

import os.path as osp
import shutil

import jax
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.ops import partition_io as tio
from fusion4landslide_tpu_torch.ops.superpoint import generate_superpoint_partition
from fusion4landslide_tpu_torch.pipelines import fusion as tf
from fusion4landslide_tpu_torch.pipelines import fusion_device as tfd
from fusion4landslide_tpu_torch.synth import synth_rough_split_tile, synth_split_tile

from test_torch_fusion_host import CFG, flax_and_torch_models
from test_torch_step import SCALARS, STATICS, _assert_step_parity

ICP_TYPES = ("point2point", "point2plane", "generalized_icp", "generalized")
#: A magnitude gate that keeps the random-weight global matches near the
#: planted motion, so the fine stage's Kabsch seeds are sane.
MAX_MAG = 0.3


def _stub_descriptors(monkeypatch):
    """Replace the DIPs descriptors of the host tile and the step with a
    fixed function of each point's coordinates (the runner and wiring
    tests check plumbing, not descriptors; the PointNet is most of a CPU
    tile's time)."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32))

    def feats(pts):
        f = torch.sin(pts @ w.to(pts.device) * 7.0)
        return f / torch.linalg.norm(f, dim=1, keepdim=True)

    monkeypatch.setattr(tf, "compute_dips_features",
                        lambda model, core, *a, **k: (feats(core), 0))
    monkeypatch.setattr(tfd, "dips_features_device",
                        lambda model, q, *a, query_count=None, **k: (
                            torch.where((torch.arange(len(q)) < query_count)[:, None],
                                        feats(q), 0.0), 0))


def _labels(labels, size):
    """(3, size) int32 per-point labels of three levels, -1 past the cloud."""
    lab = np.full((3, size), -1, np.int32)
    for li, pl in enumerate(labels):
        lab[li, :len(pl)] = pl
    return lab


@pytest.fixture(scope="module")
def models():
    return flax_and_torch_models()


@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    """A small tile with metre-scale relief (``synth_rough_split_tile``)
    and its shared partition tables, generated by the port
    (``superpoint_partition/partition_of_input_{src,tgt}_tile_5.txt``)."""
    src, tgt = synth_rough_split_tile()
    root = tmp_path_factory.mktemp("partition")
    labels = {}
    for which, pts in (("src", src), ("tgt", tgt)):
        path = root / f"partition_of_input_{which}_tile_5.txt"
        labels[which] = generate_superpoint_partition(pts, str(path), levels=3,
                                                      device="cpu")
    return dict(src=src, tgt=tgt, root=root, labels=labels)


def _with_tables(tile, out_root):
    """Copy the shared tables into ``<out_root>/superpoint_partition``."""
    dst = osp.join(out_root, "superpoint_partition")
    shutil.copytree(tile["root"], dst, dirs_exist_ok=True)


def _record(monkeypatch, module):
    """The ``fine_match_pairs`` calls made through ``module``: (args, kw, out)."""
    calls, orig = [], module.fine_match_pairs

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(module, "fine_match_pairs", rec)
    return calls


def test_step_partition_inputs_match_emulated_jax(models, monkeypatch):
    """``sp_lab_src`` / ``sp_lab_tgt``: per-point labels (L, N) from the
    generator, padded with -1, on ``tests/test_torch_step.py``'s tile."""
    import functools

    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas
    from fusion4landslide_tpu.pipelines.fusion_device import fusion3d_tile_step as j_step

    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    dips, agg, td, ta = models
    src, tgt, _, _ = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    sp = {"src": _labels(generate_superpoint_partition(src, None, device="cpu"), N),
          "tgt": _labels(generate_superpoint_partition(tgt, None, device="cpu"), M)}
    st = {**STATICS, "levels": (1, 2, 3)}
    t = dict(n=n, m=m)
    sm, tm = np.arange(N) < n, np.arange(M) < m
    scalars = SCALARS
    calls = _record(monkeypatch, tfd)
    jax.clear_caches()
    with monkeypatch.context() as mp:
        mp.setattr(knn_pallas, "pallas_available", lambda: True)
        for mod, name in ((hashgrid_pallas, "radius_sample_window"),
                          (hashgrid_pallas, "hash_grid_knn_window"), (knn_pallas, "knn_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        jo = j_step(dips, agg, sb, sm, tb, tm, jax.random.PRNGKey(0), *scalars, **st,
                    sp_lab_src=sp["src"], sp_lab_tgt=sp["tgt"])
        jo = jax.tree.map(np.asarray, jo)
    jax.clear_caches()
    to = tfd.fusion3d_tile_step(td, ta, torch.from_numpy(sb), torch.from_numpy(sm),
                                torch.from_numpy(tb), torch.from_numpy(tm), *scalars,
                                device="cpu", sp_lab_src=torch.from_numpy(sp["src"]),
                                sp_lab_tgt=torch.from_numpy(sp["tgt"]), **st)
    _assert_step_parity(jo, to, t)
    assert int(jo.n_dropped) == int(to.n_dropped)
    assert len(calls) == 3


def _padded(src, tgt):
    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - src.mean(0)
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - src.mean(0)
    return (torch.from_numpy(sb), torch.arange(N) < n, torch.from_numpy(tb),
            torch.arange(M) < m)


def test_runner_reads_and_writes_the_partition_tables(models, tile, tmp_path, monkeypatch):
    """The runner generates the absent tables of a tile, then reads them
    (tile 6); a second tile (5) reads the shared tables it is given; its
    tables equal the step's on those labels (descriptors stubbed)."""
    from fusion4landslide_tpu_torch.parallel.pipeline import fusion3d_statics, run_fusion3d_tiles

    _stub_descriptors(monkeypatch)
    _, _, td, ta = models
    src, tgt = tile["src"], tile["tgt"]
    cfg = {"output_dir": str(tmp_path), "output_folder": "run", "partition_type": "superpoint",
           "level_of_superpoint": [1, 2, 3], "feat_patch_points": 128, "feat_chunk": 512,
           "sv_cap": 256, "member_cap": 128, "agg_max_points": 64,
           "num_min_matches_for_small_patch": 3, "fine_max_matches": 64, "max_magnitude": MAX_MAG,
           "icp_threshold": 0.1, "voxel_size_init": 0.1, "dataset": "brienz_tls"}
    _with_tables(tile, tmp_path / "run")
    timings: dict = {}
    res = run_fusion3d_tiles(cfg, td, ta, [(5, src, tgt), (6, src, tgt)], device="cpu",
                             timings=timings)
    assert {"superpoint_knn", "superpoint_vccs", "superpoint_merge"} <= set(timings)
    root = tmp_path / "run" / "superpoint_partition"
    for which in ("src", "tgt"):
        for lv in (1, 2, 3):
            _, lab = tio.read_superpoint_partition(
                str(root / f"partition_of_input_{which}_tile_6.txt"), lv)
            np.testing.assert_array_equal(lab, tile["labels"][which][lv - 1])
    sb, sm, tb, tm = _padded(src, tgt)
    out = tfd.fusion3d_tile_step(td, ta, sb, sm, tb, tm, MAX_MAG, *SCALARS[1:], device="cpu",
                                 sp_lab_src=torch.from_numpy(_labels(tile["labels"]["src"],
                                                                     len(sb))),
                                 sp_lab_tgt=torch.from_numpy(_labels(tile["labels"]["tgt"],
                                                                     len(tb))),
                                 **fusion3d_statics(cfg, len(sb), len(tb)))
    n = len(src)
    valid = out.valid[:n].numpy()
    assert valid.mean() > 0.2
    want = np.hstack([src[valid], out.moved[:n].numpy()[valid] + src.mean(0)])
    for tid in (5, 6):
        got = np.loadtxt(tmp_path / "run" / "results" / f"c2f_dvfs_src2tgt_tile_{tid}.txt")
        np.testing.assert_allclose(got.reshape(-1, 6), want, atol=2e-6)
        np.testing.assert_array_equal(res[tid]["valid"], valid)


def test_icp_type_reaches_the_fine_stage(models, tile, tmp_path, monkeypatch):
    """The host tile (``icp_type`` from the config) and the step (its
    argument) hand each type to ``fine_match_pairs`` (descriptors
    stubbed); the recorded call replayed gives the tile's fine results,
    and point2point other ones."""
    _stub_descriptors(monkeypatch)
    _, _, td, ta = models
    src, tgt = tile["src"], tile["tgt"]
    fine = tf.fine_match_pairs
    calls = _record(monkeypatch, tf)
    monkeypatch.setattr(tfd, "fine_match_pairs", tf.fine_match_pairs)
    sb, sm, tb, tm = _padded(src, tgt)
    for icp_type in ICP_TYPES[1:]:
        cfg = {**CFG, "icp_type": icp_type, "max_magnitude": MAX_MAG, "return_interim": False,
               "output_dir": str(tmp_path / icp_type), "level_of_superpoint": [1]}
        tf.run_fusion3d_tile(cfg, td, ta, src, tgt, tile_id=5, device="cpu")
        tfd.fusion3d_tile_step(td, ta, sb, sm, tb, tm, MAX_MAG, *SCALARS[1:], device="cpu",
                               icp_type=icp_type, **{**STATICS, "levels": (1,)})
    assert [kw["icp_type"] for _, kw, _ in calls] == [t for t in ICP_TYPES[1:] for _ in (0, 1)]
    for a, kw, out in calls:
        again = fine(*a, **kw)
        assert out.valid.any()
        for x, y in zip(again, out):
            assert torch.equal(x, y)
        other = fine(*a, **{**kw, "icp_type": "point2point"})
        assert torch.equal(other.valid, out.valid) and not torch.equal(other.R, out.R)
