"""The port's tracing (``utils.profiling``, ``utils.timing``) on the CPU:
the host tiles' spans in a ``torch.profiler`` trace, the kernel counters
of a tile's record, and nothing counted without one.

The tiles are the suite's small ones (``synth_small_rgb_tile`` and the
400-point split tile); DIPs runs a one-layer stand-in network, since
what is checked here is where the spans open and close, not the
descriptors (the DIPs stage still samples through kernel 1's plain
version)."""

import importlib.util
import json
import logging
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
from fusion4landslide_tpu_torch.ops import hashgrid as thg
from fusion4landslide_tpu_torch.ops import hashgrid_cuda as thc
from fusion4landslide_tpu_torch.parallel.pipeline import run_f2s3_tiles
from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile
from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion_tile
from fusion4landslide_tpu_torch.pipelines.run_summary import RunSummary
from fusion4landslide_tpu_torch.synth import SMALL_IMG_SIZE, synth_small_rgb_tile, synth_split_tile
from fusion4landslide_tpu_torch.utils import profiling
from fusion4landslide_tpu_torch.utils.timing import StageTimer, add_timings, for_log

ROOT = Path(__file__).resolve().parents[1]

FUSION_CFG = {
    "output_folder": "run", "level_of_superpoint": [1, 2], "feat_patch_points": 128,
    "feat_chunk": 512, "agg_max_points": 64, "num_min_matches_for_small_patch": 3,
    "fine_max_matches": 64, "max_magnitude": 5.0, "icp_threshold": 0.1,
    "voxel_size_init": 0.1, "dataset": "brienz_tls", "use_2d_matches": True,
    "image_size": list(SMALL_IMG_SIZE), "pixel_thres": 5, "lifting_type": "nn_search",
    "matches_from_2d_type": "nn_src_only", "coarse_matching_fusion": True,
    "fine_matching_fusion": True,
}
F2S3_CFG = {
    "output_folder": "run", "voxel_size": 0.1, "max_disp_magnitude": 5.0,
    "filter_median_magnitude": True, "fill_gaps_c2c": True, "refine_results": True,
    "n_normals": 30, "small_patch_removal": True,
}
#: The stages each tile times (its ``timings`` keys), and the finer spans
#: inside them (PERF.md §3).
FUSION_STAGES = {"median_resolution", "voxel_subsampling", "dips_features", "global_3d_matches",
                 "rgb_2d", "partition_l1", "match_l1", "partition_l2", "match_l2",
                 "dense_output", "sparse_assign", "write_tables"}
FUSION_STEPS = {"tile.fusion", "grid_search.readback", "dips.sample", "dips.lrf",
                "dips.pointnet", "matching.readback", "rgb.readback", "rgb.gate", "rgb.merge",
                "tables.interim", "partition.readback", "partition.compact_labels",
                "partition.members", "matching.votes_2d", "matching.pairs", "fine.pairs",
                "fine.readback", "tile.assign_level", "tile.dense_dvf", "tile.sparse_query",
                "grid_search.build", "grid_search.query", "tile.sparse_dvf", "tables.wait"}
F2S3_STAGES = {"median_res", "dips_features", "supervoxels", "feature_nn1", "filter", "tables"}
F2S3_STEPS = {"tile.f2s3", "dips.sample", "dips.lrf", "dips.pointnet", "partition.readback",
              "matching.readback", "tables.pre_pruning", "filter.members", "filter.readback",
              "tables.gate", "tables.c2c", "tile.result"}


class TinyDescriptor(torch.nn.Module):
    """A stand-in for PointNetFeature: (B, P, 3) patches -> (B, 64) unit
    descriptors through one linear layer."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 64)

    def forward(self, patches, dtype=None):
        return torch.nn.functional.normalize(self.lin(patches.mean(dim=1)), dim=-1)


def _run_tile(kind, tmp_path, timings):
    torch.manual_seed(0)
    dips = TinyDescriptor()
    if kind == "fusion":
        _, agg = seeded_models(0, "cpu")
        src, tgt, _, _, pix, K, E, _ = synth_small_rgb_tile()
        return run_fusion_tile({**FUSION_CFG, "output_dir": str(tmp_path)}, dips, agg, src, tgt,
                               None, None, K, E, E, corres_2d=pix, tile_id=0, device="cpu",
                               timings=timings)
    src, tgt, _, _ = synth_split_tile(400, 1.0, 1.0, halo=2.0)
    return run_f2s3_tile({**F2S3_CFG, "output_dir": str(tmp_path)}, dips, seeded_filter(0, "cpu"),
                         src, tgt, tile_id=1, device="cpu", timings=timings)


def _spans(prof):
    """(name, start, end) of every span of the trace, in ns."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _covered(intervals, lo, hi) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0, lo
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, hi)
        if t > s:
            total += t - s
            end = t
    return total


@pytest.mark.parametrize("kind", ["fusion", "f2s3"])
def test_tile_spans_cover_the_tile_and_carry_the_stage_names(kind, tmp_path, monkeypatch):
    """The fusion tile runs without ``timings`` (spans open all the same,
    and no counter is touched); the F2S3 tile with it (its stage keys are
    its spans' names, and its record carries the kernels' counters). The
    stage spans and the finer spans, the tile span left out, cover at
    least 95% of the tile's wall time."""
    timings = None if kind == "fusion" else {}
    if timings is None:
        def no_count(*args):
            raise AssertionError("counted without a record")

        monkeypatch.setattr(profiling, "count", no_count)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.tile"):
            _run_tile(kind, tmp_path, timings)
    spans = _spans(prof)
    names = {n for n, _, _ in spans}
    stages, steps = ((FUSION_STAGES, FUSION_STEPS) if kind == "fusion"
                     else (F2S3_STAGES, F2S3_STEPS))
    assert stages | steps <= names, sorted(stages | steps - names)
    if timings is not None:
        assert set(timings) - {"counters"} == stages
        assert timings["counters"]["radius_sample.rows"] > 0
        assert timings["counters"]["grid_knn.rows"] > 0
    (t0, t1), = [(s, t) for n, s, t in spans if n == f"tile.{kind}"]
    inner = [(s, t) for n, s, t in spans if n != "test.tile" and not n.startswith("tile.")]
    assert _covered(inner, t0, t1) >= 0.95 * (t1 - t0)


def _window(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 6.0, size=(n, 2))
    pts = torch.from_numpy(np.column_stack([xy, 0.3 * np.sin(xy[:, 0])]).astype(np.float32))
    return thc.window_prologue(pts, thg.build_hash_grid(pts, 0.6), 512, 4096)


def test_kernel_counters_are_the_launched_blocks_window_work():
    """Kernel 1 over blocks [1, 3) and kernel 2 over all blocks count the
    scanned positions, positions x block evaluations, output rows and
    output slots of exactly those blocks."""
    win = _window()
    chunk = 512
    timings: dict = {}

    @profiling.tile("test.tile")
    def launch(*, timings):
        thc.radius_sample_blocks(win, thc.block_centres(win), torch.tensor(0.36), 128, 0,
                                 chunk=chunk, b0=1, b1=3)
        thc.grid_knn_blocks(win, 3, chunk=chunk)

    launch(timings=timings)
    scans = thc._scan_len(win.wmeta[1], chunk, win.window)
    sampled = int(scans[1:3].sum())
    assert timings["counters"] == {
        "radius_sample.positions": sampled, "radius_sample.evaluations": sampled * win.block,
        "radius_sample.rows": 2 * win.block, "radius_sample.slots": 2 * win.block * 128,
        "grid_knn.positions": int(scans.sum()), "grid_knn.evaluations": int(scans.sum()) * 512,
        "grid_knn.rows": win.n_pad, "grid_knn.slots": win.n_pad * 3,
    }
    # A second call adds to the dict's counters, as a runner's tiles do.
    launch(timings=timings)
    assert timings["counters"]["grid_knn.rows"] == 2 * win.n_pad


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn) -> int:
    with _OpCount() as mode:
        fn()
    return mode.n


def test_without_a_record_the_wrappers_run_only_the_kernels_ops():
    """With no record active (``timings=None``) the launch wrappers
    dispatch exactly the plain versions' operations, and no counters key
    appears anywhere."""
    win = _window()
    cen, r2 = thc.block_centres(win), torch.tensor(0.36)
    assert profiling.record() is None
    assert (_ops(lambda: thc.grid_knn_blocks(win, 2, chunk=512))
            == _ops(lambda: thc.grid_knn_plain(win, 2, chunk=512)))
    assert (_ops(lambda: thc.radius_sample_blocks(win, cen, r2, 128, 0, chunk=512, b0=0, b1=2))
            == _ops(lambda: thc.radius_sample_plain(win, cen, r2, 128, 0, chunk=512,
                                                    blocks=range(0, 2))))

    @profiling.tile("test.tile")
    def launch(*, timings):
        assert profiling.record() is None
        thc.grid_knn_blocks(win, 1, chunk=512)
        return timings

    assert launch(timings=None) is None


def test_records_nest_and_stay_in_their_thread():
    """A tile inside another adds to the outer record; a thread started in
    a tile (a tile stream, a table writer) sees no record of its own."""
    outer: dict = {}
    inner: dict = {}
    seen = []

    @profiling.tile("test.inner")
    def inner_tile(*, timings):
        profiling.count(profiling.record(), "x", 2)

    @profiling.tile("test.outer")
    def outer_tile(*, timings):
        profiling.count(profiling.record(), "x", torch.tensor(1))
        inner_tile(timings=inner)
        worker = threading.Thread(target=lambda: seen.append(profiling.record()))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()

    outer_tile(timings=outer)
    assert outer == {"counters": {"x": 3}} and inner == {} and seen == [None]
    assert profiling.record() is None


def test_stage_spans_open_without_timings_and_streams_sum_counters():
    timer = StageTimer(None, torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("a_stage"):
            torch.ones(3).sum()
    assert "a_stage" in {n for n, _, _ in _spans(prof)}
    total = {"a_stage": 1.0, "counters": {"grid_knn.rows": 4}}
    add_timings(total, {"a_stage": 0.5, "b_stage": 2.0,
                        "counters": {"grid_knn.rows": 6, "knn.rows": 1}})
    assert total == {"a_stage": 1.5, "b_stage": 2.0,
                     "counters": {"grid_knn.rows": 10, "knn.rows": 1}}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke_printers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_runner_timings_with_counters_go_through_the_log_printers(tmp_path, capsys):
    """A driver's run summary whose runner stages carry ``counters`` (the
    F2S3 runner with a ``timings`` dict, its step decorated) prints through
    ``chip_smoke.py``'s ``log_driver`` and stage line, counters whole; and
    the host fusion tile's stage-times log line takes a ``timings`` dict
    that already holds an earlier tile's counters."""
    torch.manual_seed(0)
    src, tgt, _, _ = synth_split_tile(400, 1.0, 1.0, halo=2.0)
    summary = RunSummary(torch.device("cpu"))
    with summary.phase("runner_s"):
        timings: dict = {}
        run_f2s3_tiles({**F2S3_CFG, "output_dir": str(tmp_path), "feat_patch_points": 128,
                        "feat_chunk": 512, "member_cap": 256},
                       TinyDescriptor(), seeded_filter(0, "cpu"), [(0, src, tgt)],
                       device="cpu", timings=timings)
    summary.stages["runner"] = timings
    out = summary.finish(logging.getLogger("test"), str(tmp_path))
    counters = out["stages_s"]["runner"]["counters"]
    assert counters["radius_sample.rows"] > 0 and counters["grid_knn.rows"] > 0
    smoke = _chip_smoke()
    smoke.log_driver("runner", {**out, "wall_s": out["total_s"]})
    smoke.log("# stages (s): " + json.dumps(for_log(timings)))
    printed = capsys.readouterr().out
    assert json.dumps(counters) in printed and "feature_nn1" in printed

    src, tgt, _, _, pix, K, E, _ = synth_small_rgb_tile()
    again = {"counters": dict(counters)}
    run_fusion_tile({**FUSION_CFG, "output_dir": str(tmp_path)}, TinyDescriptor(),
                    seeded_models(0, "cpu")[1], src, tgt, None, None, K, E, E,
                    corres_2d=pix, tile_id=0, device="cpu", timings=again,
                    logger=logging.getLogger("test"))
    assert again["counters"]["grid_knn.rows"] > counters["grid_knn.rows"]
