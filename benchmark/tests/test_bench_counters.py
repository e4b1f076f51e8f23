"""The readers of the program's kernel counters (``metrics/radius_sample_roofline.py``,
``grid_knn_roofline.py``, ``knn_rescored_per_row.py``) on a fabricated run:
known counts and kernel seconds give the hand-computed numbers, and a run
whose tiles carry no counters (a program without them) reads None."""

import importlib

import pytest

import run

#: Round peaks, so that a count of operations or bytes is that many
#: picoseconds.
PEAKS = {"fp32_flops": 1e12, "tf32_flops": 1e12, "hbm_bytes_per_s": 1e12}

#: Tile A: kernel 1 bound by operations (9 x 100 + 12 x 10 = 1020 against
#: 20 x 10 + 12 x 2 + 20 x 8 = 384 bytes), kernel 2 by operations (7 x 100
#: = 700 against 20 x 10 + 16 x 4 + 8 x 12 = 360). Tile B: kernel 1 by
#: bytes (20 x 10 + 12 x 4 + 20 x 100 = 2248 against 9 x 10 + 12 x 10 =
#: 210), kernel 2 by bytes (20 x 30 + 16 x 8 + 8 x 8 = 792 against 28).
TILE_A = {"radius_sample.evaluations": 100, "radius_sample.positions": 10,
          "radius_sample.rows": 2, "radius_sample.slots": 8,
          "grid_knn.evaluations": 100, "grid_knn.positions": 10, "grid_knn.rows": 4,
          "grid_knn.slots": 12, "knn.rows": 100, "knn.rescored": 250}
TILE_B = {"radius_sample.evaluations": 10, "radius_sample.positions": 10,
          "radius_sample.rows": 4, "radius_sample.slots": 100,
          "grid_knn.evaluations": 4, "grid_knn.positions": 30, "grid_knn.rows": 8,
          "grid_knn.slots": 8, "knn.rows": 300, "knn.rescored": 350}
#: Device seconds: twice kernel 1's least time (1020 + 2248 ps), ten times
#: kernel 2's (700 + 792 ps).
KERNELS_S = {"radius_sample": 2 * 3268e-12, "grid_knn": 10 * 1492e-12, "knn": 1e-3}


def _run(tiles, kernels_s=KERNELS_S):
    trace = {"window_s": 1.0, "busy_s": 0.5, "kernels_s": kernels_s}
    return run.Run(tiles, 1.0, trace, PEAKS)


def _tile(counters=None):
    timings = {"median_res": 0.1}
    if counters is not None:
        timings["counters"] = counters
    return {"timings": timings, "counters": {"n_core": 1}}


@pytest.mark.parametrize("name,expected", [("radius_sample_roofline", 50.0),
                                           ("grid_knn_roofline", 10.0),
                                           ("knn_rescored_per_row", 600 / 400)])
def test_known_counts_read_the_hand_computed_number(name, expected):
    reader = importlib.import_module(f"metrics.{name}")
    assert reader.read(_run([_tile(TILE_A), _tile(TILE_B)])) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("name", ["radius_sample_roofline", "grid_knn_roofline",
                                  "knn_rescored_per_row"])
def test_a_run_without_counters_reads_none(name):
    reader = importlib.import_module(f"metrics.{name}")
    assert reader.read(_run([_tile(), _tile()])) is None
    assert reader.read(_run([_tile({})])) is None


def test_kernel_3_counts_only_tiles_that_launched_it():
    reader = importlib.import_module("metrics.knn_rescored_per_row")
    fusion_like = {k: v for k, v in TILE_A.items() if not k.startswith("knn.")}
    assert reader.read(_run([_tile(fusion_like)])) is None
    assert reader.read(_run([_tile(fusion_like), _tile(TILE_B)])) == pytest.approx(350 / 300)


@pytest.mark.parametrize("name", ["radius_sample_roofline", "grid_knn_roofline"])
def test_a_kernel_that_did_not_run_reads_none(name):
    reader = importlib.import_module(f"metrics.{name}")
    assert reader.read(_run([_tile(TILE_A)], {"radius_sample": 0.0, "grid_knn": 0.0,
                                               "knn": 0.0})) is None
