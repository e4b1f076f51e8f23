"""Kernel 2's (``grid_knn``) least time over its device time, in
percent. The least time of a tile is the larger of its operations at the
float32 peak and its bytes at HBM bandwidth, from the program's counters
of the tile's launches (``timings["counters"]``): 7 operations per
candidate evaluation (a three-term score and a compare); each window
position's x, y, z, |r|^2 and index read once (20 B), each padded query's
position and row (16 B) read once and each output slot's distance and
index (8 B) written once. Summed over the window's tiles; None where no
tile has the counters."""

OPS_PER_EVALUATION = 7
BYTES_PER_POSITION = 20
BYTES_PER_ROW = 16
BYTES_PER_SLOT = 8


def least_s(c: dict, peaks: dict) -> float:
    ops = OPS_PER_EVALUATION * c["grid_knn.evaluations"]
    bytes_ = (BYTES_PER_POSITION * c["grid_knn.positions"] + BYTES_PER_ROW * c["grid_knn.rows"]
              + BYTES_PER_SLOT * c["grid_knn.slots"])
    return max(ops / peaks["fp32_flops"], bytes_ / peaks["hbm_bytes_per_s"])


def read(run):
    t = run.trace["kernels_s"]["grid_knn"] if run.trace else 0.0
    counted = [tile["timings"]["counters"] for tile in run.tiles
               if "grid_knn.positions" in tile["timings"].get("counters", {})]
    if t <= 0 or not counted:
        return None
    return sum(least_s(c, run.peaks) for c in counted) / t * 100.0
