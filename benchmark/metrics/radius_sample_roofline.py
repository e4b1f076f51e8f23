"""Kernel 1's (``radius_sample``) least time over its device time, in
percent. The least time of a tile is the larger of its operations at the
float32 peak and its bytes at HBM bandwidth, from the program's counters
of the tile's launches (``timings["counters"]``): 9 operations per
candidate evaluation (the squared distance and two tests) and 12 per
window position (centring, |r|^2 in the block's frame, mask and hash);
each position's x, y, z, |r|^2 and index read once (20 B), each output
row's query (12 B) and each output slot's index, flag and xyz (20 B)
written once. Summed over the window's tiles; None where no tile has the
counters."""

OPS_PER_EVALUATION = 9
OPS_PER_POSITION = 12
BYTES_PER_POSITION = 20
BYTES_PER_ROW = 12
BYTES_PER_SLOT = 20


def least_s(c: dict, peaks: dict) -> float:
    ops = (OPS_PER_EVALUATION * c["radius_sample.evaluations"]
           + OPS_PER_POSITION * c["radius_sample.positions"])
    bytes_ = (BYTES_PER_POSITION * c["radius_sample.positions"]
              + BYTES_PER_ROW * c["radius_sample.rows"]
              + BYTES_PER_SLOT * c["radius_sample.slots"])
    return max(ops / peaks["fp32_flops"], bytes_ / peaks["hbm_bytes_per_s"])


def read(run):
    t = run.trace["kernels_s"]["radius_sample"] if run.trace else 0.0
    counted = [tile["timings"]["counters"] for tile in run.tiles
               if "radius_sample.positions" in tile["timings"].get("counters", {})]
    if t <= 0 or not counted:
        return None
    return sum(least_s(c, run.peaks) for c in counted) / t * 100.0
