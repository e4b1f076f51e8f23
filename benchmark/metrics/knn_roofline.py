"""Kernel 3's least time (``flops.feature_knn_least_s`` of each tile's
query and reference counts) over its device time, in percent."""

import flops


def read(run):
    t = run.trace["kernels_s"]["knn"] if run.trace else 0.0
    least = sum(flops.feature_knn_least_s(*tile["counters"]["knn_nm"]) for tile in run.tiles
                if "knn_nm" in tile["counters"])
    return least / t * 100.0 if t > 0 and least > 0 else None
