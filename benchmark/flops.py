"""Operations the tiles' networks need, from layer widths and the tile's
counts, and the least time of a kernel. Frozen with the benchmark: a
later change to the program does not move them.

A multiply and an add count as two operations. DIPs runs two PointNet
trunks (the T-net's and the feature net's) on every patch of 256 points:
pointwise 3->256->512->1024, then 1024->512->256 after the max-pool, and
256->9 / 256->64 heads. The aggregation net attends over each superpoint's
members (at most ``agg_max_points``): q/k/v and output projections of
64x64, scores and mixing of members x members x 64, and a 64->64->64 MLP
on the pooled row. The F2S3 filter projects each correspondence 6->128,
runs 12 residual blocks of two 128x128 layers and a 128->1 output.
"""

from __future__ import annotations

import json
import os

import numpy as np

PATCH_POINTS = 256
_POINTWISE = 3 * 256 + 256 * 512 + 512 * 1024
_PATCHWISE = 1024 * 512 + 512 * 256
DIPS_PER_PATCH = 2 * (2 * (PATCH_POINTS * _POINTWISE + _PATCHWISE)) + 2 * 256 * (9 + 64) \
    + 2 * PATCH_POINTS * 9
FILTER_PER_ROW = 2 * (6 * 128 + 12 * 2 * 128 * 128 + 128)

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def dips_flops(patches: int) -> float:
    return float(patches) * DIPS_PER_PATCH


def aggregation_flops(member_counts, agg_max_points: int = 512) -> float:
    total = 0.0
    for counts in member_counts:
        p = np.minimum(np.asarray(counts, np.float64), agg_max_points)
        p = p[p > 0]
        total += float((2 * 4 * p * 64 * 64 + 2 * 2 * p * p * 64 + 2 * 2 * 64 * 64).sum())
    return total


def filter_flops(rows: int) -> float:
    return float(rows) * FILTER_PER_ROW


def feature_knn_least_s(n: int, m: int, dim: int = 64) -> float:
    """Least time of an exact feature 1-NN of n queries over m references:
    the larger of 2 n m dim operations at the TF32 peak (the fastest the
    card multiplies float32 operands) and the float32 inputs read once
    plus one (distance, index) pair written per query at HBM bandwidth."""
    ops = 2.0 * n * m * dim / PEAKS["tf32_flops"]
    bytes_ = ((n + m) * dim * 4 + n * 8) / PEAKS["hbm_bytes_per_s"]
    return max(ops, bytes_)
