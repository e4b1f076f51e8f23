"""Segment (label-group) utilities for fixed-shape batching.

Port of ``fusion4landslide_tpu.ops.segments``: variable-length label groups
become a dense (S, P) member-index matrix with a mask, built from a stable
sort + searchsorted.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["label_members", "label_counts", "bucket_size"]


def label_counts(labels: torch.Tensor, num_labels: int) -> torch.Tensor:
    """(num_labels,) count of points per label (label < 0 ignored)."""
    valid = labels >= 0
    return torch.zeros(num_labels, dtype=torch.int32, device=labels.device).index_add_(
        0, torch.where(valid, labels, 0).long(), valid.to(torch.int32)
    )


def label_members(
    labels: torch.Tensor, num_labels: int, members_cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense member table for label groups: ((S, P) point indices padded
    with 0, (S, P) validity). Members are the *first* P of each label in
    point order (stable sort)."""
    n = labels.shape[0]
    dev = labels.device
    valid = labels >= 0
    sort_key = torch.where(valid, labels, num_labels).long()
    sorted_labels, order = torch.sort(sort_key, stable=True)
    ar = torch.arange(num_labels, device=dev)
    starts = torch.searchsorted(sorted_labels, ar)
    counts = torch.searchsorted(sorted_labels, ar, right=True) - starts
    offsets = torch.arange(members_cap, device=dev)[None, :]
    member_mask = offsets < counts[:, None]
    gather_pos = torch.clamp(starts[:, None] + offsets, 0, n - 1)
    member_idx = torch.where(member_mask, order[gather_pos], 0)
    return member_idx.to(torch.int32), member_mask


_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_size(n: int, buckets: tuple[int, ...] = _BUCKETS) -> int:
    """Round up to a standard bucket: the listed ladder, then quarter-octave
    steps ({1.25, 1.5, 1.75, 2} x 2^(k-1)) above it — the exact ladder of
    the JAX package, so padded shapes (and with them the kernels' query
    blocks) compare row for row."""
    n = int(n)
    for b in buckets:
        if n <= b:
            return b
    k = int(np.ceil(np.log2(max(n, 1))))
    base = 2 ** (k - 1)
    for num in (5, 6, 7, 8):
        b = base * num // 4
        if n <= b:
            return b
    return 2**k
