"""Priority merge of multi-level correspondence sets (port of
``fusion4landslide_tpu.ops.merge``; reference
``merge_correspondences_by_priority_with_distance_threshold``,
src/coarse_to_fine_matching.py:40-118).

Earlier levels win; a later level contributes only the rows whose source
point lies at least ``distance_threshold`` from every source point merged
before it. The duplicate test is the exact brute-force 1-NN of
``ops.knn``.
"""

from __future__ import annotations

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.ops.knn import nn1

__all__ = ["merge_correspondences_by_priority"]


def merge_correspondences_by_priority(corres_list: list[np.ndarray],
                                      distance_threshold: float = 1e-3,
                                      device=None) -> np.ndarray:
    """Merge (N_i, 6) correspondence tables, earlier lists winning; the
    1-NN runs on ``device`` (default ``cuda``). Returns the (M, 6)
    concatenation of the kept rows."""
    dev = resolve_device(device)
    merged: list[np.ndarray] = []
    pool: np.ndarray | None = None
    for corres in corres_list:
        corres = np.asarray(corres)
        if corres.size == 0:
            continue
        if pool is None:
            merged.append(corres)
            pool = corres[:, :3].astype(np.float32)
            continue
        d2, _ = nn1(torch.as_tensor(corres[:, :3].astype(np.float32), device=dev),
                    torch.as_tensor(pool, device=dev))
        keep = ~(d2.cpu().numpy() < distance_threshold**2)
        if keep.any():
            merged.append(corres[keep])
            pool = np.concatenate([pool, corres[keep][:, :3].astype(np.float32)])
    if not merged:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(merged, axis=0)
