"""The dense DVF's per-point transform (the fusion method's dense
output): a source point takes the rigid fit of its voxel's supervoxel at
the first level, in the order of ``level_of_superpoint``, where that
supervoxel's patch pair holds a valid fit; where the coarse stage paired
one source supervoxel with several targets, the pair listed last (by
target label) stands for it. A point whose voxel is in no such
supervoxel has no DVF row. The moved point is R p + t in float64."""

from __future__ import annotations

import numpy as np


def fits(voxel: np.ndarray, levels: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """((k, 3, 3) R, (k, 3) t, (k,) assigned) of points in voxels
    ``voxel`` (-1: none). ``levels``: per level, in order, a dict of the
    voxel labels ``lab`` and the pairs' ``src`` / ``tgt`` labels, ``R``,
    ``t`` and ``valid``."""
    k = voxel.shape[0]
    R = np.tile(np.eye(3), (k, 1, 1))
    t = np.zeros((k, 3))
    done = np.zeros(k, bool)
    for lv in levels:
        lab = np.where(voxel >= 0, lv["lab"][np.clip(voxel, 0, None)], -1)
        order = np.lexsort((lv["tgt"], lv["src"]))
        src = lv["src"][order]
        # The last pair of each source label in (src, tgt) order.
        last = order[np.r_[src[1:] != src[:-1], True]] if src.size else order
        by_label = {int(lv["src"][p]): p for p in last}
        for i in np.nonzero(~done & (lab >= 0))[0]:
            p = by_label.get(int(lab[i]))
            if p is not None and lv["valid"][p]:
                R[i], t[i], done[i] = lv["R"][p], lv["t"][p], True
    return R, t, done
