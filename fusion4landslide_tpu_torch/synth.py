"""Synthetic production-shaped tiles (the port's copy of the generators in
the repository's ``bench.py``): a terrain-like epoch pair whose half-plane
``x > full / 2`` moves by ``PLANTED_SHIFT`` and whose other half is static.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PLANTED_SHIFT", "synth_overlap_tile", "synth_split_tile"]

PLANTED_SHIFT = np.array([0.05, -0.02, 0.01], np.float32)


def synth_overlap_tile(n_core: int, halo: float = 20.0, density: float = 100.0,
                       seed: int = 0):
    """A core of ``n_core`` points plus its +-``halo`` m ring at the same
    density. Returns (src, tgt, core_mask, moving_mask)."""
    rng = np.random.default_rng(seed)
    side = float(np.sqrt(n_core / density))
    full = side + 2.0 * halo
    n_total = int(round(density * full * full))
    xy = rng.uniform(0, full, size=(n_total, 2))
    z = (
        np.sin(xy[:, 0] * 0.31) * 2.0
        + np.cos(xy[:, 1] * 0.17) * 3.0
        + rng.normal(scale=0.02, size=n_total)
    )
    src = np.column_stack([xy, z]).astype(np.float32)
    core = (
        (xy[:, 0] >= halo) & (xy[:, 0] < halo + side)
        & (xy[:, 1] >= halo) & (xy[:, 1] < halo + side)
    )
    moving = src[:, 0] > full / 2
    tgt = src.copy()
    tgt[moving] += PLANTED_SHIFT
    return src, tgt, core, moving


def synth_split_tile(n_core: int, src_margin: float, tgt_margin: float,
                     halo: float = 20.0, density: float = 100.0, seed: int = 0):
    """The core/halo query-split tile: the overlap cloud cropped to the
    core bbox + ``src_margin`` (source) and + ``tgt_margin`` (target).
    Returns (src, tgt, core_mask_src, moving_mask_src)."""
    src, tgt, core, moving = synth_overlap_tile(n_core, halo=halo, density=density, seed=seed)
    side = float(np.sqrt(n_core / density))
    lo, hi = halo, halo + side

    def crop(m):
        xy = src[:, :2]
        return (
            (xy[:, 0] >= lo - m) & (xy[:, 0] < hi + m)
            & (xy[:, 1] >= lo - m) & (xy[:, 1] < hi + m)
        )

    ks = crop(src_margin)
    kt = crop(tgt_margin)
    return src[ks], tgt[kt], core[ks], moving[ks]
