"""DVF result-table writers (the port's own copy of
``fusion4landslide_tpu.io.results``).

"dvfs" rows are ``x y z x' y' z'``, "dvfms" rows ``x y z |d|``;
"visualize" variants pin the first two magnitudes to [0, max] so
CloudCompare renders a stable colour ramp (reference
src/coarse_to_fine_matching_base.py:3459-3500).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["dvf_magnitudes", "save_dvfms", "save_txt", "visual_clamp_magnitude"]

#: CloudCompare visualisation scale per dataset (base:3490-3497).
VIS_MAX_MAGNITUDE = {
    "rockfall": 0.06,
    "rockfall_simulator": 0.06,
    "brienz_tls": 5.0,
    "mattertal": 10.0,
}


def dvf_magnitudes(dvfs: np.ndarray) -> np.ndarray:
    """|d| per row of an (n, 6) dvfs table."""
    return np.linalg.norm(dvfs[:, 3:6] - dvfs[:, 0:3], axis=1)


def save_txt(path: str, table: np.ndarray, fmt: str = "%.6f") -> None:
    """Result-table text writer (fixed ``%.6f``: micrometres on metres)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, table, fmt=fmt)


def save_dvfms(path: str, dvfs: np.ndarray, magnitudes: np.ndarray | None = None) -> np.ndarray:
    """Write the (n, 4) magnitude table; returns it for reuse."""
    if magnitudes is None:
        magnitudes = dvf_magnitudes(dvfs)
    table = np.hstack([dvfs[:, :3], magnitudes[:, None]])
    save_txt(path, table)
    return table


def visual_clamp_magnitude(dvfms: np.ndarray, dataset: str | None = None,
                           max_magnitude: float | None = None) -> np.ndarray:
    """Copy with rows 0/1 magnitudes pinned to 0 and the dataset's visual
    max (base:3499-3500)."""
    out = dvfms.copy()
    if max_magnitude is None:
        max_magnitude = VIS_MAX_MAGNITUDE.get((dataset or "").lower(), 10.0)
    if out.shape[0] >= 2:
        out[0, 3] = 0.0
        out[1, 3] = max_magnitude
    return out
