"""Voxel centroids: every point falls in the cell floor((p - origin) /
size); a voxel is an occupied cell and its centroid the mean of its
points. Computed in float32, u = (p - origin) / size carries up to three
roundings, each at most 2^-24 |u|: a point whose u lies within
``near_face(u)`` of a cell face (over twice that, plus 1e-5 cell units)
may fall on either side, so the cells on both sides are not judged, and
each such point may add or remove one voxel. A centroid that lies that
close to a face names no cell for sure and is not judged either."""

from __future__ import annotations

import numpy as np

_AMBIGUOUS = 1e-5
#: Over twice the float32 rounding of (p - origin) / size, relative to |u|.
_AMBIGUOUS_REL = 2.0 ** -21


def near_face(u: np.ndarray) -> np.ndarray:
    """Coordinates of ``u`` (cell units) that float32 rounding may carry
    across a cell face."""
    return np.abs(u - np.round(u)) < _AMBIGUOUS + _AMBIGUOUS_REL * np.abs(u)


def _touched(u: np.ndarray, near: np.ndarray) -> np.ndarray:
    """(8 m, 3) cells that rows of ``u`` may fall in: on both sides of
    each face a coordinate is near."""
    lo = np.where(near, np.round(u) - 1, np.floor(u)).astype(np.int64)
    hi = np.where(near, np.round(u), np.floor(u)).astype(np.int64)
    return np.concatenate([np.where([(m >> d) & 1 for d in range(3)], hi, lo)
                           for m in range(8)])


def centroid_gap(points: np.ndarray, origin: np.ndarray, size: float, centroids: np.ndarray,
                 n_voxels: int, control=None) -> float:
    """Largest distance from one of the given ``centroids`` to the
    centroid of the cell it lies in, over cells with no ambiguous point;
    inf where the voxel count is off by more than the ambiguous points
    allow or a centroid away from every face lies in a cell that holds no
    point. ``control(points, cell of each point, cells) -> (k, 3)``
    replaces the given centroids by its own means of the cells they lie
    in."""
    p = points.astype(np.float64)
    u = (p - np.asarray(origin, np.float64)) / float(size)
    cells = np.floor(u).astype(np.int64)
    near = near_face(u)
    amb = near.any(axis=1)
    keys, inv, counts = np.unique(cells, axis=0, return_inverse=True, return_counts=True)
    inv = inv.ravel()
    if abs(len(keys) - int(n_voxels)) > int(amb.sum()):
        return float("inf")
    amb_cell = np.zeros(len(keys), bool)
    touched = _touched(u[amb], near[amb])
    tpos = np.clip(np.searchsorted(_lex(keys), _lex(touched)), 0, len(keys) - 1)
    amb_cell[tpos[(keys[tpos] == touched).all(axis=1)]] = True
    sums = np.zeros((len(keys), 3))
    np.add.at(sums, inv, p)
    cen = sums / counts[:, None]
    cu = (centroids.astype(np.float64) - origin) / float(size)
    ck = np.floor(cu).astype(np.int64)
    pos = np.clip(np.searchsorted(_lex(keys), _lex(ck)), 0, len(keys) - 1)
    hit = (keys[pos] == ck).all(axis=1)
    sure = ~near_face(cu).any(axis=1)
    if not hit[sure].all():
        return float("inf")
    judged = hit & sure & ~amb_cell[pos]
    if control is not None:
        centroids = control(points.astype(np.float32), inv, pos)
    gap = np.linalg.norm(cen[pos] - centroids, axis=1)[judged]
    return float(gap.max()) if gap.size else 0.0


def _lex(k: np.ndarray) -> np.ndarray:
    """Row keys as one sortable int64 (cells are far below 2^20 a side)."""
    k = k + np.int64(1 << 20)
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def tf32_means(device):
    """The control's centroids: each cell's sum as a product of a row of
    ones and the cell's points, rounded to TF32."""
    import torch

    from reference.precision import round_tf32

    def means(p, cell_of, cells):
        out = []
        for c in cells:
            m = round_tf32(torch.from_numpy(p[cell_of == c]).to(device))
            out.append((torch.ones((1, m.shape[0]), device=device) @ m)[0] / m.shape[0])
        return torch.stack(out).double().cpu().numpy()

    return means
