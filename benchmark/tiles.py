"""Synthetic Brienz tiles, made from a seed (a frozen copy of the terrain
of the repository's ``bench.py::synth_split_tile`` and of the nadir
camera of ``bench.py::synth_image_channel``, in numpy alone).

A tile is a square core of ``n_core`` points at ``density`` points per
m^2 on the synthetic slope, with 2 cm of height noise. The source cloud is
the core plus ``src_margin`` m on every side, the target the core plus
``tgt_margin`` m (the drivers' core/halo query split). The half of the
tile with x above the core's centre moves by ``PLANTED_SHIFT`` between the
epochs; the other half is static. Both epochs sample the same surface
points, so every source point has a known displacement.

The RGB channel is a nadir camera above the tile and dense pixel matches
through it: every ``stride``-th source point projected from both epochs,
kept where both projections fall inside the image.
"""

from __future__ import annotations

import numpy as np

PLANTED_SHIFT = np.array([0.05, -0.02, 0.01], np.float32)


def terrain_z(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.sin(x * 0.31) * 2.0 + np.cos(y * 0.17) * 3.0


def split_tile(rng: np.random.Generator, n_core: int, src_margin: float, tgt_margin: float,
               density: float) -> dict:
    """One epoch pair, cropped as the drivers crop a tile. Returns float32
    ``src`` (n, 3), ``tgt`` (m, 3), and per source point ``core`` (bool)
    and ``truth`` (n, 3) its planted displacement."""
    side = float(np.sqrt(n_core / density))
    full = side + 2.0 * tgt_margin
    n_total = int(round(density * full * full))
    xy = rng.uniform(0.0, full, size=(n_total, 2))
    z = terrain_z(xy[:, 0], xy[:, 1]) + rng.normal(scale=0.02, size=n_total)
    pts = np.column_stack([xy, z]).astype(np.float32)
    moving = pts[:, 0] > full / 2
    moved = pts.copy()
    moved[moving] += PLANTED_SHIFT
    lo, hi = tgt_margin, tgt_margin + side

    def inside(m):
        return ((xy >= lo - m) & (xy < hi + m)).all(axis=1)

    ks = inside(src_margin)
    truth = np.where(moving[ks, None], PLANTED_SHIFT[None], np.float32(0.0))
    return {"src": pts[ks], "tgt": moved[inside(tgt_margin)], "core": inside(0.0)[ks],
            "truth": truth.astype(np.float32), "n_core": int(inside(0.0).sum())}


def project(points: np.ndarray, K: np.ndarray, E: np.ndarray, image_size) -> tuple:
    """Pinhole projection with v flipped, as the dataset stores images:
    ((n, 2) float32 pixels, (n,) inside the image and in front)."""
    h, w = image_size
    cam = points.astype(np.float32) @ E[:3, :3].T + E[:3, 3]
    pix = cam @ K.T
    z = pix[:, 2]
    u = pix[:, 0] / z
    v = h - pix[:, 1] / z
    ok = (z > 0) & (u > 0) & (u < w) & (v > 0) & (v < h)
    return np.stack([u, v], axis=1).astype(np.float32), ok


def nadir_matches(src: np.ndarray, truth: np.ndarray, image_size, focal_per_side: float,
                  stride: int) -> dict:
    """A nadir camera 1.2 source spans above the tile, with focal length
    ``focal_per_side`` times the image's shorter side, and the pixel
    matches of every ``stride``-th source point with its displaced self.
    Returns ``corres_2d`` (P, 4) [su, sv, tu, tv], ``K``, ``E``
    (world -> camera) and ``m_per_px`` at the tile's mean depth."""
    h, w = image_size
    lo, hi = src.min(axis=0), src.max(axis=0)
    mid = (lo + hi) / 2
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1.0))
    focal = focal_per_side * min(h, w)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [-mid[0], -mid[1], 1.2 * span - mid[2]]
    sub = np.arange(0, src.shape[0], max(1, stride))
    uv_s, ok_s = project(src[sub], K, E, image_size)
    uv_t, ok_t = project(src[sub] + truth[sub], K, E, image_size)
    keep = ok_s & ok_t
    corres = np.concatenate([uv_s[keep], uv_t[keep]], axis=1).astype(np.float32)
    return {"corres_2d": corres, "K": K, "E": E, "m_per_px": 1.2 * span / focal}


def make_tile(seed: int, index: int, traffic: dict, image_size=None) -> dict:
    """Tile ``index`` of a run seeded ``seed``: the same pair of numbers
    gives the same tile. Traffic keys: ``n_core``, ``density``,
    ``src_margin``, ``tgt_margin``; with ``camera`` (``focal_per_side``,
    ``match_every``) also the RGB channel, at ``image_size`` (h, w), where
    the configuration has an image."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), int(index)])
    tile = split_tile(rng, int(traffic["n_core"]), float(traffic["src_margin"]),
                      float(traffic["tgt_margin"]), float(traffic["density"]))
    cam = traffic.get("camera")
    if cam and image_size:
        tile.update(nadir_matches(tile["src"], tile["truth"], tuple(image_size),
                                  float(cam["focal_per_side"]), int(cam["match_every"])))
    return tile
