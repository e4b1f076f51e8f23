"""Synthetic production-shaped tiles (the port's copy of the generators in
the repository's ``bench.py``): a terrain-like epoch pair whose half-plane
``x > full / 2`` moves by ``PLANTED_SHIFT`` and whose other half is static,
a nadir camera with dense pixel matches through it for the RGB channel
(``synth_image_channel``, ``synth_rgb_tile``), and a textured image pair
that the camera takes of an epoch pair (``synth_textured_images``, the
recipe of ``tests/test_rgb_guided.py``), written with the camera files in
the drivers' data layout by ``write_camera_files``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fusion4landslide_tpu_torch.image.geometry import project_points, rasterize_depth

__all__ = [
    "IMG_SIZE",
    "PLANTED_SHIFT",
    "DRIVER_EPOCH",
    "SMALL_IMG_SIZE",
    "synth_epoch_pair",
    "synth_image_channel",
    "synth_overlap_tile",
    "synth_rgb_tile",
    "synth_rough_split_tile",
    "synth_small_rgb_tile",
    "synth_split_tile",
    "synth_textured_images",
    "write_camera_files",
]

PLANTED_SHIFT = np.array([0.05, -0.02, 0.01], np.float32)
#: 4K imagery (``bench.py``'s RGB headline camera).
IMG_SIZE = (4096, 4096)
#: The small RGB tile's camera (``synth_small_rgb_tile``).
SMALL_IMG_SIZE = (512, 512)
#: The epoch pair of the drivers' production checks (``synth_epoch_pair``):
#: 145 m x 100 m at 100 pts/m^2 (1.45 M points, about 1.05 M after the
#: configs' 0.1 m voxel filter), so ``max_pts_per_tile: 1000000`` cuts it
#: into two tiles; on national-grid-sized coordinates.
DRIVER_EPOCH = {"width": 145.0, "height": 100.0, "offset": (2_600_000.0, 1_175_000.0, 600.0)}


def _terrain(rng, n: int, width: float, height: float) -> np.ndarray:
    """(n, 3) float32 points uniform over [0, width) x [0, height) on the
    synthetic slope, with 2 cm of height noise."""
    xy = rng.uniform(0, [width, height], size=(n, 2))
    z = (
        np.sin(xy[:, 0] * 0.31) * 2.0
        + np.cos(xy[:, 1] * 0.17) * 3.0
        + rng.normal(scale=0.02, size=n)
    )
    return np.column_stack([xy, z]).astype(np.float32)


def synth_overlap_tile(n_core: int, halo: float = 20.0, density: float = 100.0,
                       seed: int = 0):
    """A core of ``n_core`` points plus its +-``halo`` m ring at the same
    density. Returns (src, tgt, core_mask, moving_mask)."""
    rng = np.random.default_rng(seed)
    side = float(np.sqrt(n_core / density))
    full = side + 2.0 * halo
    src = _terrain(rng, int(round(density * full * full)), full, full)
    xy = src[:, :2]
    core = (
        (xy[:, 0] >= halo) & (xy[:, 0] < halo + side)
        & (xy[:, 1] >= halo) & (xy[:, 1] < halo + side)
    )
    moving = src[:, 0] > full / 2
    tgt = src.copy()
    tgt[moving] += PLANTED_SHIFT
    return src, tgt, core, moving


def synth_epoch_pair(width: float, height: float, density: float = 100.0, seed: int = 0,
                     offset=(0.0, 0.0, 0.0)):
    """A whole epoch pair over ``width`` x ``height`` m of the same slope
    at ``density`` points per m^2, whose half ``y > height / 2`` moves by
    ``PLANTED_SHIFT``; coordinates shifted by ``offset`` (float64, e.g. a
    national grid's). Returns (src (n, 3) float64, tgt (n, 3) float64,
    moving (n,))."""
    rng = np.random.default_rng(seed)
    src = _terrain(rng, int(round(density * width * height)), width, height)
    moving = src[:, 1] > height / 2
    tgt = src.copy()
    tgt[moving] += PLANTED_SHIFT
    off = np.asarray(offset, np.float64)
    return src.astype(np.float64) + off, tgt.astype(np.float64) + off, moving


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


def synth_rough_split_tile(n_core: int = 1000, density: float = 100.0, seed: int = 0):
    """A small split tile (``synth_split_tile``'s margins, 1.0 m source
    and 1.5 m target) on a surface with relief at the metre scale, whose
    half x > side / 2 moves by ``PLANTED_SHIFT``. The shipped slope is
    nearly planar at a small tile's scale (periods of 20-37 m), where the
    point-to-plane and generalized ICP solves are ill-posed. Returns
    (src, tgt) float32."""
    rng = np.random.default_rng(seed)
    side = float(np.sqrt(n_core / density)) + 3.0
    xy = rng.uniform(0, side, size=(int(density * side * side), 2))
    z = (0.4 * np.sin(2.1 * xy[:, 0]) + 0.4 * np.cos(1.7 * xy[:, 1])
         + 0.3 * np.sin(1.3 * (xy[:, 0] + xy[:, 1])) + rng.normal(scale=0.02, size=len(xy)))
    src = np.column_stack([xy, z]).astype(np.float32)
    tgt = src.copy()
    tgt[src[:, 0] > side / 2] += PLANTED_SHIFT

    def inner(m):
        return ((xy >= 1.5 - m) & (xy < side - 1.5 + m)).all(1)

    return src[inner(1.0)], tgt[inner(1.5)]


def synth_image_channel(src: np.ndarray, tgt: np.ndarray, n_matches: int,
                        image_size: tuple[int, int] = IMG_SIZE, focal: float = 4000.0):
    """A nadir camera 1.2 spans above the tile and dense pixel matches
    through it: every ``len(src) // n_matches``-th source point projected
    from both epochs, kept where both projections fall inside the image
    (``bench.py::synth_image_channel``, on the CPU). Returns (pix (P, 4)
    [su, sv, tu, tv] float32, K (3, 3), E (4, 4) world->camera, metres
    per pixel at the tile's mean depth)."""
    h, w = image_size
    lo, hi = src.min(axis=0), src.max(axis=0)
    mid = (lo + hi) / 2
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1.0))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [-mid[0], -mid[1], 1.2 * span - mid[2]]
    sub = np.arange(0, src.shape[0], max(1, src.shape[0] // n_matches))
    Et, Kt = torch.from_numpy(E), torch.from_numpy(K)
    uv_s, _, ok_s = project_points(torch.from_numpy(src[sub]), Et, Kt, image_size)
    uv_t, _, ok_t = project_points(torch.from_numpy(tgt[sub]), Et, Kt, image_size)
    keep = (ok_s & ok_t).numpy()
    pix = np.concatenate([uv_s.numpy()[keep], uv_t.numpy()[keep]], axis=1).astype(np.float32)
    return pix, K, E, float(E[2, 3] + mid[2]) / focal


def synth_rgb_tile(n_core: int, src_margin: float, tgt_margin: float, halo: float = 20.0,
                   image_size: tuple[int, int] = IMG_SIZE, focal: float = 4000.0,
                   seed: int = 0):
    """The RGB headline tile of ``bench.py``: a split tile and pixel
    matches for ``len(src) // 2`` source points, each paired with its true
    displaced position. A small tile takes a small image (e.g. 512^2 at
    focal 500) to keep the pixel scale. Returns (src, tgt, core, moving,
    pix, K, E, m_per_px)."""
    src, tgt, core, moving = synth_split_tile(n_core, src_margin, tgt_margin, halo=halo, seed=seed)
    tgt_of_src = src.copy()
    tgt_of_src[moving] += PLANTED_SHIFT
    pix, K, E, m_per_px = synth_image_channel(
        src, tgt_of_src, src.shape[0] // 2, image_size, focal
    )
    return src, tgt, core, moving, pix, K, E, m_per_px


def synth_small_rgb_tile():
    """A ~1.3 k / 2 k-point RGB tile (a 600-point core, source margin
    0.6 m, target margin 1 m) seen by a 512^2 camera at focal 500
    (8.8 mm per pixel): the CPU tests' and the small-tile card checks'
    tile. Returns what ``synth_rgb_tile`` returns."""
    return synth_rgb_tile(600, 0.6, 1.0, halo=1.0, image_size=SMALL_IMG_SIZE, focal=500.0)


#: Texture cells per image pixel side: the texture is smooth over a few
#: pixels (bilinear between cell corners).
TEXTURE_CELL_PX = 4.0


def synth_textured_images(src: np.ndarray, tgt: np.ndarray, image_size: tuple[int, int], *,
                          v_flip: bool = True, seed: int = 0, camera=None):
    """An image pair of an epoch pair (``src[i]`` and ``tgt[i]`` the same
    surface point in both epochs) taken by one nadir camera that sees the
    whole source epoch at ``image_size`` = (height, width). Each point
    carries the texture of its source ground position (x, y): seeded
    uniform values on a grid of ``TEXTURE_CELL_PX`` pixels, bilinear in
    between, so a moved point carries its texture along. Each epoch is
    rasterised through ``project_points`` (v flipped as the dataset flips
    it) and ``rasterize_depth``; pixels no point hits take the nearest
    rendered pixel's value. ``camera`` = (K, E) renders through that
    camera instead (the texture grid unchanged). Returns (src image, tgt
    image) as (h, w) uint8, K (3, 3), E (4, 4) world->camera, metres per
    pixel at the epoch's mean depth."""
    from scipy.ndimage import distance_transform_edt

    h, w = image_size
    lo, hi = src.min(axis=0), src.max(axis=0)
    mid = (lo + hi) / 2
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1.0))
    depth = 1.2 * span
    focal = 1.1 * min(h, w)  # the epoch spans ~92% of the shorter side
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [-mid[0], -mid[1], depth - mid[2]]
    m_per_px = depth / focal
    cell = TEXTURE_CELL_PX * m_per_px
    if camera is not None:
        K, E = (np.asarray(c, np.float32) for c in camera)
    rng = np.random.default_rng(seed)
    gxy = (src[:, :2] - lo[:2]) / cell
    grid = rng.uniform(0.0, 255.0, size=(int(gxy[:, 0].max()) + 2, int(gxy[:, 1].max()) + 2))
    i0 = np.floor(gxy).astype(np.int64)
    f = gxy - i0
    tex = ((1 - f[:, 0]) * (1 - f[:, 1]) * grid[i0[:, 0], i0[:, 1]]
           + f[:, 0] * (1 - f[:, 1]) * grid[i0[:, 0] + 1, i0[:, 1]]
           + (1 - f[:, 0]) * f[:, 1] * grid[i0[:, 0], i0[:, 1] + 1]
           + f[:, 0] * f[:, 1] * grid[i0[:, 0] + 1, i0[:, 1] + 1])
    Et, Kt = torch.from_numpy(E), torch.from_numpy(K)

    def render(pts: np.ndarray) -> np.ndarray:
        uv, z, ok = project_points(torch.from_numpy(pts.astype(np.float32)), Et, Kt, image_size,
                                   v_flip=v_flip)
        _, imap = rasterize_depth(uv, z, ok, image_size)
        imap = imap.numpy()
        near = distance_transform_edt(imap < 0, return_distances=False, return_indices=True)
        filled = imap[near[0], near[1]]
        return np.clip(np.rint(tex[filled]), 0, 255).astype(np.uint8)

    return render(src), render(tgt), K, E, m_per_px


def write_camera_files(root: str, K: np.ndarray, E: np.ndarray,
                       images: tuple[np.ndarray, np.ndarray] | None = None,
                       names: tuple[str, str] = ("epoch1.png", "epoch2.png")) -> None:
    """The drivers' camera layout under ``root``: ``image/camera_intrinsic.txt``,
    one camera pose (the inverse of the world->camera ``E``) per epoch in
    ``image/transformations/pose_epoch{1,2}.txt`` (the ``brienz_tls``
    reader), and with ``images`` the two images as
    ``image/raw_images/<names>``."""
    os.makedirs(os.path.join(root, "image", "transformations"), exist_ok=True)
    np.savetxt(os.path.join(root, "image", "camera_intrinsic.txt"), K, delimiter=" ")
    for epoch in (1, 2):
        np.savetxt(os.path.join(root, "image", "transformations", f"pose_epoch{epoch}.txt"),
                   np.linalg.inv(E.astype(np.float64)), delimiter=" ")
    if images is not None:
        from PIL import Image

        os.makedirs(os.path.join(root, "image", "raw_images"), exist_ok=True)
        for img, name in zip(images, names):
            Image.fromarray(img).save(os.path.join(root, "image", "raw_images", name))
