"""Synthetic production-shaped tiles (the port's copy of the generators in
the repository's ``bench.py``): a terrain-like epoch pair whose half-plane
``x > full / 2`` moves by ``PLANTED_SHIFT`` and whose other half is static,
a nadir camera with dense pixel matches through it for the RGB channel
(``synth_image_channel``, ``synth_rgb_tile``), and a textured image pair
that the camera takes of an epoch pair (``synth_textured_images``, the
recipe of ``tests/test_rgb_guided.py``), written with the camera files in
the drivers' data layout by ``write_camera_files``.

The hard scenes (the port's copy of the repository's
``tools/synth_scene.py``, bit for bit): a procedural texture over world
coordinates seen by a nadir (``nadir_camera``, ``render_image``) or an
oblique camera with hidden-surface removal (``oblique_camera``,
``render_image_occluded``, ``visible_in_view``), the analytic pixel flow
of a planted shift (``planted_flow``), and an epoch pair with a 2x
range-falloff density and a rotating moving disc
(``make_epoch_pair_hard``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fusion4landslide_tpu_torch.image.geometry import project_points, rasterize_depth

__all__ = [
    "DEFAULT_DENSITY",
    "IMG_SIZE",
    "PLANTED_SHIFT",
    "DRIVER_EPOCH",
    "HARD_PAIR",
    "HARD_TILE_CFG",
    "SMALL_IMG_SIZE",
    "hard_tile_readings",
    "make_epoch_pair_hard",
    "nadir_camera",
    "oblique_camera",
    "planted_flow",
    "render_image",
    "render_image_occluded",
    "synth_epoch_pair",
    "synth_image_channel",
    "synth_overlap_tile",
    "synth_rgb_tile",
    "synth_rough_split_tile",
    "synth_small_rgb_tile",
    "synth_split_tile",
    "synth_textured_images",
    "terrain_z",
    "texture",
    "visible_in_view",
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
#: Points per m^2 of the hard scenes (median resolution ~0.1 m).
DEFAULT_DENSITY = 100.0


def terrain_z(x: np.ndarray, y: np.ndarray, noise: float = 0.0, rng=None):
    """Height of the synthetic slope at (x, y); with ``noise`` and ``rng``
    plus that much Gaussian noise."""
    z = np.sin(x * 0.31) * 2.0 + np.cos(y * 0.17) * 3.0
    if noise and rng is not None:
        z = z + rng.normal(scale=noise, size=np.shape(x))
    return z


def _terrain(rng, n: int, width: float, height: float) -> np.ndarray:
    """(n, 3) float32 points uniform over [0, width) x [0, height) on the
    synthetic slope, with 2 cm of height noise."""
    xy = rng.uniform(0, [width, height], size=(n, 2))
    z = terrain_z(xy[:, 0], xy[:, 1], noise=0.02, rng=rng)
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


# ---- The hard scenes ------------------------------------------------------


def texture(x: np.ndarray, y: np.ndarray, seed: int = 3) -> np.ndarray:
    """Procedural multi-scale texture over world coordinates, in [0, 1]:
    four random-direction sinusoids per octave (0.05..10 cycles/m), so
    both epochs sample one world texture and a planted surface motion
    becomes exactly the planted pixel flow."""
    rng = np.random.default_rng(seed)
    val = np.zeros(np.broadcast(x, y).shape, np.float32)
    for freq in (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0):
        amp = 1.0 / np.sqrt(freq / 0.05)
        for _ in range(4):
            ang = rng.uniform(0, 2 * np.pi)
            ph = rng.uniform(0, 2 * np.pi)
            k = 2 * np.pi * freq
            val += amp * np.sin(
                k * (x * np.cos(ang) + y * np.sin(ang)) + ph
            ).astype(np.float32)
    val -= val.min()
    val /= max(val.max(), 1e-6)
    return val


def nadir_camera(extent: float, image_size, margin: float = 1.05):
    """(K, extrinsic 4x4 world->camera, altitude) of a straight-down
    camera over the [0, extent]^2 terrain that frames the whole extent
    just inside the (height, width) image."""
    h, w = image_size
    alt = 3.0 * extent
    cx, cy = extent / 2.0, extent / 2.0
    f = min(h, w) * alt / (extent * margin)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float64)
    # Camera->world axes: x_cam = +x, y_cam = -y, z_cam = -z (looking down).
    Rcw = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    C = np.array([cx, cy, alt], np.float64)
    pose = np.eye(4)
    pose[:3, :3] = Rcw
    pose[:3, 3] = C
    return K, np.linalg.inv(pose), alt


def render_image(image_size, K: np.ndarray, extrinsic: np.ndarray, extent: float, *,
                 shift=None, seed: int = 3, v_flip: bool = True, iters: int = 6) -> np.ndarray:
    """The terrain texture seen by the camera, (h, w) uint8: each pixel's
    ray is marched onto z = terrain_z(x, y) by ``iters`` fixed-point
    steps. With ``shift`` the x > extent / 2 half has moved by that world
    vector (the target epoch's image)."""
    h, w = image_size
    pose = np.linalg.inv(extrinsic)
    Rcw = pose[:3, :3]
    C = pose[:3, 3]
    Kinv = np.linalg.inv(K)
    u = np.arange(w, dtype=np.float64) + 0.5
    v_img = np.arange(h, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, v_img)
    v = (h - vv) if v_flip else vv
    d_cam = np.stack([uu, v, np.ones_like(uu)], axis=-1) @ Kinv.T
    d_w = d_cam @ Rcw.T
    s = np.full((h, w), C[2], np.float64)
    for _ in range(iters):
        px = C[0] + s * d_w[..., 0]
        py = C[1] + s * d_w[..., 1]
        gz = terrain_z(px, py)
        s = (C[2] - gz) / np.maximum(-d_w[..., 2], 1e-9)
    px = C[0] + s * d_w[..., 0]
    py = C[1] + s * d_w[..., 1]
    if shift is not None:
        sx, sy, _ = shift
        moving = px > extent / 2.0
        px = np.where(moving, px - sx, px)
        py = np.where(moving, py - sy, py)
    tex = texture(px.astype(np.float32), py.astype(np.float32), seed=seed)
    return np.clip(tex * 255.0, 0, 255).astype(np.uint8)


def planted_flow(uv_src: np.ndarray, image_size, K: np.ndarray, extrinsic: np.ndarray,
                 extent: float, shift, *, v_flip: bool = True) -> np.ndarray:
    """(n, 2) target-image (u, v) of source pixels ``uv_src``: each ray's
    first terrain hit, moved by ``shift`` where x > extent / 2, then
    reprojected."""
    h, w = image_size
    pose = np.linalg.inv(extrinsic)
    Rcw = pose[:3, :3]
    C = pose[:3, 3]
    Kinv = np.linalg.inv(K)
    uu = uv_src[:, 0].astype(np.float64)
    vv = uv_src[:, 1].astype(np.float64)
    v = (h - vv) if v_flip else vv
    d_cam = np.stack([uu, v, np.ones_like(uu)], axis=-1) @ Kinv.T
    d_w = d_cam @ Rcw.T
    s_max = 2.0 * np.linalg.norm(np.array([extent, extent, 0.0]) - C) + 4.0 * extent
    s, _hit = _first_hit(C, d_w, float(s_max))
    p = np.stack([C[0] + s * d_w[:, 0], C[1] + s * d_w[:, 1], C[2] + s * d_w[:, 2]], axis=-1)
    moving = p[:, 0] > extent / 2.0
    p_t = p + moving[:, None] * np.asarray(shift, np.float64)
    cam = p_t @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    pix = cam @ K.T
    u_t = pix[:, 0] / pix[:, 2]
    v_t = pix[:, 1] / pix[:, 2]
    if v_flip:
        v_t = h - v_t
    return np.stack([u_t, v_t], axis=-1)


#: The hard pair of the repository's ``tests/test_synth_hard.py`` (20 000
#: points, a 0.8 degree rotation of the disc) and the host fusion tile
#: configuration it runs there (patch 16, ``feat_k_max`` 16, levels 1-2).
HARD_PAIR = {"n": 20_000, "shift": (0.05, -0.02, 0.01), "rot_deg": 0.8, "seed": 2}
HARD_TILE_CFG = {
    "output_folder": "run", "feat_k_max": 16, "feat_patch_points": 16, "feat_chunk": 64,
    "num_min_matches_for_small_patch": 5, "level_of_superpoint": [1, 2],
    "max_magnitude": 1.0, "icp_threshold": 0.1, "save_interim": False,
}


def hard_tile_readings(out: dict, moving: np.ndarray, true_disp: np.ndarray) -> dict:
    """A host fusion tile's result on a hard pair, as the hard test reads
    it: the assigned share of the source points and the median error
    against ``true_disp`` on the static and on the moving assigned points."""
    v = out["valid"]
    est = np.zeros_like(true_disp)
    est[v] = out["dvfs"][:, 3:6] - out["dvfs"][:, :3]
    err = np.linalg.norm(est - true_disp, axis=1)
    return {"assigned": float(v.mean()), "static_err_m": float(np.median(err[~moving & v])),
            "moving_err_m": float(np.median(err[moving & v]))}


def make_epoch_pair_hard(n: int, shift=(0.05, -0.02, 0.01), rot_deg: float = 0.5,
                         density: float = DEFAULT_DENSITY, seed: int = 0, scanner=None):
    """An epoch pair of ``n`` points with a scanner-like density, falling
    off as 1 / (1 + 2 r / extent) with the range r from ``scanner``
    (default the (0, 0) corner), and a moving disc (centre (0.68, 0.55)
    extent, radius 0.22 extent) rotated by ``rot_deg`` about the vertical
    through its centre, then shifted by ``shift``. Returns (src, tgt,
    extent, moving_mask, true_disp (n, 3))."""
    rng = np.random.default_rng(seed)
    extent = float(np.sqrt(n / density))
    scanner = np.asarray(scanner if scanner is not None else (0.0, 0.0), np.float64)
    pts = []
    need = n
    while need > 0:
        cand = rng.uniform(0, extent, size=(int(need * 3.5) + 64, 2))
        r = np.linalg.norm(cand - scanner, axis=1)
        accept = rng.random(len(cand)) < 1.0 / (1.0 + 2.0 * r / extent)
        cand = cand[accept]
        pts.append(cand[:need])
        need -= len(cand[:need])
    xy = np.concatenate(pts, axis=0)[:n]
    z = terrain_z(xy[:, 0], xy[:, 1], noise=0.02, rng=rng)
    src = np.column_stack([xy, z]).astype(np.float32)

    centre = np.array([0.68 * extent, 0.55 * extent], np.float64)
    radius = 0.22 * extent
    moving = np.linalg.norm(xy - centre, axis=1) < radius
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]], np.float64)
    c3 = np.array([centre[0], centre[1], 0.0], np.float64)
    tgt = src.astype(np.float64).copy()
    tgt[moving] = (tgt[moving] - c3) @ R.T + c3 + np.asarray(shift, np.float64)
    true_disp = (tgt - src).astype(np.float32)
    return src, tgt.astype(np.float32), extent, moving, true_disp


def oblique_camera(extent: float, image_size, elev_deg: float = 40.0, azim_deg: float = 25.0,
                   margin: float = 1.25):
    """(K, extrinsic 4x4 world->camera, camera centre) of a camera that
    looks at the terrain centre from ``elev_deg`` above the horizon at
    azimuth ``azim_deg``, from 2.2 extents away."""
    h, w = image_size
    el = np.deg2rad(elev_deg)
    az = np.deg2rad(azim_deg)
    target = np.array([extent / 2.0, extent / 2.0, 0.0], np.float64)
    dist = 2.2 * extent
    C = target + dist * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)],
                                 np.float64)
    fwd = target - C
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd], axis=1)  # camera->world columns
    f = min(h, w) * dist / (extent * margin)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float64)
    pose = np.eye(4)
    pose[:3, :3] = Rcw
    pose[:3, 3] = C
    return K, np.linalg.inv(pose), C


def _first_hit(C, d_w, s_max, coarse: int = 192, refine: int = 25):
    """First terrain intersection along rays p = C + s d: a sign-change
    scan over ``coarse`` samples of s, then ``refine`` bisections.
    Returns (s_hit, hit_mask)."""
    shape = d_w.shape[:-1]
    s_lo = np.zeros(shape)
    s_hi = np.full(shape, s_max)
    found = np.zeros(shape, bool)
    prev_s = np.full(shape, 1e-3)
    prev_f = (C[2] + prev_s * d_w[..., 2]
              - terrain_z(C[0] + prev_s * d_w[..., 0], C[1] + prev_s * d_w[..., 1]))
    for i in range(1, coarse + 1):
        s = 1e-3 + (s_max - 1e-3) * i / coarse
        px = C[0] + s * d_w[..., 0]
        py = C[1] + s * d_w[..., 1]
        f = C[2] + s * d_w[..., 2] - terrain_z(px, py)
        cross = ~found & (prev_f > 0) & (f <= 0)
        s_lo = np.where(cross, prev_s, s_lo)
        s_hi = np.where(cross, s, s_hi)
        found |= cross
        prev_s, prev_f = np.full(shape, s), f
    for _ in range(refine):
        mid = 0.5 * (s_lo + s_hi)
        f = (C[2] + mid * d_w[..., 2]
             - terrain_z(C[0] + mid * d_w[..., 0], C[1] + mid * d_w[..., 1]))
        s_hi = np.where(f <= 0, mid, s_hi)
        s_lo = np.where(f <= 0, s_lo, mid)
    return 0.5 * (s_lo + s_hi), found


def render_image_occluded(image_size, K: np.ndarray, extrinsic: np.ndarray, extent: float, *,
                          shift=None, seed: int = 3, v_flip: bool = True) -> np.ndarray:
    """``render_image`` with hidden-surface removal (each ray's first
    terrain hit), for oblique cameras; rays that miss the terrain render
    as 0."""
    h, w = image_size
    pose = np.linalg.inv(extrinsic)
    Rcw = pose[:3, :3]
    C = pose[:3, 3]
    Kinv = np.linalg.inv(K)
    u = np.arange(w, dtype=np.float64) + 0.5
    v_img = np.arange(h, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, v_img)
    v = (h - vv) if v_flip else vv
    d_cam = np.stack([uu, v, np.ones_like(uu)], axis=-1) @ Kinv.T
    d_w = d_cam @ Rcw.T
    s_max = 2.0 * np.linalg.norm(np.array([extent, extent, 0.0]) - C) + 4.0 * extent
    s, hit = _first_hit(C, d_w, s_max)
    px = C[0] + s * d_w[..., 0]
    py = C[1] + s * d_w[..., 1]
    if shift is not None:
        sx, sy, _ = shift
        moving = px > extent / 2.0
        px = np.where(moving, px - sx, px)
        py = np.where(moving, py - sy, py)
    tex = texture(px.astype(np.float32), py.astype(np.float32), seed=seed)
    return np.clip(tex * 255.0 * hit, 0, 255).astype(np.uint8)


def visible_in_view(points: np.ndarray, K: np.ndarray, extrinsic: np.ndarray, extent: float,
                    tol: float = 0.05) -> np.ndarray:
    """True where a world point is the first terrain hit along its viewing
    ray (not occluded by nearer relief)."""
    C = np.linalg.inv(extrinsic)[:3, 3]
    d = points - C
    dist = np.linalg.norm(d, axis=1)
    d_w = d / dist[:, None]
    s, hit = _first_hit(C, d_w, float(dist.max()) * 1.05)
    return hit & (np.abs(s - dist) <= tol * dist.clip(min=1.0))
