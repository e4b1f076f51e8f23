"""Headless figure writers (PNG / JPG files), the port's own copy of
``fusion4landslide_tpu.utils.visualization``.

The reference's visual debugging is interactive: Open3D windows for
coarse patch matches (reference base:3159-3231, :4279-4403) and
EfficientLoFTR ``make_matching_figure`` pop-ups / JPGs for 2D image
matches (base:1213-1224). These render the same content with
matplotlib's Agg backend straight to files:

- :func:`save_matching_figure`: the epoch images side by side with match
  lines coloured by flow magnitude (``save_img_matching_visualization``);
- :func:`save_patch_match_figure`: top-down and oblique scatter of the two
  epoch clouds with one matched patch pair highlighted, the target epoch
  shifted by the config's ``offset`` (``visualize_patch``);
- :func:`save_matches_within_patch_figure`: the fine stage's point
  correspondences inside one patch pair (``visualize_matches_within_patch``).

All are host-side numpy and return the written path. matplotlib is
imported inside the functions only, so the package imports without it;
:func:`require_matplotlib` lets a tile refuse a figure option before any
work where matplotlib is missing. Callers: the host fusion tile
(``pipelines/fusion.py``: patch and match figures) and the rgb_guided host
tile (``pipelines/rgb_guided.py``: match figures); the runners write no
figures, as the JAX runners do not.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

#: The config keys that ask for figures.
FIGURE_KEYS = ("save_img_matching_visualization", "visualize_patch")


def require_matplotlib(cfg, keys=FIGURE_KEYS) -> None:
    """Raise ``ImportError`` naming matplotlib when ``cfg`` sets one of
    ``keys`` and matplotlib cannot be imported."""
    asked = [k for k in keys if bool(cfg.get(k, False))]
    if not asked:
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError(f"{', '.join(asked)}: the figure writers need matplotlib, which "
                          "is not installed; set the option to False") from exc


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def save_matching_figure(
    img0: np.ndarray,
    img1: np.ndarray,
    matches: np.ndarray,
    path: str,
    *,
    text: str | None = None,
    max_lines: int = 800,
    dpi: int = 75,
    seed: int = 0,
) -> str:
    """Side-by-side image pair with match lines (EfficientLoFTR
    ``make_matching_figure`` equivalent, reference base:1213-1224).

    ``matches``: (N, 4) [x0, y0, x1, y1] full-image pixel matches. Lines
    are coloured by flow magnitude; at most ``max_lines`` random matches
    are drawn (the reference caps via dpi=30 rasterisation instead).
    """
    plt = _plt()
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)
    m = np.asarray(matches, np.float64).reshape(-1, 4)
    if len(m) > max_lines:
        keep = np.random.default_rng(seed).choice(
            len(m), max_lines, replace=False
        )
        m = m[keep]

    fig, axes = plt.subplots(1, 2, figsize=(12, 6), dpi=dpi)
    for ax, img in zip(axes, (img0, img1)):
        if img.ndim == 2:
            ax.imshow(img, cmap="gray")
        else:
            ax.imshow(img)
        ax.set_axis_off()
    fig.tight_layout(pad=0.5)
    fig.canvas.draw()  # final axes positions before figure-space transforms

    if len(m):
        flow = np.linalg.norm(m[:, 2:4] - m[:, 0:2], axis=1)
        fmax = float(flow.max()) or 1.0
        cmap = plt.get_cmap("turbo")
        t0 = axes[0].transData
        t1 = axes[1].transData
        tf = fig.transFigure.inverted()
        p0 = tf.transform(t0.transform(m[:, 0:2]))
        p1 = tf.transform(t1.transform(m[:, 2:4]))
        for k in range(len(m)):
            fig.add_artist(
                plt.Line2D(
                    [p0[k, 0], p1[k, 0]],
                    [p0[k, 1], p1[k, 1]],
                    color=cmap(flow[k] / fmax),
                    linewidth=0.5,
                    alpha=0.6,
                )
            )
        axes[0].scatter(m[:, 0], m[:, 1], s=2, c="w", edgecolors="none")
        axes[1].scatter(m[:, 2], m[:, 3], s=2, c="w", edgecolors="none")
    title = f"{len(m)} matches shown"
    if text:
        title = f"{text} — {title}"
    fig.suptitle(title, fontsize=9)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)
    return path


def _scatter_clouds(ax, clouds, view: str, point_size: float):
    """clouds: list of (pts (N,3), color, size_scale, label)."""
    for pts, color, scale, label in clouds:
        if not len(pts):
            continue
        if view == "top":
            ax.scatter(
                pts[:, 0], pts[:, 1], s=point_size * scale, c=color,
                edgecolors="none", label=label,
            )
        else:  # oblique: x vs (y+z)/sqrt(2) poor-man's isometric
            ax.scatter(
                pts[:, 0],
                0.7071 * (pts[:, 1] + pts[:, 2]),
                s=point_size * scale,
                c=color,
                edgecolors="none",
                label=label,
            )
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_axis_off()


def _downsample(pts: np.ndarray, cap: int, seed: int = 0) -> np.ndarray:
    pts = np.asarray(pts)
    if len(pts) <= cap:
        return pts
    keep = np.random.default_rng(seed).choice(len(pts), cap, replace=False)
    return pts[keep]


# Reference's fixed palette (base:3217-3219).
SRC_COLOR = (0.921, 0.569, 0.0)
TGT_COLOR = (0.0, 0.839, 1.0)
PATCH_COLOR = (1.0, 0.0, 0.0)


def save_patch_match_figure(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    patch_src: np.ndarray,
    patch_tgt: np.ndarray,
    path: str,
    *,
    offset=(75.0, 75.0, 75.0),
    small_region: float | None = None,
    max_background: int = 60_000,
    dpi: int = 90,
) -> str:
    """One coarse patch match over the two epoch clouds
    (``visualize_patch``, reference base:3159-3231): source epoch in
    orange, target epoch shifted by ``offset`` in cyan, the matched patch
    pair in red (patch_tgt drawn at its offset position). ``small_region``
    crops both backgrounds to that half-width box around each patch centre
    (the reference's ``_crop_small_point_cloud_for_visualization``)."""
    plt = _plt()
    off = np.asarray(offset, np.float64).reshape(3)
    src_pts = np.asarray(src_pts, np.float64)
    tgt_pts = np.asarray(tgt_pts, np.float64)
    patch_src = np.asarray(patch_src, np.float64)
    patch_tgt = np.asarray(patch_tgt, np.float64) + off

    if small_region and len(patch_src) and len(patch_tgt):
        c_s = patch_src.mean(axis=0)
        c_t = patch_tgt.mean(axis=0) - off
        keep_s = np.all(np.abs(src_pts - c_s) <= small_region, axis=1)
        keep_t = np.all(np.abs(tgt_pts - c_t) <= small_region, axis=1)
        src_pts = src_pts[keep_s]
        tgt_pts = tgt_pts[keep_t]

    bg_s = _downsample(src_pts, max_background)
    bg_t = _downsample(tgt_pts, max_background) + off
    clouds = [
        (bg_s, [SRC_COLOR], 1.0, "src epoch"),
        (bg_t, [TGT_COLOR], 1.0, "tgt epoch (+offset)"),
        (patch_src, [PATCH_COLOR], 4.0, "matched patch (src)"),
        (patch_tgt, [PATCH_COLOR], 4.0, "matched patch (tgt)"),
    ]
    fig, axes = plt.subplots(1, 2, figsize=(12, 6), dpi=dpi)
    _scatter_clouds(axes[0], clouds, "top", 0.6)
    axes[0].set_title("top-down", fontsize=9)
    _scatter_clouds(axes[1], clouds, "oblique", 0.6)
    axes[1].set_title("oblique", fontsize=9)
    axes[0].legend(loc="upper left", fontsize=7, markerscale=4)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)
    return path


def save_matches_within_patch_figure(
    patch_src: np.ndarray,
    patch_tgt: np.ndarray,
    corr_src: np.ndarray,
    corr_tgt: np.ndarray,
    path: str,
    *,
    offset=(0.0, 0.0, 0.0),
    max_lines: int = 300,
    dpi: int = 90,
    seed: int = 0,
) -> str:
    """Fine-stage correspondences inside one matched patch pair
    (``visualize_matches_within_patch``, reference base:4279-4403):
    both patches top-down with the point-correspondence segments. A zero
    default offset keeps true displacement vectors readable; pass the
    config offset to separate the clouds like the reference does."""
    plt = _plt()
    off = np.asarray(offset, np.float64).reshape(3)
    patch_src = np.asarray(patch_src, np.float64)
    patch_tgt = np.asarray(patch_tgt, np.float64) + off
    corr_src = np.asarray(corr_src, np.float64).reshape(-1, 3)
    corr_tgt = np.asarray(corr_tgt, np.float64).reshape(-1, 3) + off
    if len(corr_src) > max_lines:
        keep = np.random.default_rng(seed).choice(
            len(corr_src), max_lines, replace=False
        )
        corr_src = corr_src[keep]
        corr_tgt = corr_tgt[keep]

    fig, ax = plt.subplots(figsize=(8, 8), dpi=dpi)
    _scatter_clouds(
        ax,
        [
            (patch_src, [SRC_COLOR], 1.5, "src patch"),
            (patch_tgt, [TGT_COLOR], 1.5, "tgt patch"),
        ],
        "top",
        1.0,
    )
    for k in range(len(corr_src)):
        ax.plot(
            [corr_src[k, 0], corr_tgt[k, 0]],
            [corr_src[k, 1], corr_tgt[k, 1]],
            color="r",
            linewidth=0.5,
            alpha=0.7,
        )
    ax.legend(loc="upper left", fontsize=7, markerscale=4)
    ax.set_title(f"{len(corr_src)} correspondences", fontsize=9)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)
    return path


def patch_visualization_requests(cfg, n_pairs: int, seed: int = 0):
    """Which coarse patch pairs to render, per the reference's
    ``visualization:`` keys (base:3160-3167): ``num_of_visualize_samples``
    indices, random when ``random_choice`` else the first ones. Returns an
    int array (possibly empty)."""
    if not bool(cfg.get("visualize_patch", False)) or n_pairs <= 0:
        return np.zeros((0,), np.int64)
    k = min(int(cfg.get("num_of_visualize_samples", 10)), n_pairs)
    if bool(cfg.get("random_choice", False)):
        return np.sort(
            np.random.default_rng(seed).choice(n_pairs, k, replace=False)
        )
    return np.arange(k)
