"""Point-to-point ICP of one patch pair (Besl & McKay 1992) over its
matched points, in float64: each iteration pairs every source point
with its nearest target point within ``max_dist`` and fits a rigid
transform to those pairs (Kabsch, equal weights); it stops when the
share of paired points and their RMS distance both change by less than
1e-6, when a fit cannot be made (fewer than 3 pairs), or after
``max_iter`` iterations. Fits resting on fewer than ``MIN_INLIERS`` pairs
are not judged: a rigid fit to 3 or 4 nearly collinear points turns
about their line by whatever rounding decides.
"""

from __future__ import annotations

import torch

from reference.precision import round_tf32

MIN_INLIERS = 10


def kabsch(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, tf32: bool = False):
    """R, t minimising sum w |R x1 + t - x2|^2 (a proper rotation); the
    identity where fewer than 3 rows have weight (no fit). ``tf32``: the
    cross-covariance from TF32 operands (the control)."""
    if int((w > 0).sum()) < 3:
        return torch.eye(3, dtype=x1.dtype, device=x1.device), torch.zeros_like(x1[0])
    w = w / w.sum()
    mu1, mu2 = (w[:, None] * x1).sum(0), (w[:, None] * x2).sum(0)
    a, b = (x1 - mu1) * w[:, None], x2 - mu2
    H = (round_tf32(a).T @ round_tf32(b)).double() if tf32 else a.T @ b
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    return R, mu2 - R @ mu1


def _pairs(src, tgt, mask, R, t, max_dist):
    moved = src @ R.T + t
    d2 = torch.cdist(moved, tgt[mask], compute_mode="donot_use_mm_for_euclid_dist") ** 2
    best, j = d2.min(dim=1)
    inlier = mask & (best <= max_dist**2)
    return tgt[mask][j], inlier, best


def step(src, tgt, mask, R, t, max_dist, tf32: bool = False):
    """One iteration from (R, t): the new (R, t), or None where fewer
    than 3 points pair up (no fit)."""
    matched, inlier, _ = _pairs(src, tgt, mask, R, t, max_dist)
    if int(inlier.sum()) < 3:
        return None
    return kabsch(src[inlier], matched[inlier], torch.ones_like(src[inlier, 0]), tf32)


def icp(src, tgt, mask, R, t, max_dist, max_iter: int = 30, tf32: bool = False):
    """(R, t, pairs at the end) after at most ``max_iter`` iterations
    from (R, t)."""
    src, tgt, R, t = src.double(), tgt.double(), R.double(), t.double()

    def metrics(R, t):
        _, inlier, best = _pairs(src, tgt, mask, R, t, max_dist)
        n = int(inlier.sum())
        return n / max(int(mask.sum()), 1), float(best[inlier].mean().sqrt()) if n else 0.0

    fit, rmse = metrics(R, t)
    for _ in range(max_iter):
        nxt = step(src, tgt, mask, R, t, max_dist, tf32)
        if nxt is None:
            break
        R, t = nxt
        fit2, rmse2 = metrics(R, t)
        if abs(fit2 - fit) < 1e-6 and abs(rmse2 - rmse) < 1e-6:
            break
        fit, rmse = fit2, rmse2
    return R, t, int(_pairs(src, tgt, mask, R, t, max_dist)[1].sum())
