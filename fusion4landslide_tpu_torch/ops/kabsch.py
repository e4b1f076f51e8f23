"""Batched, masked, weighted Kabsch rigid fit.

Port of ``fusion4landslide_tpu.ops.kabsch`` (reference src/functions.py:
12-85): degenerate fits (fewer than 3 weighted points, non-finite SVD)
return the identity with ``valid=False``.
"""

from __future__ import annotations

import torch

__all__ = ["rt_to_transform", "transform_points", "transformation_residuals", "weighted_kabsch"]


def transform_points(points, R, t) -> torch.Tensor:
    """(..., N, 3) rigidly transformed points R p + t."""
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def transformation_residuals(x1, x2, R, t) -> torch.Tensor:
    """(..., N) pointwise residuals ||R x1 + t - x2|| (reference
    src/functions.py:88-104)."""
    return torch.linalg.norm(transform_points(x1, R, t) - x2, dim=-1)


def rt_to_transform(R, t) -> torch.Tensor:
    """(..., 4, 4) homogeneous transforms from (..., 3, 3) rotations and
    (..., 3) translations."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def weighted_kabsch(x1, x2, weights=None, mask=None, *, eps: float = 1e-7):
    """min ||R x1 + t - x2|| over (..., N, 3) stacks with normalised
    weights. Returns (R (..., 3, 3), t (..., 3), residuals (..., N),
    valid (...))."""
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    if weights is None:
        weights = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    else:
        weights = weights.to(x1.dtype)
    if mask is not None:
        weights = weights * mask.to(x1.dtype)
    weights = weights / (weights.sum(-1, keepdim=True) + eps)
    w = weights[..., None]
    wsum = w.sum(-2, keepdim=True) + eps
    mu1 = (w * x1).sum(-2, keepdim=True) / wsum
    mu2 = (w * x2).sum(-2, keepdim=True) / wsum
    x1c = x1 - mu1
    x2c = x2 - mu2
    H = torch.einsum("...ni,...nj->...ij", x1c * w, x2c)
    U, S, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.zeros_like(H)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = torch.sign(det) + (det == 0.0).to(H.dtype)
    R = V @ D @ Ut
    t = mu2[..., 0, :] - torch.einsum("...ij,...j->...i", R, mu1[..., 0, :])
    eff_pts = (weights > 0).to(x1.dtype).sum(-1)
    finite = torch.isfinite(S).all(-1) & torch.isfinite(R).all(-1).all(-1)
    valid = finite & (eff_pts >= 3)
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand_as(R)
    R = torch.where(valid[..., None, None], R, eye)
    t = torch.where(valid[..., None], t, torch.zeros_like(t))
    res = transformation_residuals(x1, x2, R, t)
    if mask is not None:
        res = torch.where(mask.to(torch.bool), res, 0.0)
    return R, t, res, valid
