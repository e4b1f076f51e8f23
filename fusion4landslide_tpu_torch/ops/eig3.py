"""Closed-form eigenanalysis of batched symmetric 3x3 matrices.

Port of ``fusion4landslide_tpu.ops.eig3``: Cardano's trigonometric solution
for the eigenvalues (Eberly, "A Robust Eigensolver for 3x3 Symmetric
Matrices") and a cross product of rows of (A - lambda I) for the
smallest-eigenvalue eigenvector. Branchless elementwise math.
"""

from __future__ import annotations

import torch

__all__ = ["eigvals_sym3x3", "smallest_eigenvector_sym3x3"]


def _unpack(A):
    return (
        A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
        A[..., 0, 1], A[..., 0, 2], A[..., 1, 2],
    )


def eigvals_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues (..., 3) of symmetric (..., 3, 3) matrices."""
    a00, a11, a22, a01, a02, a12 = _unpack(A)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    safe_p = torch.clamp(p, min=torch.finfo(A.dtype).tiny)
    det = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(det / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lmid = 3.0 * q - lmax - lmin
    return torch.stack([lmin, lmid, lmax], dim=-1)


def smallest_eigenvector_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector (..., 3) of the smallest eigenvalue; a fixed
    fallback axis (z) where the answer is degenerate."""
    tiny = torch.finfo(A.dtype).tiny
    m = A.abs().amax(dim=(-2, -1), keepdim=True)
    An = A / torch.clamp(m, min=tiny)
    lmin = eigvals_sym3x3(An)[..., 0]
    a00, a11, a22, a01, a02, a12 = _unpack(An)
    r0 = torch.stack([a00 - lmin, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lmin, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lmin], dim=-1)
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    norm = torch.linalg.norm(best, dim=-1, keepdim=True)
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    ok = norm > 1e-12
    return torch.where(ok, best / torch.clamp(norm, min=1e-30), fallback)
