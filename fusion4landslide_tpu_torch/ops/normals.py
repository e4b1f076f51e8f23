"""PCA normal estimation over a caller-supplied kNN graph.

Port of ``fusion4landslide_tpu.ops.normals.pca_normals`` with precomputed
neighbours: the normal is the smallest-eigenvalue eigenvector of the
neighbourhood covariance (unoriented; VCCS uses |n1.n2|).
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.eig3 import smallest_eigenvector_sym3x3

__all__ = ["pca_normals", "neighborhood_covariance"]


def neighborhood_covariance(points, neigh_idx, neigh_mask) -> torch.Tensor:
    """(n, 3, 3) covariance of each point's neighbours about their mean."""
    neigh = points[neigh_idx.long()]
    w = neigh_mask.to(points.dtype)[..., None]
    cnt = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    mean = (neigh * w).sum(dim=1, keepdim=True) / cnt
    d = (neigh - mean) * w
    return torch.einsum("nki,nkj->nij", d, d) / cnt[..., 0][..., None]


def pca_normals(points, mask=None, *, neigh_idx, neigh_mask) -> torch.Tensor:
    """(n, 3) unit normals (arbitrary sign; zero rows for masked points)."""
    normals = smallest_eigenvector_sym3x3(
        neighborhood_covariance(points, neigh_idx, neigh_mask)
    )
    if mask is not None:
        normals = torch.where(mask.to(torch.bool)[:, None], normals, 0.0)
    return normals
