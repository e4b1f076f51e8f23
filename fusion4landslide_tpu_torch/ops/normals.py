"""PCA normal estimation over kNN neighbourhoods.

Port of ``fusion4landslide_tpu.ops.normals.pca_normals``: the normal is
the smallest-eigenvalue eigenvector of the neighbourhood covariance
(unoriented; VCCS uses |n1.n2|). The kNN graph is the caller's
(``neigh_idx`` / ``neigh_mask``, the supervoxel stage's) or, without one,
the exact k nearest neighbours of ``ops.knn.knn``. Leading batch
dimensions (the ICP variants' pair axis) are supported.
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.eig3 import smallest_eigenvector_sym3x3
from fusion4landslide_tpu_torch.ops.knn import knn

__all__ = ["pca_normals", "neighborhood_covariance"]


def neighborhood_covariance(points, neigh_idx, neigh_mask) -> torch.Tensor:
    """(..., n, 3, 3) covariance of each point's neighbours about their
    mean, for (..., n, 3) points and an (..., n, k) graph."""
    idx = neigh_idx.long()
    flat = idx.reshape(*idx.shape[:-2], -1, 1).expand(*idx.shape[:-2], -1, 3)
    neigh = torch.gather(points.expand(*idx.shape[:-2], *points.shape[-2:]), -2,
                         flat).reshape(*idx.shape, 3)
    w = neigh_mask.to(points.dtype)[..., None]
    cnt = torch.clamp(w.sum(dim=-2, keepdim=True), min=1.0)
    mean = (neigh * w).sum(dim=-2, keepdim=True) / cnt
    d = (neigh - mean) * w
    return torch.einsum("...ki,...kj->...ij", d, d) / cnt[..., 0][..., None]


def pca_normals(points, mask=None, *, k: int = 30, neigh_idx=None,
                neigh_mask=None) -> torch.Tensor:
    """(..., n, 3) unit normals (arbitrary sign; zero rows for masked
    points) from the caller's graph or from the ``k`` nearest valid
    neighbours."""
    if neigh_idx is None:
        sqd, neigh_idx = knn(points, points, k, mask)
        neigh_mask = torch.isfinite(sqd)
    normals = smallest_eigenvector_sym3x3(
        neighborhood_covariance(points, neigh_idx, neigh_mask)
    )
    if mask is not None:
        normals = torch.where(mask.to(torch.bool)[..., None], normals, 0.0)
    return normals
