"""Local-reference-frame (LRF) patches for DIPs descriptors.

Port of ``fusion4landslide_tpu.ops.lrf`` (the DIP LRF of Poiesi & Boscaini,
reference src/data_loader.py:42-106), the pre-sampled-neighbour form the
grid sampler feeds: covariance z-axis sign-disambiguated against the mean
neighbour direction, weighted in-plane x-axis, patch = R^T (q - p) / R;
sparse patches (<= 10 in-radius points) are only scaled by 1/R.
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.eig3 import smallest_eigenvector_sym3x3

__all__ = ["lrf_patches_from_neighbors"]

_EPS = 1e-6


def lrf_patches_from_neighbors(query, neigh, valid, radius) -> torch.Tensor:
    """(n, k, 3) patches in each query's LRF from pre-sampled neighbour
    coordinates ``neigh`` (n, k, 3) with ``valid`` (n, k) — the sampler
    already excludes the query point, so every valid sample enters the
    covariance."""
    radius = torch.as_tensor(radius, dtype=query.dtype, device=query.device)
    patch, v = _lrf_normalize(query, neigh, valid, valid, radius)
    return torch.where(v[..., None], patch, 0.0)


def _lrf_normalize(query, neigh, valid, cov_mask, radius):
    diff = neigh - query[:, None, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    w = cov_mask.to(query.dtype)[..., None]
    cnt = torch.clamp(w.sum(dim=1), min=1.0)
    dw = diff * w
    cov = torch.einsum("nki,nkj->nij", dw, dw) / cnt[..., None]
    np_hat = smallest_eigenvector_sym3x3(cov)
    s = torch.einsum("ni,nki->n", np_hat, -dw)
    zp = torch.where((s > 0)[:, None], np_hat, -np_hat)
    proj = torch.einsum("nki,ni->nk", diff, zp)
    v = diff - proj[..., None] * zp[:, None, :]
    alpha = torch.where(cov_mask, (radius - dist) ** 2, 0.0)
    beta = proj**2 * cov_mask
    xp = torch.einsum("nki,nk->ni", v, alpha * beta)
    xp = xp / (torch.linalg.norm(xp, dim=-1, keepdim=True) + _EPS)
    yp = torch.linalg.cross(zp, xp)
    lrf = torch.stack([xp, yp, zp], dim=1)
    local = torch.einsum("nij,nkj->nki", lrf, diff) / radius
    sparse = valid.sum(dim=1) <= 10
    raw = neigh / radius
    patch = torch.where(sparse[:, None, None], raw, local)
    patch = torch.where(valid[..., None], patch, 0.0)
    return patch, valid
