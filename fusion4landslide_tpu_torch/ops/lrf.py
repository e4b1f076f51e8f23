"""Local-reference-frame (LRF) patches for DIPs descriptors.

Port of ``fusion4landslide_tpu.ops.lrf`` (the DIP LRF of Poiesi & Boscaini,
reference src/data_loader.py:42-106): covariance z-axis sign-disambiguated
against the mean neighbour direction, weighted in-plane x-axis, patch =
R^T (q - p) / R; sparse patches (<= 10 in-radius points) are only scaled
by 1/R.

Two forms: ``lrf_patches_from_neighbors`` takes pre-sampled neighbours (the
grid samplers exclude the query itself), ``lrf_patches_from_knn`` an
ascending (n, k_max) neighbour table (its nearest entry, the query itself
when the query is in the support, stays out of the covariance) and keeps
a random ``num_points`` subset of the in-radius entries;
``extract_lrf_patches`` builds that table with the exact ``ops.knn.knn``.
The subset's uniform priorities are an input (the JAX package draws them
with ``jax.random.uniform``), or come from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.eig3 import smallest_eigenvector_sym3x3
from fusion4landslide_tpu_torch.ops.knn import knn

__all__ = ["extract_lrf_patches", "lrf_patches_from_knn", "lrf_patches_from_neighbors",
           "lrf_patches_from_samples"]

_EPS = 1e-6


def lrf_patches_from_neighbors(query, neigh, valid, radius) -> torch.Tensor:
    """(n, k, 3) patches in each query's LRF from pre-sampled neighbour
    coordinates ``neigh`` (n, k, 3) with ``valid`` (n, k) — the sampler
    already excludes the query point, so every valid sample enters the
    covariance."""
    radius = torch.as_tensor(radius, dtype=query.dtype, device=query.device)
    patch, v = _lrf_normalize(query, neigh, valid, valid, radius)
    return torch.where(v[..., None], patch, 0.0)


def lrf_patches_from_samples(query, support, idx, valid, radius) -> torch.Tensor:
    """(n, k, 3) LRF patches from pre-sampled neighbour *indices* ``idx``
    (n, k) into ``support``: the coordinates are gathered, then
    ``lrf_patches_from_neighbors``."""
    return lrf_patches_from_neighbors(query, support[idx.long()], valid, radius)


def lrf_patches_from_knn(query, support, sqd, idx, radius, priorities=None, *,
                         num_points: int = 256, generator=None) -> torch.Tensor:
    """(n, num_points, 3) LRF patches from an ascending (n, k_max) kNN
    table ``sqd`` / ``idx`` into ``support``: entries within ``radius``
    are valid, all but the first enter the covariance, and the
    ``num_points`` valid entries of largest ``priorities`` (n, k_max)
    uniform draws are kept (ties to the lower entry, as ``lax.top_k``),
    zero-padded. Without ``priorities`` they are drawn from
    ``generator``."""
    n, k_max = sqd.shape
    radius = torch.as_tensor(radius, dtype=query.dtype, device=query.device)
    dist = torch.sqrt(sqd)
    valid = torch.isfinite(dist) & (dist <= radius)
    neigh = support[idx.long()]
    cov_mask = valid.clone()
    cov_mask[:, 0] = False
    patch, valid = _lrf_normalize(query, neigh, valid, cov_mask, radius)
    if priorities is None:
        priorities = torch.rand((n, k_max), generator=generator, device=query.device)
    pri = torch.where(valid, priorities.to(query.device), -torch.inf)
    sel = torch.sort(pri, dim=1, descending=True, stable=True).indices[:, :num_points]
    picked = torch.gather(patch, 1, sel[..., None].expand(-1, -1, 3))
    return torch.where(torch.gather(valid, 1, sel)[..., None], picked, 0.0)


def extract_lrf_patches(query, support, radius, priorities=None, *, k_max: int = 512,
                        num_points: int = 256, support_mask=None,
                        generator=None) -> torch.Tensor:
    """(n, num_points, 3) LRF patches of ``query`` from its ``k_max``
    exact nearest ``support`` points (``ops.knn.knn``; masked supports
    excluded), through ``lrf_patches_from_knn``."""
    sqd, idx = knn(query, support, k_max, support_mask)
    return lrf_patches_from_knn(query, support, sqd, idx, radius, priorities,
                                num_points=num_points, generator=generator)


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
