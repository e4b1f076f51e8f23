"""Point-to-point ICP, batched over patch pairs.

Port of ``fusion4landslide_tpu.ops.icp.icp_point2point`` (reference
utils/o3d_tools.py:12-71): each iteration rigid-fits the source onto its
current 1-NN correspondences within ``max_dist`` and re-searches; a pair
stops when fitness and inlier RMSE both change by less than ``rel_tol``,
its fit degenerates, or ``max_iter`` iterations ran. The JAX version is
vmapped over pairs; here the pair axis is a leading batch dimension and a
pair that has stopped keeps its state while the others iterate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops.kabsch import transform_points, weighted_kabsch
from fusion4landslide_tpu_torch.ops.knn import knn

__all__ = ["ICPResult", "icp_point2point"]


class ICPResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    fitness: torch.Tensor  # (B,)
    inlier_rmse: torch.Tensor  # (B,)
    n_inliers: torch.Tensor  # (B,) int32
    corr_idx: torch.Tensor  # (B, n)
    corr_inlier: torch.Tensor  # (B, n)


def icp_point2point(src, tgt, max_dist, src_mask=None, tgt_mask=None, *,
                    max_iter: int = 30, rel_tol: float = 1e-6,
                    R_init=None, t_init=None) -> ICPResult:
    """Rigidly register (B, n, 3) ``src`` onto (B, m, 3) ``tgt``."""
    B, n = src.shape[0], src.shape[1]
    dev, dtype = src.device, src.dtype
    smask = (
        torch.ones((B, n), dtype=torch.bool, device=dev)
        if src_mask is None
        else src_mask.to(torch.bool)
    )
    n_valid = torch.clamp(smask.sum(-1), min=1)
    R = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3) if R_init is None else R_init
    t = torch.zeros((B, 3), dtype=dtype, device=dev) if t_init is None else t_init
    max_d2 = torch.as_tensor(max_dist, dtype=dtype, device=dev) ** 2

    def correspondences(R, t):
        sqd, idx = knn(transform_points(src, R, t), tgt, 1, tgt_mask)
        sqd, idx = sqd[..., 0], idx[..., 0]
        inlier = smask & torch.isfinite(sqd) & (sqd <= max_d2)
        return idx, inlier, sqd

    def metrics(inlier, sqd):
        cnt = inlier.sum(-1)
        fitness = cnt / n_valid
        rmse = torch.sqrt(
            torch.where(inlier, sqd, 0.0).sum(-1) / torch.clamp(cnt, min=1)
        )
        return fitness, rmse

    idx, inlier, sqd = correspondences(R, t)
    fit, rmse = metrics(inlier, sqd)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        matched = torch.gather(tgt, 1, idx.long()[..., None].expand(B, n, 3))
        R_new, t_new, _, ok = weighted_kabsch(src, matched, weights=inlier.to(dtype))
        R_fit = torch.where(ok[:, None, None], R_new, R)
        t_fit = torch.where(ok[:, None], t_new, t)
        idx2, inlier2, sqd2 = correspondences(R_fit, t_fit)
        fit2, rmse2 = metrics(inlier2, sqd2)
        conv = (torch.abs(fit2 - fit) < rel_tol) & (torch.abs(rmse2 - rmse) < rel_tol)
        act = ~done
        R = torch.where(act[:, None, None], R_fit, R)
        t = torch.where(act[:, None], t_fit, t)
        fit = torch.where(act, fit2, fit)
        rmse = torch.where(act, rmse2, rmse)
        idx = torch.where(act[:, None], idx2, idx)
        inlier = torch.where(act[:, None], inlier2, inlier)
        done = done | (act & (conv | ~ok))
    return ICPResult(
        R=R, t=t, fitness=fit, inlier_rmse=rmse,
        n_inliers=inlier.sum(-1).to(torch.int32), corr_idx=idx, corr_inlier=inlier,
    )
