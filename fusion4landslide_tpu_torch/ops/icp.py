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

__all__ = ["ICPLoop", "ICPResult", "icp_point2point", "start_pose"]


class ICPResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    fitness: torch.Tensor  # (B,)
    inlier_rmse: torch.Tensor  # (B,)
    n_inliers: torch.Tensor  # (B,) int32
    corr_idx: torch.Tensor  # (B, n)
    corr_inlier: torch.Tensor  # (B, n)


class ICPLoop:
    """The iteration every ICP solver shares (the JAX solvers'
    ``while_loop``, vmapped over pairs): correspondences by 1-NN within
    ``max_dist``, fitness and inlier RMSE, and per-pair stopping when both
    change by less than ``rel_tol`` (and, with ``stop_on_bad``, when an
    update is rejected). A stopped pair keeps its state."""

    def __init__(self, src, tgt, max_dist, src_mask, tgt_mask):
        B, n = src.shape[0], src.shape[1]
        self.src, self.tgt, self.tgt_mask = src, tgt, tgt_mask
        self.smask = (torch.ones((B, n), dtype=torch.bool, device=src.device)
                      if src_mask is None else src_mask.to(torch.bool))
        self.n_valid = torch.clamp(self.smask.sum(-1), min=1)
        self.max_d2 = torch.as_tensor(max_dist, dtype=src.dtype, device=src.device) ** 2

    def correspondences(self, R, t):
        sqd, idx = knn(transform_points(self.src, R, t), self.tgt, 1, self.tgt_mask)
        sqd, idx = sqd[..., 0], idx[..., 0]
        return idx, self.smask & torch.isfinite(sqd) & (sqd <= self.max_d2), sqd

    def metrics(self, inlier, sqd):
        cnt = inlier.sum(-1)
        rmse = torch.sqrt(torch.where(inlier, sqd, 0.0).sum(-1) / torch.clamp(cnt, min=1))
        return cnt / self.n_valid, rmse

    def run(self, step, R, t, max_iter: int, rel_tol: float, stop_on_bad: bool) -> ICPResult:
        """``step(R, t, idx, inlier) -> (R_new, t_new, ok)`` per iteration;
        where ``ok`` is False the pair keeps (R, t)."""
        B = self.src.shape[0]
        idx, inlier, sqd = self.correspondences(R, t)
        fit, rmse = self.metrics(inlier, sqd)
        done = torch.zeros((B,), dtype=torch.bool, device=self.src.device)
        for _ in range(max_iter):
            if bool(done.all()):
                break
            R_new, t_new, ok = step(R, t, idx, inlier)
            R_fit = torch.where(ok[:, None, None], R_new, R)
            t_fit = torch.where(ok[:, None], t_new, t)
            idx2, inlier2, sqd2 = self.correspondences(R_fit, t_fit)
            fit2, rmse2 = self.metrics(inlier2, sqd2)
            conv = (torch.abs(fit2 - fit) < rel_tol) & (torch.abs(rmse2 - rmse) < rel_tol)
            act = ~done
            R = torch.where(act[:, None, None], R_fit, R)
            t = torch.where(act[:, None], t_fit, t)
            fit = torch.where(act, fit2, fit)
            rmse = torch.where(act, rmse2, rmse)
            idx = torch.where(act[:, None], idx2, idx)
            inlier = torch.where(act[:, None], inlier2, inlier)
            done = done | (act & ((conv | ~ok) if stop_on_bad else conv))
        return ICPResult(R=R, t=t, fitness=fit, inlier_rmse=rmse,
                         n_inliers=inlier.sum(-1).to(torch.int32), corr_idx=idx,
                         corr_inlier=inlier)


def start_pose(src, R_init=None, t_init=None):
    """(B, 3, 3) identity and (B, 3) zeros unless given."""
    B, dev, dtype = src.shape[0], src.device, src.dtype
    R = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3) if R_init is None else R_init
    t = torch.zeros((B, 3), dtype=dtype, device=dev) if t_init is None else t_init
    return R, t


def icp_point2point(src, tgt, max_dist, src_mask=None, tgt_mask=None, *,
                    max_iter: int = 30, rel_tol: float = 1e-6,
                    R_init=None, t_init=None) -> ICPResult:
    """Rigidly register (B, n, 3) ``src`` onto (B, m, 3) ``tgt``: each
    iteration a weighted Kabsch fit on the current inliers (a degenerate
    fit stops the pair)."""
    loop = ICPLoop(src, tgt, max_dist, src_mask, tgt_mask)
    B, n = src.shape[0], src.shape[1]

    def step(R, t, idx, inlier):
        matched = torch.gather(tgt, 1, idx.long()[..., None].expand(B, n, 3))
        R_new, t_new, _, ok = weighted_kabsch(src, matched, weights=inlier.to(src.dtype))
        return R_new, t_new, ok

    return loop.run(step, *start_pose(src, R_init, t_init), max_iter, rel_tol, stop_on_bad=True)
