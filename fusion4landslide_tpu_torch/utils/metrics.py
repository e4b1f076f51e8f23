"""Registration metrics on tensors (port of
``fusion4landslide_tpu.utils.metrics``; reference utils/metrics.py:14-26)."""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.kabsch import transform_points

__all__ = ["compute_inlier_ratio", "median_displacement_error"]


def compute_inlier_ratio(src: torch.Tensor, tgt: torch.Tensor, R: torch.Tensor,
                         t: torch.Tensor, inlier_threshold=0.1,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of (n, 3) correspondences whose residual after ``R``,
    ``t`` is below ``inlier_threshold``; over the ``mask`` rows if given."""
    res = torch.linalg.vector_norm(transform_points(src, R, t) - tgt, dim=-1)
    ok = res < inlier_threshold
    if mask is not None:
        m = mask.to(torch.bool)
        return (ok & m).sum() / torch.clamp(m.sum(), min=1)
    return ok.to(torch.float32).mean()


def median_displacement_error(dvfs_a: torch.Tensor, dvfs_b: torch.Tensor) -> torch.Tensor:
    """Median |d_a - d_b| between two (n, 6) DVF tables on the same source
    points. For an even n this is the mean of the two middle values, as
    ``jnp.median`` takes it (``torch.median`` would return the lower)."""
    da = dvfs_a[:, 3:6] - dvfs_a[:, :3]
    db = dvfs_b[:, 3:6] - dvfs_b[:, :3]
    return torch.quantile(torch.linalg.vector_norm(da - db, dim=-1), 0.5)
