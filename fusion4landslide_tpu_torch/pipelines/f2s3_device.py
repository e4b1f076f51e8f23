"""Device-resident helpers shared by the tile steps.

Port of the parts of ``fusion4landslide_tpu.pipelines.f2s3_device`` that
the fusion tile step uses: ``dips_features_device`` (its accelerator
branch), ``drop_small_and_compact`` and ``masked_median``.
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.pipelines.f2s3 import compute_dips_features

__all__ = ["dips_features_device", "drop_small_and_compact", "masked_median"]


def masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of ``vals`` over ``valid`` rows."""
    s = torch.sort(torch.where(valid, vals, torch.inf)).values
    cnt = valid.sum()
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=0)
    return 0.5 * (s[lo] + s[hi])


def dips_features_device(model, query, support, support_mask, radius, *,
                         patch_points: int = 256, chunk: int = 2048,
                         query_count=None):
    """((n, 64) DIPs descriptors of a padded query cloud, () sampler
    window overflow count); rows at or past ``query_count`` are zero.
    This is the path the JAX package takes on an accelerator (grid
    sampler); its CPU branches ('knn' / traced 'random' samplers) compute
    different functions and are not ported."""
    if patch_points % 128:
        raise NotImplementedError(
            "patch_points % 128 != 0 takes the JAX package's CPU sampler, "
            "which is not ported"
        )
    return compute_dips_features(
        model, query, support, radius, patch_points=patch_points, chunk=chunk,
        halo_mask=support_mask, n_core=query_count,
    )


def drop_small_and_compact(labels: torch.Tensor, valid: torch.Tensor, min_count):
    """Labels with <= min_count valid members become -1; survivors are
    renumbered 0..K-1 in order. Returns (labels (n,), n_labels ())."""
    n = labels.shape[0]
    has = valid & (labels >= 0)
    lab0 = torch.where(has, labels, 0).long()
    counts = torch.zeros((n,), dtype=torch.int32, device=labels.device)
    counts.index_add_(0, lab0, has.to(torch.int32))
    ok = has & (counts[lab0] > min_count)
    used = torch.zeros((n,), dtype=torch.int32, device=labels.device).scatter_reduce(
        0, lab0, ok.to(torch.int32), reduce="amax"
    )
    remap = torch.cumsum(used, 0) - 1
    new = torch.where(ok, remap[lab0], -1)
    return new.to(torch.int32), used.sum()
