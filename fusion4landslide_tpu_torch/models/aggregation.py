"""Superpoint feature aggregation with masked self-attention.

Port of ``fusion4landslide_tpu.models.aggregation.ClusterFeatureNet``
(reference cluster_feature_net_self_attention.py:5-103): per superpoint, a
single-head self-attention over the member DIPs features, a mean over the
valid members, then a 2-layer MLP -> one 64-d superpoint feature;
``gather_superpoint_buckets`` and ``aggregate_superpoints`` (chunked over
superpoints, with a strided member subsample) feed it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["ClusterFeatureNet", "aggregate_superpoints", "gather_superpoint_buckets"]


class ClusterFeatureNet(nn.Module):
    """Masked self-attention + mean + MLP over (S, P, D) member buckets."""

    def __init__(self, in_dim: int = 64, hidden_dim: int = 64, output_dim: int = 64):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.query = nn.Linear(in_dim, hidden_dim)
        self.key = nn.Linear(in_dim, hidden_dim)
        self.value = nn.Linear(in_dim, hidden_dim)
        self.fc = nn.Linear(hidden_dim, output_dim)
        self.mlp0 = nn.Linear(output_dim, hidden_dim)
        self.mlp1 = nn.Linear(hidden_dim, output_dim)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(feats), self.key(feats), self.value(feats)
        scores = torch.einsum("spd,sqd->spq", q, k) / math.sqrt(self.hidden_dim)
        scores = torch.where(mask[:, None, :], scores, -torch.inf)
        attn = torch.softmax(scores, dim=-1)
        attn = torch.where(mask[:, :, None], attn, 0.0)
        attended = self.fc(torch.einsum("spq,sqd->spd", attn, v))
        w = mask.to(feats.dtype)[..., None]
        pooled = (attended * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        return self.mlp1(torch.relu(self.mlp0(pooled)))


def _centroids(coords, member_idx, member_mask) -> torch.Tensor:
    """(S, 3) mean of each bucket's valid member coordinates (0 when
    empty)."""
    w = member_mask.to(coords.dtype)[..., None]
    return (coords[member_idx.long()] * w).sum(1) / torch.clamp(w.sum(1), min=1.0)


def gather_superpoint_buckets(point_feats, point_coords, member_idx, member_mask):
    """Per-point features and coordinates gathered into (S, P, .) buckets
    by the padded member table ``member_idx`` (S, P) with ``member_mask``:
    (feats (S, P, D) zero at padding, coords (S, P, 3), centroids (S, 3))."""
    idx = member_idx.long()
    feats = point_feats[idx] * member_mask.to(point_feats.dtype)[..., None]
    return feats, point_coords[idx], _centroids(point_coords, member_idx, member_mask)


def aggregate_superpoints(agg: ClusterFeatureNet, feat_arr, coords, member_idx, member_mask, *,
                          agg_max_points: int, s_chunk: int = 128):
    """Superpoint features (S, 64) and centroids (S, 3): ClusterFeatureNet
    over the member buckets, chunked over S, with a strided member
    subsample of at most ``agg_max_points`` bounding the quadratic
    attention (at P <= ``agg_max_points`` the JAX function's result).
    Chunks with no live member are skipped (their features are never
    read)."""
    S, P = member_idx.shape
    if P > agg_max_points:
        stride = -(-P // agg_max_points)
        mi = member_idx[:, ::stride][:, :agg_max_points]
        mm = member_mask[:, ::stride][:, :agg_max_points]
    else:
        mi, mm = member_idx, member_mask
    spt_feat = torch.zeros((S, 64), dtype=torch.float32, device=feat_arr.device)
    live = mm.view(-1, mm.shape[1]).any(-1)
    for s0 in range(0, S, s_chunk):
        if not bool(live[s0:s0 + s_chunk].any()):
            continue
        mic, mmc = mi[s0:s0 + s_chunk].long(), mm[s0:s0 + s_chunk]
        feats = feat_arr[mic] * mmc[..., None]
        spt_feat[s0:s0 + s_chunk] = agg(feats, mmc)
    # Centroid over the FULL member set (not the strided subsample).
    return spt_feat, _centroids(coords, member_idx, member_mask)
