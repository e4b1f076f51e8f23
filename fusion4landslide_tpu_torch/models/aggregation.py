"""Superpoint feature aggregation with masked self-attention.

Port of ``fusion4landslide_tpu.models.aggregation.ClusterFeatureNet``
(reference cluster_feature_net_self_attention.py:5-103): per superpoint, a
single-head self-attention over the member DIPs features, a mean over the
valid members, then a 2-layer MLP -> one 64-d superpoint feature.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["ClusterFeatureNet"]


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
