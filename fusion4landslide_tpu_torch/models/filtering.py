"""Learned correspondence outlier filter (F2S3's FilteringNetwork).

Port of ``fusion4landslide_tpu.models.filtering`` (reference
src/models/outlier_classifier.py:10-63): a 6 -> 128 projection, residual
``PointCN`` blocks of Linear + InstanceNorm + stat-free BatchNorm + ReLU
(twice), and a 128 -> 1 output squashed by relu(tanh(.)). Normalisations
reduce over the *valid* rows of each (..., n, 6) batch only, so padded
supervoxel buckets run as one batch. Submodule names (``l1``,
``block{i}.conv0``, ``block{i}.conv1``, ``output``) follow the Flax tree,
so ``models.convert.state_dict_from_flax`` maps it unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["FilteringNetwork", "PointCN"]

_EPS = 1e-3
#: Channel width of the projection and of every block.
_CHANNELS = 128


def _masked_norm(x: torch.Tensor, mask: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise per channel over valid rows: (x - mean) / sqrt(var + eps)."""
    w = mask.to(x.dtype)[..., None]
    cnt = torch.clamp(w.sum(-2, keepdim=True), min=1.0)
    mean = (x * w).sum(-2, keepdim=True) / cnt
    var = (((x - mean) ** 2) * w).sum(-2, keepdim=True) / cnt
    return (x - mean) * torch.rsqrt(var + eps)


class PointCN(nn.Module):
    """Residual context-normalisation block (outlier_classifier.py:10-29).
    Each Linear is followed by the norm twice: InstanceNorm2d and
    BatchNorm2d without running statistics, both eps 1e-3, both over the
    point axis (the reference's batch size is always 1)."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Linear(_CHANNELS, _CHANNELS)
        self.conv1 = nn.Linear(_CHANNELS, _CHANNELS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in (self.conv0, self.conv1):
            h = _masked_norm(_masked_norm(conv(h), mask, _EPS), mask, _EPS)
            h = torch.relu(h)
        return h + x


class FilteringNetwork(nn.Module):
    """Per-correspondence inlier weights in [0, 1)
    (outlier_classifier.py:32-63); masked rows get 0."""

    def __init__(self, num_layers: int = 12):
        super().__init__()
        self.num_layers = num_layers
        self.l1 = nn.Linear(6, _CHANNELS)
        for i in range(num_layers):
            self.add_module(f"block{i}", PointCN())
        self.output = nn.Linear(_CHANNELS, 1)

    def forward(self, corr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # corr: (..., n, 6) scaled correspondences; mask: (..., n).
        x = self.l1(corr)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, mask)
        w = torch.relu(torch.tanh(self.output(x)[..., 0]))
        return torch.where(mask.to(torch.bool), w, 0.0)
