"""DIPs local feature descriptor (PointNet + T-net), inference only.

Port of ``fusion4landslide_tpu.models.dips`` (reference
src/models/local_feature_descriptor.py:5-113): pointwise MLP
3->256->512->1024, global max-pool, FC 1024->512->256->64, L2-normalised
64-d descriptor; a 3x3 T-net aligns the patch first. Input layout is
(B, N, 3) points-last, as in the JAX package; BatchNorm runs in eval mode.
Module and parameter names follow the Flax tree (``models.convert``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["EvalBatchNorm", "PointNetFeature", "STN3d"]


class EvalBatchNorm(nn.Module):
    """BatchNorm1d in eval mode: y = g * (x - mean) / sqrt(var + eps) + b."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * (x - self.mean) * torch.rsqrt(self.var + self.eps) + self.bias


class _MLPStack(nn.Module):
    """Shared trunk: pointwise 3->256->512->1024, max-pool, FC 1024->512->256."""

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = nn.Linear(3, 256), EvalBatchNorm(256)
        self.conv2, self.bn2 = nn.Linear(256, 512), EvalBatchNorm(512)
        self.conv3, self.bn3 = nn.Linear(512, 1024), EvalBatchNorm(1024)
        self.fc1, self.bn4 = nn.Linear(1024, 512), EvalBatchNorm(512)
        self.fc2, self.bn5 = nn.Linear(512, 256), EvalBatchNorm(256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))
        x = x.amax(dim=-2)
        x = torch.relu(self.bn4(self.fc1(x)))
        return torch.relu(self.bn5(self.fc2(x)))


class STN3d(nn.Module):
    """Spatial transformer predicting a 3x3 alignment."""

    def __init__(self):
        super().__init__()
        self.trunk = _MLPStack()
        self.fc3 = nn.Linear(256, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.fc3(self.trunk(x))
        return m.reshape(*m.shape[:-1], 3, 3) + torch.eye(3, dtype=m.dtype, device=m.device)


class PointNetFeature(nn.Module):
    """64-d L2-normalised patch descriptor of (B, N, 3) LRF patches."""

    def __init__(self, dim: int = 64):
        super().__init__()
        self.stn3d = STN3d()
        self.trunk = _MLPStack()
        self.fc3 = nn.Linear(256, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trans = self.stn3d(x)
        x = torch.einsum("...ij,...nj->...ni", trans, x)
        out = self.fc3(self.trunk(x)).to(torch.float32)
        return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)
