"""DIPs local feature descriptor (PointNet + T-net), inference only.

Port of ``fusion4landslide_tpu.models.dips`` (reference
src/models/local_feature_descriptor.py:5-113): pointwise MLP
3->256->512->1024, global max-pool, FC 1024->512->256->64, L2-normalised
64-d descriptor; a 3x3 T-net aligns the patch first. Input layout is
(B, N, 3) points-last, as in the JAX package; BatchNorm runs in eval mode.
Module and parameter names follow the Flax tree (``models.convert``).

``dtype=torch.bfloat16`` (the JAX package's ``dtype='bfloat16'``,
``feat_dtype: bfloat16``) follows Flax's rounding as the JAX package's
CPU build computes it: only the trunks' five dense layers (conv1-3,
fc1-2) compute in bf16, with input, kernel and bias cast to bf16 and the
product rounded to bf16; XLA keeps the bias add in float32 (excess
precision; rounding it too moves more descriptors away from Flax's), and
the float32 BatchNorm parameters take it from there, so the max-pool runs
on float32. Both ``fc3`` layers, the
T-net product and the L2 norm stay float32.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["EvalBatchNorm", "PointNetFeature", "STN3d", "feat_torch_dtype"]


def feat_torch_dtype(feat_dtype) -> torch.dtype | None:
    """The trunk dtype of a ``feat_dtype`` option: None or 'float32' ->
    None (float32), 'bfloat16' -> ``torch.bfloat16``."""
    if feat_dtype in (None, "float32"):
        return None
    if feat_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"feat_dtype must be float32 or bfloat16, not {feat_dtype!r}")


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
        # The operations of scale * (x - mean) * rsqrt(var + eps) + bias in
        # their order, on one temporary (multiplication commutes exactly).
        y = x - self.mean
        y.mul_(self.scale).mul_(torch.rsqrt(self.var + self.eps)).add_(self.bias)
        return y


class _MLPStack(nn.Module):
    """Shared trunk: pointwise 3->256->512->1024, max-pool, FC 1024->512->256."""

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = nn.Linear(3, 256), EvalBatchNorm(256)
        self.conv2, self.bn2 = nn.Linear(256, 512), EvalBatchNorm(512)
        self.conv3, self.bn3 = nn.Linear(512, 1024), EvalBatchNorm(1024)
        self.fc1, self.bn4 = nn.Linear(1024, 512), EvalBatchNorm(512)
        self.fc2, self.bn5 = nn.Linear(512, 256), EvalBatchNorm(256)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        def dense(layer, h):
            if dtype is None:
                return layer(h)
            y = torch.matmul(h.to(dtype), layer.weight.to(dtype).T)
            return y.float() + layer.bias.to(dtype).float()

        x = self.bn1(dense(self.conv1, x)).relu_()
        x = self.bn2(dense(self.conv2, x)).relu_()
        x = self.bn3(dense(self.conv3, x))
        x = x.amax(dim=-2)
        x = torch.relu(self.bn4(dense(self.fc1, x)))
        return torch.relu(self.bn5(dense(self.fc2, x)))


class STN3d(nn.Module):
    """Spatial transformer predicting a 3x3 alignment."""

    def __init__(self):
        super().__init__()
        self.trunk = _MLPStack()
        self.fc3 = nn.Linear(256, 9)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        m = self.fc3(self.trunk(x, dtype))
        return m.reshape(*m.shape[:-1], 3, 3) + torch.eye(3, dtype=m.dtype, device=m.device)


class PointNetFeature(nn.Module):
    """64-d L2-normalised patch descriptor of (B, N, 3) LRF patches;
    ``forward(x, dtype)`` takes the trunks' compute dtype (None: float32,
    or ``torch.bfloat16``)."""

    def __init__(self, dim: int = 64):
        super().__init__()
        self.stn3d = STN3d()
        self.trunk = _MLPStack()
        self.fc3 = nn.Linear(256, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        trans = self.stn3d(x, dtype)
        x = torch.einsum("...ij,...nj->...ni", trans, x)
        out = self.fc3(self.trunk(x, dtype)).to(torch.float32)
        return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)
