"""The F2S3 correspondence filter (Gojcic et al. 2021) on one supervoxel's
correspondences, in float64: coordinates scaled by their largest
absolute value; a 6->128 projection; residual blocks of two (Linear,
context norm, batch norm without statistics, ReLU), both norms over the
supervoxel's rows with eps 1e-3; a 128->1 output through relu(tanh)."""

from __future__ import annotations

import torch

from reference.precision import round_tf32


def _norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(0, keepdim=True)
    var = ((x - mean) ** 2).mean(0, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-3)


def _dense(raw, name, x, tf32):
    w, b = raw[f"{name}.weight"], raw[f"{name}.bias"]
    if tf32:  # the control: TF32 operands, float32 accumulation
        return (round_tf32(x) @ round_tf32(w).T).to(x.dtype) + b.to(x.dtype)
    return torch.matmul(x, w.to(x.dtype).T) + b.to(x.dtype)


def scores(raw: dict, corr: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """(n,) inlier scores of one supervoxel's (n, 6) correspondences."""
    c = corr.to(torch.float32 if tf32 else torch.float64)
    x = _dense(raw, "l1", c / c.abs().max().clamp(min=1e-12), tf32)
    blocks = len({k.split(".")[0] for k in raw if k.startswith("block")})
    for b in range(blocks):
        h = x
        for conv in (0, 1):
            h = torch.relu(_norm(_norm(_dense(raw, f"block{b}.conv{conv}", h, tf32))))
        x = h + x
    return torch.relu(torch.tanh(_dense(raw, "output", x, tf32)[:, 0])).to(torch.float64)
