"""Superpoint feature aggregation (the fusion method's learned
aggregation: ClusterFeatureNet) of one superpoint's members, in float64:
single-head self-attention over the members' 64-d descriptors (scores
q.k / 8, softmax over the valid members), a 64x64 output projection, the
mean over the valid members, then a 64->64->64 MLP with a ReLU. Members
above ``max_points`` are thinned by the documented strided rule: every
``ceil(P / max_points)``-th slot of the (S, P) member table, the first
``max_points`` of them."""

from __future__ import annotations

import math

import torch

from reference.precision import round_tf32


def thin(member_idx: torch.Tensor, member_mask: torch.Tensor, max_points: int):
    """The member slots the network sees: the strided subsample of the
    table where it is wider than ``max_points``."""
    P = member_idx.shape[1]
    if P <= max_points:
        return member_idx, member_mask
    stride = -(-P // max_points)
    return member_idx[:, ::stride][:, :max_points], member_mask[:, ::stride][:, :max_points]


def _dense(raw, name, x, tf32):
    w, b = raw[f"{name}.weight"], raw[f"{name}.bias"]
    if tf32:  # the control: TF32 operands, float32 accumulation
        return (round_tf32(x) @ round_tf32(w).T).to(x.dtype) + b.to(x.dtype)
    return torch.matmul(x, w.to(x.dtype).T) + b.to(x.dtype)


def features(raw: dict, feats: torch.Tensor, mask: torch.Tensor, *,
             tf32: bool = False) -> torch.Tensor:
    """(S, 64) superpoint features of (S, P, 64) member descriptors with
    (S, P) validity. ``tf32``: every product with TF32 operands."""
    dt = torch.float32 if tf32 else torch.float64
    x = torch.where(mask[..., None], feats.to(dt), 0.0)
    q, k, v = (_dense(raw, n, x, tf32) for n in ("query", "key", "value"))
    mul = (lambda a, b: round_tf32(a) @ round_tf32(b)) if tf32 else torch.matmul
    scores = mul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    scores = torch.where(mask[:, None, :], scores, -torch.inf)
    attn = torch.where(mask[:, :, None], torch.softmax(scores, dim=-1), 0.0)
    attended = _dense(raw, "fc", mul(attn, v), tf32)
    w = mask.to(dt)[..., None]
    pooled = (attended * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    return _dense(raw, "mlp1", torch.relu(_dense(raw, "mlp0", pooled, tf32)), tf32).double()
