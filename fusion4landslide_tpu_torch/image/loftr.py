"""The compact LoFTR-family matcher and the ``loftr`` checkpoint loader
(port of ``fusion4landslide_tpu.image.loftr``).

``LoFTRMatcher`` is the JAX package's in-environment architecture: a
LayerNorm conv backbone (1/2 fine and 1/8 coarse maps), a 2-d sinusoidal
position encoding, interleaved self/cross linear-attention blocks with
separate weights per image, dual-softmax mutual matching and a 5x5
soft-argmax refinement in the fine maps. Flax conventions are kept: norms
with eps 1e-6 and the fast variance, ``"SAME"`` padding (stride-2 convs
pad (0, 1) on even sizes), the tanh-approximated GELU.

``load_torch_loftr`` reads a LoFTR-family checkpoint and dispatches on its
layout: upstream zju3dv/LoFTR (``indoor_ds`` / ``outdoor_ds``) to
``image.loftr_classic``, ``transformers`` EfficientLoFTR to
``image.eloftr.load_torch_eloftr``; any other layout raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.flax_bridge import (
    flat_from_tree,
    flax_norm,
    seeded_init,
    state_dict_from_flat,
)

__all__ = ["LoFTRMatcher", "load_torch_loftr", "loftr_from_flax", "loftr_match",
           "seeded_loftr"]


class _Norm(nn.Module):
    """Flax ``LayerNorm`` over the last axis (eps 1e-6)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return flax_norm(x, -1, self.weight, self.bias)


class _ConvBlock(nn.Module):
    """Bias-free 3x3 conv with Flax ``"SAME"`` padding, LayerNorm over
    channels, ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, bias=False)
        self.norm = _Norm(cout)

    def forward(self, x):
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((-(-n // self.stride) - 1) * self.stride + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        x = self.conv(F.pad(x, pads))
        return torch.relu(self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))


class _Backbone(nn.Module):
    def __init__(self, dim_fine: int, dim_coarse: int):
        super().__init__()
        self.s1 = _ConvBlock(1, dim_fine, 2)
        self.s1b = _ConvBlock(dim_fine, dim_fine)
        self.s2 = _ConvBlock(dim_fine, 128, 2)
        self.s2b = _ConvBlock(128, 128)
        self.s3 = _ConvBlock(128, dim_coarse, 2)
        self.s3b = _ConvBlock(dim_coarse, dim_coarse)

    def forward(self, x):
        c1 = self.s1b(self.s1(x))
        return c1, self.s3b(self.s3(self.s2b(self.s2(c1))))


class _LinearAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.merge = nn.Linear(dim, dim)

    def forward(self, x, source):
        b, n, d = x.shape
        h = self.heads
        q = F.elu(self.q(x).view(b, n, h, d // h)) + 1.0
        k = F.elu(self.k(source).view(b, -1, h, d // h)) + 1.0
        v = self.v(source).view(b, -1, h, d // h)
        kv = torch.einsum("bmhd,bmhe->bhde", k, v)
        z = 1.0 / (torch.einsum("bnhd,bhd->bnh", q, k.sum(1)) + 1e-6)
        out = torch.einsum("bnhd,bhde,bnh->bnhe", q, kv, z).reshape(b, n, d)
        return self.merge(out)


class _Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = _Norm(dim)
        self.norm1s = _Norm(dim)
        self.attn = _LinearAttention(dim)
        self.norm2 = _Norm(dim)
        self.mlp0 = nn.Linear(dim, 2 * dim)
        self.mlp1 = nn.Linear(2 * dim, dim)

    def forward(self, x, source):
        x = x + self.attn(self.norm1(x), self.norm1s(source))
        return x + self.mlp1(F.gelu(self.mlp0(self.norm2(x)), approximate="tanh"))


class _CoarseTransformer(nn.Module):
    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            for name in ("self0", "self1", "cross0", "cross1"):
                setattr(self, f"{name}_{i}", _Block(dim))

    def forward(self, f0, f1):
        for i in range(self.layers):
            f0 = getattr(self, f"self0_{i}")(f0, f0)
            f1 = getattr(self, f"self1_{i}")(f1, f1)
            f0n = getattr(self, f"cross0_{i}")(f0, f1)
            f1 = getattr(self, f"cross1_{i}")(f1, f0)
            f0 = f0n
        return f0, f1


def _pos_encoding(h: int, w: int, dim: int, device) -> torch.Tensor:
    """(h, w, dim) 2-d sinusoidal encoding: sin/cos of x, then of y."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    d4 = dim // 4
    freqs = torch.exp(-torch.arange(d4, dtype=torch.float32, device=device)
                      * float(np.log(10000.0) / max(d4 - 1, 1)))
    enc = []
    for grid in (xs, ys):
        arg = (grid * freqs).expand(h, w, d4)
        enc += [torch.sin(arg), torch.cos(arg)]
    return torch.cat(enc, dim=-1)


class LoFTRMatcher(nn.Module):
    """The JAX package's compact coarse-to-fine matcher."""

    def __init__(self, dim_coarse: int = 256, dim_fine: int = 64, layers: int = 4):
        super().__init__()
        self.backbone = _Backbone(dim_fine, dim_coarse)
        self.transformer = _CoarseTransformer(dim_coarse, layers)

    def forward(self, img0, img1):
        """(H, W) grey images -> coarse tokens (S, d) each, fine maps
        (H/2, W/2, C) each, (hc, wc)."""
        fine, coarse = self.backbone(torch.stack([img0, img1])[:, None])
        _, d, hc, wc = coarse.shape
        tok = coarse.permute(0, 2, 3, 1) + _pos_encoding(hc, wc, d, coarse.device)
        tok = tok.reshape(2, hc * wc, d)
        t0, t1 = self.transformer(tok[:1], tok[1:])
        fine = fine.permute(0, 2, 3, 1)
        return t0[0], t1[0], fine[0], fine[1], (hc, wc)


@torch.inference_mode()
def _match_core(model: LoFTRMatcher, img0, img1, match_threshold: float):
    t0, t1, fine0, fine1, (hc, wc) = model(img0, img1)
    dev = img0.device
    sim = torch.matmul(t0, t1.T) / math.sqrt(t0.shape[-1])
    p = torch.softmax(sim, dim=1)
    p0 = torch.softmax(sim, dim=0)
    del sim
    p.mul_(p0)
    del p0
    best_j = torch.argmax(p, dim=1)
    conf = p.gather(1, best_j[:, None])[:, 0]
    ii = torch.arange(hc * wc, device=dev)
    ok = (torch.argmax(p, dim=0)[best_j] == ii) & (conf > match_threshold)
    del p

    # Fine refinement: the coarse cell's centre vector in img0's fine map
    # against a clipped 5x5 window around the match in img1's.
    win, half = 5, 2
    h, w, _ = fine1.shape
    y0, x0 = (ii // wc) * 4, (ii % wc) * 4
    y1, x1 = (best_j // wc) * 4, (best_j % wc) * 4
    d = torch.arange(-half, half + 1, device=dev)
    yy = torch.clamp(y1[:, None, None] + d[None, :, None], 0, h - 1)
    xx = torch.clamp(x1[:, None, None] + d[None, None, :], 0, w - 1)
    corr = torch.einsum("nc,nklc->nkl", fine0[y0, x0], fine1[yy, xx])
    prob = torch.softmax(corr.reshape(-1, win * win), dim=-1).reshape(-1, win, win)
    df = d.to(torch.float32)
    off_y = (prob * df[None, :, None]).sum(dim=(1, 2))
    off_x = (prob * df[None, None, :]).sum(dim=(1, 2))
    u0 = (ii % wc) * 8.0 + 4.0
    v0 = (ii // wc) * 8.0 + 4.0
    u1 = (best_j % wc) * 8.0 + 4.0 + off_x * 2.0
    v1 = (best_j // wc) * 8.0 + 4.0 + off_y * 2.0
    return u0, v0, u1, v1, conf, ok


def loftr_match(model: LoFTRMatcher, img0, img1, *,
                match_threshold: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """((M, 4) float32 [u0 v0 u1 v1], (M,) confidences): grey
    (0.299, 0.587, 0.114) images divided by 255, zero-padded to
    multiples of 8, on the model's device."""
    from fusion4landslide_tpu_torch.image.loftr_classic import classic_prepare

    t0, t1 = classic_prepare(img0, img1, next(model.parameters()).device, always_scale=True)
    u0, v0, u1, v1, conf, ok = _match_core(model, t0, t1, float(match_threshold))
    return torch.stack([u0, v0, u1, v1], 1)[ok].cpu().numpy(), conf[ok].cpu().numpy()


def _is_norm(key: str) -> bool:
    return key.split(".")[-2].startswith("norm")


def loftr_from_flax(params: Mapping, device=None, **kw) -> LoFTRMatcher:
    """The module of the JAX package's ``LoFTRMatcher`` params (a Flax
    tree, nested or flat; a ``params`` level is accepted); ``kw`` are the
    architecture's options."""
    flat = flat_from_tree(params)
    for key, val in list(flat.items()):
        parts = key.split("/")
        if parts[-2] in ("q", "k", "v"):  # DenseGeneral (in, heads, dh) / (heads, dh)
            flat[key] = val.reshape(val.shape[0], -1) if parts[-1] == "kernel" else val.ravel()
    model = LoFTRMatcher(**kw)
    model.load_state_dict(state_dict_from_flat(flat))
    return model.eval().to(resolve_device(device))


def seeded_loftr(seed: int = 0, device=None, **kw) -> LoFTRMatcher:
    """The compact module with numpy-seeded weights: Kaiming-normal conv
    and dense kernels, N(0, 0.05) biases, norm scales N(1, 0.1) and biases
    N(0, 0.05) (the port's stand-in for the JAX package's Flax init)."""
    return seeded_init(LoFTRMatcher(**kw), seed, _is_norm).eval().to(resolve_device(device))


def load_torch_loftr(state_dict_or_path, device=None) -> nn.Module:
    """The LoFTR-family module of a torch checkpoint (a path or a state
    dict; a leading ``matcher.`` is dropped), by layout: upstream
    zju3dv/LoFTR -> ``ClassicLoFTR``, ``transformers`` EfficientLoFTR ->
    ``EfficientLoFTR``; otherwise ``NotImplementedError``. A path is read
    with ``torch.load`` (``weights_only=True``)."""
    sd = state_dict_or_path
    if isinstance(sd, (str, bytes)):
        from fusion4landslide_tpu_torch.models.convert import load_torch_checkpoint

        sd = load_torch_checkpoint(str(sd))
    stripped = {k.removeprefix("matcher."): v for k, v in sd.items()}
    if any(k.startswith("efficientloftr.backbone") for k in stripped):
        from fusion4landslide_tpu_torch.image.eloftr import load_torch_eloftr

        return load_torch_eloftr(stripped, device=device)
    from fusion4landslide_tpu_torch.image.loftr_classic import (
        classic_from_upstream,
        is_classic_loftr_state_dict,
    )

    if is_classic_loftr_state_dict(stripped):
        return classic_from_upstream(stripped, device=device)
    raise NotImplementedError(
        f"checkpoint loaded ({len(sd)} tensors) but its layout is not recognised; "
        "supported: upstream zju3dv/LoFTR (indoor/outdoor_ds.ckpt) and transformers "
        "EfficientLoFTR")
