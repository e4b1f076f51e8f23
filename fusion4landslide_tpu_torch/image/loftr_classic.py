"""Classic LoFTR (Sun et al., CVPR 2021), port of
``fusion4landslide_tpu.image.loftr_classic``.

The upstream zju3dv/LoFTR architecture, as in the JAX package:

- ResNetFPN_8_2: 7x7 stem, three stages of two BasicBlocks (128/196/256),
  a top-down FPN with align-corners bilinear 2x upsampling; 1/8 coarse
  (256) and 1/2 fine (128) maps. BatchNorms are folded into the convs;
- the sine position encoding, with the upstream ``temp_bug_fix=False``
  frequency layout the published checkpoints were trained with;
- a LocalFeatureTransformer of interleaved self/cross encoder layers, each
  shared by both images, cross sequential (img1 attends the updated img0):
  bias-free q/k/v/merge, elu+1 linear attention, LayerNorm, concat MLP;
- dual-softmax coarse matching at temperature 0.1, mutual max, threshold
  and border removal;
- FinePreprocess (5x5 windows conditioned on the coarse tokens), a one-pair
  fine transformer and the spatial expectation.

The maps are NCHW here, NHWC in JAX; norms are Flax's (eps 1e-6, fast
variance, ``flax_bridge.flax_norm``). The fine stage runs on the kept
coarse cells only (each cell's window is independent).

Weights: ``classic_from_upstream`` reads the upstream state dict
(``indoor_ds.ckpt`` / ``outdoor_ds.ckpt`` layout, BatchNorms folded as the
JAX ``convert_classic_loftr`` folds them, every tensor consumed),
``classic_from_flax`` the JAX package's params, and ``seeded_classic``
builds numpy-seeded weights at trained-like scales.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Sequence

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

__all__ = [
    "ClassicLoFTR",
    "ClassicLoFTRConfig",
    "classic_from_flax",
    "classic_from_upstream",
    "classic_loftr_core",
    "classic_loftr_match",
    "classic_prepare",
    "classic_to_upstream",
    "is_classic_loftr_state_dict",
    "seeded_classic",
]


@dataclasses.dataclass(frozen=True)
class ClassicLoFTRConfig:
    """Upstream LoFTR hyper-parameters (configs/loftr/loftr_ds.py)."""

    initial_dim: int = 128
    block_dims: Sequence[int] = (128, 196, 256)
    d_coarse: int = 256
    d_fine: int = 128
    nhead: int = 8
    coarse_layers: int = 4  # self/cross pairs
    fine_layers: int = 1
    window: int = 5
    temperature: float = 0.1
    match_threshold: float = 0.2
    border_rm: int = 2
    temp_bug_fix: bool = False


class _FoldedConv(nn.Module):
    """A biased conv (a BatchNorm folded in), 'same' symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=True)

    def forward(self, x):
        return self.conv(x)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _FoldedConv(cin, cout, 3, stride)
        self.conv2 = _FoldedConv(cout, cout, 3)
        self.down = (_FoldedConv(cin, cout, 1, stride) if stride != 1 or cin != cout
                     else None)

    def forward(self, x):
        y = self.conv2(torch.relu(self.conv1(x)))
        if self.down is not None:
            x = self.down(x)
        return torch.relu(x + y)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x with align_corners (the JAX package's formula)."""
    h, w = x.shape[-2:]
    dev = x.device
    ys = torch.linspace(0.0, h - 1.0, 2 * h, device=dev)
    xs = torch.linspace(0.0, w - 1.0, 2 * w, device=dev)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]

    def g(yi, xi):
        return x[..., yi, :][..., xi]

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


class ResNetFPN82(nn.Module):
    """1/8 coarse (d3) and 1/2 fine (d1) maps of a (B, 1, H, W) image."""

    def __init__(self, cfg: ClassicLoFTRConfig):
        super().__init__()
        d1, d2, d3 = cfg.block_dims
        self.stem = _FoldedConv(1, cfg.initial_dim, 7, 2)
        self.layer1_0 = _BasicBlock(cfg.initial_dim, d1)
        self.layer1_1 = _BasicBlock(d1, d1)
        self.layer2_0 = _BasicBlock(d1, d2, 2)
        self.layer2_1 = _BasicBlock(d2, d2)
        self.layer3_0 = _BasicBlock(d2, d3, 2)
        self.layer3_1 = _BasicBlock(d3, d3)
        self.layer3_outconv = _FoldedConv(d3, d3, 1)
        self.layer2_outconv = _FoldedConv(d2, d3, 1)
        self.layer2_outconv2_0 = _FoldedConv(d3, d3, 3)
        self.layer2_outconv2_1 = _FoldedConv(d3, d2, 3)
        self.layer1_outconv = _FoldedConv(d1, d2, 1)
        self.layer1_outconv2_0 = _FoldedConv(d2, d2, 3)
        self.layer1_outconv2_1 = _FoldedConv(d2, d1, 3)

    def forward(self, x):
        x0 = torch.relu(self.stem(x))
        x1 = self.layer1_1(self.layer1_0(x0))
        x2 = self.layer2_1(self.layer2_0(x1))
        x3 = self.layer3_1(self.layer3_0(x2))
        x3_out = self.layer3_outconv(x3)
        h = self.layer2_outconv(x2) + _upsample2x(x3_out)
        h = self.layer2_outconv2_1(F.leaky_relu(self.layer2_outconv2_0(h), 0.01))
        g = self.layer1_outconv(x1) + _upsample2x(h)
        g = self.layer1_outconv2_1(F.leaky_relu(self.layer1_outconv2_0(g), 0.01))
        return x3_out, g


class _Norm(nn.Module):
    """Flax ``LayerNorm`` over the last axis (eps 1e-6)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return flax_norm(x, -1, self.weight, self.bias)


class EncoderLayer(nn.Module):
    """Upstream LoFTREncoderLayer: elu+1 linear attention, merge,
    LayerNorm, concat MLP, LayerNorm, residual."""

    def __init__(self, dim: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.merge = nn.Linear(dim, dim, bias=False)
        self.mlp0 = nn.Linear(2 * dim, 2 * dim, bias=False)
        self.mlp1 = nn.Linear(2 * dim, dim, bias=False)
        self.norm1 = _Norm(dim)
        self.norm2 = _Norm(dim)

    def forward(self, x, source):
        b, n, d = x.shape
        h = self.nhead
        q = F.elu(self.q_proj(x).view(b, n, h, d // h)) + 1.0
        k = F.elu(self.k_proj(source).view(b, -1, h, d // h)) + 1.0
        v = self.v_proj(source).view(b, -1, h, d // h)
        kv = torch.einsum("bshd,bshv->bhdv", k, v)
        z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(1)) + 1e-6)
        msg = torch.einsum("blhd,bhdv,blh->blhv", q, kv, z).reshape(b, n, d)
        msg = self.norm1(self.merge(msg))
        hcat = self.mlp1(torch.relu(self.mlp0(torch.cat([x, msg], dim=-1))))
        return x + self.norm2(hcat)


class LocalFeatureTransformer(nn.Module):
    def __init__(self, dim: int, nhead: int, pairs: int):
        super().__init__()
        self.pairs = pairs
        for i in range(pairs):
            setattr(self, f"self_{i}", EncoderLayer(dim, nhead))
            setattr(self, f"cross_{i}", EncoderLayer(dim, nhead))

    def forward(self, f0, f1):
        for i in range(self.pairs):
            self_l, cross_l = getattr(self, f"self_{i}"), getattr(self, f"cross_{i}")
            f0 = self_l(f0, f0)
            f1 = self_l(f1, f1)
            f0 = cross_l(f0, f1)
            f1 = cross_l(f1, f0)
        return f0, f1


def _pos_encoding_sine(h: int, w: int, d_model: int, temp_bug_fix: bool) -> np.ndarray:
    """(h, w, d_model) upstream PositionEncodingSine (numpy float32, as
    the JAX package builds it)."""
    d4 = d_model // 4
    idx = np.arange(0, d_model // 2, 2, dtype=np.float32)
    if temp_bug_fix:
        div = np.exp(idx * (-np.log(10000.0) / (d_model // 2)))
    else:  # the legacy layout of the published checkpoints
        div = np.exp(idx * (-np.log(10000.0) / d_model // 2))
    y = np.arange(1, h + 1, dtype=np.float32)[:, None, None]
    x = np.arange(1, w + 1, dtype=np.float32)[None, :, None]
    pe = np.zeros((h, w, d_model), np.float32)
    pe[:, :, 0::4] = np.broadcast_to(np.sin(x * div), (h, w, d4))
    pe[:, :, 1::4] = np.broadcast_to(np.cos(x * div), (h, w, d4))
    pe[:, :, 2::4] = np.broadcast_to(np.sin(y * div), (h, w, d4))
    pe[:, :, 3::4] = np.broadcast_to(np.cos(y * div), (h, w, d4))
    return pe


class ClassicLoFTR(nn.Module):
    def __init__(self, cfg: ClassicLoFTRConfig = ClassicLoFTRConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN82(cfg)
        self.loftr_coarse = LocalFeatureTransformer(cfg.d_coarse, cfg.nhead, cfg.coarse_layers)
        self.loftr_fine = LocalFeatureTransformer(cfg.d_fine, cfg.nhead, cfg.fine_layers)
        self.fine_down_proj = nn.Linear(cfg.d_coarse, cfg.d_fine)
        self.fine_merge_feat = nn.Linear(2 * cfg.d_fine, cfg.d_fine)

    def forward(self, img0, img1):
        """(H, W) grey images in [0, 1] -> coarse tokens (1, S, d_coarse)
        each, fine maps (d_fine, H/2, W/2) each, (hc, wc)."""
        c = self.cfg
        coarse, fine = self.backbone(torch.stack([img0, img1])[:, None])
        _, _, hc, wc = coarse.shape
        pe = torch.from_numpy(_pos_encoding_sine(hc, wc, c.d_coarse, c.temp_bug_fix))
        tok = coarse.permute(0, 2, 3, 1) + pe.to(coarse.device)
        tok = tok.reshape(2, hc * wc, c.d_coarse)
        t0, t1 = self.loftr_coarse(tok[:1], tok[1:])
        return t0, t1, fine[0], fine[1], (hc, wc)

    def fine_stage(self, win0, win1, cent0, cent1):
        """FinePreprocess and the fine transformer: (S, W*W, d_fine)
        windows conditioned on the (S, d_coarse) matched tokens."""
        s, ww, d = win0.shape
        cents = self.fine_down_proj(torch.cat([cent0, cent1], 0))
        cond = cents[:, None, :].expand(2 * s, ww, d)
        wins = self.fine_merge_feat(torch.cat([torch.cat([win0, win1], 0), cond], dim=-1))
        return self.loftr_fine(wins[:s], wins[s:])


def _unfold_fine(fmap: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """(C, H, W) -> (L, window^2, C) zero-padded windows centred on every
    ``stride``-th fine pixel (torch ``F.unfold`` with pad window // 2)."""
    C = fmap.shape[0]
    win = F.unfold(fmap[None], window, stride=stride, padding=window // 2)
    return win.reshape(C, window * window, -1).permute(2, 1, 0)


@torch.inference_mode()
def classic_loftr_core(model: ClassicLoFTR, img0: torch.Tensor, img1: torch.Tensor,
                       match_threshold: float, mark=None):
    """(u0, v0, u1, v1, confidence, ok) per coarse cell of img0 for two
    (H, W) grey images with H and W multiples of 8; ``mark(stage)`` after
    ``backbone_transformer``, ``coarse_match`` and ``fine``. The S x S
    coarse temporaries are freed as they are consumed."""
    mark = mark or (lambda _: None)
    cfg = model.cfg
    dev = img0.device
    t0, t1, fine0, fine1, (hc, wc) = model(img0, img1)
    mark("backbone_transformer")
    sq = math.sqrt(cfg.d_coarse)
    t0, t1 = t0[0] / sq, t1[0] / sq
    sim = torch.matmul(t0, t1.T) / cfg.temperature
    conf = torch.softmax(sim, dim=0)
    conf1 = torch.softmax(sim, dim=1)
    del sim
    conf.mul_(conf1)
    del conf1
    best_j = torch.argmax(conf, dim=1)
    cbest = conf.gather(1, best_j[:, None])[:, 0]
    ii = torch.arange(hc * wc, device=dev)
    mutual = torch.argmax(conf, dim=0)[best_j] == ii
    del conf
    bd = cfg.border_rm

    def inb(x, y):
        return (x >= bd) & (x < wc - bd) & (y >= bd) & (y < hc - bd)

    ok = mutual & (cbest > match_threshold) & inb(ii % wc, ii // wc) & inb(best_j % wc,
                                                                        best_j // wc)
    mark("coarse_match")

    W = cfg.window
    u0 = (ii % wc).float() * 8.0
    v0 = (ii // wc).float() * 8.0
    u1 = (best_j % wc).float() * 8.0
    v1 = (best_j // wc).float() * 8.0
    sel = torch.nonzero(ok)[:, 0]
    if sel.numel():
        js = best_j[sel]
        win0 = _unfold_fine(fine0, W, 4)[sel]
        win1 = _unfold_fine(fine1, W, 4)[js]
        w0, w1 = model.fine_stage(win0, win1, t0[sel] * sq, (t1 * sq)[js])
        centre = w0[:, (W * W) // 2, :]
        simf = torch.einsum("sc,src->sr", centre, w1) / math.sqrt(cfg.d_fine)
        heat = torch.softmax(simf, dim=-1).reshape(-1, W, W)
        lin = torch.linspace(-1.0, 1.0, W, device=dev)
        gy, gx = torch.meshgrid(lin, lin, indexing="ij")
        ex = (heat * gx[None]).sum(dim=(1, 2))
        ey = (heat * gy[None]).sum(dim=(1, 2))
        u1 = u1.index_add(0, sel, ex * (W // 2) * 2.0)
        v1 = v1.index_add(0, sel, ey * (W // 2) * 2.0)
    mark("fine")
    return u0, v0, u1, v1, cbest, ok


def classic_prepare(img0, img1, device, always_scale: bool = False):
    """The two (H, W) float32 images ``classic_loftr_core`` takes, on
    ``device``: grey (0.299, 0.587, 0.114) of an RGB input, divided by 255
    when img0's maximum exceeds 1.5 (``always_scale``: always, as the
    compact matcher does), zero-padded to multiples of 8."""
    g0 = np.asarray(img0, np.float32)
    g1 = np.asarray(img1, np.float32)
    if g0.ndim == 3:
        gray = np.asarray([0.299, 0.587, 0.114], np.float32)
        g0, g1 = g0 @ gray, g1 @ gray
    if always_scale or g0.max() > 1.5:
        g0, g1 = g0 / 255.0, g1 / 255.0
    H = -(-g0.shape[0] // 8) * 8
    W = -(-g0.shape[1] // 8) * 8
    out = []
    for g in (g0, g1):
        t = torch.zeros((H, W), dtype=torch.float32, device=device)
        t[:g.shape[0], :g.shape[1]] = torch.from_numpy(np.ascontiguousarray(g)).to(device)
        out.append(t)
    return out


def classic_loftr_match(model: ClassicLoFTR, img0, img1, *, match_threshold: float | None = None,
                        mark=None) -> tuple[np.ndarray, np.ndarray]:
    """((M, 4) float32 [u0 v0 u1 v1] matches, (M,) confidences) on the
    model's device."""
    thr = model.cfg.match_threshold if match_threshold is None else float(match_threshold)
    t0, t1 = classic_prepare(img0, img1, next(model.parameters()).device)
    u0, v0, u1, v1, conf, ok = classic_loftr_core(model, t0, t1, thr, mark)
    return torch.stack([u0, v0, u1, v1], 1)[ok].cpu().numpy(), conf[ok].cpu().numpy()


# --------------------------------------------------------------------------
# Parameters.
# --------------------------------------------------------------------------


def is_classic_loftr_state_dict(sd) -> bool:
    """The upstream zju3dv/LoFTR layout (indoor/outdoor_ds)."""
    return "backbone.conv1.weight" in sd and any(
        k.startswith("loftr_coarse.layers.0.q_proj") for k in sd)


def _bn_keys(prefix: str):
    return [f"{prefix}.{k}" for k in ("weight", "bias", "running_mean", "running_var")]


def _upstream_map(cfg: ClassicLoFTRConfig) -> list:
    """[(port key stem, upstream conv key, upstream BatchNorm prefix or
    None)] of the backbone, and [(port key, upstream key)] of the rest."""
    convs = [("backbone.stem", "backbone.conv1", "backbone.bn1")]
    for li in (1, 2, 3):
        for bi in range(2):
            p = f"backbone.layer{li}.{bi}"
            q = f"backbone.layer{li}_{bi}"
            convs += [(f"{q}.conv1", f"{p}.conv1", f"{p}.bn1"),
                      (f"{q}.conv2", f"{p}.conv2", f"{p}.bn2"),
                      (f"{q}.down", f"{p}.downsample.0", f"{p}.downsample.1")]
    convs.append(("backbone.layer3_outconv", "backbone.layer3_outconv", None))
    for li in (1, 2):
        convs += [(f"backbone.layer{li}_outconv", f"backbone.layer{li}_outconv", None),
                  (f"backbone.layer{li}_outconv2_0", f"backbone.layer{li}_outconv2.0",
                   f"backbone.layer{li}_outconv2.1"),
                  (f"backbone.layer{li}_outconv2_1", f"backbone.layer{li}_outconv2.3", None)]
    dense = []
    for name, pairs in (("loftr_coarse", cfg.coarse_layers), ("loftr_fine", cfg.fine_layers)):
        for i in range(2 * pairs):
            dst = f"{name}.{'self' if i % 2 == 0 else 'cross'}_{i // 2}"
            src = f"{name}.layers.{i}"
            dense += [(f"{dst}.{a}.weight", f"{src}.{b}.weight") for a, b in
                      (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                       ("merge", "merge"), ("mlp0", "mlp.0"), ("mlp1", "mlp.2"),
                       ("norm1", "norm1"), ("norm2", "norm2"))]
            dense += [(f"{dst}.{n}.bias", f"{src}.{n}.bias") for n in ("norm1", "norm2")]
    for a, b in (("fine_down_proj", "down_proj"), ("fine_merge_feat", "merge_feat")):
        dense += [(f"{a}.weight", f"fine_preprocess.{b}.weight"),
                  (f"{a}.bias", f"fine_preprocess.{b}.bias")]
    return convs, dense


def classic_from_upstream(sd: Mapping, cfg: ClassicLoFTRConfig | None = None,
                          device=None) -> ClassicLoFTR:
    """The module (eval, on ``device``, default ``cuda``) of an upstream
    LoFTR state dict (a leading ``matcher.`` is dropped): eval-mode
    BatchNorms folded into their convs (eps 1e-5); a missing key raises
    ``KeyError``, an unconsumed tensor ``ValueError``."""
    cfg = cfg or ClassicLoFTRConfig()
    sd = {k.removeprefix("matcher."): v for k, v in sd.items()}
    used: set = set()

    def take(key):
        used.add(key)
        v = sd[key]
        return (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                ).astype(np.float32)

    out: dict[str, torch.Tensor] = {}
    model = ClassicLoFTR(cfg)
    want = model.state_dict()
    convs, dense = _upstream_map(cfg)
    for dst, conv, bn in convs:
        if f"{dst}.conv.weight" not in want:
            continue  # a block without a downsample
        w = take(f"{conv}.weight")
        if bn is None:
            b = take(f"{conv}.bias") if f"{conv}.bias" in sd else np.zeros(w.shape[0], np.float32)
        else:
            g, beta, mean, var = (take(k) for k in _bn_keys(bn))
            scale = g / np.sqrt(var + 1e-5)
            w, b = w * scale[:, None, None, None], beta - mean * scale
            if f"{bn}.num_batches_tracked" in sd:
                used.add(f"{bn}.num_batches_tracked")
        out[f"{dst}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{dst}.conv.bias"] = torch.from_numpy(np.ascontiguousarray(b))
    for dst, src in dense:
        out[dst] = torch.from_numpy(take(src))
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint tensors ({len(unused)}): "
                         f"{sorted(unused)[:8]}...")
    model.load_state_dict(out)
    return model.eval().to(resolve_device(device))


def classic_to_upstream(model: ClassicLoFTR) -> dict[str, torch.Tensor]:
    """An upstream-layout state dict of the module, BatchNorms as identity
    (weight 1, bias 0, mean 0, var 1 - 1e-5), so ``classic_from_upstream``
    returns the same module."""
    cfg = model.cfg
    sd = model.state_dict()
    out = {}
    convs, dense = _upstream_map(cfg)
    for dst, conv, bn in convs:
        if f"{dst}.conv.weight" not in sd:
            continue
        w, b = sd[f"{dst}.conv.weight"], sd[f"{dst}.conv.bias"]
        out[f"{conv}.weight"] = w.clone()
        if bn is None:
            out[f"{conv}.bias"] = b.clone()
            continue
        g, beta, mean, var = _bn_keys(bn)
        out[g] = torch.ones_like(b)
        out[beta] = b.clone()
        out[mean] = torch.zeros_like(b)
        out[var] = torch.full_like(b, 1.0 - 1e-5)
    for dst, src in dense:
        out[src] = sd[dst].clone()
    return out


def classic_from_flax(params: Mapping, cfg: ClassicLoFTRConfig | None = None,
                      device=None) -> ClassicLoFTR:
    """The module of the JAX package's ``ClassicLoFTR`` params (a Flax
    tree, nested or flat; a ``params`` level is accepted)."""
    cfg = cfg or ClassicLoFTRConfig()
    flat = flat_from_tree(params)
    for key, val in list(flat.items()):
        if key.split("/")[-2] in ("q_proj", "k_proj", "v_proj"):
            flat[key] = val.reshape(val.shape[0], -1)  # DenseGeneral (in, heads, dh)
    model = ClassicLoFTR(cfg)
    model.load_state_dict(state_dict_from_flat(flat))
    return model.eval().to(resolve_device(device))


def seeded_classic(cfg: ClassicLoFTRConfig = ClassicLoFTRConfig(), seed: int = 0,
                   device=None) -> ClassicLoFTR:
    """The module with numpy-seeded weights at trained-like scales, as
    ``image.eloftr.seeded_eloftr`` draws them: Kaiming-normal conv and
    dense kernels, N(0, 0.05) biases, norm scales N(1, 0.1) and biases
    N(0, 0.05)."""
    return seeded_init(ClassicLoFTR(cfg), seed,
                       lambda key: key.split(".")[-2].startswith("norm")).eval().to(
        resolve_device(device))
