"""EfficientLoFTR dense matcher (port of ``fusion4landslide_tpu.image.eloftr``).

The reference's production matcher for its fusion and rgb_guided
pipelines. The architecture, as in the JAX package:

- a RepVGG backbone whose three branches and BatchNorms are folded into
  one biased 3x3 conv per block (stage 0's map is dropped; the 1/2 and
  1/4 maps feed the fine fusion, the 1/8 map is the coarse map); both
  images run as one batch of 2;
- a coarse transformer of aggregated attention: queries reduced by a
  depthwise 4x4/stride-4 conv, keys/values by a 4x4 max-pool, one shared
  LayerNorm, softmax attention on the reduced tokens (2-D RoPE with 1-based
  positions and interleaved pairs on self attention only), a bilinear 4x
  upsample cropped to the map, concat + MLP + LayerNorm residual; cross
  attention is sequential (img1 attends the *updated* img0);
- coarse matching: dual softmax of the scaled similarity, threshold,
  border removal and an exact mutual-max test; outputs stay dense per
  coarse cell of img0 with an ``ok`` mask;
- fine fusion up to full resolution, then an 8x8 vs 10x10 window dual
  softmax argmax and a 3x3 soft-argmax on the last ``fine_matching_slice_dim``
  channels.

Attention is explicit ``torch.matmul`` + ``softmax`` in float32 (no fused
attention), so the order of operations is the JAX one; TF32 stays off
(``resolve_device``). Flax norms use eps 1e-6 and the fast variance
(``flax_bridge.flax_norm``). The maps are NCHW here, NHWC in JAX.

Weights: ``load_eloftr_weights`` reads the JAX package's flat ``.npz``
(``weights/eloftr_tiny.npz``), ``eloftr_from_flax`` a Flax tree in memory,
``load_torch_eloftr`` a ``transformers`` ``EfficientLoFTRForKeypointMatching``
state dict (RepVGG branches and BatchNorms folded at load), and
``seeded_eloftr`` builds numpy-seeded weights at trained-like scales.
"""

from __future__ import annotations

import dataclasses
import math
import os.path as osp
import re
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.flax_bridge import (
    flat_from_module,
    flat_from_tree,
    flax_norm,
    read_flat_npz,
    seeded_init,
    state_dict_from_flat,
    write_flat_npz,
)

__all__ = [
    "ELoFTRConfig",
    "EfficientLoFTR",
    "eloftr_core",
    "eloftr_from_flax",
    "eloftr_match",
    "eloftr_prepare",
    "eloftr_to_flax",
    "load_eloftr_weights",
    "load_torch_eloftr",
    "save_eloftr_weights",
    "seeded_eloftr",
]


@dataclasses.dataclass(frozen=True)
class ELoFTRConfig:
    stage_num_blocks: tuple = (1, 2, 4, 14)
    out_features: tuple = (64, 64, 128, 256)
    stage_stride: tuple = (2, 1, 2, 2)
    hidden_size: int = 256
    num_attention_layers: int = 4
    num_attention_heads: int = 8
    q_aggregation_kernel_size: int = 4
    kv_aggregation_kernel_size: int = 4
    q_aggregation_stride: int = 4
    kv_aggregation_stride: int = 4
    fine_kernel_size: int = 8
    fine_matching_slice_dim: int = 8
    coarse_matching_temperature: float = 0.1
    coarse_matching_threshold: float = 0.2
    coarse_matching_border_removal: int = 2
    fine_matching_regress_temperature: float = 10.0
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 4.0

    @property
    def fine_fusion_dims(self) -> tuple:
        return tuple(reversed(self.out_features))[:-1]


_TUPLE_KEYS = ("stage_num_blocks", "out_features", "stage_stride")


class _Norm(nn.Module):
    """Flax ``LayerNorm`` over the last axis (eps 1e-6)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_norm(x, -1, self.weight, self.bias)


class _RepVGGBlock(nn.Module):
    """A folded RepVGG block: biased 3x3 conv (padding 1), ReLU."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=True)

    def forward(self, x):
        return torch.relu(self.conv(x))


class RepVGGBackbone(nn.Module):
    def __init__(self, cfg: ELoFTRConfig):
        super().__init__()
        cin = 1
        self.names = []
        for s, (blocks, feats, stride) in enumerate(
                zip(cfg.stage_num_blocks, cfg.out_features, cfg.stage_stride)):
            stage = []
            for b in range(blocks):
                self.add_module(f"stage{s}_block{b}",
                                _RepVGGBlock(cin, feats, stride if b == 0 else 1))
                stage.append(f"stage{s}_block{b}")
                cin = feats
            self.names.append(stage)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outputs = []
        for stage in self.names:
            for name in stage:
                x = getattr(self, name)(x)
            outputs.append(x)
        return outputs[1:]  # 1/2, 1/4, 1/8 (stage 0 excluded)


def _rope_embeddings(cfg: ELoFTRConfig, h: int, w: int, device):
    """2-D RoPE (cos, sin), each (h*w, hidden_size); positions are 1-based
    row / column indices, interleaved into even / odd slots."""
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    rope_dim = int(head_dim * cfg.partial_rotary_factor)
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, rope_dim, 2, dtype=np.float32) / rope_dim))
    i_idx = np.arange(1, h + 1, dtype=np.float32)[:, None, None]
    j_idx = np.arange(1, w + 1, dtype=np.float32)[None, :, None]
    emb = np.zeros((h, w, cfg.hidden_size // 2), np.float32)
    emb[:, :, 0::2] = i_idx * inv_freq
    emb[:, :, 1::2] = j_idx * inv_freq
    sin = np.repeat(np.sin(emb), 2, axis=-1).reshape(h * w, cfg.hidden_size)
    cos = np.repeat(np.cos(emb), 2, axis=-1).reshape(h * w, cfg.hidden_size)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def _apply_rope(q, k, cos, sin):
    # q, k: (B, S, D); cos / sin: (S, D).
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


class ELoFTRAttention(nn.Module):
    def __init__(self, cfg: ELoFTRConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, nn.Linear(d, d, bias=False))

    def forward(self, x, source, rope):
        # x: (B, S, D) queries; source: (B, S, D) keys / values.
        B, S, d = x.shape
        dh = d // self.heads
        q, k, v = self.q_proj(x), self.k_proj(source), self.v_proj(source)
        if rope is not None:
            q, k = _apply_rope(q, k, *rope)
        q, k, v = (t.reshape(B, S, self.heads, dh).transpose(1, 2) for t in (q, k, v))
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        out = torch.matmul(torch.softmax(attn, dim=-1), v)
        return self.o_proj(out.transpose(1, 2).reshape(B, S, d))


class AggregatedAttention(nn.Module):
    """Aggregate 4x4 -> attention on the reduced tokens -> upsample -> MLP
    residual (EfficientLoFTRAggregatedAttention)."""

    def __init__(self, cfg: ELoFTRConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.q_aggregation = nn.Conv2d(d, d, cfg.q_aggregation_kernel_size,
                                       stride=cfg.q_aggregation_stride, groups=d, bias=False)
        self.agg_norm = _Norm(d)
        self.attention = ELoFTRAttention(cfg)
        self.fc1 = nn.Linear(2 * d, 2 * d, bias=False)
        self.fc2 = nn.Linear(2 * d, d, bias=False)
        self.mlp_norm = _Norm(d)

    def forward(self, x, source, rope):
        # x / source: (B, D, H, W).
        c = self.cfg
        B, d, H, W = x.shape
        q = self.q_aggregation(x)
        kv = F.max_pool2d(source, c.kv_aggregation_kernel_size, c.kv_aggregation_stride)
        ah, aw = q.shape[-2:]
        qn = self.agg_norm(q.flatten(2).transpose(1, 2))
        kvn = self.agg_norm(kv.flatten(2).transpose(1, 2))
        out = self.attention(qn, kvn, rope).transpose(1, 2).reshape(B, d, ah, aw)
        up = F.interpolate(out, size=(ah * c.q_aggregation_kernel_size,
                                      aw * c.q_aggregation_kernel_size),
                           mode="bilinear", align_corners=False)[:, :, :H, :W]
        inter = torch.cat([x, up], dim=1).permute(0, 2, 3, 1)
        h = self.fc2(F.leaky_relu(self.fc1(inter), 0.01))
        return x + self.mlp_norm(h).permute(0, 3, 1, 2)


class LocalFeatureTransformerLayer(nn.Module):
    def __init__(self, cfg: ELoFTRConfig):
        super().__init__()
        self.self_attention = AggregatedAttention(cfg)
        self.cross_attention = AggregatedAttention(cfg)

    def forward(self, f0, f1, rope):
        f0 = self.self_attention(f0, f0, rope)
        f1 = self.self_attention(f1, f1, rope)
        # Sequential cross attention: f1 sees the updated f0; no RoPE.
        f0 = self.cross_attention(f0, f1, None)
        f1 = self.cross_attention(f1, f0, None)
        return f0, f1


class OutConvBlock(nn.Module):
    def __init__(self, cres: int, hidden: int, inter: int):
        super().__init__()
        self.out_conv1 = nn.Conv2d(cres, inter, 1, bias=False)
        # out_conv2's BatchNorm is folded into its bias.
        self.out_conv2 = nn.Conv2d(inter, inter, 3, padding=1, bias=True)
        self.out_conv3 = nn.Conv2d(inter, hidden, 3, padding=1, bias=False)

    def forward(self, x, residual):
        r = self.out_conv1(residual) + x
        r = self.out_conv3(F.leaky_relu(self.out_conv2(r), 0.01))
        return F.interpolate(r, scale_factor=2, mode="bilinear", align_corners=False)


class FineFusion(nn.Module):
    def __init__(self, cfg: ELoFTRConfig):
        super().__init__()
        dims = cfg.fine_fusion_dims
        res_ch = list(reversed(cfg.out_features[1:-1]))  # [1/4 map, 1/2 map]
        self.out_conv = nn.Conv2d(cfg.hidden_size, dims[0], 1, bias=False)
        self.n_layers = len(dims) - 1
        for i in range(1, len(dims)):
            self.add_module(f"out_conv_layer{i - 1}",
                            OutConvBlock(res_ch[i - 1], dims[i], dims[i - 1]))

    def forward(self, coarse, residuals):
        x = F.interpolate(self.out_conv(coarse), scale_factor=2, mode="bilinear",
                          align_corners=False)
        res = list(reversed(residuals))
        for i in range(self.n_layers):
            x = getattr(self, f"out_conv_layer{i}")(x, res[i])
        return x  # full resolution, dims[-1] channels


class EfficientLoFTR(nn.Module):
    """Backbone + coarse transformer + fine fusion (the JAX package's
    ``EfficientLoFTRFlax``); ``forward`` returns the coarse maps of both
    images (2, D, hc, wc) and the full-resolution fine maps."""

    def __init__(self, cfg: ELoFTRConfig = ELoFTRConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = RepVGGBackbone(cfg)
        for i in range(cfg.num_attention_layers):
            self.add_module(f"layer{i}", LocalFeatureTransformerLayer(cfg))
        self.fine_fusion = FineFusion(cfg)

    def transform(self, coarse: torch.Tensor) -> torch.Tensor:
        """The coarse transformer on (2, D, hc, wc)."""
        c = self.cfg
        hc, wc = coarse.shape[-2:]
        agg_h = (hc - c.q_aggregation_kernel_size) // c.q_aggregation_stride + 1
        agg_w = (wc - c.q_aggregation_kernel_size) // c.q_aggregation_stride + 1
        rope = _rope_embeddings(c, agg_h, agg_w, coarse.device)
        f0, f1 = coarse[0:1], coarse[1:2]
        for i in range(c.num_attention_layers):
            f0, f1 = getattr(self, f"layer{i}")(f0, f1, rope)
        return torch.cat([f0, f1], dim=0)

    def fine(self, coarse: torch.Tensor, residuals) -> torch.Tensor:
        return self.fine_fusion(coarse / math.sqrt(self.cfg.hidden_size), residuals)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor):
        # imgs: (H, W) grey in [0, 1].
        *residuals, coarse = self.backbone(torch.stack([img0, img1])[:, None])
        coarse = self.transform(coarse)
        return coarse, self.fine(coarse, residuals)


def _unfold_windows(fmap: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    """(C, H, W) -> (L, kernel * kernel, C) sliding windows, row-major
    within the window and over the windows."""
    C = fmap.shape[0]
    win = F.unfold(fmap[None], kernel, stride=stride, padding=pad)  # (1, C k k, L)
    return win.reshape(C, kernel * kernel, -1).permute(2, 1, 0)


@torch.inference_mode()
def eloftr_core(model: EfficientLoFTR, img0: torch.Tensor, img1: torch.Tensor, mark=None):
    """(u0, v0, u1, v1, score, ok), dense per coarse cell of img0, for two
    (H, W) grey images with H and W multiples of 32. ``mark(stage)`` is
    called after the ``backbone``, ``transformer``, ``coarse_match`` and
    ``fine`` stages. The S x S coarse temporaries are freed as they are
    consumed (the softmax over columns needs whole columns)."""
    mark = mark or (lambda _: None)
    c = model.cfg
    dev = img0.device
    *residuals, coarse = model.backbone(torch.stack([img0, img1])[:, None])
    mark("backbone")
    coarse = model.transform(coarse)
    mark("transformer")
    _, d, hc, wc = coarse.shape
    S = hc * wc

    # Coarse matching: dual softmax, threshold, border removal, mutual max.
    f = coarse.flatten(2).transpose(1, 2) / math.sqrt(d)
    sim = torch.matmul(f[0], f[1].T) / c.coarse_matching_temperature
    conf = torch.softmax(sim, dim=1)
    conf0 = torch.softmax(sim, dim=0)
    del sim
    conf.mul_(conf0)
    del conf0
    mask = conf > c.coarse_matching_threshold
    b = c.coarse_matching_border_removal
    ii = torch.arange(S, device=dev)
    if b > 0:
        inner = (ii // wc >= b) & (ii // wc < hc - b) & (ii % wc >= b) & (ii % wc < wc - b)
        mask &= inner[:, None]
        mask &= inner[None, :]
    mask &= conf == conf.amax(dim=1, keepdim=True)
    mask &= conf == conf.amax(dim=0, keepdim=True)
    conf.mul_(mask)
    del mask
    match_j = torch.argmax(conf, dim=1)
    score0 = conf.gather(1, match_j[:, None])[:, 0]
    del conf
    ok = score0 > 0
    mark("coarse_match")

    # Fine windows: img0 8x8 aligned windows, img1 10x10 (+1 halo).
    fine = model.fine(coarse, residuals)
    k = c.fine_kernel_size
    win0 = _unfold_windows(fine[0], k, k, 0)  # (S, k*k, C)
    win1 = _unfold_windows(fine[1], k + 2, k, 1)[match_j]  # (S, (k+2)^2, C)
    del fine
    slice_dim = c.fine_matching_slice_dim
    c_first = win0.shape[-1] - slice_dim
    a0 = win0[..., :c_first] / math.sqrt(c_first)
    a1 = win1[..., :c_first] / math.sqrt(c_first)
    fc = torch.bmm(a0, a1.transpose(1, 2))
    fc = torch.softmax(fc, dim=1) * torch.softmax(fc, dim=2)
    fc = fc.reshape(S, k * k, k + 2, k + 2)[..., 1:-1, 1:-1].reshape(S, k ** 4)
    best = torch.argmax(fc, dim=-1)
    idx0, idx1 = best // (k * k), best % (k * k)

    # Window-relative offsets (centre-of-window convention): grid - k/2 + .5.
    p = torch.arange(k * k, device=dev)
    off = torch.stack([p % k, p // k], dim=-1).float() - (k // 2) + 0.5  # (k*k, [x, y])
    scale = img0.shape[0] / hc
    kp0 = torch.stack([ii % wc, ii // wc], dim=-1).float()
    kp1 = torch.stack([match_j % wc, match_j // wc], dim=-1).float()
    u0v0 = kp0 * scale + off[idx0]
    u1v1 = kp1 * scale + off[idx1]

    # Second stage: 3x3 spatial expectation on the last slice_dim channels.
    b0 = win0[ii, idx0, c_first:]  # (S, slice_dim): only the chosen row
    b1 = win1[..., c_first:] / math.sqrt(slice_dim)
    sc = torch.bmm(b1, b0[:, :, None])[..., 0].reshape(S, k + 2, k + 2)
    ci, cj = idx1 // k + 1, idx1 % k + 1
    dy, dx = torch.meshgrid(torch.arange(-1, 2, device=dev), torch.arange(-1, 2, device=dev),
                            indexing="ij")
    local = sc[ii[:, None, None], ci[:, None, None] + dy, cj[:, None, None] + dx]
    prob = torch.softmax((local / c.fine_matching_regress_temperature).reshape(S, 9),
                         dim=-1).reshape(S, 3, 3)
    g = torch.linspace(-1.0, 1.0, 3, device=dev)
    ex = (prob * g[None, None, :]).sum(dim=(1, 2))
    ey = (prob * g[None, :, None]).sum(dim=(1, 2))
    u1v1 = u1v1 + torch.stack([ex, ey], dim=-1) * (3 // 2)
    mark("fine")
    return u0v0[:, 0], u0v0[:, 1], u1v1[:, 0], u1v1[:, 1], score0, ok


def eloftr_prepare(img0, img1, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two (H, W) float32 images ``eloftr_core`` takes, on ``device``:
    an RGB crop is read by its channel 0, both images are divided by 255
    when img0's maximum exceeds 1.5, and each side is zero-padded up to a
    multiple of 32 (the JAX package's conventions)."""
    g0 = np.asarray(img0, np.float32)
    g1 = np.asarray(img1, np.float32)
    if g0.ndim == 3:
        g0, g1 = g0[..., 0], g1[..., 0]
    if g0.max() > 1.5:
        g0, g1 = g0 / 255.0, g1 / 255.0
    H = -(-g0.shape[0] // 32) * 32
    W = -(-g0.shape[1] // 32) * 32
    out = []
    for g in (g0, g1):
        t = torch.zeros((H, W), dtype=torch.float32, device=device)
        t[:g.shape[0], :g.shape[1]] = torch.from_numpy(np.ascontiguousarray(g)).to(device)
        out.append(t)
    return out[0], out[1]


def eloftr_match(model: EfficientLoFTR, img0, img1, *, mark=None) -> tuple[np.ndarray, np.ndarray]:
    """((M, 4) float32 [u0 v0 u1 v1] pixel matches, (M,) confidences) on
    the model's device (inputs as ``eloftr_prepare`` takes them)."""
    t0, t1 = eloftr_prepare(img0, img1, next(model.parameters()).device)
    u0, v0, u1, v1, conf, ok = eloftr_core(model, t0, t1, mark)
    out = torch.stack([u0, v0, u1, v1], dim=1)[ok]
    return out.cpu().numpy(), conf[ok].cpu().numpy()


# --------------------------------------------------------------------------
# Parameters.
# --------------------------------------------------------------------------


def _is_norm(key: str) -> bool:
    return key.split(".")[-2] in ("agg_norm", "mlp_norm")


def eloftr_from_flax(params: Mapping, cfg: ELoFTRConfig, device=None) -> EfficientLoFTR:
    """The port's module, in eval mode on ``device`` (default ``cuda``),
    with the parameters of a Flax tree (nested or flat, numpy or jax
    leaves; a ``params`` level is accepted)."""
    model = EfficientLoFTR(cfg)
    model.load_state_dict(state_dict_from_flat(flat_from_tree(params)))
    return model.eval().to(resolve_device(device))


def eloftr_to_flax(model: EfficientLoFTR) -> dict[str, np.ndarray]:
    """The flat Flax tree (``params/...`` paths) of the port's module."""
    return flat_from_module(model, _is_norm)


def load_eloftr_weights(path: str, device=None) -> EfficientLoFTR:
    """The module of a flat ``.npz`` checkpoint in the JAX package's format
    (``save_eloftr_weights``; ``weights/eloftr_tiny.npz``)."""
    flat, cfg = read_flat_npz(path, _TUPLE_KEYS)
    return eloftr_from_flax(flat, ELoFTRConfig(**cfg), device)


def save_eloftr_weights(path: str, model: EfficientLoFTR) -> None:
    """Write the module as the JAX package's ``.npz`` checkpoint."""
    write_flat_npz(path, eloftr_to_flax(model), model.cfg)


def seeded_eloftr(cfg: ELoFTRConfig = ELoFTRConfig(), seed: int = 0, device=None) -> EfficientLoFTR:
    """The module with numpy-seeded weights at trained-like scales (as
    ``tests/test_eloftr.py`` re-initialises its torch oracle): Kaiming-normal
    conv and dense kernels, N(0, 0.05) biases, norm scales N(1, 0.1) and
    biases N(0, 0.05). Default-initialised E-LoFTR collapses its activations
    to ~1e-14."""
    return seeded_init(EfficientLoFTR(cfg), seed, _is_norm).eval().to(resolve_device(device))


def _fold_bn(w, bn_w, bn_b, bn_mean, bn_var, eps=1e-5):
    """Fold an eval-mode BatchNorm into the preceding conv (OIHW)."""
    scale = bn_w / np.sqrt(bn_var + eps)
    return w * scale[:, None, None, None], bn_b - bn_mean * scale


def _np(sd, key):
    v = sd[key]
    return (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)).astype(np.float32)


def _fuse_repvgg_block(sd, prefix, in_ch, out_ch, stride, eps=1e-5):
    """conv3x3 + BN, conv1x1 + BN and the identity BN folded into one biased
    3x3 conv (exact for inference): (OIHW kernel, bias)."""
    bn = ("weight", "bias", "running_mean", "running_var")
    w3, b3 = _fold_bn(_np(sd, f"{prefix}.conv1.conv.weight"),
                      *(_np(sd, f"{prefix}.conv1.norm.{k}") for k in bn), eps)
    w1, b1 = _fold_bn(_np(sd, f"{prefix}.conv2.conv.weight"),
                      *(_np(sd, f"{prefix}.conv2.norm.{k}") for k in bn), eps)
    w = w3.copy()
    w[:, :, 1:2, 1:2] += w1
    b = b3 + b1
    if in_ch == out_ch and stride == 1 and f"{prefix}.identity.weight" in sd:
        gid, bid, mid, vid = (_np(sd, f"{prefix}.identity.{k}") for k in bn)
        scale = gid / np.sqrt(vid + eps)
        for ch in range(out_ch):
            w[ch, ch, 1, 1] += scale[ch]
        b = b + bid - mid * scale
    return w, b


def _read_checkpoint(path: str) -> dict:
    """The state dict at ``path``: a ``.safetensors`` file (through the
    ``safetensors`` package), a ``.pt`` / ``.bin`` file (``torch.load``), or
    a directory holding one."""
    if osp.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin", "pytorch_model.pt"):
            if osp.exists(osp.join(path, name)):
                path = osp.join(path, name)
                break
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    from fusion4landslide_tpu_torch.models.convert import load_torch_checkpoint

    return load_torch_checkpoint(path)


def load_torch_eloftr(state_dict_or_path, cfg: ELoFTRConfig | None = None,
                      device=None) -> EfficientLoFTR:
    """The module of a ``transformers`` ``EfficientLoFTRForKeypointMatching``
    checkpoint (the published conversion of the upstream
    ``eloftr_outdoor.ckpt``): a state dict, a ``.pt`` / ``.bin`` /
    ``.safetensors`` path, or a directory holding one. The architecture is
    read from the state dict over ``cfg``'s other settings; RepVGG branches
    and BatchNorms are folded at load."""
    sd = state_dict_or_path
    if isinstance(sd, (str, bytes)):
        sd = _read_checkpoint(str(sd))
    sd = {k.removeprefix("matcher."): v for k, v in sd.items()}
    stage_blocks: dict[int, int] = {}
    stage_out: dict[int, int] = {}
    for k in sd:
        m = re.match(r"efficientloftr\.backbone\.stages\.(\d+)\.blocks\.(\d+)"
                     r"\.conv1\.conv\.weight", k)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            stage_blocks[s] = max(stage_blocks.get(s, 0), b + 1)
            if b == 0:
                stage_out[s] = int(sd[k].shape[0])
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := re.match(
        r"efficientloftr\.local_feature_transformer\.layers\.(\d+)\.", k)))
    n_stages = len(stage_blocks)
    base = cfg or ELoFTRConfig()
    cfg = dataclasses.replace(
        base,
        stage_num_blocks=tuple(stage_blocks[s] for s in range(n_stages)),
        out_features=tuple(stage_out[s] for s in range(n_stages)),
        stage_stride=tuple(base.stage_stride[:n_stages]),
        hidden_size=stage_out[n_stages - 1],
        num_attention_layers=n_layers,
    )
    out: dict[str, torch.Tensor] = {}
    t = torch.from_numpy
    in_ch = 1
    for s in range(n_stages):
        for b in range(cfg.stage_num_blocks[s]):
            w, bias = _fuse_repvgg_block(sd, f"efficientloftr.backbone.stages.{s}.blocks.{b}",
                                         in_ch, cfg.out_features[s],
                                         cfg.stage_stride[s] if b == 0 else 1)
            out[f"backbone.stage{s}_block{b}.conv.weight"] = t(w)
            out[f"backbone.stage{s}_block{b}.conv.bias"] = t(bias)
            in_ch = cfg.out_features[s]
    for i in range(cfg.num_attention_layers):
        for kind in ("self_attention", "cross_attention"):
            src = f"efficientloftr.local_feature_transformer.layers.{i}.{kind}"
            dst = f"layer{i}.{kind}"
            pairs = [("q_aggregation.weight", "aggregation.q_aggregation.weight"),
                     ("agg_norm.weight", "aggregation.norm.weight"),
                     ("agg_norm.bias", "aggregation.norm.bias"),
                     ("fc1.weight", "mlp.fc1.weight"), ("fc2.weight", "mlp.fc2.weight"),
                     ("mlp_norm.weight", "mlp.layer_norm.weight"),
                     ("mlp_norm.bias", "mlp.layer_norm.bias")]
            pairs += [(f"attention.{n}.weight", f"attention.{n}.weight")
                      for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
            for a, r in pairs:
                out[f"{dst}.{a}"] = t(_np(sd, f"{src}.{r}"))
    out["fine_fusion.out_conv.weight"] = t(_np(sd, "refinement_layer.out_conv.weight"))
    for i in range(len(cfg.fine_fusion_dims) - 1):
        p = f"refinement_layer.out_conv_layers.{i}"
        w2, b2 = _fold_bn(_np(sd, f"{p}.out_conv2.weight"),
                          *(_np(sd, f"{p}.batch_norm.{k}")
                            for k in ("weight", "bias", "running_mean", "running_var")))
        out[f"fine_fusion.out_conv_layer{i}.out_conv1.weight"] = t(_np(sd, f"{p}.out_conv1.weight"))
        out[f"fine_fusion.out_conv_layer{i}.out_conv2.weight"] = t(w2)
        out[f"fine_fusion.out_conv_layer{i}.out_conv2.bias"] = t(b2)
        out[f"fine_fusion.out_conv_layer{i}.out_conv3.weight"] = t(_np(sd, f"{p}.out_conv3.weight"))
    model = EfficientLoFTR(cfg)
    model.load_state_dict(out)
    return model.eval().to(resolve_device(device))
