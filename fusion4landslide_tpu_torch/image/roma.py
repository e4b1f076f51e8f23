"""RoMa-family dense matcher (port of ``fusion4landslide_tpu.image.roma``).

The reference's ``img_matching_type: RoMA`` role, through its four-call
contract (match -> sample -> pixel coordinates):

1. a conv encoder pyramid at strides 1, 2, 4, 8, shared by both images;
2. a Gaussian-process coarse matcher: an exponential cosine kernel
   ``exp((sim - 1) / tau)``, tau = 0.02 + softplus(exp(log_temp)),
   regresses B's Fourier coordinate embeddings onto A's grid through
   ``torch.linalg.solve`` of the (hb wb)^2 Gram matrix;
3. a conv decoder over anchor logits (K x K) + certainty, then conv
   refiners at strides 4 and 2 on a local correlation around the warp,
   and a bilinear upsample to stride 1.

The JAX package runs every map unbatched as (h, w, c), and this port keeps
that layout (convs go through NCHW and back). Flax's defaults are kept
where they differ from torch's:

- convs pad ``"SAME"``: a stride-2 3x3 conv on an even side pads (0, 1),
  not (1, 1) (``_same_pad``);
- ``GroupNorm`` on an unbatched (h, w, c) map takes its leading axis for
  the batch, so the statistics are per row over (w, channels of the
  group); eps 1e-6 and the fast variance (``flax_bridge.flax_norm``);
- ``grid_sample`` is the explicit four-tap bilinear gather with zero
  padding, as in JAX.

``roma_sample`` draws with ``torch.multinomial`` from an explicit
generator, or takes the drawn indices as an input (the parity tests feed
it JAX's draws). ``load_roma_weights`` reads ``weights/roma_tiny.npz``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping, Sequence

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
    state_dict_from_flat,
    write_flat_npz,
)

__all__ = [
    "RoMaConfig",
    "RoMaMatcher",
    "grid_sample",
    "load_roma_weights",
    "roma_fb_error_px",
    "roma_from_flax",
    "roma_match",
    "roma_sample",
    "roma_to_flax",
    "roma_to_pixel_coordinates",
    "save_roma_weights",
]


@dataclasses.dataclass(frozen=True)
class RoMaConfig:
    enc_channels: Sequence[int] = (32, 64, 128)  # strides 2, 4, 8
    gp_dim: int = 128
    coord_freqs: int = 16
    anchors: int = 32
    decoder_channels: int = 128
    decoder_blocks: int = 3
    refine_channels: Sequence[int] = (96, 64)  # strides 4, 2
    corr_radius: int = 3
    kernel_temperature: float = 0.1
    gp_noise: float = 1e-3


_TUPLE_KEYS = ("enc_channels", "refine_channels")


def _coord_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) normalised pixel-centre coordinates in [-1, 1], (x, y)."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * 2.0 - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _fourier_embed(coords: torch.Tensor, freqs: int) -> torch.Tensor:
    """(..., 2) in [-1, 1] -> (..., 4 freqs): cos / sin of the coordinates
    at 2^f pi, per axis."""
    k = 2.0 ** torch.arange(freqs, dtype=coords.dtype, device=coords.device)
    ang = coords[..., None] * k * math.pi
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return emb.reshape(*coords.shape[:-1], 4 * freqs)


def grid_sample(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``fmap`` (h, w, c) at normalised coords (..., 2)
    in [-1, 1] (x, y), zero outside."""
    h, w, _ = fmap.shape
    x = (coords[..., 0] + 1.0) * 0.5 * w - 0.5
    y = (coords[..., 1] + 1.0) * 0.5 * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = fmap[torch.clamp(yi, 0, h - 1).long(), torch.clamp(xi, 0, w - 1).long()]
        return v * inb[..., None]

    return (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + tap(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + tap(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + tap(y0 + 1, x0 + 1) * (wx * wy)[..., None])


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """Flax / XLA ``"SAME"`` padding (low, high) of one side."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _Conv(nn.Conv2d):
    """A Flax ``nn.Conv`` (padding ``"SAME"``) on an (h, w, c) map."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=True)

    def forward(self, x):
        h, w, _ = x.shape
        k, s = self.kernel_size[0], self.stride[0]
        (ht, hb), (wl, wr) = _same_pad(h, k, s), _same_pad(w, k, s)
        y = F.pad(x.permute(2, 0, 1)[None], (wl, wr, ht, hb))
        return super().forward(y)[0].permute(1, 2, 0)


class _GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` on an unbatched (h, w, c) map: statistics per
    row h over (w, the channels of each group)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        h, w, c = x.shape
        g = self.groups
        y = flax_norm(x.reshape(h, w, g, c // g), (1, 3), self.weight.reshape(g, c // g),
                      self.bias.reshape(g, c // g))
        return y.reshape(h, w, c)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _Conv(cin, ch, 3, stride)
        self.GroupNorm_0 = _GroupNorm(ch, next(g for g in (8, 4, 2, 1) if ch % g == 0))

    def forward(self, x):
        return torch.relu(self.GroupNorm_0(self.Conv_0(x)))


def _blocks(module: nn.Module, blocks) -> None:
    """Register ``_ConvBlock_{i}`` submodules under Flax's auto names."""
    for i, block in enumerate(blocks):
        module.add_module(f"_ConvBlock_{i}", block)


class _Encoder(nn.Module):
    """Conv pyramid: features at strides 1, 2, 4, 8."""

    def __init__(self, cfg: RoMaConfig):
        super().__init__()
        self.Conv_0 = _Conv(1, 16, 3)
        chans, blocks = 16, []
        for ch in cfg.enc_channels:
            blocks += [_ConvBlock(chans, ch, 2), _ConvBlock(ch, ch)]
            chans = ch
        _blocks(self, blocks)
        self.n = len(blocks)

    def forward(self, img):  # (h, w) grey in [0, 1]
        feats = [torch.relu(self.Conv_0(img[..., None]))]
        for i in range(0, self.n, 2):
            x = getattr(self, f"_ConvBlock_{i}")(feats[-1])
            feats.append(getattr(self, f"_ConvBlock_{i + 1}")(x))
        return feats  # [s1, s2, s4, s8]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-8)


class _GPMatcher(nn.Module):
    """Exponential cosine kernel regression of B's coordinate embeddings
    onto A's grid."""

    def __init__(self, cfg: RoMaConfig, cin: int):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Linear(cin, cfg.gp_dim)
        self.proj_b = nn.Linear(cin, cfg.gp_dim)
        self.log_temp = nn.Parameter(torch.tensor(math.log(cfg.kernel_temperature),
                                                  dtype=torch.float32))

    def forward(self, fa, fb):
        cfg = self.cfg
        pa, pb = self.proj(fa), self.proj_b(fb)
        ha, wa, _ = pa.shape
        hb, wb, _ = pb.shape
        a = _unit(pa.reshape(ha * wa, cfg.gp_dim))
        b = _unit(pb.reshape(hb * wb, cfg.gp_dim))
        tau = 0.02 + F.softplus(torch.exp(self.log_temp))
        k_ab = torch.exp((torch.matmul(a, b.T) - 1.0) / tau)
        k_bb = torch.exp((torch.matmul(b, b.T) - 1.0) / tau)
        emb_b = _fourier_embed(_coord_grid(hb, wb, fa.device), cfg.coord_freqs).reshape(hb * wb, -1)
        eye = torch.eye(k_bb.shape[0], dtype=k_bb.dtype, device=k_bb.device)
        sol = torch.linalg.solve(k_bb + cfg.gp_noise * eye, emb_b)
        return torch.matmul(k_ab, sol).reshape(ha, wa, -1)


class _CoarseDecoder(nn.Module):
    """[A features, GP posterior] -> anchor logits (K^2) + certainty; the
    warp is the probability-weighted anchor coordinate."""

    def __init__(self, cfg: RoMaConfig, cin: int):
        super().__init__()
        self.cfg = cfg
        ch = cfg.decoder_channels
        _blocks(self, [_ConvBlock(cin, ch)] + [_ConvBlock(ch, ch)
                                               for _ in range(cfg.decoder_blocks - 1)])
        self.Conv_0 = _Conv(ch, cfg.anchors * cfg.anchors + 1, 1)

    def forward(self, fa, mu):
        cfg = self.cfg
        x = self._ConvBlock_0(torch.cat([fa, mu], dim=-1))
        for i in range(1, cfg.decoder_blocks):
            x = x + getattr(self, f"_ConvBlock_{i}")(x)
        logits = self.Conv_0(x)
        k = cfg.anchors
        probs = torch.softmax(logits[..., :-1], dim=-1)
        anchor_xy = _coord_grid(k, k, fa.device).reshape(k * k, 2)
        return torch.einsum("hwk,kc->hwc", probs, anchor_xy), logits[..., -1], logits[..., :-1]


class _Refiner(nn.Module):
    """Local correlation around the current warp + conv head -> warp delta
    and certainty update."""

    def __init__(self, cfg: RoMaConfig, cin: int, ch: int):
        super().__init__()
        self.r = cfg.corr_radius
        _blocks(self, [_ConvBlock(cin + (2 * self.r + 1) ** 2 + 3, ch), _ConvBlock(ch, ch)])
        self.Conv_0 = _Conv(ch, 3, 3)

    def forward(self, fa, fb, warp, certainty):
        r = self.r
        hb, wb, _ = fb.shape
        dev = fa.device
        dy, dx = torch.meshgrid(torch.arange(-r, r + 1, device=dev),
                                torch.arange(-r, r + 1, device=dev), indexing="ij")
        offs = torch.stack([dx.reshape(-1) * 2.0 / wb, dy.reshape(-1) * 2.0 / hb], dim=-1)
        fb_s = grid_sample(fb, warp[:, :, None, :] + offs[None, None])  # (h, w, T, c)
        corr = torch.einsum("hwc,hwtc->hwt", _unit(fa), _unit(fb_s))
        x = torch.cat([fa, corr, warp, certainty[..., None]], dim=-1)
        x = self._ConvBlock_0(x)
        x = x + self._ConvBlock_1(x)
        out = self.Conv_0(x)
        scale = torch.tensor([2.0 * r / wb, 2.0 * r / hb], dtype=warp.dtype, device=dev)
        return warp + torch.tanh(out[..., :2]) * scale, certainty + out[..., 2]


def _upsample_field(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of an (h', w', c) field to (h, w, c)."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                      align_corners=False)
    return y[0].permute(1, 2, 0)


class RoMaMatcher(nn.Module):
    """Dense matcher: (warp (h, w, 2) normalised B coordinates per A pixel,
    certainty (h, w) in [0, 1])."""

    def __init__(self, cfg: RoMaConfig = RoMaConfig()):
        super().__init__()
        self.cfg = cfg
        c8 = cfg.enc_channels[-1]
        self.encoder = _Encoder(cfg)
        self.gp = _GPMatcher(cfg, c8)
        self.decoder = _CoarseDecoder(cfg, c8 + 4 * cfg.coord_freqs)
        enc = [16] + list(cfg.enc_channels)
        for li, ch in enumerate(cfg.refine_channels):
            self.add_module(f"refiner_{li}", _Refiner(cfg, enc[-2 - li], ch))

    def forward(self, img0, img1, intermediates: dict | None = None):
        fa, fb = self.encoder(img0), self.encoder(img1)
        mu = self.gp(fa[-1], fb[-1])
        warp, cert, anchor_logits = self.decoder(fa[-1], mu)
        if intermediates is not None:
            intermediates.update(fa=fa, fb=fb, gp=mu, coarse_warp=warp, coarse_cert=cert,
                                 anchor_logits=anchor_logits)
        for li in range(len(self.cfg.refine_channels)):
            fa_l, fb_l = fa[-2 - li], fb[-2 - li]
            h, w, _ = fa_l.shape
            warp = _upsample_field(warp, h, w)
            cert = _upsample_field(cert[..., None], h, w)[..., 0]
            warp, cert = getattr(self, f"refiner_{li}")(fa_l, fb_l, warp, cert)
            if intermediates is not None:
                intermediates[f"warp_s{li}"] = warp
        h1, w1, _ = fa[0].shape
        warp = _upsample_field(warp, h1, w1)
        cert = _upsample_field(cert[..., None], h1, w1)[..., 0]
        return warp, torch.sigmoid(cert)


def _as_image(img, device) -> torch.Tensor:
    x = img if torch.is_tensor(img) else torch.from_numpy(np.asarray(img, np.float32))
    x = x.to(device=device, dtype=torch.float32)
    return x / 255.0 if float(x.max()) > 1.5 else x


@torch.inference_mode()
def roma_match(model: RoMaMatcher, img0, img1):
    """``roma_model.match``: (warp (h, w, 2), certainty (h, w)) on the
    model's device; an image whose maximum exceeds 1.5 is divided by 255."""
    dev = next(model.parameters()).device
    return model(_as_image(img0, dev), _as_image(img1, dev))


@torch.inference_mode()
def roma_fb_error_px(model: RoMaMatcher, img0, img1):
    """(warp_f, cert_f, err_px (h, w)): the A -> B warp, its certainty and
    each A pixel's forward-backward round-trip error in pixels."""
    warp_f, cert_f = roma_match(model, img0, img1)
    warp_b, _ = roma_match(model, img1, img0)
    h, w, _ = warp_f.shape
    grid = _coord_grid(h, w, warp_f.device)
    back = grid_sample(warp_b, warp_f)
    dx = (back[..., 0] - grid[..., 0]) * 0.5 * w
    dy = (back[..., 1] - grid[..., 1]) * 0.5 * h
    return warp_f, cert_f, torch.sqrt(dx * dx + dy * dy)


def roma_sample(warp: torch.Tensor, certainty: torch.Tensor, num: int = 10000, *,
                idx: torch.Tensor | None = None, generator: torch.Generator | None = None):
    """``roma_model.sample``: a certainty-weighted draw (with replacement)
    of ``min(num, h w)`` matches. Returns ((n, 4) normalised [xA, yA, xB,
    yB], (n,) certainties, (n,) drawn flat indices). ``idx`` gives the
    draws; otherwise ``torch.multinomial`` draws them from ``generator``."""
    h, w, _ = warp.shape
    flat = torch.cat([_coord_grid(h, w, warp.device), warp], dim=-1).reshape(h * w, 4)
    cert = certainty.reshape(h * w)
    if idx is None:
        total = cert.sum()
        p = cert / torch.clamp(total, min=1e-9) if float(total) > 0 else torch.ones_like(cert)
        idx = torch.multinomial(p, min(num, h * w), replacement=True, generator=generator)
    idx = torch.as_tensor(idx, device=warp.device).long()
    return flat[idx], cert[idx], idx


def roma_to_pixel_coordinates(matches, h_a, w_a, h_b, w_b):
    """``roma_model.to_pixel_coordinates``: (kpts_a (n, 2), kpts_b (n, 2))."""
    m = torch.as_tensor(matches)
    ka = torch.stack([(m[:, 0] + 1.0) * 0.5 * w_a - 0.5, (m[:, 1] + 1.0) * 0.5 * h_a - 0.5], -1)
    kb = torch.stack([(m[:, 2] + 1.0) * 0.5 * w_b - 0.5, (m[:, 3] + 1.0) * 0.5 * h_b - 0.5], -1)
    return ka, kb


def _is_norm(key: str) -> bool:
    return key.split(".")[-2].startswith("GroupNorm")


def roma_from_flax(params: Mapping, cfg: RoMaConfig, device=None) -> RoMaMatcher:
    """The port's module, in eval mode on ``device`` (default ``cuda``),
    with the parameters of a Flax tree (nested or flat)."""
    model = RoMaMatcher(cfg)
    model.load_state_dict(state_dict_from_flat(flat_from_tree(params)))
    return model.eval().to(resolve_device(device))


def roma_to_flax(model: RoMaMatcher) -> dict[str, np.ndarray]:
    """The flat Flax tree (``params/...`` paths) of the port's module."""
    return flat_from_module(model, _is_norm)


def load_roma_weights(path: str, device=None) -> RoMaMatcher:
    """The module of a flat ``.npz`` checkpoint in the JAX package's format
    (``weights/roma_tiny.npz``)."""
    flat, cfg = read_flat_npz(path, _TUPLE_KEYS)
    return roma_from_flax(flat, RoMaConfig(**cfg), device)


def save_roma_weights(path: str, model: RoMaMatcher) -> None:
    """Write the module as the JAX package's ``.npz`` checkpoint."""
    write_flat_npz(path, roma_to_flax(model), model.cfg)
