"""Dense 2D image matching for epoch pairs (port of
``fusion4landslide_tpu.image.matching``).

- ``zncc_grid_match``: zero-normalised cross-correlation over a grid of
  template centres (classical digital image correlation). Every candidate
  displacement of a block of centres is scored at once: the numerator is a
  grouped convolution of each centre's search window with its own template
  (``F.conv2d(..., groups=B)``), the candidates' sums and energies box
  sums with a shared ones kernel; the candidate norm is
  ``sqrt(sum c^2 - (sum c)^2 / p^2)`` in float32, as in the JAX package.
  Sub-pixel refinement by a parabola fit on the correlation surface.
- the learned matchers E-LoFTR (``image.eloftr``; the shipped configs'
  ``img_matching_type: eloftr``, ``weights/eloftr_tiny.npz``) and RoMa
  (``image.roma``; ``weights/roma_tiny.npz``, with its forward-backward
  self-check and certainty-weighted sample), and ``loftr``: a LoFTR-family
  checkpoint (``LOFTR_WEIGHT_SEARCH_PATHS`` or ``weights=``) through
  ``image.loftr.load_torch_loftr`` (classic LoFTR or E-LoFTR by layout),
  ``params=`` (a module), or the compact ``image.loftr.LoFTRMatcher`` with
  numpy-seeded weights where none resolve. Where their weights do not
  resolve, the learned matchers fall back to ZNCC with a warning, as in
  the JAX package. ``match_epoch_images`` probes the E-LoFTR paths for
  ``loftr`` too, as the JAX function does, so in this repository it hands
  ``weights/eloftr_tiny.npz`` to ``torch.load`` and raises the same
  ``RuntimeError``.
- ``match_epoch_images``: the sliding-window crop loop (step = crop -
  overlap), optional 8-neighbour cross pairing, ``max_flow_px`` widening,
  dedup by the (u0, v0) pixel cell, the near-bound warning and RoMa's ZNCC
  fallback when every crop fails its self-check.
- ``get_matcher`` / ``MATCHERS`` and ``resolve_learned_weights``.

Matching runs on ``device`` (default ``cuda``); TF32 stays off for the
convolutions and matmuls (``resolve_device``).
"""

from __future__ import annotations

import os.path as osp
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fusion4landslide_tpu_torch.device import resolve_device

__all__ = [
    "LOFTR_WEIGHT_SEARCH_PATHS",
    "MATCHERS",
    "RomaCrop",
    "get_matcher",
    "match_epoch_images",
    "matcher_options",
    "resolve_learned_weights",
    "roma_crop_match",
    "zncc_grid_match",
]

#: Centres per block of the correlation (the JAX ``g_block``).
_G_BLOCK = 512
_GRAY = (0.299, 0.587, 0.114)


def _to_gray(img, device) -> torch.Tensor:
    """(h, w) float32 intensities of an (h, w) or (h, w, c) image."""
    x = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img,
                        dtype=torch.float32, device=device)
    if x.ndim == 3:
        return torch.einsum("hwc,c->hw", x[..., :3],
                            torch.tensor(_GRAY, dtype=torch.float32, device=device))
    return x


def _parab(cm, c0, cp):
    denom = cm - 2.0 * c0 + cp
    return torch.where(denom.abs() > 1e-9, torch.clamp(0.5 * (cm - cp) / denom, -1.0, 1.0),
                       torch.zeros_like(denom))


def _zncc_core(img0: torch.Tensor, img1: torch.Tensor, grid_step: int, patch: int, search: int):
    """(centres (G, 2) [y, x], flow_y, flow_x, score, texture) over the
    grid of centres at least ``patch // 2 + search`` from the border."""
    dev = img0.device
    h, w = img0.shape
    half = patch // 2
    margin = half + search
    ys = torch.arange(margin, h - margin, grid_step, device=dev)
    xs = torch.arange(margin, w - margin, grid_step, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=1)
    n_off = 2 * search + 1
    win = patch + 2 * search
    rel = torch.arange(-half, patch - half, device=dev)
    py, px = torch.meshgrid(rel, rel, indexing="ij")
    prel = torch.stack([py.reshape(-1), px.reshape(-1)], dim=1)
    wrel = torch.arange(-half - search, -half - search + win, device=dev)
    ones_k = torch.ones((1, 1, patch, patch), dtype=torch.float32, device=dev)
    np2 = float(patch * patch)
    outs = []
    for s0 in range(0, centers.shape[0], _G_BLOCK):
        cb = centers[s0:s0 + _G_BLOCK]
        B = cb.shape[0]
        # Templates from img0, zero-mean and unit-norm: (B, p^2).
        pos0 = cb[:, None, :] + prel[None]
        t = img0[pos0[..., 0], pos0[..., 1]]
        t = t - t.mean(dim=1, keepdim=True)
        t_norm = torch.sqrt((t * t).sum(dim=1, keepdim=True)) + 1e-6
        t = t / t_norm
        # Each centre's img1 search window: (B, win, win).
        wy = cb[:, 0:1] + wrel[None]
        wx = cb[:, 1:2] + wrel[None]
        w1 = img1[wy[:, :, None], wx[:, None, :]]
        num = F.conv2d(w1[None], t.reshape(B, 1, patch, patch), groups=B)[0]
        c_sum = F.conv2d(w1[:, None], ones_k)[:, 0]
        c_sq = F.conv2d((w1 * w1)[:, None], ones_k)[:, 0]
        c_norm = torch.sqrt(torch.clamp(c_sq - c_sum * c_sum / np2, min=0.0))
        corr = (num / (c_norm + 1e-6)).reshape(B, -1)
        best = corr.argmax(dim=1)
        score = torch.gather(corr, 1, best[:, None])[:, 0]
        by, bx = best // n_off, best % n_off
        corr2 = corr.reshape(B, n_off, n_off)
        bi = torch.arange(B, device=dev)
        bys = torch.clamp(by, 1, n_off - 2)
        bxs = torch.clamp(bx, 1, n_off - 2)
        sub_y = _parab(corr2[bi, bys - 1, bxs], corr2[bi, bys, bxs], corr2[bi, bys + 1, bxs])
        sub_x = _parab(corr2[bi, bys, bxs - 1], corr2[bi, bys, bxs], corr2[bi, bys, bxs + 1])
        outs.append(((by - search).float() + sub_y, (bx - search).float() + sub_x, score,
                     t_norm[:, 0]))
    if not outs:
        empty = torch.zeros((0,), device=dev)
        return centers, empty, empty, empty, empty
    fy, fx, sc, tn = (torch.cat(z) for z in zip(*outs))
    return centers, fy, fx, sc, tn


def zncc_grid_match(img0, img1, *, grid_step: int = 8, patch: int = 16, search: int = 32,
                    min_score: float = 0.6, min_texture: float = 1.0,
                    device=None) -> np.ndarray:
    """Dense grid matches between two co-registered epoch images (numpy
    arrays or tensors, grey or colour): an (M, 4) float32 array of
    [u0, v0, u1, v1], kept where the ZNCC score reaches ``min_score`` and
    the template's contrast (its zero-mean norm) ``min_texture``."""
    dev = resolve_device(device)
    g0, g1 = _to_gray(img0, dev), _to_gray(img1, dev)
    centers, fy, fx, score, texture = _zncc_core(g0, g1, grid_step, patch, search)
    keep = ((score >= min_score) & (texture >= min_texture)).cpu().numpy()
    centers = centers.cpu().numpy()
    u0 = centers[:, 1].astype(np.float32)
    v0 = centers[:, 0].astype(np.float32)
    u1 = u0 + fx.cpu().numpy()
    v1 = v0 + fy.cpu().numpy()
    return np.stack([u0, v0, u1, v1], axis=1)[keep]


#: Loaded learned matchers, keyed by (weights, device).
_ELOFTR_CACHE: dict = {}
_ROMA_CACHE: dict = {}
_LOFTR_CACHE: dict = {}

#: Probed locations of upstream LoFTR checkpoints (the JAX package's list).
LOFTR_WEIGHT_SEARCH_PATHS = (
    "weights/outdoor_ds.ckpt",
    "weights/indoor_ds.ckpt",
    "weights/loftr.ckpt",
)

#: Probed locations of converted learned-matcher checkpoints (the JAX
#: package's lists).
WEIGHT_SEARCH_PATHS = (
    "weights/efficientloftr",
    "weights/eloftr.safetensors",
    "weights/eloftr_outdoor.ckpt",
    "weights/eloftr_tiny.npz",
)
ROMA_WEIGHT_SEARCH_PATHS = (
    "weights/roma_tiny.npz",
    "weights/roma.npz",
)


def _eloftr_model(params, weights, dev):
    """The E-LoFTR module: ``params`` (a module), else the resolved
    checkpoint (a JAX-format ``.npz`` or a ``transformers`` checkpoint),
    else random weights of the tiny-like architecture, with a warning
    (seeded here; the JAX package draws its Flax init)."""
    from fusion4landslide_tpu_torch.image import eloftr as E

    if params is not None:
        return params.to(dev)
    weights = resolve_learned_weights(weights)
    key = (weights or "__random__", str(dev))
    if key not in _ELOFTR_CACHE:
        if weights is not None and str(weights).endswith(".npz"):
            _ELOFTR_CACHE[key] = E.load_eloftr_weights(weights, dev)
        elif weights is not None:
            _ELOFTR_CACHE[key] = E.load_torch_eloftr(weights, device=dev)
        else:
            warnings.warn("eloftr matcher running with random weights; convert an upstream "
                          "checkpoint (image.eloftr.load_torch_eloftr) for production matching",
                          stacklevel=3)
            cfg = E.ELoFTRConfig(stage_num_blocks=(1, 1, 2, 2), out_features=(32, 32, 64, 128),
                                 hidden_size=128, num_attention_layers=2)
            _ELOFTR_CACHE[key] = E.seeded_eloftr(cfg, 0, dev)
    return _ELOFTR_CACHE[key]


def _eloftr_matcher(img0, img1, *, params=None, weights=None, device=None, mark=None, **_):
    """EfficientLoFTR (``image.eloftr``): the reference's production
    matcher. (M, 4) float32 [u0, v0, u1, v1]; ``mark(stage)`` as
    ``eloftr_core`` takes it."""
    from fusion4landslide_tpu_torch.image.eloftr import eloftr_match

    dev = resolve_device(device)
    uv, _conf = eloftr_match(_eloftr_model(params, weights, dev), img0, img1, mark=mark)
    return uv


def _loftr_matcher(img0, img1, *, params=None, weights=None, match_threshold: float = 0.2,
                   device=None, **_):
    """LoFTR family (``img_matching_type: loftr``): ``params`` (a
    ``ClassicLoFTR``, ``EfficientLoFTR`` or ``LoFTRMatcher`` module), else
    the resolved checkpoint through ``load_torch_loftr``, else the compact
    ``LoFTRMatcher`` with numpy-seeded weights (seed 0), with a warning.
    (M, 4) float32 [u0, v0, u1, v1]."""
    from fusion4landslide_tpu_torch.image import loftr as L
    from fusion4landslide_tpu_torch.image.eloftr import EfficientLoFTR, eloftr_match
    from fusion4landslide_tpu_torch.image.loftr_classic import ClassicLoFTR, classic_loftr_match

    dev = resolve_device(device)
    if params is None:
        weights = resolve_learned_weights(weights, LOFTR_WEIGHT_SEARCH_PATHS)
        key = (weights or "__random__", str(dev))
        if key not in _LOFTR_CACHE:
            if weights is None:
                warnings.warn("loftr matcher running with random weights; convert an upstream "
                              "checkpoint (image.loftr.load_torch_loftr) for production matching",
                              stacklevel=3)
                _LOFTR_CACHE[key] = L.seeded_loftr(0, dev)
            else:
                _LOFTR_CACHE[key] = L.load_torch_loftr(weights, device=dev)
        params = _LOFTR_CACHE[key]
    model = params.to(dev)
    if isinstance(model, ClassicLoFTR):
        uv, _conf = classic_loftr_match(model, img0, img1, match_threshold=match_threshold)
    elif isinstance(model, EfficientLoFTR):
        uv, _conf = eloftr_match(model, img0, img1)
    else:
        uv, _conf = L.loftr_match(model, img0, img1, match_threshold=match_threshold)
    return uv


class RomaCrop(NamedTuple):
    """One crop pair through RoMa: the kept matches (M, 4), the
    certainty-weighted forward-backward consistent fraction, whether the
    self-check passed, and the drawn flat indices (None when it failed)."""

    matches: np.ndarray
    fb_frac: float
    passed: bool
    sample_idx: torch.Tensor | None


def _resize(g: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of an (h, w) image to (size, size), antialiased
    when it shrinks (``jax.image.resize``'s ``"bilinear"``)."""
    return F.interpolate(g[None, None], size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)[0, 0]


def roma_crop_match(model, img0, img1, *, num_matches: int = 5000, min_certainty: float = 0.3,
                    work_size: int = 224, fb_px: float = 6.0, fb_min_frac: float = 0.15,
                    sample_idx=None, generator: torch.Generator | None = None) -> RomaCrop:
    """RoMa on one crop pair: grey by the channel mean, resized to
    ``work_size``; the forward-backward self-check (matches whose round
    trip exceeds ``fb_px`` at work resolution are dropped; the crop is
    unmatched when less than ``fb_min_frac`` of the certainty survives);
    a certainty-weighted sample of ``num_matches`` (``sample_idx``, or
    drawn from ``generator``, by default one seeded with 0 on the model's
    device), mapped to crop pixels and kept where certainty reaches
    ``min_certainty``."""
    from fusion4landslide_tpu_torch.image.roma import (
        roma_fb_error_px,
        roma_sample,
        roma_to_pixel_coordinates,
    )

    dev = next(model.parameters()).device
    (h0, w0), (h1, w1) = img0.shape[:2], img1.shape[:2]
    g0, g1 = (torch.as_tensor(np.asarray(g, np.float32) if not torch.is_tensor(g) else g,
                              dtype=torch.float32, device=dev) for g in (img0, img1))
    if g0.ndim == 3:
        g0 = g0.mean(dim=-1)
    if g1.ndim == 3:
        g1 = g1.mean(dim=-1)
    warp, cert, err_px = roma_fb_error_px(model, _resize(g0, work_size), _resize(g1, work_size))
    consistent = err_px <= fb_px
    frac = float((cert * consistent).sum()) / max(float(cert.sum()), 1e-9)
    if frac < fb_min_frac:
        return RomaCrop(np.zeros((0, 4), np.float32), frac, False, None)
    if generator is None and sample_idx is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    matches, c, idx = roma_sample(warp, cert * consistent, num_matches, idx=sample_idx,
                                  generator=generator)
    ka, kb = roma_to_pixel_coordinates(matches, h0, w0, h1, w1)
    keep = c >= min_certainty
    out = torch.cat([ka[keep], kb[keep]], dim=1).cpu().numpy().astype(np.float32)
    return RomaCrop(out, frac, True, idx)


def _roma_matcher(img0, img1, *, params=None, weights=None, device=None, logger=None,
                  fb_px: float = 6.0, **kw):
    """RoMa (``image.roma``): the reference's ``img_matching_type: RoMA``
    role, self-checked per crop (``roma_crop_match``), with ``params`` (a
    module) or the resolved checkpoint. A crop that fails the check
    returns no matches, with a warning."""
    from fusion4landslide_tpu_torch.image.roma import load_roma_weights

    dev = resolve_device(device)
    if params is not None:
        model = params.to(dev)
    else:
        weights = resolve_learned_weights(weights, ROMA_WEIGHT_SEARCH_PATHS)
        if weights is None:
            raise FileNotFoundError("no RoMa weights provisioned; pass weights= (the JAX "
                                    "package's roma_train writes them)")
        if (weights, str(dev)) not in _ROMA_CACHE:
            _ROMA_CACHE[(weights, str(dev))] = load_roma_weights(weights, dev)
        model = _ROMA_CACHE[(weights, str(dev))]
    keys = ("num_matches", "min_certainty", "work_size", "fb_min_frac", "sample_idx", "generator")
    res = roma_crop_match(model, img0, img1, fb_px=fb_px,
                          **{k: v for k, v in kw.items() if k in keys})
    if not res.passed:
        msg = (f"roma self-check failed: only {100 * res.fb_frac:.1f}% of certainty-weighted "
               f"pixels are forward-backward consistent within {fb_px} px at work resolution "
               "— returning no matches for this crop (the matcher is unreliable at these "
               "shapes)")
        if logger is not None:
            logger.warning(msg)
        else:
            warnings.warn(msg, stacklevel=2)
    return res.matches


MATCHERS = {
    "zncc": zncc_grid_match,
    "loftr": _loftr_matcher,
    "eloftr": _eloftr_matcher,
    "roma": _roma_matcher,
    "romav2": _roma_matcher,
}


def get_matcher(name: str):
    """The matcher registered under ``name`` (case-insensitive)."""
    try:
        return MATCHERS[name.lower()]
    except KeyError as e:
        raise NotImplementedError(
            f"image matcher '{name}' is not available; options: {sorted(MATCHERS)}"
        ) from e


def resolve_learned_weights(weights=None, paths=WEIGHT_SEARCH_PATHS):
    """A learned matcher's checkpoint path: ``weights`` (must exist), else
    the first of ``paths`` found relative to the working directory or to
    the repository root; None when nothing is there."""
    if weights is not None:
        if not osp.exists(str(weights)):
            raise FileNotFoundError(f"learned matcher weights not found: {weights}")
        return str(weights)
    repo_root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    for cand in paths:
        for base in ("", repo_root):
            p = osp.join(base, cand) if base else cand
            if osp.exists(p):
                return p
    return None


def matcher_options(cfg) -> dict:
    """``match_epoch_images`` options from a config (``img_matching_type``,
    ``crop_size``, ``overlap_size``, ``img_matching_cross_crops``,
    ``max_flow_px``)."""
    return dict(
        matcher=str(cfg.get("img_matching_type", "zncc")).lower(),
        crop_size=tuple(cfg["crop_size"]) if cfg.get("crop_size") else None,
        overlap_size=tuple(cfg["overlap_size"]) if cfg.get("overlap_size") else None,
        cross_crops=bool(cfg.get("img_matching_cross_crops", False)),
        max_flow_px=cfg.get("max_flow_px"),
    )


def match_epoch_images(img0, img1, *, matcher: str = "zncc",
                       crop_size: tuple[int, int] | None = None,
                       overlap_size: tuple[int, int] | None = None,
                       cross_crops: bool = False, max_flow_px: float | None = None,
                       logger=None, device=None, **kw) -> np.ndarray:
    """(M, 4) float32 [u0, v0, u1, v1] matches between two epoch images.

    With ``crop_size`` the images are matched over a sliding grid of crop
    pairs (step = crop - overlap, default overlap half a crop); each img0
    crop pairs with the same-position img1 crop, or with ``cross_crops``
    also its 8 neighbours. ``max_flow_px`` widens the ZNCC search to cover
    it and turns cross pairing on when it exceeds half the overlap.
    Matches from overlapping crops are deduplicated by their (u0, v0)
    pixel cell, the first kept. A warning is logged when the median flow
    is within 20% of the ZNCC search bound.

    A learned matcher runs with the checkpoint ``weights=`` or the first
    one found under ``weights/``; without one it falls back to ZNCC with a
    warning (``allow_random=True`` runs it with random weights). When every
    RoMa crop fails its self-check, the pair is matched by ZNCC instead."""
    name = matcher.lower()
    if name in ("eloftr", "loftr", "roma", "romav2") and kw.get("params") is None:
        paths = ROMA_WEIGHT_SEARCH_PATHS if name in ("roma", "romav2") else WEIGHT_SEARCH_PATHS
        resolved = resolve_learned_weights(kw.get("weights"), paths)
        if resolved is None and not kw.pop("allow_random", False):
            if logger is not None:
                logger.warning("no converted %s weights found (checked weights/ and the "
                               "'weights' option) — falling back to the ZNCC matcher", matcher)
            matcher, name = "zncc", "zncc"
            kw.pop("weights", None)
        elif resolved is not None:
            kw["weights"] = resolved
    kw.pop("allow_random", None)
    fn = get_matcher(matcher)
    is_zncc = name == "zncc"
    dev = resolve_device(device)
    kw["device"] = dev
    if is_zncc:
        kw.pop("weights", None)
        # Grey once, on the device; crops slice it.
        img0, img1 = _to_gray(img0, dev), _to_gray(img1, dev)
        if max_flow_px is not None and max_flow_px > int(kw.get("search", 32)):
            kw["search"] = int(np.ceil(max_flow_px))
    if max_flow_px is not None and crop_size is not None:
        oh, ow = overlap_size or (crop_size[0] // 2, crop_size[1] // 2)
        if max_flow_px > min(oh, ow) / 2:
            cross_crops = True

    def warn_near_bound(merged):
        if merged.shape[0] == 0 or not is_zncc or logger is None:
            return
        med = float(np.median(np.max(np.abs(merged[:, 2:4] - merged[:, 0:2]), axis=1)))
        bound = float(kw.get("search", 32))
        if med > 0.8 * bound:
            logger.warning("median pixel flow %.1f px is within 20%% of the ZNCC search bound "
                           "%d px — matches beyond the bound are silently lost; raise 'search' "
                           "or set max_flow_px", med, int(bound))

    def fallback_if_empty(merged):
        """RoMa's per-crop self-check can empty every crop: match the pair
        by ZNCC instead of returning an empty channel."""
        if merged.shape[0] or name not in ("roma", "romav2"):
            return merged
        if logger is not None:
            logger.warning("img_matching_type=%s produced no self-check-consistent matches — "
                           "falling back to the ZNCC matcher", matcher)
        zkw = {k: v for k, v in kw.items()
               if k in ("grid_step", "patch", "search", "min_score", "min_texture")}
        return match_epoch_images(img0, img1, matcher="zncc", crop_size=crop_size,
                                  overlap_size=overlap_size, cross_crops=cross_crops,
                                  max_flow_px=max_flow_px, logger=logger, device=dev, **zkw)

    if crop_size is None:
        out = fn(img0, img1, **kw)
        warn_near_bound(out)
        return fallback_if_empty(out)
    ch, cw = crop_size
    oh, ow = overlap_size or (ch // 2, cw // 2)
    sh, sw = max(ch - oh, 1), max(cw - ow, 1)
    h, w = img0.shape[:2]
    ys = list(range(0, max(h - ch, 0) + 1, sh))
    xs = list(range(0, max(w - cw, 0) + 1, sw))
    out = []
    for y0 in ys:
        for x0 in xs:
            c0 = img0[y0:y0 + ch, x0:x0 + cw]
            pairs = ([(y1, x1) for y1 in ys for x1 in xs
                      if abs(y1 - y0) <= sh and abs(x1 - x0) <= sw]
                     if cross_crops else [(y0, x0)])
            for y1, x1 in pairs:
                m = fn(c0, img1[y1:y1 + ch, x1:x1 + cw], **kw)
                if m.size:
                    out.append(m + np.asarray([x0, y0, x1, y1], np.float32))
    if not out:
        return fallback_if_empty(np.zeros((0, 4), np.float32))
    merged = np.concatenate(out, axis=0)
    key = merged[:, 1].round().astype(np.int64) * (w + 1) + merged[:, 0].round().astype(np.int64)
    _, first = np.unique(key, return_index=True)
    merged = merged[np.sort(first)]
    warn_near_bound(merged)
    return fallback_if_empty(merged)
