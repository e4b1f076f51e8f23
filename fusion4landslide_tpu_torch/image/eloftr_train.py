"""Training of the compact EfficientLoFTR on synthetic homographies.

Port of ``fusion4landslide_tpu.image.eloftr_train``, which trained the
shipped ``weights/eloftr_tiny.npz`` on ``image.roma_train``'s pairs. The
loss follows the published LoFTR / EfficientLoFTR recipe:

- coarse: cross-entropy on the dual-softmax confidence at the
  ground-truth coarse cell correspondence;
- fine stage 1: cross-entropy over the (k+2)^2 target-window positions of
  the first-stage correlation, teacher-forced at the ground-truth coarse
  match, for every source-window pixel;
- fine stage 2: l2 between the 3x3 softmax expectation on the
  ``fine_matching_slice_dim`` channels and the ground-truth sub-pixel
  residual.

``EfficientLoFTR.forward`` gives the coarse maps (2, D, hc, wc) and the
fine maps (2, C, H, W) with autograd; the pairs of a batch go through it
one at a time and their losses are averaged (the JAX trainer ``vmap``s
the per-pair loss). Adam under optax's cosine decay, and the numpy
generator consumed as the JAX trainer consumes it. A parity run starts
from JAX's ``model.init`` parameters (``eloftr_from_flax``); a port-only
run from numpy draws of Flax's default initialisers
(``flax_bridge.flax_default_init``): ``seeded_eloftr``'s trained-like
scales start the dual softmax at chance and train slower, short of
``tests/test_eloftr_train.py``'s bar (coarse CE below 0.7x its first
value in 60 steps).

CLI::

    python -m fusion4landslide_tpu_torch.image.eloftr_train --out /tmp/eloftr_tiny.npz \\
        [--steps 2000 --size 96 --lr 1e-3 --batch 4 --seed 0 --device cuda]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.eloftr import (
    EfficientLoFTR,
    ELoFTRConfig,
    _unfold_windows,
    _is_norm,
    save_eloftr_weights,
)
from fusion4landslide_tpu_torch.image.flax_bridge import flax_default_init
from fusion4landslide_tpu_torch.image.roma import grid_sample
from fusion4landslide_tpu_torch.image.roma_train import (
    TrainSettings,
    adam_cosine,
    make_pair,
    sample_batch,
)

__all__ = ["COMPACT_CONFIG", "eloftr_batch_loss", "eloftr_loss", "train_eloftr"]

#: The compact preset (the shape of the matcher's random-weights fallback).
COMPACT_CONFIG = ELoFTRConfig(
    stage_num_blocks=(1, 1, 2, 2),
    out_features=(32, 32, 64, 128),
    hidden_size=128,
    num_attention_layers=2,
)


def _warp_px(warp_gt: torch.Tensor, u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """The dense ground-truth warp (n, n, 2), normalised as ``make_pair``
    writes it, sampled at float pixel positions (u, v): image-1 pixel
    positions (..., 2)."""
    cu = (u + 0.5) * 2.0 / n - 1.0
    cv = (v + 0.5) * 2.0 / n - 1.0
    return (grid_sample(warp_gt, torch.stack([cu, cv], dim=-1)) + 1.0) * n / 2.0


def eloftr_loss(model: EfficientLoFTR, img0, img1, warp_gt, valid):
    """The JAX ``_loss_fn`` of one pair: (total, (coarse CE, fine CE,
    stage-2 l2))."""
    c = model.cfg
    n = img0.shape[0]
    dev = img0.device
    coarse, fine = model(img0, img1)
    _, d, hc, wc = coarse.shape
    S = hc * wc
    scale = n // hc
    k = c.fine_kernel_size

    # Coarse dual-softmax CE at the ground-truth cell correspondence.
    f = coarse.flatten(2).transpose(1, 2) / math.sqrt(d)
    sim = torch.matmul(f[0], f[1].T) / c.coarse_matching_temperature
    log_conf = torch.log_softmax(sim, dim=0) + torch.log_softmax(sim, dim=1)
    ii = torch.arange(S, device=dev)
    q0x = (ii % wc).to(torch.float32) * scale
    q0y = (ii // wc).to(torch.float32) * scale
    p1 = _warp_px(warp_gt, q0x, q0y, n)
    jx = torch.round(p1[..., 0] / scale).to(torch.int64)
    jy = torch.round(p1[..., 1] / scale).to(torch.int64)
    in_b = (jx >= 0) & (jx < wc) & (jy >= 0) & (jy < hc)
    src_ok = grid_sample(
        valid[..., None].to(torch.float32),
        torch.stack([(q0x + 0.5) * 2 / n - 1, (q0y + 0.5) * 2 / n - 1], dim=-1),
    )[..., 0] > 0.5
    vc = (in_b & src_ok).to(torch.float32)
    j_gt = torch.clamp(jy, 0, hc - 1) * wc + torch.clamp(jx, 0, wc - 1)
    ce_c = -torch.gather(log_conf, 1, j_gt[:, None])[:, 0]
    ce_c = (ce_c * vc).sum() / torch.clamp(vc.sum(), min=1.0)

    # Fine windows, teacher-forced at the ground-truth coarse match.
    win0 = _unfold_windows(fine[0], k, k, 0)  # (S, k^2, C)
    win1 = _unfold_windows(fine[1], k + 2, k, 1)[j_gt]  # (S, (k+2)^2, C)
    slice_dim = c.fine_matching_slice_dim
    c_first = win0.shape[-1] - slice_dim
    a0 = win0[..., :c_first] / math.sqrt(c_first)
    a1 = win1[..., :c_first] / math.sqrt(c_first)
    e1 = torch.einsum("spc,sqc->spq", a0, a1)

    # Claimed coordinates of every source-window pixel, their truth, and
    # its position in the teacher-forced (k+2)^2 target window.
    py, px = torch.meshgrid(torch.arange(k, device=dev), torch.arange(k, device=dev),
                            indexing="ij")
    offx = (px.reshape(-1) - k // 2 + 0.5).to(torch.float32)
    offy = (py.reshape(-1) - k // 2 + 0.5).to(torch.float32)
    p1f = _warp_px(warp_gt, q0x[:, None] + offx[None], q0y[:, None] + offy[None], n)
    q1x = (j_gt % wc).to(torch.float32) * scale
    q1y = (j_gt // wc).to(torch.float32) * scale
    gx = p1f[..., 0] - q1x[:, None] + (k // 2 + 0.5)
    gy = p1f[..., 1] - q1y[:, None] + (k // 2 + 0.5)
    gxi = torch.round(gx).to(torch.int64)
    gyi = torch.round(gy).to(torch.int64)
    in_w = (gxi >= 0) & (gxi < k + 2) & (gyi >= 0) & (gyi < k + 2)
    vf = vc[:, None] * in_w.to(torch.float32)
    g_idx = torch.clamp(gyi, 0, k + 1) * (k + 2) + torch.clamp(gxi, 0, k + 1)
    ce_f = -torch.gather(torch.log_softmax(e1, dim=-1), -1, g_idx[..., None])[..., 0]
    ce_f = (ce_f * vf).sum() / torch.clamp(vf.sum(), min=1.0)

    # Stage 2: 3x3 expectation on the slice channels around the truth.
    b0 = win0[..., c_first:]
    b1 = win1[..., c_first:] / math.sqrt(slice_dim)
    sc = torch.einsum("spc,sqc->spq", b0, b1)
    dy, dx = torch.meshgrid(torch.arange(-1, 2, device=dev), torch.arange(-1, 2, device=dev),
                            indexing="ij")
    yy = torch.clamp(gyi[..., None, None] + dy, 0, k + 1)
    xx = torch.clamp(gxi[..., None, None] + dx, 0, k + 1)
    local = torch.gather(sc, -1, (yy * (k + 2) + xx).reshape(S, k * k, 9))
    prob = torch.softmax(local / c.fine_matching_regress_temperature, dim=-1).reshape(S, k * k, 3, 3)
    g = torch.linspace(-1.0, 1.0, 3, device=dev)
    ex = (prob * g[None, None, None, :]).sum(dim=(-2, -1))
    ey = (prob * g[None, None, :, None]).sum(dim=(-2, -1))
    rx = torch.clamp(gx - torch.round(gx), -1.0, 1.0)
    ry = torch.clamp(gy - torch.round(gy), -1.0, 1.0)
    l2 = (ex - rx) ** 2 + (ey - ry) ** 2
    l2 = (l2 * vf).sum() / torch.clamp(vf.sum(), min=1.0)
    return ce_c + 0.5 * ce_f + 0.25 * l2, (ce_c, ce_f, l2)


def eloftr_batch_loss(model: EfficientLoFTR, batch):
    """Mean loss and mean parts over the pairs of a batch."""
    outs = [eloftr_loss(model, *(x[b] for x in batch)) for b in range(batch[0].shape[0])]
    loss = torch.stack([o[0] for o in outs]).mean()
    aux = tuple(torch.stack([o[1][i] for o in outs]).mean() for i in range(3))
    return loss, aux


def train_eloftr(settings: TrainSettings | None = None, cfg: ELoFTRConfig | None = None, *,
                 seed: int = 0, log_every: int = 100, logger=None,
                 checkpoint_to: str | None = None, checkpoint_every: int = 500,
                 model: EfficientLoFTR | None = None, device=None):
    """Train the compact EfficientLoFTR on synthetic homographies, on
    ``device`` (default ``cuda``), from ``model`` (e.g. ``eloftr_from_flax``
    of a Flax init) or ``flax_default_init`` with ``seed``. Returns (model, cfg,
    history); history logs (coarse CE, fine CE, l2), each from before its
    step's update."""
    settings = settings or TrainSettings(size=96, steps=2000, lr=1e-3)
    cfg = model.cfg if model is not None else (cfg or COMPACT_CONFIG)
    if settings.size % 32:
        raise ValueError("image size must be a multiple of 32")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    make_pair(rng, settings)  # the JAX trainer's initialisation pair
    if model is None:
        model = flax_default_init(EfficientLoFTR(cfg), seed, _is_norm)
    model = model.to(dev).train()
    opt, sched = adam_cosine(model, settings.lr, settings.steps)
    history = []
    for it in range(settings.steps):
        batch = sample_batch(rng, settings, dev)
        opt.zero_grad(set_to_none=True)
        loss, aux = eloftr_batch_loss(model, batch)
        loss.backward()
        opt.step()
        sched.step()
        if it % log_every == 0 or it == settings.steps - 1:
            vals = tuple(float(a.detach()) for a in aux)
            history.append(vals)
            msg = (f"eloftr_train step {it}: loss={float(loss.detach()):.4f} "
                   f"ce_c={vals[0]:.4f} ce_f={vals[1]:.4f} l2={vals[2]:.4f}")
            if logger:
                logger.info(msg)
            else:
                print(msg, flush=True)
        if checkpoint_to and it and (it % checkpoint_every == 0 or it == settings.steps - 1):
            save_eloftr_weights(checkpoint_to, model)
    return model.eval(), cfg, history


def main(argv: list[str] | None = None) -> None:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--out", required=True, help="checkpoint path (.npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default cuda")
    args = p.parse_args(argv)
    settings = TrainSettings(size=args.size, steps=args.steps, lr=args.lr, batch=args.batch)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    model, _, history = train_eloftr(settings, seed=args.seed, checkpoint_to=args.out,
                                     device=args.device)
    save_eloftr_weights(args.out, model)
    print(f"saved {args.out}; final {history[-1]}")


if __name__ == "__main__":
    main()
