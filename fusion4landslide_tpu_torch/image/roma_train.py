"""Training of the RoMa-family matcher on synthetic homographies.

Port of ``fusion4landslide_tpu.image.roma_train``, which trained the
shipped ``weights/roma_tiny.npz``: procedural textures warped by random
similarity transforms with known dense ground-truth flow. The loss is
RoMa's: robust end-point error of the refined warp, of every refiner
output and of the coarse warp, anchor cross-entropy at the coarse stage
(classification over the K x K coordinate grid), and certainty binary
cross-entropy against the inlier indicator.

The JAX trainer ``vmap``s the per-pair loss; here the pairs of a batch go
through the module one at a time (RoMa's unbatched maps take their
``GroupNorm`` statistics per row) and their losses are averaged. Adam
with optax's ``cosine_decay_schedule`` (its closed form through
``LambdaLR``), as the JAX trainer. The numpy generator is consumed as
the JAX trainer consumes it (one pair for the initialisation, then the
batches), so a run from the same seed sees the same pairs.

A parity run starts from JAX's ``model.init`` parameters
(``roma_from_flax``); a port-only run from numpy draws of Flax's default
initialisers (``flax_bridge.flax_default_init``).

CLI::

    python -m fusion4landslide_tpu_torch.image.roma_train --out /tmp/roma_tiny.npz \\
        [--steps 1500 --size 96 --lr 2e-3 --seed 0 --device cuda]
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.roma import (
    RoMaConfig,
    RoMaMatcher,
    grid_sample,
    _is_norm,
    save_roma_weights,
)
from fusion4landslide_tpu_torch.image.flax_bridge import flax_default_init

__all__ = [
    "TrainSettings",
    "adam_cosine",
    "make_pair",
    "resize_bilinear",
    "roma_batch_loss",
    "roma_loss",
    "sample_batch",
    "train_roma",
]


@dataclasses.dataclass
class TrainSettings:
    size: int = 96
    steps: int = 1500
    lr: float = 2e-3
    batch: int = 4
    max_shift: float = 0.25  # of image extent
    max_rot: float = 0.15  # radians
    inlier_px: float = 3.0  # certainty-BCE inlier radius


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")`` of an (h, w) or (h, w, c)
    tensor: half-pixel centres, antialiased when it shrinks."""
    chan = x.dim() == 3
    y = x.permute(2, 0, 1)[None] if chan else x[None, None]
    y = F.interpolate(y, size=(int(shape[0]), int(shape[1])), mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0) if chan else y[0, 0]


def _texture(rng, n: int) -> np.ndarray:
    """Procedural multi-scale texture (random Fourier field)."""
    img = np.zeros((n, n), np.float32)
    for k in (2, 4, 8, 16, 32):
        a = rng.normal(size=(k, k)).astype(np.float32)
        img += resize_bilinear(torch.from_numpy(a), (n, n)).numpy() / np.sqrt(k)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def make_pair(rng, settings: TrainSettings):
    """One training sample from ``rng`` (numpy): (img0, img1, warp_gt
    (h, w, 2) normalised image-1 coordinates of each image-0 pixel, valid
    (h, w)), the JAX function's draws and arithmetic."""
    n = settings.size
    base = _texture(rng, 2 * n)
    ang = rng.uniform(-settings.max_rot, settings.max_rot)
    s = rng.uniform(0.9, 1.1)
    t = rng.uniform(-settings.max_shift, settings.max_shift, size=2) * n
    R = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32)
    # img0 = centre crop; img1 = crop of the transformed texture such that
    # pixel p0 in img0 corresponds to p1 = R p0 + t in img1's frame.
    c = n // 2
    img0 = base[c:c + n, c:c + n]
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    p0 = np.stack([xx, yy], -1).astype(np.float32)
    src = (p0 - t) @ np.linalg.inv(R).T
    coords = np.stack([src[..., 0] / n * 2 - 1 + 1e-6, src[..., 1] / n * 2 - 1 + 1e-6], -1)
    img1 = grid_sample(torch.from_numpy(np.ascontiguousarray(img0))[..., None],
                       torch.from_numpy(coords.astype(np.float32)))[..., 0].numpy()
    p1 = p0 @ R.T + t
    warp_gt = np.stack([p1[..., 0] / n * 2 - 1, p1[..., 1] / n * 2 - 1], -1).astype(np.float32)
    valid = (p1[..., 0] >= 0) & (p1[..., 0] < n) & (p1[..., 1] >= 0) & (p1[..., 1] < n)
    return img0.astype(np.float32), img1.astype(np.float32), warp_gt, valid


def sample_batch(rng, settings: TrainSettings, device) -> tuple[torch.Tensor, ...]:
    """``settings.batch`` pairs stacked: (img0, img1, warp_gt, valid)."""
    pairs = [make_pair(rng, settings) for _ in range(settings.batch)]
    return tuple(torch.from_numpy(np.stack([p[i] for p in pairs])).to(device) for i in range(4))


def _weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def _scale_epe(w: torch.Tensor, warp_gt: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Robust EPE of a lower-resolution warp against the resized truth."""
    h, wd, _ = w.shape
    gt = resize_bilinear(warp_gt, (h, wd))
    return _weighted_mean(torch.sqrt(((w - gt) ** 2).sum(-1) + 1e-8), resize_bilinear(v, (h, wd)))


def roma_loss(model: RoMaMatcher, img0, img1, warp_gt, valid, inlier_norm: float):
    """The JAX ``_loss_fn`` of one pair: (total, (epe, anchor CE, BCE))."""
    inter: dict = {}
    warp, cert = model(img0, img1, inter)
    err = torch.sqrt(((warp - warp_gt) ** 2).sum(-1) + 1e-8)
    v = valid.to(torch.float32)
    epe = _weighted_mean(err, v)
    scale_epe = 0.0
    for li in range(len(model.cfg.refine_channels)):
        scale_epe = scale_epe + _scale_epe(inter[f"warp_s{li}"], warp_gt, v)
    scale_epe = scale_epe + _scale_epe(inter["coarse_warp"], warp_gt, v)
    logits = inter["anchor_logits"]
    hc, wc, kk = logits.shape
    k = int(np.sqrt(kk))
    gt_c = resize_bilinear(warp_gt, (hc, wc))
    gx = torch.clamp(((gt_c[..., 0] + 1) * 0.5 * k).to(torch.int32), 0, k - 1)
    gy = torch.clamp(((gt_c[..., 1] + 1) * 0.5 * k).to(torch.int32), 0, k - 1)
    label = (gy * k + gx).long()
    ce = -torch.gather(torch.log_softmax(logits, dim=-1), -1, label[..., None])[..., 0]
    ce = _weighted_mean(ce, resize_bilinear(v, (hc, wc)))
    inlier = (err < inlier_norm).to(torch.float32) * v
    bce = -(inlier * torch.log(cert + 1e-6) + (1 - inlier) * torch.log(1 - cert + 1e-6)).mean()
    return epe + 0.5 * scale_epe + 0.25 * ce + 0.1 * bce, (epe, ce, bce)


def roma_batch_loss(model: RoMaMatcher, batch, inlier_norm: float):
    """Mean loss and mean parts over the pairs of a batch."""
    outs = [roma_loss(model, *(x[b] for x in batch), inlier_norm) for b in range(batch[0].shape[0])]
    loss = torch.stack([o[0] for o in outs]).mean()
    aux = tuple(torch.stack([o[1][i] for o in outs]).mean() for i in range(3))
    return loss, aux


def adam_cosine(model: torch.nn.Module, lr: float, steps: int, alpha: float = 0.05):
    """Adam (optax's defaults) under optax's ``cosine_decay_schedule(lr,
    steps, alpha)``: update t uses lr ((1 - alpha) (1 + cos(pi min(t,
    steps) / steps)) / 2 + alpha). Returns (optimizer, scheduler)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def factor(t: int) -> float:
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(t, steps) / steps)) + alpha

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def train_roma(settings: TrainSettings | None = None, cfg: RoMaConfig | None = None, *,
               seed: int = 0, log_every: int = 200, logger=None,
               checkpoint_to: str | None = None, checkpoint_every: int = 500,
               model: RoMaMatcher | None = None, device=None):
    """Train the compact RoMa matcher on synthetic homographies, on
    ``device`` (default ``cuda``), from ``model`` (e.g. ``roma_from_flax``
    of a Flax init) or ``flax_default_init`` with ``seed``. ``checkpoint_to``
    writes the JAX ``.npz`` format every ``checkpoint_every`` steps and at
    the end. Returns (model, cfg, history): the logged mean end-point
    errors (normalised units), each from before its step's update."""
    settings = settings or TrainSettings()
    cfg = model.cfg if model is not None else (cfg or RoMaConfig())
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    make_pair(rng, settings)  # the JAX trainer's initialisation pair
    if model is None:
        model = flax_default_init(RoMaMatcher(cfg), seed, _is_norm)
    model = model.to(dev).train()
    opt, sched = adam_cosine(model, settings.lr, settings.steps)
    inlier_norm = settings.inlier_px * 2.0 / settings.size
    history = []
    for it in range(settings.steps):
        batch = sample_batch(rng, settings, dev)
        opt.zero_grad(set_to_none=True)
        loss, aux = roma_batch_loss(model, batch, inlier_norm)
        loss.backward()
        opt.step()
        sched.step()
        if it % log_every == 0 or it == settings.steps - 1:
            epe = float(aux[0].detach())
            history.append(epe)
            msg = (f"roma_train step {it}: loss={float(loss.detach()):.4f} "
                   f"epe={epe:.4f} (~{epe * settings.size / 2:.2f} px)")
            if logger:
                logger.info(msg)
            else:
                print(msg, flush=True)
        if checkpoint_to and it and (it % checkpoint_every == 0 or it == settings.steps - 1):
            save_roma_weights(checkpoint_to, model)
    return model.eval(), cfg, history


def main(argv: list[str] | None = None) -> None:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--out", required=True, help="checkpoint path (.npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default cuda")
    args = p.parse_args(argv)
    settings = TrainSettings(size=args.size, steps=args.steps, lr=args.lr)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    model, _, history = train_roma(settings, seed=args.seed, checkpoint_to=args.out,
                                   device=args.device)
    save_roma_weights(args.out, model)
    print(f"saved {args.out}; final EPE {history[-1]:.4f}")


if __name__ == "__main__":
    main()
