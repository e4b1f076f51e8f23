"""DIPs descriptors over grid-sampled LRF patches.

Port of the accelerator branch of
``fusion4landslide_tpu.pipelines.f2s3.compute_dips_features``
(reference src/f2s3.py:91-154 + src/data_loader.py:42-106): one radius
sampler sweep (kernel 1, ``'random'`` priority, seed 0 — the sampler's
fixed seed matches the reference's ``setup_seed(0)``) draws each patch's
in-radius subset, then LRF + PointNet run in chunks.

The whole padded query cloud is sorted and blocked ONCE, exactly as the
window prologue does (kernel 1 centres on each 512-query block's mean, so
re-blocking per chunk would move borderline radius decisions); the kernel
and the network then run over consecutive ranges of those blocks, so the
whole-cloud (n, P, 3) sampler output never exists at once. Rows at or past
``n_core`` (padding) skip the network and get zero descriptors.
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid
from fusion4landslide_tpu_torch.ops.hashgrid_cuda import (
    block_centres,
    radius_sample_blocks,
    window_prologue,
)
from fusion4landslide_tpu_torch.ops.lrf import lrf_patches_from_neighbors
from fusion4landslide_tpu_torch.ops.segments import bucket_size

__all__ = ["compute_dips_features"]

#: Query blocks per sampler launch (65536 queries at block 512).
_SAMPLE_BLOCKS = 128


@torch.inference_mode()
def compute_dips_features(model, core_pts, halo_pts, radius, *,
                          patch_points: int = 256, chunk: int = 2048,
                          halo_mask=None, n_core=None):
    """((n, 64) descriptors of ``core_pts`` with patches from ``halo_pts``,
    () sampler window overflow count). ``n_core``: exclusive bound on the
    valid query rows (padded clouds); rows at or past it get zeros."""
    if patch_points % 128:
        raise NotImplementedError("patch_points must be a multiple of 128")
    n = core_pts.shape[0]
    dev = core_pts.device
    nb = max(bucket_size(n), chunk)
    nb = -(-nb // chunk) * chunk
    q = torch.cat([core_pts, core_pts.new_zeros((nb - n, 3))])
    m = halo_pts.shape[0]
    mb = bucket_size(m)
    halo_p = torch.cat([halo_pts, halo_pts.new_zeros((mb - m, 3))])
    hmask = (
        torch.ones((m,), dtype=torch.bool, device=dev)
        if halo_mask is None
        else halo_mask.to(torch.bool)
    )
    hmask_p = torch.cat([hmask, hmask.new_zeros((mb - m,))])
    radius_q = torch.as_tensor(radius, dtype=torch.float32, device=dev)

    grid = build_hash_grid(halo_p, radius_q, hmask_p)
    win = window_prologue(q, grid)
    cen = block_centres(win)
    r2 = radius_q**2
    n_valid = n if n_core is None else int(n_core)
    feats = torch.zeros((n, 64), dtype=torch.float32, device=dev)
    for b0 in range(0, win.nb, _SAMPLE_BLOCKS):
        b1 = min(win.nb, b0 + _SAMPLE_BLOCKS)
        rows = win.qrow[b0 * win.block:b1 * win.block].long()
        keep = (rows >= 0) & (rows < n_valid)
        if not bool(keep.any()):
            continue
        _, valid, xyz = radius_sample_blocks(
            win, cen, r2, patch_points, 0, "random", b0=b0, b1=b1
        )
        sel = torch.nonzero(keep).squeeze(1)
        qpos = win.qpos[b0 * win.block:b1 * win.block]
        for c0 in range(0, sel.shape[0], chunk):
            s = sel[c0:c0 + chunk]
            patches = lrf_patches_from_neighbors(qpos[s], xyz[s], valid[s], radius_q)
            feats[rows[s]] = model(patches)
    return feats, win.overflow
