"""The F2S3 tile step on one device, and helpers shared by the tile steps.

Port of ``fusion4landslide_tpu.pipelines.f2s3_device``: ``f2s3_tile_step``
(median resolution -> DIPs descriptors -> supervoxels of the source ->
feature-space 1-NN -> learned per-supervoxel pruning -> magnitude gate ->
C2C spatial 1-NN) on padded, centred tile tensors, following the JAX
step's accelerator branch; ``dips_features_device``,
``masked_median`` (also used by the fusion step), and
``drop_small_and_compact`` (defined in ``pipelines.f2s3``).

``dips_features_device`` takes the JAX function's branches: patch sizes
that are multiples of 128 run kernel 1 (``compute_dips_features``), as on
a TPU; other sizes take the traced grid branches, ``sample_priority``
``'knn'`` (the ``k_max`` nearest in-radius points, then a random subset)
or ``'random'`` (a hash-priority ball sample of a permuted support). The
JAX step's ``jax.random`` draws become ``DipsDraws`` inputs, or draws from
a ``torch.Generator`` seeded with ``rng_seed``.

Fixed-shape conventions as in the JAX step: supervoxel buckets use static
caps ``(sv_cap, member_cap)``; supervoxels past the cap, or members past
``member_cap``, fall out of the learned filter (``keep=False``) and are
counted in ``n_dropped``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.models.dips import feat_torch_dtype
from fusion4landslide_tpu_torch.ops.hashgrid import (
    build_hash_grid,
    knn_grid_traced,
    median_nn_distance_traced,
    radius_sample_grid,
)
from fusion4landslide_tpu_torch.ops.knn import nn1
from fusion4landslide_tpu_torch.ops.lrf import lrf_patches_from_knn, lrf_patches_from_neighbors
from fusion4landslide_tpu_torch.ops.segments import label_members
from fusion4landslide_tpu_torch.ops.supervoxel import (
    supervoxel_graph,
    supervoxel_segmentation,
)
from fusion4landslide_tpu_torch.pipelines.f2s3 import (
    DipsDraws,
    chunk_priorities,
    compute_dips_features,
    drop_small_and_compact,
    filter_supervoxel_buckets,
)
from fusion4landslide_tpu_torch.utils.profiling import tile
from fusion4landslide_tpu_torch.utils.timing import StageTimer

__all__ = [
    "F2S3TileResult",
    "dips_features_device",
    "drop_small_and_compact",
    "f2s3_tile_step",
    "masked_median",
]


def masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of ``vals`` over ``valid`` rows."""
    s = torch.sort(torch.where(valid, vals, torch.inf)).values
    cnt = valid.sum()
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=0)
    return 0.5 * (s[lo] + s[hi])


@torch.inference_mode()
def dips_features_device(model, query, support, support_mask, radius, *, k_max: int = 512,
                         patch_points: int = 256, chunk: int = 2048, sample_cap: int = 48,
                         sample_priority: str = "knn", dtype=None, query_count=None,
                         draws: DipsDraws | None = None, generator=None):
    """((n, 64) DIPs descriptors of a padded query cloud, () sampler
    overflow count); rows at or past ``query_count`` are zero and their
    chunks skip the network.

    ``patch_points`` a multiple of 128: kernel 1 (``compute_dips_features``;
    the count is of truncated window blocks). Otherwise, over the query
    cloud zero-padded to whole chunks (JAX ``pipelines/f2s3_device.py:
    145-196``):

    - ``'knn'``: one ``knn_grid_traced`` of every query for its ``k_max``
      nearest in-radius supports (``r_max`` = the patch radius, ``cap`` =
      max(``sample_cap``, ceil(k_max / 27))), then per chunk
      ``lrf_patches_from_knn`` with that chunk's (chunk, k_max) priorities
      and the network;
    - ``'random'``: the support permuted by ``draws.perm``, one grid over
      it, and per chunk ``radius_sample_grid`` (``cap`` = ``sample_cap``,
      hash seed ``draws.seed``), the LRF and the network.

    Any ``sample_priority`` but 'random' takes the 'knn' branch, as in
    JAX. The grid branches count truncated cell runs. Draws not given come
    from ``generator``."""
    if patch_points % 128 == 0:
        return compute_dips_features(
            model, query, support, radius, patch_points=patch_points, chunk=chunk,
            halo_mask=support_mask, n_core=query_count, dtype=dtype,
        )
    tdt = feat_torch_dtype(dtype)
    n, m = query.shape[0], support.shape[0]
    dev = query.device
    chunk = min(chunk, n)
    nv = n if query_count is None else int(query_count)
    q = torch.cat([query, query.new_zeros(((-n) % chunk, 3))])
    feats = torch.zeros((n, 64), dtype=torch.float32, device=dev)
    draws = draws or DipsDraws()

    def put(c0, patches):
        feats[c0:c0 + chunk] = model(patches, tdt)[:n - c0]

    if sample_priority == "random":
        perm = draws.perm
        if perm is None:
            perm = torch.randperm(m, generator=generator, device=dev)
        seed = draws.seed
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator, device=dev))
        perm = perm.to(dev).long()
        msk = None if support_mask is None else support_mask.to(torch.bool)[perm]
        grid = build_hash_grid(support[perm], radius, msk)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        for c0 in range(0, min(nv, n), chunk):
            qc = q[c0:c0 + chunk]
            coords, valid, ov = radius_sample_grid(qc, grid, radius, seed, num_samples=patch_points,
                                                   cap=sample_cap, query_block=chunk)
            overflow = overflow + ov
            put(c0, lrf_patches_from_neighbors(qc, coords, valid, radius))
    else:
        sqd, idx, overflow = knn_grid_traced(q, support, k_max, ref_mask=support_mask,
                                             r_max=radius, cap=max(sample_cap, -(-k_max // 27)))
        for c0 in range(0, min(nv, n), chunk):
            sl = slice(c0, c0 + chunk)
            put(c0, lrf_patches_from_knn(q[sl], support, sqd[sl], idx[sl], radius,
                                         chunk_priorities(draws, c0, chunk),
                                         num_points=patch_points, generator=generator))
        del sqd, idx
    feats[nv:] = 0.0
    return feats, overflow


class F2S3TileResult(NamedTuple):
    new_tgt: torch.Tensor  # (N, 3) matched / rigid-predicted target per src point
    keep: torch.Tensor  # (N,) survived learned pruning + max-magnitude gate
    mag: torch.Tensor  # (N,) |new_tgt - src| (0 where not kept)
    nn_tgt: torch.Tensor  # (N, 3) pre-pruning 1-NN target
    labels: torch.Tensor  # (N,) supervoxel label per src point (-1 dropped)
    median_res: torch.Tensor  # () max(src, tgt) median resolution
    c2c: torch.Tensor  # (N,) spatial 1-NN distance src -> tgt (inf if disabled)
    n_dropped: torch.Tensor  # () points lost to the static supervoxel caps
    overflow: int  # grid-window blocks truncated to the window, this step
    overflow_by_source: dict | None = None  # overflow split: {"sampler", "grid_knn"}


def _count_bound(mask: torch.Tensor) -> int:
    """Last valid row + 1 (not the mask sum, which undercounts a mask with
    interior holes)."""
    idx = torch.arange(1, mask.shape[0] + 1, device=mask.device)
    return int(torch.where(mask, idx, 0).max())


@tile("tile.f2s3_step")
@torch.inference_mode()
def f2s3_tile_step(
    dips,
    filt,
    src: torch.Tensor,
    smask: torch.Tensor,
    tgt: torch.Tensor,
    tmask: torch.Tensor,
    max_disp: float = 0.0,
    voxel_size: float = 0.0,
    *,
    k_max: int = 512,
    patch_points: int = 256,
    chunk: int = 2048,
    k_neighbors: int = 30,
    sv_cap: int = 1024,
    member_cap: int = 512,
    rockfall: bool = False,
    refine_results: bool = True,
    small_patch_removal: bool = True,
    with_c2c: bool = True,
    feat_dtype: str | None = None,
    sample_cap: int = 48,
    sample_priority: str = "knn",
    dips_draws: tuple[DipsDraws | None, DipsDraws | None] | None = None,
    rng_seed: int = 0,
    timings: dict | None = None,
    device=None,
) -> F2S3TileResult:
    """One F2S3 tile: padded, centred (N, 3) ``src`` / (M, 3) ``tgt``
    clouds with masks, on ``device`` (default ``cuda``; a CUDA run without
    a card raises). ``dips`` is the PointNetFeature module, ``filt`` the
    FilteringNetwork (its depth is the module's). ``max_disp`` <= 0
    disables the magnitude gate; ``rockfall`` pins the supervoxel radius
    to 0.1 (f2s3.py:185-186).

    ``k_max``, ``sample_cap`` and ``sample_priority`` select and size the
    DIPs grid branches for patch sizes that are not a multiple of 128
    (``dips_features_device``); ``feat_dtype`` 'bfloat16' runs the
    PointNet trunks in bf16. The JAX step splits its PRNG key into the two
    clouds' draws: here ``dips_draws`` (source, target) gives them, and
    draws not given come from one ``torch.Generator`` on the device seeded
    with ``rng_seed`` (the source's first). Each stage is a span
    (``utils.timing``); ``timings`` (optional dict) accumulates per-stage
    seconds, synchronising the device at each stage boundary, and the
    kernels' work under ``counters`` (``utils.profiling``).
    """
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    smask = torch.as_tensor(smask, device=dev).to(torch.bool)
    tmask = torch.as_tensor(tmask, device=dev).to(torch.bool)
    dips, filt = dips.to(dev), filt.to(dev)
    f32 = src.dtype
    stages = StageTimer(timings, dev)
    with stages.stage("median_res"):
        n = src.shape[0]

        # 1. median resolution -> patch radius (f2s3.py:106, 481-507).
        med_s, ov_s = median_nn_distance_traced(src, smask)
        med_t, ov_t = median_nn_distance_traced(tgt, tmask)
        median_res = torch.maximum(med_s, med_t)
        ov_grid = ov_s + ov_t
        radius = torch.sqrt(torch.tensor(3.0, dtype=f32, device=dev)) * 10.0 * median_res

    with stages.stage("dips_features"):
        # 2. DIPs descriptors (f2s3.py:91-154); rows past the last valid one
        # skip the network.
        feat_kw = dict(k_max=k_max, patch_points=patch_points, chunk=chunk, sample_cap=sample_cap,
                       sample_priority=sample_priority, dtype=feat_dtype,
                       generator=torch.Generator(device=dev).manual_seed(rng_seed))
        draws_s, draws_t = dips_draws or (None, None)
        src_feat, ov_s = dips_features_device(dips, src, src, smask, radius, draws=draws_s,
                                              query_count=_count_bound(smask), **feat_kw)
        tgt_feat, ov_t = dips_features_device(dips, tgt, tgt, tmask, radius, draws=draws_t,
                                              query_count=_count_bound(tmask), **feat_kw)
        ov_sampler = ov_s + ov_t

    with stages.stage("supervoxels"):
        # 3. Supervoxels of the source (f2s3.py:183-189), small patches out.
        if rockfall:
            svl_radius = torch.tensor(0.1, dtype=f32, device=dev)
        else:
            svl_radius = torch.clamp(radius, min=float(voxel_size))
        gi, gm, ov = supervoxel_graph(src, svl_radius, smask, k_neighbors=k_neighbors)
        ov_sampler = ov_sampler + ov
        seg = supervoxel_segmentation(src, svl_radius, smask, neigh_idx=gi, neigh_mask=gm)
        labels, _ = drop_small_and_compact(seg.labels, smask, 10 if small_patch_removal else 1)

    with stages.stage("feature_nn1"):
        # 4. Feature-space 1-NN (f2s3.py:273-285) through kernel 3; padded
        # target rows masked.
        nn_sq, nn_idx = nn1(src_feat, tgt_feat, tmask)
        nn_tgt = tgt[nn_idx.long()]
        nn_ok = smask & torch.isfinite(nn_sq)
        correspondences = torch.cat([src, nn_tgt], dim=1)

    with stages.stage("filter"):
        # 5. Per-supervoxel learned pruning (f2s3.py:321-366).
        member_idx, member_mask = label_members(labels, sv_cap, member_cap)
        new_tgt_b, keep_b, scores_b, _ = filter_supervoxel_buckets(
            filt, correspondences, member_idx, member_mask, rockfall=rockfall
        )
        if not refine_results:
            keep_b = member_mask & (scores_b > 0.99999)
            new_tgt_b = correspondences[member_idx.long()][..., 3:6]
        rows = member_idx[member_mask].long()
        new_tgt = nn_tgt.clone()
        new_tgt[rows] = new_tgt_b[member_mask]
        keep = torch.zeros((n,), dtype=torch.bool, device=dev)
        keep[rows] = keep_b[member_mask]
        keep = keep & nn_ok
        in_filter = torch.zeros((n,), dtype=torch.bool, device=dev)
        in_filter[rows] = True
        n_dropped = (smask & (labels >= 0) & ~in_filter).sum()

    with stages.stage("gates"):
        # 6. Max-magnitude gate (f2s3.py:392-394).
        mag = torch.linalg.norm(new_tgt - src, dim=-1)
        keep = keep & ((max_disp <= 0) | (mag <= max_disp))
        mag = torch.where(keep, mag, 0.0)

    with stages.stage("c2c"):
        # 7. C2C spatial 1-NN for the gap fill (f2s3.py:452-477).
        if with_c2c:
            c2c_sq, _, ov = knn_grid_traced(
                src, tgt, 1, r0=4.0 * median_res, ref_mask=tmask, query_mask=smask,
                max_doublings=10,
            )
            ov_grid = ov_grid + ov
            c2c = torch.sqrt(c2c_sq[:, 0])
        else:
            c2c = torch.full((n,), torch.inf, dtype=f32, device=dev)

    return F2S3TileResult(
        new_tgt=new_tgt, keep=keep, mag=mag, nn_tgt=nn_tgt, labels=labels,
        median_res=median_res, c2c=c2c, n_dropped=n_dropped,
        overflow=int(ov_sampler + ov_grid),
        overflow_by_source={"sampler": int(ov_sampler), "grid_knn": int(ov_grid)},
    )
