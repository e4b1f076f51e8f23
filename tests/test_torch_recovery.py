"""Recovery of the planted shift with seeded random weights: the port's CPU
step against the JAX step (TPU branch emulated on the CPU) on a symmetric
split tile at the production density (100 pts/m^2) and the production
statics of ``configs/landslide/fusion_3d_brienz.yaml``.

``chip_smoke.py`` runs the production tile with ``seeded_models(0)`` and
holds its recovery to floors; this witness measures, on a reduced tile of
the same geometry and with the same weights (bridged to Flax), what the
reference reaches and what broken runs of the port reach. Run it as a
script from the repository root (one JSON line per run):

    PYTHONPATH=. python tests/test_torch_recovery.py --n-core 10000 --margin 5

(minutes on the CPU). The port's runs also go on a card, at the
production tile's full size (JAX is not needed for them):

    PYTHONPATH=. python tests/test_torch_recovery.py --device cuda \
        --n-core 250000 --margin 10 --halo 20 --chunk 2048 \
        --runs port port:no_icp port:tgt_seed

Runs: ``jax`` (the reference, emulated TPU branch), ``port`` (the port's
CPU path), ``port:no_icp`` (fine stage without ICP refinement),
``port:tgt_seed`` (the target cloud's patch sampler draws with another
seed, so the two epochs' descriptors stop corresponding) and ``stages``
(each stage of the port's step replayed through its JAX twin on the
same inputs, see ``stages``; the median resolution is the first).

Three readings of the median resolution, which the voxel grid and every
later stage follow: ``port:jax_median`` (the port's step fed the JAX
step's median of the same clouds, its ``median_nn_distance_traced`` with
the TPU branch emulated; CPU only, as it runs JAX),
``port:exact_median`` (the median through the gather join
``hash_grid_knn_join``, squared distances from coordinate differences,
where kernel 2 forms the uncentred score) and ``port:median_nudge`` (the
sound run's median scaled by 1 + 3e-4, ``NUDGE``; ``port:median_nudge=-3e-4``
scales it by 1 - 3e-4):

    PYTHONPATH=. python tests/test_torch_recovery.py --n-core 10000 \
        --margin 10 --halo 20 --runs jax port port:jax_median stages
    PYTHONPATH=. python tests/test_torch_recovery.py --device cuda \
        --n-core 1000000 --margin 10 --halo 20 --chunk 2048 --runs port \
        port:exact_median port:median_nudge port:median_nudge=-3e-4

``--pipeline f2s3`` runs the F2S3 step instead (``f2s3_brienz.yaml``
statics, ``seeded_models(0)`` and ``seeded_filter(0)``); "assigned" then
reads "kept by the learned filter". Runs: ``jax``, ``port``,
``port:no_refine`` (``refine_results: false``: only scores > 0.99999
survive, no rigid re-fit) and ``port:tgt_shuffle`` (the target
descriptors permuted, so feature matches are random):

    PYTHONPATH=. python tests/test_torch_recovery.py --pipeline f2s3 \
        --device cuda --n-core 250000 --margin 10 --halo 20 --chunk 2048 \
        --runs port port:no_refine port:tgt_shuffle

``--pipeline fusion_rgb`` runs the RGB+3D fusion step (the
``fusion_brienz.yaml`` statics) on ``bench.py``'s RGB tile: source margin
half the target margin, a nadir 4096^2 camera and pixel matches for half
the source points (``synth_rgb_tile``). Runs: ``jax``, ``port`` and
``port:pix_shuffle`` (the matches' target endpoints permuted across rows,
so every 2D match is wrong); "assigned" and the errors are then held to
``bench.py``'s targets, which the JSON line states:

    PYTHONPATH=. python tests/test_torch_recovery.py --pipeline fusion_rgb \
        --device cuda --n-core 250000 --margin 10 --halo 20 --chunk 2048 \
        --runs port port:pix_shuffle

``--pipeline fusion_host`` runs the host fusion tile (``run_fusion3d_tile``,
what ``main_fusion`` runs per tile on one device) on the tiles the driver
cuts from ``synth_epoch_pair(width, height)``: the port's tiler with the
shipped configs' 0.1 m voxel filter, ``--max-pts`` per tile and the +-20 m
halo, then the driver's core/halo crop (5 m / 10 m), with the
``fusion_3d_brienz.yaml`` config as the driver loads it. Readings are per
tile on its core, as ``chip_smoke.py``'s driver phase reads its tables.
Runs: ``jax``, ``port``, ``port:no_icp`` (``icp_refine: false``),
``port:tgt_seed`` and ``port:tgt_shuffle`` (the target voxels'
descriptors permuted). ``--pipeline f2s3_host`` does the same for the
host F2S3 tile (``f2s3_brienz.yaml``; runs ``port:no_refine``,
``port:tgt_shuffle``). On the CPU at a reduced epoch, and on a card at
the driver phases' epoch (``chip_smoke.py``'s ``CLI_EPOCH``: 145 m x 50 m
cut by ``max_pts_per_tile`` 400 000), whose readings place
``chip_smoke.py``'s ``RECOVERY_CLI`` and ``RECOVERY_CLI_F2S3`` floors:

    PYTHONPATH=. python tests/test_torch_recovery.py --pipeline fusion_host \
        --epoch 40 25 --max-pts 50000 --runs jax port
    PYTHONPATH=. python tests/test_torch_recovery.py --pipeline fusion_host \
        --device cuda --epoch 145 50 --max-pts 400000 \
        --runs port port:no_icp port:tgt_seed port:tgt_shuffle
    PYTHONPATH=. python tests/test_torch_recovery.py --pipeline f2s3_host \
        --device cuda --epoch 145 50 --max-pts 400000 \
        --runs port port:no_refine port:tgt_shuffle
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time

import numpy as np
import pytest
import torch
import yaml
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models.convert import (
    params_from_flax,
    seeded_filter,
    seeded_models,
)
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.parallel.pipeline import f2s3_statics, fusion3d_statics
from fusion4landslide_tpu_torch.synth import (
    DRIVER_EPOCH,
    PLANTED_SHIFT,
    synth_epoch_pair,
    synth_rgb_tile,
    synth_split_tile,
)

#: ``chip_smoke.py``'s production config (fusion_3d_brienz.yaml statics).
CFG = {
    "level_of_superpoint": [1, 2, 3], "feat_patch_points": 256, "feat_chunk": 2048,
    "member_cap": 512, "agg_max_points": 512, "num_min_matches_for_small_patch": 10,
    "fine_max_matches": 256, "global_matching_gated": True, "output_tgt2src": False,
}
SCALARS = (5.0, 0.1, 0.1, 10, 10, 0.5, 0.15)
#: The RGB channel's settings of ``configs/landslide/fusion_brienz.yaml``,
#: on ``bench.py``'s 4096^2 camera.
RGB_CFG = {
    "dataset": "brienz_tls", "use_2d_matches": True, "image_size": [4096, 4096],
    "pixel_thres": 5, "lifting_type": "nn_search", "matches_from_2d_type": "nn_src_only",
    "coarse_matching_fusion": True, "fine_matching_fusion": True, "weighting_svd": False,
}
#: ``chip_smoke.py``'s F2S3 config (f2s3_brienz.yaml statics) and its
#: step scalars (max_disp_magnitude, voxel_size).
F2S3_CFG = {
    "n_normals": 30, "fill_gaps_c2c": True, "refine_results": True,
    "small_patch_removal": True, "feat_patch_points": 256,
}
F2S3_SCALARS = (5.0, 0.1)
#: Config keys set from the command line (``--set KEY=VALUE``) over
#: ``CFG`` / ``F2S3_CFG`` / the host tiles' YAML, in every run.
OVERRIDES: dict = {}


def flax_from_state_dict(sd: dict) -> dict:
    """Flax parameter tree (numpy leaves) of a port state dict: the
    inverse of ``state_dict_from_flax``."""
    tree: dict = {}
    for key, val in sd.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", arr.T.copy()
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return {"params": tree}


def recovery(valid, moved, src, core, moving) -> dict:
    """chip_smoke.py's recovery readings from a step's (n,) ``valid`` and
    (n, 3) ``moved`` (centred frame) for the (n, 3) centred ``src``."""
    disp = np.where(valid[:, None], moved - src, 0.0)
    static = core & ~moving
    err_mov = np.linalg.norm(disp[core & moving & valid] - PLANTED_SHIFT, axis=1)
    err_sta = np.linalg.norm(disp[static & valid], axis=1)
    return {
        "static_assigned": float(valid[static].mean()),
        "core_assigned": float(valid[core].mean()),
        "static_err_m": float(np.median(err_sta)) if err_sta.size else None,
        "moving_err_m": float(np.median(err_mov)) if err_mov.size else None,
    }


def split_tile(n_core: int, margin: float, halo: float | None = None):
    """The symmetric split tile of ``chip_smoke.py`` at density 100
    (``halo`` defaults to ``margin``: the cropped ring is the same)."""
    halo = margin if halo is None else halo
    src, tgt, core, moving = synth_split_tile(n_core, margin, margin, halo=halo)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    return dict(n=n, m=m, sb=sb, tb=tb, sm=np.arange(N) < n, tm=np.arange(M) < m,
                core=core, moving=moving)


def rgb_tile(n_core: int, margin: float, halo: float | None = None):
    """``bench.py``'s RGB tile: source margin ``margin / 2``, target margin
    ``margin``, pixel matches for half the source points; the step's image
    inputs under ``images`` and ``bench.py``'s tolerance under ``tol``."""
    halo = margin if halo is None else halo
    src, tgt, core, moving, pix, K, E, m_per_px = synth_rgb_tile(n_core, margin / 2, margin, halo=halo)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    pixb = np.zeros((1, bucket_size(len(pix)), 4), np.float32)
    pixb[0, : len(pix)] = pix
    images = dict(pix_matches=pixb, pix_count=np.array([len(pix)], np.int32), intrinsic=K,
                  src_extrinsics=E[None], tgt_extrinsics=E[None],
                  center=c.astype(np.float32), pixel_thres=5.0)
    return dict(n=n, m=m, sb=sb, tb=tb, sm=np.arange(N) < n, tm=np.arange(M) < m,
                core=core, moving=moving, images=images, tol=2e-3 + 0.7 * m_per_px)


@contextlib.contextmanager
def _peak(device: str):
    """Yields a dict that gets ``peak_gib``, the run's peak device memory,
    when ``device`` is a CUDA device (nothing on the CPU)."""
    got: dict = {}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    yield got
    if cuda:
        torch.cuda.synchronize(device)
        got["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30


@contextlib.contextmanager
def tpu_branch_emulated():
    """The JAX package's TPU branch on the CPU (Pallas in interpret mode)."""
    import jax

    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_pallas, "pallas_available", lambda: True)
        for mod, name in (
            (hashgrid_pallas, "radius_sample_window"),
            (hashgrid_pallas, "hash_grid_knn_window"),
            (knn_pallas, "knn_pallas"),
        ):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        yield
    jax.clear_caches()


@contextlib.contextmanager
def _fault(name: str | None):
    """Broken variants of the port's step, for the witness's broken runs."""
    with pytest.MonkeyPatch.context() as mp:
        if name == "tgt_seed":
            from fusion4landslide_tpu_torch.pipelines import f2s3

            calls = {"clouds": 0}
            sample = f2s3.radius_sample_blocks
            dips = f2s3.compute_dips_features

            def counted(*a, **kw):
                calls["clouds"] += 1
                return dips(*a, **kw)

            def reseeded(win, cen, r2, P, seed, *a, **kw):
                return sample(win, cen, r2, P, seed + calls["clouds"] - 1, *a, **kw)

            mp.setattr(f2s3, "radius_sample_blocks", reseeded)
            from fusion4landslide_tpu_torch.pipelines import f2s3_device

            mp.setattr(f2s3_device, "compute_dips_features", counted)
            from fusion4landslide_tpu_torch.pipelines import fusion

            mp.setattr(fusion, "compute_dips_features", counted)
        elif name == "tgt_shuffle":
            from fusion4landslide_tpu_torch.pipelines import f2s3_device

            feats = f2s3_device.dips_features_device
            calls = {"clouds": 0}

            def shuffled(*a, query_count=None, **kw):
                out, overflow = feats(*a, query_count=query_count, **kw)
                calls["clouds"] += 1
                if calls["clouds"] == 2:  # the target cloud
                    gen = torch.Generator().manual_seed(0)
                    perm = torch.randperm(int(query_count), generator=gen).to(out.device)
                    out[: int(query_count)] = out[perm]
                return out, overflow

            mp.setattr(f2s3_device, "dips_features_device", shuffled)
            # The host tiles: the second descriptor call is the target's.
            from fusion4landslide_tpu_torch.pipelines import f2s3, fusion

            host_calls = {"clouds": 0}

            def host_shuffled(fn):
                def wrapped(*a, **kw):
                    out, overflow = fn(*a, **kw)
                    host_calls["clouds"] += 1
                    if host_calls["clouds"] == 2:
                        gen = torch.Generator().manual_seed(0)
                        out = out[torch.randperm(out.shape[0], generator=gen).to(out.device)]
                    return out, overflow
                return wrapped

            for mod in (f2s3, fusion):
                mp.setattr(mod, "compute_dips_features", host_shuffled(mod.compute_dips_features))
        elif name in ("jax_median", "exact_median") or str(name).startswith("median_nudge"):
            from fusion4landslide_tpu_torch.pipelines import fusion_device

            if name == "jax_median":
                median = jax_median_traced
            elif name == "exact_median":
                median = exact_median_traced
            else:
                rel = float(name.partition("=")[2] or NUDGE)
                median = functools.partial(nudged_median_traced, rel=rel,
                                           median=fusion_device.median_nn_distance_traced)
            mp.setattr(fusion_device, "median_nn_distance_traced", median)
        elif name not in (None, "no_icp", "no_refine"):
            raise ValueError(f"unknown fault {name!r}")
        yield


#: The relative parting of the two packages' median resolutions on the
#: 10 000-point core's split tile (0.0561162 m against JAX's 0.0561332 m),
#: by which ``port:median_nudge`` scales the port's.
NUDGE = 3e-4


def jax_median_traced(points, mask=None):
    """The JAX step's median resolution of the same cloud (its
    ``median_nn_distance_traced``, TPU branch emulated), in the port's
    return form (median, overflow 0)."""
    import jax.numpy as jnp

    from fusion4landslide_tpu.ops.hashgrid import median_nn_distance_traced

    with tpu_branch_emulated():
        med = float(median_nn_distance_traced(jnp.asarray(points.cpu().numpy()),
                                              jnp.asarray(mask.cpu().numpy())))
    return (torch.tensor(med, dtype=points.dtype, device=points.device),
            torch.zeros((), dtype=torch.int32, device=points.device))


def exact_median_traced(points, mask=None, *, max_doublings: int = 8):
    """``median_nn_distance_traced``'s radius loop with each 1-NN through
    the gather join ``hash_grid_knn_join`` (squared distances from
    coordinate differences, no window), its cap the longest cell run, so
    no run is cut and every in-radius neighbour is scored."""
    from fusion4landslide_tpu_torch.ops.hashgrid import (
        _density_radius,
        _masked_median,
        build_hash_grid,
        hash_grid_knn_join,
    )

    valid = mask.to(torch.bool)
    cnt = int(torch.clamp(valid.sum(), min=1))
    radius = _density_radius(points, valid)
    med = torch.tensor(torch.inf, dtype=points.dtype, device=points.device)
    found, it = 0, 0
    while 2 * found <= cnt and it < max_doublings:
        grid = build_hash_grid(points, radius, valid)
        runs = grid.starts[1:-1].long() - grid.starts[:-2].long()  # the dump cell left out
        cap = -(-int(runs.max()) // 32) * 32
        d, _, ov = hash_grid_knn_join(points, grid, radius, 1, cap=cap, exclude_self=True)
        assert int(ov) == 0, ov
        dd = torch.sqrt(d[:, 0])
        ok = valid & torch.isfinite(dd)
        med = _masked_median(dd, ok)
        found = int(ok.sum())
        radius = radius * 2.0
        it += 1
    return med, torch.zeros((), dtype=torch.int32, device=points.device)


def nudged_median_traced(points, mask=None, *, rel: float, median):
    """``median`` (the port's ``median_nn_distance_traced``) scaled by
    (1 + ``rel``)."""
    med, overflow = median(points, mask)
    return med * (1.0 + rel), overflow


def run(kind: str, tile: dict, device: str = "cpu", chunk: int = 512) -> dict:
    """One run (``jax``, ``port`` or ``port:<fault>``) on ``tile`` with
    ``seeded_models(0)``; returns its recovery readings. The port's
    runs go on ``device``; the JAX run is always the emulated CPU one.
    ``chunk`` (DIPs network rows per call) bounds memory; chip_smoke.py
    uses 2048. A tile with ``images`` runs the RGB+3D step."""
    N, M, n = tile["sb"].shape[0], tile["tb"].shape[0], tile["n"]
    images = dict(tile.get("images", {}))
    cfg = {**CFG, **(RGB_CFG if images else {}), "feat_chunk": chunk, **OVERRIDES}
    statics = fusion3d_statics(cfg, N, M, with_image=bool(images))
    td, ta = seeded_models(0, "cpu")
    fault = kind.split(":", 1)[1] if ":" in kind else None
    if fault == "no_icp":
        statics["icp_max_iter"] = 0
    elif fault == "pix_shuffle":
        pix = images["pix_matches"].copy()
        cnt = int(images["pix_count"][0])
        perm = np.random.default_rng(0).permutation(cnt)
        pix[0, :cnt, 2:] = pix[0, perm, 2:]
        images["pix_matches"] = pix
        fault = None
    t0 = time.perf_counter()
    if kind == "jax":
        import jax

        from fusion4landslide_tpu.pipelines.fusion_device import fusion3d_tile_step

        with tpu_branch_emulated():
            out = fusion3d_tile_step(
                flax_from_state_dict(td.state_dict()), flax_from_state_dict(ta.state_dict()),
                tile["sb"], tile["sm"], tile["tb"], tile["tm"], jax.random.PRNGKey(0),
                *SCALARS, **images, **statics,
            )
            valid, moved = np.asarray(out.valid[:n]), np.asarray(out.moved[:n])
            extra = dict(n_vox=[int(out.n_vox_src), int(out.n_vox_tgt)],
                         median_res=float(out.median_res))
    else:
        from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

        stages: dict = {}
        with _fault(fault), _peak(device) as peak:
            out = fusion3d_tile_step(
                td, ta, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
                torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *SCALARS,
                device=device, timings=stages,
                **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in images.items()}, **statics,
            )
        valid, moved = out.valid[:n].cpu().numpy(), out.moved[:n].cpu().numpy()
        extra = dict(n_vox=[int(out.n_vox_src), int(out.n_vox_tgt)],
                     median_res=float(out.median_res), overflow=out.overflow,
                     stages_s=stages, **peak)
    extra["n_c2d"] = int(out.n_c2d)
    rec = recovery(valid, moved, tile["sb"][:n], tile["core"], tile["moving"])
    if images:
        extra["bench_targets"] = {"core_assigned": 0.9, "err_m": tile["tol"]}
    return {"run": kind, **rec, **extra, "valid": valid, "moved": moved,
            "seconds": time.perf_counter() - t0}


def run_f2s3(kind: str, tile: dict, device: str = "cpu", chunk: int = 512) -> dict:
    """One F2S3 run (``jax``, ``port`` or ``port:<fault>``) on ``tile``
    with ``seeded_models(0)`` and ``seeded_filter(0)``; returns its
    recovery readings over the points the filter kept."""
    N, M, n = tile["sb"].shape[0], tile["tb"].shape[0], tile["n"]
    statics = f2s3_statics({**F2S3_CFG, "feat_chunk": chunk, **OVERRIDES}, N, M)
    td, _ = seeded_models(0, "cpu")
    tf = seeded_filter(0, "cpu")
    fault = kind.split(":", 1)[1] if ":" in kind else None
    if fault == "no_refine":
        statics["refine_results"] = False
    t0 = time.perf_counter()
    if kind == "jax":
        import jax

        from fusion4landslide_tpu.pipelines.f2s3_device import f2s3_tile_step

        with tpu_branch_emulated():
            out = f2s3_tile_step(
                flax_from_state_dict(td.state_dict()), flax_from_state_dict(tf.state_dict()),
                tile["sb"], tile["sm"], tile["tb"], tile["tm"], jax.random.PRNGKey(0),
                *F2S3_SCALARS, num_layers=tf.num_layers,
                **{k: v for k, v in statics.items() if k != "feat_dtype"},
            )
            keep, moved = np.asarray(out.keep[:n]), np.asarray(out.new_tgt[:n])
    else:
        from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step

        stages: dict = {}
        with _fault(fault), _peak(device) as peak:
            out = f2s3_tile_step(
                td, tf, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
                torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *F2S3_SCALARS,
                device=device, timings=stages, **statics,
            )
        keep, moved = out.keep[:n].cpu().numpy(), out.new_tgt[:n].cpu().numpy()
        extra = dict(stages_s=stages, **peak)
    rec = recovery(keep, moved, tile["sb"][:n], tile["core"], tile["moving"])
    return {"run": "f2s3:" + kind, **rec, "kept": float(keep.mean()),
            "median_res": float(out.median_res), "valid": keep, "moved": moved,
            "seconds": time.perf_counter() - t0, **(extra if kind != "jax" else {})}


#: Stages of the port's step held against their JAX twins by ``stages``:
#: name in the port's ``fusion_device`` -> JAX module of the same name.
_STAGES = {
    "median_nn_distance_traced": "ops.hashgrid",
    "gated_feature_nn1": "ops.gated_match",
    "supervoxel_graph": "ops.supervoxel",
    "supervoxel_segmentation": "ops.supervoxel",
    "_segment_centroids": "pipelines.fusion_device",
    "drop_small_and_compact": "pipelines.f2s3_device",
    "label_members": "ops.segments",
    "_aggregate_chunked": "pipelines.fusion_device",
    "coarse_match_superpoints_chunked": "pipelines.fusion_device",
    "fine_match_pairs": "pipelines.fusion",
}


def _outputs(name: str, out, port: bool) -> list:
    """A stage's compared outputs; the port's window overflow count,
    which the JAX functions do not return, is left out."""
    if name == "supervoxel_segmentation":
        return [out.labels]
    if name == "fine_match_pairs":
        return [out.valid]  # R, t: compared on the pairs valid on both sides
    if port and name in ("median_nn_distance_traced", "supervoxel_graph", "_segment_centroids"):
        out = out[:-1]
    return list(out) if isinstance(out, tuple) else [out]


def _seed_refit_singular_values(args, kw, pair: int) -> list:
    """Singular values of the first ICP refit's cross-covariance for one
    fine pair (float64): its matched voxels, the Kabsch seed, the 1-NN
    inliers within ``icp_threshold`` under the seed."""
    mem, mm, tl, gi, gv, lt, sv, tv = (np.asarray(a, np.float64) if a.dtype.kind == "f"
                                       else np.asarray(a) for a in
                                       (x.numpy() for x in args[:8]))
    w = gi[mem[pair]]
    mv = mm[pair] & gv[mem[pair]] & (lt[w] == tl[pair])
    a, b = sv[mem[pair][mv]][: kw["fine_max_matches"]], tv[w[mv]][: kw["fine_max_matches"]]

    def fit(x, y):
        cx, cy = x.mean(0), y.mean(0)
        u, _, vt = np.linalg.svd((x - cx).T @ (y - cy))
        d = np.sign(np.linalg.det(vt.T @ u.T))
        rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        return rot, cy - rot @ cx

    rot, tr = fit(a, b)
    d2 = (((a @ rot.T + tr)[:, None] - b[None]) ** 2).sum(-1)
    inl = d2.min(1) <= kw["icp_threshold"] ** 2
    x, y = a[inl], b[d2.argmin(1)[inl]]
    cov = (x - x.mean(0)).T @ (y - y.mean(0))
    return np.linalg.svd(cov, compute_uv=False).tolist()


def stages(tile: dict, chunk: int = 512) -> dict:
    """The port's CPU step once, every call of ``_STAGES`` recorded (the
    median resolution first, one call per cloud); each is then replayed
    through the JAX function of the same name (TPU branch emulated) on the
    SAME inputs, so a disagreement is that stage's own.
    Returns per stage and call: mismatching entries of discrete outputs,
    max |diff| of float outputs; for the fine pairs, mismatches of
    ``valid``, max |dR| and |dt| over the pairs valid on both sides, and
    for each pair whose translations differ by > 1 mm the singular values
    of its first ICP refit."""
    import importlib

    import jax.numpy as jnp

    from fusion4landslide_tpu_torch.pipelines import fusion_device as tfd

    N, M = tile["sb"].shape[0], tile["tb"].shape[0]
    statics = fusion3d_statics({**CFG, "feat_chunk": chunk}, N, M)
    td, ta = seeded_models(0, "cpu")
    fa = flax_from_state_dict(ta.state_dict())
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in _STAGES:
            def rec(*a, _f=getattr(tfd, name), _n=name, **kw):
                out = _f(*a, **kw)
                calls.append((_n, a, kw, out))
                return out
            mp.setattr(tfd, name, rec)
        tfd.fusion3d_tile_step(
            td, ta, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
            torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *SCALARS,
            device="cpu", **statics,
        )

    def to_jax(v):
        if isinstance(v, torch.nn.Module):
            return fa
        if isinstance(v, torch.Tensor):
            arr = v.numpy()
            return jnp.asarray(arr.astype(np.int32) if arr.dtype == np.int64 else arr)
        return v

    report: dict = {}
    with tpu_branch_emulated():
        for name, a, kw, out in calls:
            jfn = getattr(importlib.import_module("fusion4landslide_tpu." + _STAGES[name]), name)
            jout = jfn(*map(to_jax, a), **{k: to_jax(v) for k, v in kw.items()})
            row = []
            for t_v, j_v in zip(_outputs(name, out, True), _outputs(name, jout, False)):
                t_v, j_v = np.asarray(t_v), np.asarray(j_v)
                if t_v.dtype.kind == "f":
                    both = np.isfinite(t_v) & np.isfinite(j_v)
                    row.append(float(np.abs(t_v[both] - j_v[both]).max()) if both.any() else 0.0)
                else:
                    row.append(int((t_v.astype(np.int64) != j_v.astype(np.int64)).sum()))
            if name == "fine_match_pairs":
                ok = out.valid.numpy() & np.asarray(jout.valid)
                dR = np.abs(out.R.numpy() - np.asarray(jout.R)).max((1, 2))[ok]
                dt = np.abs(out.t.numpy() - np.asarray(jout.t)).max(1)
                row += [float(dR.max()) if ok.any() else 0.0,
                        float(dt[ok].max()) if ok.any() else 0.0,
                        {int(p): _seed_refit_singular_values(a, kw, int(p))
                         for p in np.nonzero(ok & (dt > 1e-3))[0]}]
            report.setdefault(name, []).append(row)
    return report


def driver_tiles(width: float, height: float, max_pts: int) -> list[dict]:
    """The tiles ``main_fusion`` runs for ``synth_epoch_pair(width, height)``
    (offset ``DRIVER_EPOCH``'s) with the shipped configs' tiling: each
    tile's cropped source and target clouds, core points and the moving
    half's boundary."""
    from fusion4landslide_tpu_torch.io.ply import PointCloud
    from fusion4landslide_tpu_torch.pipelines.driver import crop_cloud_to_core
    from fusion4landslide_tpu_torch.tiling import tile_epoch_pair

    offset = DRIVER_EPOCH["offset"]
    src, tgt, _ = synth_epoch_pair(width, height, offset=offset)
    tiles, sf, tf, *_ = tile_epoch_pair(src, tgt, max_pts, 5000, voxel_size=0.1, halo=20.0)
    out = []
    for tp in tiles:
        core = sf[tp.src_idx]
        lo, hi = core.min(axis=0), core.max(axis=0)
        out.append(dict(
            tile_id=tp.tile_id, core=core, moving_y=offset[1] + height / 2,
            src=crop_cloud_to_core(PointCloud(sf[tp.src_halo_idx]), lo, hi, 5.0).points,
            tgt=crop_cloud_to_core(PointCloud(tf[tp.tgt_halo_idx]), lo, hi, 10.0).points,
        ))
    return out


def run_host(kind: str, tile: dict, device: str = "cpu", pipeline: str = "fusion_host") -> dict:
    """One host-tile run (``jax``, ``port`` or ``port:<fault>``) of a
    driver tile with ``seeded_models(0)`` (and ``seeded_filter(0)``) and
    the shipped ``fusion_3d_brienz.yaml`` (``pipeline='fusion_host'``) or
    ``f2s3_brienz.yaml`` (``'f2s3_host'``) as the drivers load them;
    returns its per-tile recovery readings from the written DVF rows."""
    import importlib
    import tempfile

    from fusion4landslide_tpu_torch.checks import driver_tile_recovery
    from fusion4landslide_tpu_torch.config import load_yaml

    fusion = pipeline == "fusion_host"
    cfg = load_yaml("configs/landslide/" + ("fusion_3d_brienz.yaml" if fusion else
                                            "f2s3_brienz.yaml"), keep_sub_directory=fusion)
    td, ta = seeded_models(0, "cpu")
    second = ta if fusion else seeded_filter(0, "cpu")
    fault = kind.split(":", 1)[1] if ":" in kind else None
    if fault == "no_icp":
        cfg["icp_refine"] = False
    elif fault == "no_refine":
        cfg["refine_results"] = False
    cfg.update(OVERRIDES)
    name = "run_fusion3d_tile" if fusion else "run_f2s3_tile"
    module = "pipelines.fusion" if fusion else "pipelines.f2s3"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg["output_dir"] = tmp
        if kind == "jax":
            fn = getattr(importlib.import_module("fusion4landslide_tpu." + module), name)
            with tpu_branch_emulated():
                out = fn(cfg, flax_from_state_dict(td.state_dict()),
                         flax_from_state_dict(second.state_dict()), tile["src"], tile["tgt"],
                         tile_id=tile["tile_id"])
        else:
            fn = getattr(importlib.import_module("fusion4landslide_tpu_torch." + module), name)
            extra = {"stages_s": {}}
            with _fault(None if fault in ("no_icp", "no_refine") else fault), \
                    _peak(device) as peak:
                out = fn(cfg, td, second, tile["src"], tile["tgt"], tile_id=tile["tile_id"],
                         device=device, timings=extra["stages_s"])
            extra.update(peak)
    dvfs = out["dvfs"]
    rec = driver_tile_recovery(tile["core"], dvfs[:, :3], dvfs[:, 3:6] - dvfs[:, :3],
                               tile["moving_y"], PLANTED_SHIFT.astype(np.float64))
    return {"run": f"{pipeline}:{kind}", "tile": tile["tile_id"], **rec,
            "src": len(tile["src"]), "tgt": len(tile["tgt"]), "dvfs": dvfs,
            "seconds": time.perf_counter() - t0, **(extra if kind != "jax" else {})}


def test_flax_bridge_round_trips_the_seeded_weights():
    """The witness hands ``seeded_models`` weights to the JAX step: the
    inverse bridge gives the Flax modules' own tree and round-trips."""
    import jax

    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet
    from fusion4landslide_tpu.models.dips import PointNetFeature

    td, ta = seeded_models(0, "cpu")
    fd, fa = flax_from_state_dict(td.state_dict()), flax_from_state_dict(ta.state_dict())
    ref_d = PointNetFeature().init(jax.random.PRNGKey(0), np.zeros((1, 128, 3), np.float32))
    ref_a = ClusterFeatureNet().init(
        jax.random.PRNGKey(1), np.zeros((1, 8, 64), np.float32), np.ones((1, 8), bool)
    )
    for got, ref in ((fd, ref_d), (fa, ref_a)):
        shapes = jax.tree.map(np.shape, got)
        assert shapes == jax.tree.map(np.shape, jax.tree.map(np.asarray, ref))
    sd_d, sd_a = params_from_flax(fd, fa)
    for sd, mod in ((sd_d, td), (sd_a, ta)):
        for key, val in mod.state_dict().items():
            assert torch.equal(sd[key], val), key


def test_recovery_readings_of_a_known_field():
    """Exact shift on the moving half, zero on the static half, one point
    in four unassigned."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(400, 3)).astype(np.float32)
    core = np.arange(400) < 300
    moving = np.arange(400) % 2 == 0
    valid = np.arange(400) % 4 != 3
    moved = src + np.where(moving[:, None], PLANTED_SHIFT + [0.002, 0, 0], 0.0)
    rec = recovery(valid, moved, src, core, moving)
    assert rec["static_assigned"] == pytest.approx(0.5)
    assert rec["core_assigned"] == pytest.approx(0.75)
    assert rec["static_err_m"] == 0.0
    assert rec["moving_err_m"] == pytest.approx(0.002, abs=1e-7)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-core", type=int, default=10000)
    ap.add_argument("--margin", type=float, default=5.0)
    ap.add_argument("--halo", type=float, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--runs", nargs="+", default=["jax", "port"])
    ap.add_argument("--pipeline", choices=("fusion", "f2s3", "fusion_rgb", "fusion_host",
                                           "f2s3_host"), default="fusion")
    ap.add_argument("--epoch", nargs=2, type=float,
                    default=[DRIVER_EPOCH["width"], DRIVER_EPOCH["height"]],
                    help="fusion_host: the epoch's width and height (m)")
    ap.add_argument("--max-pts", type=int, default=1_000_000,
                    help="fusion_host: max_pts_per_tile")
    ap.add_argument("--set", nargs="+", default=[], metavar="KEY=VALUE",
                    help="config keys over every run's config (YAML values), e.g. "
                         "feat_patch_points=192 feat_sample_priority=random")
    args = ap.parse_args()
    for item in args.set:
        key, _, value = item.partition("=")
        OVERRIDES[key] = yaml.safe_load(value)
    if OVERRIDES:
        print(json.dumps({"set": OVERRIDES}), flush=True)
    torch.set_grad_enabled(False)
    if args.pipeline in ("fusion_host", "f2s3_host"):
        tiles = driver_tiles(*args.epoch, args.max_pts)
        print(json.dumps({"epoch_m": args.epoch, "max_pts": args.max_pts,
                          "device": args.device, "tiles": len(tiles)}), flush=True)
        for tile in tiles:
            by = {}
            for kind in args.runs:
                res = run_host(kind, tile, args.device, args.pipeline)
                by[kind] = res["dvfs"]
                print(json.dumps({k: v for k, v in res.items() if k != "dvfs"}), flush=True)
            if "jax" in by and "port" in by:
                rows = {tuple(r[:3]): r[3:] for r in by["jax"]}
                both = [(rows[tuple(r[:3])], r[3:]) for r in by["port"] if tuple(r[:3]) in rows]
                gap = np.array([np.linalg.norm(a - b) for a, b in both])
                print(json.dumps({"tile": tile["tile_id"], "jax_vs_port": {
                    "overlap_frac": len(both) / max(len(by["jax"]), len(by["port"]), 1),
                    "median_gap_m": float(np.median(gap)) if gap.size else None,
                    "frac_gap_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
                }}), flush=True)
        return
    make = rgb_tile if args.pipeline == "fusion_rgb" else split_tile
    tile = make(args.n_core, args.margin, args.halo)
    print(json.dumps({"tile": {"n_core": args.n_core, "margin_m": args.margin,
                               "halo_m": args.halo, "device": args.device,
                               "chunk": args.chunk,
                               "src": tile["n"], "tgt": tile["m"],
                               "bucket": tile["sb"].shape[0]}}), flush=True)
    done = []
    for kind in args.runs:
        if kind == "stages":
            print(json.dumps({"stages": stages(tile, args.chunk)}), flush=True)
            continue
        res = (run_f2s3 if args.pipeline == "f2s3" else run)(kind, tile, args.device, args.chunk)
        done.append(res)
        print(json.dumps({k: v for k, v in res.items() if k not in ("valid", "moved")}),
              flush=True)
    by = {r["run"]: r for r in done}
    pre = "f2s3:" if args.pipeline == "f2s3" else ""
    if pre + "jax" in by and pre + "port" in by:
        vj, vt = by[pre + "jax"]["valid"], by[pre + "port"]["valid"]
        common = vj & vt
        gap = np.linalg.norm(by[pre + "jax"]["moved"][common] - by[pre + "port"]["moved"][common], axis=1)
        print(json.dumps({"jax_vs_port": {
            "overlap_frac": float(common.sum()) / max(int(vj.sum()), int(vt.sum()), 1),
            "median_gap_m": float(np.median(gap)) if gap.size else None,
            "frac_gap_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
        }}), flush=True)


if __name__ == "__main__":
    main()
