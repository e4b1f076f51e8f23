#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fusion4landslide_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel in ``fusion4landslide_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel, into ``fusion4landslide_tpu_torch/_build``);
2. kernel 2 (grid kNN) against its plain PyTorch version on the card,
   bit for bit: on a production-density grid (k = 1, 3 and 32, with and
   without ``exclude_self``), on a near-tie cloud (duplicated refs and
   one-ulp neighbours), on the source cloud of phase 7's RGB tile (1.31 M
   queries, k = 1) and on that tile's pixel-space launch (its ~1.1 M
   projected source voxels against its ~605 k pixel matches, 5-pixel
   cells, z = 0), the last two on windows fitted as the step fits them;
   timed at the production 3D shape (524 288 queries, k = 1,
   ``exclude_self``), at the RGB tile's source shape and at its
   pixel-space shape;
3. kernel 1 (radius sampler) against its plain version: P = 256
   ``'random'`` and P = 128 ``'distance'`` on every 8th block and the
   widest one, on the production cloud and on phase 7's source cloud
   (whose widest windows pass 32 768 positions: fitted), each timed at
   its main-path launch shape: 128 blocks at P = 256 ``'random'`` (DIPs)
   and every block at P = 128 ``'distance'`` (the supervoxel graph);
4. kernel 3 (feature kNN) against its plain version, bit for bit: the
   F2S3 tile's shape (524 288 x 524 288 x 64, k = 1, refs past 489 362
   masked) and 65 536 x 65 536 x 64 at k = 8 with ``exclude_self``, on
   seeded unit-norm features, the plain version on the first 2 048 query
   rows; and a near-tie stress shape (32 768 rows of 64, self-kNN at
   k = 8 with ``exclude_self``: exact duplicates, rows one ulp apart,
   norms over 1e-3..1e3) on every row; prints the rescored candidates per
   row and the tensor-core bound beside the float32 one;
5. small tiles on the card against the port's CPU path (the path the CPU
   tests hold against the JAX package): the fusion step with the gated
   and with the ungated global match (scored as ``tools/parity_check.py``
   scores two paths), the F2S3 step, and the host F2S3 tile
   (``run_f2s3_tile``, on a tile above ``median_nn_distance``'s 4096-point
   grid threshold), and the RGB+3D fusion step (``lifting_type``
   ``nn_search`` and ``interpolation``) on a small tile seen by a 512^2
   camera; every small tile's CPU path (and those of phases (j), (l),
   (r), (s) and (u)) runs in a worker process of its own (``spawn``, two
   cores left to the card's process) while the card goes on: the fusion
   steps', (r)'s and (s)'s are scored after phase (u)'s production fusion
   tile, the F2S3 tiles', (j)'s, (l)'s and (u)'s after phases (q), (x)
   and (y), before the driver phases;
6. one production-shaped tile (a 250 000-point core at 100 pts/m^2 with
   symmetric 10 m margins, ~490 k points per cloud, bucket 524288) through
   ``run_fusion3d_tiles`` with the ``fusion_3d_brienz.yaml`` statics and
   seeded random weights: asserts the grid kernels launched during the
   step, finite outputs, and recovery of the planted displacement between
   the sound and the broken readings of random-init descriptors (see
   ``RECOVERY``);
7. the RGB+3D fusion step on ``bench.py``'s ``e2e`` tile at the shipped
   size (``RGB_TILE``: a 1 000 000-point core, source margin 5 m, target
   margin 10 m, the +-20 m halo; 1 210 554 / 1 440 062 points in buckets
   1 310 720 / 1 572 864; a 4096^2 nadir camera and 605 277 pixel
   matches, half the source points; built on a thread from the start)
   through ``run_fusion3d_tiles`` with an ``image_kit_fn`` and the
   ``fusion_brienz.yaml`` statics in float32: asserts kernels 1 and 2
   launched during the step, no window overflow, the result tables, and
   ``bench.py``'s own recovery targets (see ``RECOVERY_RGB``); prints
   the clouds' sizes and buckets, ``sv_cap`` / ``sv_cap_tgt``, stage
   times, launches, overflow by kernel, ``n_dropped``, ``n_c2d``, peak
   memory and the free memory after the step;
8. the 3D-only tile through ``run_f2s3_tiles`` with the ``f2s3_brienz.yaml``
   statics and seeded random weights: asserts all three kernels launched
   during the step, finite outputs, the result tables, and recovery
   readings between the sound and a broken run (see ``RECOVERY_F2S3``);
   prints stage times, peak memory and the kept fraction; then a
   quarter-size tile through the host tile ``run_f2s3_tile`` (launches,
   time, peak memory, tables, finite outputs);
9.-11. the drivers from files on disk, each run as a subprocess
   (``python3 -m fusion4landslide_tpu_torch.main_…``) on the card, with
   seeded random weights written as reference-format checkpoints and
   the shipped configs with only paths and file names changed (plus the
   RGB camera's ``image_size``): ``main_fusion`` 3D-only
   (``fusion_3d_brienz.yaml``) on ``DRIVER_EPOCH``, an epoch pair of
   1.45 M points per epoch that the tiler cuts into two tiles (kernels 1
   and 2 launched, every tile's ``c2f_*`` tables, recovery per tile
   between the floors ``RECOVERY_CLI``, then a second run that skips
   both tiles); ``main_fusion`` RGB+3D (``fusion_brienz.yaml``, phase
   10) on ``FULL_TILE_EPOCH``, which the shipped config keeps as one tile
   of 972 456 / 972 286 points after its 0.1 m voxel filter (the shipped
   tile size, on the host tile), seen by ``bench.py``'s 4096^2 nadir
   camera, with pixel matches for half the source points in
   ``img_matching_results/`` (``bench.py``'s targets, ``RECOVERY_RGB``;
   window overflow 0; the tile's points and buckets, process start, the
   host tile's main stages, peak and free memory after the run);
   ``main_f2s3`` (``f2s3_brienz.yaml``) on the
   two-tile epoch (all three kernels, the ``f2s3_*`` tables,
   ``RECOVERY_CLI_F2S3``); each prints seconds per tile with the host
   tile's stage times, tiling and reading seconds, peak memory and
   launches (from the driver's ``run summary`` line);
   Each driver phase also prints the run's grid-window overflow by
   kernel;
12. (a) ``nn1_spatial`` on the F1 witness (3 000 sources over 200 000
   targets, whose first radius overflows kernel 2's window) against an
   exact float64 1-NN: no row more than 1 mm off (run after phase 4);
13. (b) the ZNCC matcher on the first 960 x 1280 crop pair of a textured
   image pair rendered at ``rgb_guided_brienz.yaml``'s 1920 x 2560 from
   ``RGB_EPOCH``, card vs the port's CPU path (kept-set overlap, flow
   gap, seconds per crop pair);
   Then the learned matchers on the same crop pair: (f) E-LoFTR with
   ``weights/eloftr_tiny.npz``, card vs CPU path (kept cells, |duv|),
   seconds per crop pair by stage and peak memory; (g) E-LoFTR at the
   upstream width with seeded weights (seconds and peak memory at the
   shipped crop, card vs CPU on a 256 x 320 crop); (i) RoMa with
   ``weights/roma_tiny.npz`` (the self-check's consistent fraction, card
   vs CPU, the ZNCC fallback, and the sampled matches with the card's
   draws fed to the CPU path);
14.-15. (c), (d) ``main_rgb_guided`` (``rgb_guided_brienz.yaml`` with
   paths, file names and ``img_matching_type: zncc`` changed) on that
   epoch and image pair, with ``use_mesh: auto`` (the host tile: kernels
   1 and 2 launched) and ``true`` (the runner: kernel 1 launched); the
   four tables, stage times, peak memory, and recovery of the planted
   shift between the floors ``RECOVERY_RGB_GUIDED``; then (h) the same
   host-tile run with only paths and file names changed, so with the
   shipped ``eloftr`` matcher (``RECOVERY_RGB_GUIDED_ELOFTR``; kernels 1
   and 2 launched), with its match count;
16. (e) ``main_piecewise_icp`` (``piecewise_icp_brienz.yaml``, paths and
   names changed) on the two tiles of phase 9, ``use_mesh: auto`` and
   ``true``: no kernel launched, the tables, the stable and unstable
   fractions of each half's core, seconds per tile;
Phases (j)-(m): (j) the superpoint generator
   (``ops/superpoint.py``) on a ~12 k-point tile cloud, card vs the CPU
   path (labels per level up to relabelling), then on ``RGB_EPOCH``'s
   490 000-point source cloud (seconds of the 30-NN search, features,
   level-1 VCCS and region merge, regions per level, peak memory), run
   after phase 5; (l) ``icp_type`` ``point2plane`` and ``generalized``
   on a small tile with metre-scale relief through the step and the host
   tile, card vs CPU (equal assigned sets, the DVF gap reported), and the
   production tile of phase 6 again with ``generalized`` (tile and
   ``fine`` seconds beside point2point's, the same assigned points,
   recovery); (k) ``main_fusion`` 3D-only with ``partition_type:
   superpoint`` on ``RGB_EPOCH`` after phase 10 (partition tables,
   kernels 1 and 2 launched, recovery above ``RECOVERY_SUPERPOINT``);
   (m) classic LoFTR at the upstream width with seeded weights on the
   first 960 x 1280 crop pair (seconds by stage, peak memory; card vs
   CPU on 256 x 320) and ``main_rgb_guided`` with ``icp_type:
   point2plane`` (recovery against ``RECOVERY_RGB_GUIDED``), inside the
   rgb_guided phases;
Phases (n)-(r): (n) the F2S3 feature cache: phase 11 runs with
   ``save_interim: true``; tile 0's tables are deleted and ``main_f2s3``
   reruns it with ``feat_compute: false`` (no ``dips_features`` stage,
   kernel 3 launched once, kernel 1 only for the supervoxel graph; tile
   seconds beside the computing run's, the largest gap between the two
   runs' ``f2s3_*`` tables); (o) E57: ``RGB_EPOCH``'s two epochs written
   with ``io.e57.write_e57`` and read back through ``read_point_cloud``,
   bit-equal to the PLY arrays (seconds per million points), and phase
   (c) reads its epoch from the ``.e57`` files; (p) the native tiler
   (``tiling/native.py``: ``g++`` build of ``cpp/tiler.cpp``) on phase
   9's epoch files against the numpy tiler without voxel filter (tile
   count, each tile's core source points; seconds of both); (q) two tile
   streams on the one card (``devices=["cuda:0", "cuda:0"]``): the F2S3
   runner over two quarter-size tiles and ``run_piecewise_tiles`` over
   phase 16's tiles, tables and results equal to the one-stream run's and
   the launches summing to its counts; (r) the fusion step with
   ``nested_levels=False`` (levels 1-3) on phase 5's small tile, card vs
   CPU (equal assigned sets, the DVF gap reported). Phases 9, 11 and 16
   run on ``CLI_EPOCH``, ``DRIVER_EPOCH`` at half its height, cut into two
   tiles by ``max_pts_per_tile: CLI_TILE_PTS``; (q) runs a sixteenth-size
   tile pair with 5 m margins;
Phases (s)-(v): (s) the DIPs grid branches at ``feat_patch_points`` 96:
   the small fusion and F2S3 steps, each with ``sample_priority``
   ``'knn'`` and ``'random'`` (``feat_k_max`` ``SMALL_K_MAX``), card vs
   the CPU path on the card's draws (assigned / kept sets and the DVF gap
   as ``tools/parity_check.py`` scores them), and on the F2S3 tile both
   branches' descriptors (max error, 1-NN agreement), run after phase (r)
   (the CPU path in the worker process of phase 5);
   (t) the production tile of phase 6 through ``run_fusion3d_tiles`` at
   ``feat_patch_points: 192``, ``feat_k_max: 512`` ('knn'), and (u) with
   ``feat_dtype: bfloat16``: tile and ``dips_features`` seconds beside
   phase 6's, peak memory, overflow, launches, recovery against
   ``RECOVERY``; (u) also the F2S3 tile of phase 8 in bf16 (against
   ``RECOVERY_F2S3``, beside phase 8's seconds) and bf16 descriptors on a
   small tile, card vs CPU; (v) matcher training on the card: E-LoFTR at
   ``tests/test_eloftr_train.py``'s TINY for 60 steps and RoMa at
   ``tests/test_roma.py``'s TINY for 120 steps from
   ``flax_bridge.flax_default_init``: steps per second, the loss history,
   the JAX tests' checks (coarse CE < 0.7x, EPE < 0.6x the first), the
   first step's loss and gradients card vs CPU (cuDNN's deterministic
   algorithms; a second card run gives the spread from run to run),
   checkpoints written to a temporary directory and read back;
Phases (w)-(y): (w) the host fusion tile (``parity_check.run_path``) on
   phase 6's production tile with phase 6's configuration, its DVF table
   joined with phase 6's runner table as ``tools/parity_check.py`` joins
   them (``parity_check.parity_readings``: assigned-set overlap, gap
   median / p95 / max, share over 10 mm, each path's error against the
   planted field; host seconds, stage times, peak memory, launches), run
   after phase 6; (x) ``matcher_eval`` at the production crops: ``zncc``,
   ``eloftr`` and ``roma`` on the rendered 1920 x 2560 nadir scene of a
   150 m extent with a ~25 px planted shift (rendered by numpy in a
   process of its own from phase 6 on), one warm repeat each: EPE, precision at 3
   and 5 px, match count, seconds per image and crop pair, whether the
   matcher fell back to ZNCC; (y) the host fusion tile on the hard pair
   of ``tests/test_synth_hard.py`` (``synth.HARD_PAIR``, 20 000 points, a
   2x density gradient and a rotating disc; ``synth.HARD_TILE_CFG``) held
   to that test's bars (assigned > 0.7, static median < 5 mm, moving
   median < 10 mm), with its window overflow and launches; (x) and (y)
   run after phase (q);
17. a ``kernels`` JSON line: launches on phase 7's RGB tile
   (``launches_path``; kernel 3, which that path does not run, on phase
   8's F2S3 tile) and per path, time (and at phase 7's launch shapes,
   ``rgb_tile_*``), the time before the kernel's redesign
   (``ms_before``), plain-version time, the least time the card could
   take (bound), what bounds it, and a library yardstick where one
   exists;
18. last line: ``{"ok": true, "device": {...}}``.

Lines ``# elapsed ... s: <phase>`` give the seconds since the start at
the main phase boundaries. It imports neither ``jax`` nor
``fusion4landslide_tpu``, and never falls back to the CPU or to the
plain versions.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor
#: FLOP/s, dense TF32 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
#: Recovery floors of the production tile with ``seeded_models(0)``. On an
#: H100 80GB HBM3 (700 W) the port reads 45.6% of the static core
#: assigned, 3.57 mm median static and 7.91 mm median moving error; the
#: broken run closest to that (the target cloud's patch sampler reseeded,
#: ``tests/test_torch_recovery.py`` run ``port:tgt_seed``) reads 39.1%,
#: 4.41 mm and 9.17 mm, and the step without ICP 62.9 mm / 121.5 mm. Each
#: floor lies between the sound and the broken reading. ``bench.py``'s
#: targets (> 0.9 assigned, < 2 mm) assume descriptors that match across
#: epochs; random-init ones do not, in the JAX reference either (the
#: witness holds the emulated JAX step and the port's CPU step on reduced
#: tiles of this geometry).
RECOVERY = {"static_assigned": 0.42, "static_err_m": 4.0e-3, "moving_err_m": 8.5e-3}
#: Floors of the same tile through the F2S3 runner with ``seeded_models(0)``
#: and ``seeded_filter(0)``. On an H100 80GB HBM3 (700 W) the port keeps
#: 0.176% of the tile; its kept moving-core points read the planted shift
#: to 4.5e-6 m (exact matches), its kept static-core points err 2.46 m
#: (median). With the target descriptors permuted
#: (``tests/test_torch_recovery.py --pipeline f2s3``, run
#: ``port:tgt_shuffle``) it keeps 0.117%, at 3.30 m moving and 3.63 m
#: static error. ``refine_results: false`` (run ``port:no_refine``) reads
#: the same errors as the sound run. Each floor lies between the sound and
#: the shuffled reading: a regression alarm for these weights, not a
#: quality bound.
RECOVERY_F2S3 = {"kept": 0.0015, "static_err_m": 3.0, "moving_err_m": 1.0e-2}
#: ``bench.py``'s targets for the RGB+3D step (its lines 368-400): the 2D
#: vote channel matches every patch, so more than 90% of the core is
#: assigned, and the median error on either half stays under
#: ``2 mm + 0.7 m_per_px`` (the pixel-space chaining tolerance).
RECOVERY_RGB = {"core_assigned": 0.9, "err_floor_m": 2e-3, "err_per_m_per_px": 0.7}
#: Floors of the 3D-only driver's tiles (``CLI_EPOCH`` through
#: ``main_fusion`` with ``fusion_3d_brienz.yaml`` and ``seeded_models(0)``
#: checkpoints), per tile on its core. On an H100 80GB HBM3 (700 W) the
#: sound tiles read 18.9% / 11.1% of the static core assigned, 12.9 mm /
#: 128 mm median static and 126 mm / 298 mm median moving error; with the
#: target descriptors permuted (``tests/test_torch_recovery.py --pipeline
#: fusion_host --epoch 145 50 --max-pts 400000``, run
#: ``port:tgt_shuffle``) 0.36% / 0.54%, 3.75 m / 3.47 m and 3.07 m /
#: 1.85 m. (On the whole ``DRIVER_EPOCH``, before the cut: 13.9% /
#: 6.9%, 14.2 / 204 mm, 155 / 276 mm sound; 0.59% / 0.11%, 3.27 / 4.86 m,
#: 4.15 / 3.39 m permuted.) The witness's other broken runs
#: (``port:no_icp``, ``port:tgt_seed``) read within the sound tiles'
#: spread: with random weights the host tile's pairs are mostly false, in
#: the JAX reference too. Each floor lies between the sound and the
#: permuted readings.
RECOVERY_CLI = {"static_assigned": 0.02, "static_err_m": 1.0, "moving_err_m": 1.0}
#: Floors of the F2S3 driver's tiles (the same epoch through ``main_f2s3``
#: with ``f2s3_brienz.yaml``, ``seeded_models(0)`` and ``seeded_filter(0)``
#: checkpoints): the core fraction written (kept by the filter and the
#: magnitude gate) and the median errors, between the sound and the broken
#: readings of ``tests/test_torch_recovery.py --pipeline f2s3_host --epoch
#: 145 50 --max-pts 400000``. The voxel filter leaves no exact cross-epoch
#: duplicates, so the step's ``RECOVERY_F2S3`` (exact moving matches) does
#: not carry over. On an H100 80GB HBM3 (700 W) the sound tiles keep
#: 0.192% / 0.263% of their core at 2.48 m / 2.60 m median static and
#: 2.53 m / 2.66 m moving error; with the target descriptors permuted (run
#: ``port:tgt_shuffle``) 0.091% / 0.121% at 3.15 m / 3.57 m and 3.69 m /
#: 3.46 m; ``refine_results: false`` (run ``port:no_refine``) reads as the
#: sound run. With the epoch cut to ``CLI_EPOCH`` the floors were placed
#: again between these readings (on the whole ``DRIVER_EPOCH`` the sound
#: tiles read 0.121% / 0.166% kept at 1.49 / 1.79 m static and 2.75 / 2.68
#: m moving error, the permuted 0.063% / 0.064% at 3.35 / 3.46 m and 3.43
#: / 3.46 m, and the floors were 0.0009 kept and 2.5 m static). A
#: regression alarm for these weights, not a quality bound.
RECOVERY_CLI_F2S3 = {"kept": 0.0015, "static_err_m": 2.9, "moving_err_m": 3.1}
#: Floors of ``main_fusion`` 3D-only with ``partition_type: superpoint``
#: on ``RGB_EPOCH`` (one tile, phase (k), ``seeded_models(0)``
#: checkpoints), on its core. On an H100 80GB HBM3 (700 W) the sound run
#: assigns 8.06% of the static core at 8.27 mm static and 79.9 mm moving
#: median error; with the partition tables' labels shuffled
#: (``superpoint_broken_run()``) no superpoint passes the fine quality
#: gate and nothing is assigned. The assignment floor lies between the
#: two; the error floors are alarms at ~6x and ~4x the sound reading.
RECOVERY_SUPERPOINT = {"static_assigned": 0.03, "static_err_m": 0.05, "moving_err_m": 0.3}
#: The fusion runner's settings of phases 6 and 7: the
#: ``fusion_3d_brienz.yaml`` / ``fusion_brienz.yaml`` statics, with
#: ``bench.py``'s DIPs and supervoxel sizes spelled out.
FUSION_CFG = {
    "dataset": "brienz_tls",
    "voxel_size_init": 0.1,
    "level_of_superpoint": [1, 2, 3],
    "num_min_matches_for_small_patch": 10,
    "remove_low_quality_patch_matches": True,
    "num_min_matches_for_quality_check": 10,
    "thres_dist_diff": 0.5,
    "thres_inlier_ratio": 0.15,
    "coarse_refinement_3d_type": "nn_mutual",
    "num_min_fine_match": 10,
    "icp_refine": True,
    "output_tgt2src": False,
    "assign_type": "assign_then_nn",
    "icp_threshold": 0.1,
    "max_magnitude": 5,
    "feat_patch_points": 256,
    "feat_chunk": 2048,
    "member_cap": 512,
    "agg_max_points": 512,
    "fine_max_matches": 256,
    "global_matching_gated": True,
}
#: bench.py's RGB headline tile (its ``e2e`` mode's defaults: ``BENCH_N``
#: core points, source margin ``max_magnitude``, target margin twice that,
#: the +-20 m halo; ``synth.synth_rgb_tile``): ~1.21 M / 1.44 M points in
#: buckets 1 310 720 / 1 572 864 and ~605 k pixel matches.
RGB_TILE = dict(n_core=1_000_000, src_margin=5.0, tgt_margin=10.0, halo=20.0)
#: fusion_brienz.yaml's settings that the fusion runner reads (the RGB
#: channel on bench.py's 4096^2 camera).
RGB_CFG = {
    "use_2d_matches": True,
    "image_size": [4096, 4096],
    "pixel_thres": 5,
    "lifting_type": "nn_search",
    "matches_from_2d_type": "nn_src_only",
    "coarse_matching_fusion": True,
    "fine_matching_fusion": True,
    "weighting_svd": False,
}
#: float32 operations per candidate evaluation in each kernel.
OPS_GRID_KNN = 7  # 3 mul + 3 add for the score, 1 compare
OPS_RADIUS_SAMPLE = 9  # the 7 of d^2 (3-term dot, + |r|^2, + |qc|^2), 2 tests
#: Kernel 1's operations per (query block, window position), counted once
#: per block: centring (3), |r|^2 in the frame (5), mask and hash (~4).
OPS_RADIUS_STAGE = 12
#: Kernel 3's epilogue operations per (query, ref) pair on the CUDA cores:
#: two FMAs (s^ - delta) and a min.
OPS_KNN_EPILOGUE = 5
#: Each kernel's time per launch before its redesign, on an H100 80GB
#: HBM3 at 700 W (PERF.md: this script on the tree before the redesign).
MS_BEFORE = {"grid_knn": 3.974, "radius_sample": 5.620, "knn": 1623.3}
#: Kernel 3's plain version runs on this many query rows.
KNN_PLAIN_ROWS = 2048
#: f2s3_brienz.yaml's settings that the F2S3 runner reads.
F2S3_CFG = {
    "voxel_size": 0.1,
    "max_disp_magnitude": 5,
    "filter_median_magnitude": True,
    "fill_gaps_c2c": True,
    "refine_results": True,
    "n_normals": 30,
    "small_patch_removal": True,
    "feat_patch_points": 256,
    "feat_chunk": 2048,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def log_elapsed(t_start: float, where: str) -> None:
    """A line with the seconds since the run started, at a phase boundary."""
    log(f"# elapsed {time.perf_counter() - t_start:.1f} s: {where}")


def check(ok, what) -> None:
    """Fail the run (a raise, not an ``assert``: it holds under ``-O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes at the HBM rate and
    the operations at ``peak`` FLOP/s."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_work(win, chunk: int, b0: int = 0, b1: int | None = None) -> tuple[int, int]:
    """(candidate positions summed over blocks [b0, b1), the same times the
    block's query count) for this run's windows."""
    from fusion4landslide_tpu_torch.ops.hashgrid_cuda import _scan_len

    scans = _scan_len(win.wmeta[1], chunk, win.window)[b0:b1]
    return int(scans.sum()), int(scans.sum()) * win.block


def reset_launches() -> None:
    from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES

    for key in LAUNCHES:
        LAUNCHES[key] = 0


def read_launches() -> dict:
    from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES

    return dict(LAUNCHES)


def padded(src: np.ndarray, tgt: np.ndarray):
    """A tile centred on its source mean and padded to its buckets (numpy)."""
    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    n, m = src.shape[0], tgt.shape[0]
    sb = np.zeros((bucket_size(n), 3), np.float32)
    sb[:n] = src - src.mean(0)
    tb = np.zeros((bucket_size(m), 3), np.float32)
    tb[:m] = tgt - src.mean(0)
    return sb, np.arange(len(sb)) < n, tb, np.arange(len(tb)) < m, n, m


def padded_small_tile(src_margin: float, tgt_margin: float):
    """A ~3k-point split tile, centred and padded to its buckets (numpy)."""
    from fusion4landslide_tpu_torch.synth import synth_split_tile

    src, tgt, _, _ = synth_split_tile(1000, src_margin, tgt_margin, halo=2.0)
    return padded(src, tgt)


def image_inputs(src: np.ndarray, pix: np.ndarray, K: np.ndarray, E: np.ndarray) -> dict:
    """The RGB step's image inputs (numpy) for one image pair: pixel
    matches padded to their bucket, the camera, the tile's centre."""
    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    pixb = np.zeros((1, bucket_size(len(pix)), 4), np.float32)
    pixb[0, : len(pix)] = pix
    return dict(
        pix_matches=pixb, pix_count=np.array([len(pix)]), intrinsic=K,
        src_extrinsics=E[None], tgt_extrinsics=E[None],
        center=src.mean(0).astype(np.float32), pixel_thres=5.0,
    )


def cpu_run(fn, *args):
    """``fn(cpu, *args)`` in the worker process, leaving two cores to the
    process driving the card."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - 2))
    return fn(torch.device("cpu"), *args)


def split_run(dev, pool, fn, *args) -> dict:
    """``fn(dev, *args)`` on the card, its launches read just after it,
    and ``fn(cpu, *args)`` submitted to ``pool`` (the worker process)
    before it: the state a ``*_compare`` function scores."""
    future = pool.submit(cpu_run, fn, *args)
    reset_launches()
    card = fn(dev, *args)
    torch.cuda.synchronize()
    return dict(card=card, cpu=future, launches=read_launches())


def _on_host(t):
    """A NamedTuple's tensor fields moved to the CPU, as numpy arrays."""
    return _numpy_fields(t._replace(**{k: v.cpu() for k, v in t._asdict().items()
                                       if torch.is_tensor(v)}))


def fusion_small_run(d, global_gated: bool, lifting: str | None, step_kw: dict) -> tuple:
    """The fusion step on a small tile on device ``d``: (result with numpy
    fields, source points, the RGB tile's core mask or None). With
    ``lifting`` the step runs the RGB channel on ``synth_small_rgb_tile``;
    ``step_kw`` overrides the step's statics."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step
    from fusion4landslide_tpu_torch.synth import SMALL_IMG_SIZE, synth_small_rgb_tile

    small = dict(levels=(1, 2), patch_points=128, chunk=512, k_neighbors=8,
                 sv_cap=256, member_cap=128, agg_max_points=64, small_patch=3,
                 icp_max_iter=8, fine_max_matches=64, global_gated=global_gated)
    images, core = {}, None
    if lifting is None:
        sb, sm, tb, tm, ns, _ = padded_small_tile(1.0, 1.5)
    else:
        src, tgt, core, _, pix, K, E, _ = synth_small_rgb_tile()
        sb, sm, tb, tm, ns, _ = padded(src, tgt)
        images = image_inputs(src, pix, K, E)
        small.update(image_size=SMALL_IMG_SIZE, lifting=lifting)
    small.update(step_kw)
    dm, am = seeded_models(0, d)
    o = fusion3d_tile_step(
        dm, am, torch.from_numpy(sb).to(d), torch.from_numpy(sm).to(d),
        torch.from_numpy(tb).to(d), torch.from_numpy(tm).to(d),
        5.0, 0.1, 0.1, 10, 10, 0.5, 0.15, device=d,
        **{k: torch.as_tensor(v, device=d) if isinstance(v, np.ndarray) else v
           for k, v in images.items()},
        **small,
    )
    return _on_host(o), ns, core


def fusion_small_card_side(dev, pool, global_gated: bool, lifting: str | None = None,
                           **step_kw) -> dict:
    """``split_run`` of the fusion step on a small tile;
    ``fusion_small_compare`` scores the two. ``step_kw`` overrides the
    step's statics (phase (r): ``nested_levels=False``, where the assigned
    sets must be equal)."""
    return dict(split_run(dev, pool, fusion_small_run, global_gated, lifting, step_kw),
                global_gated=global_gated, lifting=lifting, step_kw=step_kw)


def fusion_small_compare(state: dict) -> dict:
    """The small fusion step, card vs the port's CPU path, scored as
    ``tools/parity_check.py`` scores two paths. Returns the card run's
    launches."""
    (g, ns, core), launches = state["card"], state["launches"]
    global_gated, lifting, step_kw = state["global_gated"], state["lifting"], state["step_kw"]
    g, c = _tensor_fields(g), _tensor_fields(state["cpu"].result()[0])
    vg, vc = g.valid[:ns].numpy(), c.valid[:ns].numpy()
    common = vg & vc
    gap = np.linalg.norm(g.moved[:ns].numpy()[common] - c.moved[:ns].numpy()[common], axis=1)
    parity = {
        "n_vox": [int(g.n_vox_src), int(c.n_vox_src), int(g.n_vox_tgt), int(c.n_vox_tgt)],
        "median_res_rel": abs(float(g.median_res) - float(c.median_res)) / float(c.median_res),
        "assigned": [int(vg.sum()), int(vc.sum())],
        "overlap_frac": float(common.sum()) / max(int(vg.sum()), int(vc.sum()), 1),
        "median_delta_disp_m": float(np.median(gap)) if gap.size else None,
        "frac_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
        "n_c2d": [int(g.n_c2d), int(c.n_c2d)],
        "launches": launches,
    }
    parity["assigned_equal"] = bool((vg == vc).all())
    log(f"# phase small-tile fusion parity (global_gated={global_gated}, lifting={lifting}, "
        f"{json.dumps(step_kw)}, card vs CPU path, {ns} pts): {json.dumps(parity)}")
    if step_kw:
        check(parity["assigned_equal"], parity)
    nv = parity["n_vox"]
    check(nv[0] == nv[1] and nv[2] == nv[3] and g.overflow == 0, parity)
    check(parity["n_c2d"][0] == parity["n_c2d"][1], parity)
    if lifting is not None:
        # The 2D vote channel assigns nearly all of the core.
        check(parity["n_c2d"][0] > 0 and float(vg[core].mean()) > 0.9, parity)
    # Ungated, the random-init descriptors' global 1-NN mostly falls outside
    # the magnitude gate: ~2% of the points are assigned (10%+ gated).
    min_assigned = 0.1 if global_gated else 0.01
    check(parity["median_res_rel"] <= 1e-6 and vg.sum() > min_assigned * ns, parity)
    check(parity["overlap_frac"] >= 0.99 and parity["median_delta_disp_m"] < 1e-4, parity)
    check(parity["frac_gt_10mm"] <= 0.01, parity)
    check(bool(torch.isfinite(g.moved).all()), "non-finite moved points")
    return launches


def f2s3_small_run(d):
    """The F2S3 step on a small tile on device ``d`` (numpy fields)."""
    from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step

    sb, sm, tb, tm, _, _ = padded_small_tile(1.5, 1.5)
    small = dict(patch_points=128, chunk=512, k_neighbors=30, sv_cap=256, member_cap=256)
    dm, _ = seeded_models(0, d)
    return _on_host(f2s3_tile_step(
        dm, seeded_filter(0, d), torch.from_numpy(sb).to(d), torch.from_numpy(sm).to(d),
        torch.from_numpy(tb).to(d), torch.from_numpy(tm).to(d), 5.0, 0.1, device=d, **small))


def f2s3_small_compare(state: dict) -> dict:
    """The F2S3 step on a small tile, card vs the port's CPU path, scored
    as ``tests/test_torch_f2s3.py`` scores the port against JAX. Returns
    the card run's launches."""
    ns = padded_small_tile(1.5, 1.5)[4]
    launches = state["launches"]
    g, c = _tensor_fields(state["card"]), _tensor_fields(state["cpu"].result())
    lab = c.labels[:ns].numpy()
    nn_same = (g.nn_tgt[:ns] == c.nn_tgt[:ns]).all(1).numpy()
    same = ~np.isin(lab, lab[~nn_same & (lab >= 0)])
    kg, kc_ = g.keep[:ns].numpy() & same, c.keep[:ns].numpy() & same
    both = kg & kc_
    gap = np.linalg.norm((g.new_tgt[:ns] - c.new_tgt[:ns]).numpy()[both], axis=1)
    cg, cc = g.c2c[:ns].double().numpy(), c.c2c[:ns].double().numpy()
    parity = {
        "median_res_rel": abs(float(g.median_res) - float(c.median_res)) / float(c.median_res),
        "labels_equal_frac": float((g.labels[:ns] == c.labels[:ns]).double().mean()),
        "n_dropped": [int(g.n_dropped), int(c.n_dropped)],
        "nn_equal_frac": float(nn_same.mean()),
        "kept": [int(kg.sum()), int(kc_.sum())],
        "keep_overlap_frac": float(both.sum()) / max(int(kg.sum()), int(kc_.sum()), 1),
        "median_delta_tgt_m": float(np.median(gap)) if gap.size else None,
        "frac_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
        "c2c_within_1e-5_frac": float((np.abs(cg - cc) <= 1e-5).mean()),
        "c2c_sq_max_err": float(np.abs(cg**2 - cc**2).max()),
        "launches": launches,
    }
    log(f"# phase small-tile F2S3 parity (card vs CPU path, {ns} pts): {json.dumps(parity)}")
    check(parity["median_res_rel"] <= 1e-6 and parity["labels_equal_frac"] >= 0.99, parity)
    check(parity["nn_equal_frac"] >= 0.99 and kg.sum() > 0.01 * ns, parity)
    check(parity["keep_overlap_frac"] >= 0.99 and parity["median_delta_tgt_m"] < 1e-4, parity)
    check(parity["frac_gt_10mm"] <= 0.01 and parity["c2c_within_1e-5_frac"] >= 0.995, parity)
    check(parity["c2c_sq_max_err"] <= 8e-6 and min(launches.values()) > 0, parity)
    check(bool(torch.isfinite(g.new_tgt).all()), "non-finite F2S3 targets")
    return launches


def _host_small_tile():
    from fusion4landslide_tpu_torch.synth import synth_split_tile

    src, tgt, _, _ = synth_split_tile(2000, 1.5, 1.5, halo=2.0)
    return src, tgt


def f2s3_host_small_run(d):
    """The host F2S3 tile (``run_f2s3_tile``) on a 5.6 k-point tile on
    device ``d``: (its result, the result tables written, the C2C-combined
    table's C2C column)."""
    from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
    from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile

    src, tgt = _host_small_tile()
    c2c_name = os.path.join("combined_with_c2c", "f2s3_dvfms_combined_with_c2c_of_tile_0.txt")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        dm, _ = seeded_models(0, d)
        cfg = dict(F2S3_CFG, output_dir=tmp, output_folder="run")
        out = run_f2s3_tile(cfg, dm, seeded_filter(0, d), src, tgt, device=d)
        results = os.path.join(tmp, "run", "results")
        written = sorted(os.path.relpath(os.path.join(r, f), results)
                         for r, _, fs in os.walk(results) for f in fs)
        c2c = np.loadtxt(os.path.join(results, c2c_name)).reshape(-1, 4)[:, 3]
    return out, written, c2c


def f2s3_host_small_compare(state: dict) -> dict:
    """The host F2S3 tile on its 5.6 k-point tile, card vs the port's CPU
    path, scored as ``tests/test_torch_f2s3_host.py`` scores the port
    against JAX. Returns the card run's launches."""
    from fusion4landslide_tpu_torch.ops.knn import knn

    src, _ = _host_small_tile()
    n = src.shape[0]
    check(n > 4096, "the host parity tile must take median_nn_distance's grid loop")
    launches = state["launches"]
    (g, g_written, g_c2c), (c, c_written, c_c2c) = state["card"], state["cpu"].result()
    # Feature 1-NN on each side's descriptors; rows that differ must be
    # near-ties of the CPU side (descriptor distance gap within 5e-5).
    fg, fc = torch.from_numpy(g["src_feat"]), torch.from_numpy(c["src_feat"])
    tg, tc = torch.from_numpy(g["tgt_feat"]), torch.from_numpy(c["tgt_feat"])
    d2, i2 = knn(fc, tc, 2)
    _, ig = knn(fg, tg, 1)
    nn_same = (ig[:, 0] == i2[:, 0]).numpy()
    tie = (torch.sqrt(d2[:, 1]) - torch.sqrt(d2[:, 0]) <= 5e-5).numpy()
    lab = c["labels"]
    same = ~np.isin(lab, lab[~nn_same & (lab >= 0)])
    kg, kc_ = g["keep"] & same, c["keep"] & same
    # Each side's written targets per point, keyed by the exact source
    # coordinates the tile writes (centred in float32, centre added back).
    centre = src.mean(axis=0)
    index = {tuple(p): i for i, p in enumerate((src - centre).astype(np.float32) + centre)}

    def targets(o):
        t = np.full((n, 3), np.nan)
        t[[index[tuple(p)] for p in o["dvfs"][:, :3]]] = o["dvfs"][:, 3:6]
        return t

    pg, pc = targets(g), targets(c)
    both = same & ~np.isnan(pg[:, 0]) & ~np.isnan(pc[:, 0])
    gap = np.linalg.norm(pg[both] - pc[both], axis=1)
    parity = {
        "points": n,
        "labels_equal_frac": float((g["labels"] == c["labels"]).mean()),
        "feat_max_abs_err": float(max((fg - fc).abs().max(), (tg - tc).abs().max())),
        "nn_equal_frac": float(nn_same.mean()),
        "nn_unexplained": int((~nn_same & ~tie).sum()),
        "same_frac": float(same.mean()),
        "kept": [int(kg.sum()), int(kc_.sum())],
        "keep_overlap_frac": float((kg & kc_).sum()) / max(int(kg.sum()), int(kc_.sum()), 1),
        "median_delta_tgt_m": float(np.median(gap)) if gap.size else None,
        "frac_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
        "c2c_within_1e-5_frac": float((np.abs(g_c2c - c_c2c)[same] <= 1e-5).mean()),
        "tables_equal": g_written == c_written,
        "launches": launches,
    }
    log(f"# phase small-tile host F2S3 parity (run_f2s3_tile, card vs CPU path): "
        f"{json.dumps(parity)}")
    check(parity["labels_equal_frac"] >= 0.99 and parity["feat_max_abs_err"] <= 1e-4, parity)
    check(parity["nn_unexplained"] == 0 and parity["same_frac"] > 0.9, parity)
    check(kg.sum() > 0.01 * n and parity["keep_overlap_frac"] >= 0.99, parity)
    check(gap.size and parity["median_delta_tgt_m"] < 1e-4 and parity["frac_gt_10mm"] <= 0.01, parity)
    check(parity["c2c_within_1e-5_frac"] >= 0.99 and parity["tables_equal"], parity)
    check(min(launches.values()) > 0 and np.isfinite(g["dvfs"]).all(), parity)
    return launches


def fusion_rgb_tile(dev, cfg: dict, dips, agg, tile: tuple, label: str = "RGB tile step"):
    """One RGB+3D tile through ``run_fusion3d_tiles`` with an
    ``image_kit_fn``: prints its time, peak memory, launches, overflow,
    ``n_c2d`` and stage times, checks its tables, finite outputs and
    ``bench.py``'s recovery targets (``RECOVERY_RGB``); returns the
    launches read just after the step."""
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.parallel.pipeline import fusion3d_statics, run_fusion3d_tiles
    from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT

    src, tgt, core, moving, pix, K, E, m_per_px = tile
    n = src.shape[0]
    N, M = bucket_size(n), bucket_size(tgt.shape[0])
    statics = fusion3d_statics(cfg, N, M, with_image=True)
    log(f"# {label}: src {n} pts in bucket {N}, tgt {tgt.shape[0]} pts in bucket {M}, "
        f"{pix.shape[0]} pixel matches in bucket {bucket_size(pix.shape[0])}, sv_cap "
        f"{statics['sv_cap']}, sv_cap_tgt {statics['sv_cap_tgt']}, member_cap "
        f"{statics['member_cap']}, feat_dtype {statics['feat_dtype']}")

    def kit(tile_id, s, t):
        return {"pix": [pix], "intrinsic": K, "src_extrinsics": [E], "tgt_extrinsics": [E]}

    timings: dict = {}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        run_cfg = dict(cfg, output_dir=tmp, output_folder="smoke")
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_fusion3d_tiles(run_cfg, dips, agg, [(0, src, tgt)], device=dev,
                                 timings=timings, image_kit_fn=kit,
                                 pix_cap=bucket_size(pix.shape[0]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        free, total = torch.cuda.mem_get_info() if dev.type == "cuda" else (0, 0)
        written = sorted(os.listdir(os.path.join(tmp, "smoke", "results")))
    out = res[0]
    log(f"# {label}: {step_s:.2f} s, peak {peak:.2f} GiB, after the step {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB free, overflow {out['overflow_by_source']}, n_dropped "
        f"{out['n_dropped']}, n_c2d {out['n_c2d']}, voxels {out['n_vox']} (DIPs "
        f"{1e6 * timings['dips_features'] / sum(out['n_vox']):.2f} us a voxel), launches "
        f"{launches} ({card()})")
    log(f"# {label} stages (s): " + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    log(f"# {label} tables: {written}")
    check(launches["grid_knn"] > 0 and launches["radius_sample"] > 0, launches)
    check(out["overflow"] == 0, ("window overflow", out["overflow_by_source"]))
    check(out["n_c2d"] > 0 and "c2f_dvfs_src2tgt_tile_0.txt" in written, (out["n_c2d"], written))
    ok = out["valid"]
    disp = out["dvfs"][:, 3:6] - out["dvfs"][:, :3]
    check(np.isfinite(disp).all(), "non-finite RGB displacements")
    disp_all = np.zeros((n, 3))
    disp_all[ok] = disp
    static = core & ~moving
    err_mov = np.linalg.norm(disp_all[core & moving & ok] - PLANTED_SHIFT, axis=1)
    err_sta = np.linalg.norm(disp_all[static & ok], axis=1)
    tol = RECOVERY_RGB["err_floor_m"] + RECOVERY_RGB["err_per_m_per_px"] * m_per_px
    rec = {
        "core_assigned": float(ok[core].mean()),
        "static_core_assigned": float(ok[static].mean()),
        "moving_err_m": float(np.median(err_mov)) if err_mov.size else None,
        "static_err_m": float(np.median(err_sta)) if err_sta.size else None,
        "tol_m": tol,
        "frac_moving_over_tol": float((err_mov > tol).mean()) if err_mov.size else None,
    }
    log(f"# {label} recovery: {json.dumps(rec)} (targets {json.dumps(RECOVERY_RGB)})")
    check(rec["core_assigned"] > RECOVERY_RGB["core_assigned"], rec)
    check(err_mov.size and rec["moving_err_m"] < tol, rec)
    check(err_sta.size and rec["static_err_m"] < tol, rec)
    return launches


def pixel_window(dev, src, tgt, pix, K, E, image_size):
    """The RGB step's first pixel-space kernel-2 window on this tile, built
    as the step builds it: the source voxel centroids (median-resolution
    voxels on the clouds' shared min corner) projected through the
    camera, as queries with a zero z column, against the pixel matches'
    source endpoints in 5-pixel cells, the window fitted."""
    from fusion4landslide_tpu_torch.image.geometry import project_points
    from fusion4landslide_tpu_torch.ops import hashgrid_cuda as hc
    from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, median_nn_distance_traced
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.ops.voxel import voxel_downsample

    n, m = src.shape[0], tgt.shape[0]
    N = bucket_size(n)
    centre = src.mean(axis=0)
    sp, sm = padded_cloud(dev, src, centre)
    tp, tm = padded_cloud(dev, tgt, centre)
    med = torch.maximum(median_nn_distance_traced(sp, sm)[0], median_nn_distance_traced(tp, tm)[0])
    origin = torch.minimum(sp[:n].min(dim=0).values, tp[:m].min(dim=0).values)
    cent, _, _, nv = voxel_downsample(sp, med, sm, origin=origin)
    uv, _, _ = project_points(
        cent + torch.from_numpy(centre.astype(np.float32)).to(dev), torch.from_numpy(E).to(dev),
        torch.from_numpy(K).to(dev), image_size, mask=torch.arange(N, device=dev) < nv,
    )
    Pc = bucket_size(pix.shape[0])
    ref = torch.zeros((Pc, 3), dtype=torch.float32, device=dev)
    ref[: pix.shape[0], :2] = torch.from_numpy(pix[:, :2]).to(dev)
    grid = build_hash_grid(ref, 5.0, torch.arange(Pc, device=dev) < pix.shape[0])
    q3 = torch.cat([uv, torch.zeros_like(uv[:, :1])], dim=1)
    return hc.window_prologue(q3, grid, 512, 32768, fit_chunk=2048), int(nv)


def grid_knn_bit_check(win, tag: str, cases, chunk: int) -> None:
    """Kernel 2 against ``grid_knn_plain`` bit for bit on the rows of
    every 8th block (every block when there are few), per (k,
    exclude_self) case."""
    from fusion4landslide_tpu_torch.ops import hashgrid_cuda as hc

    dev = win.qpos.device
    blocks = list(range(0, win.nb, 8 if win.nb > 64 else 1))
    rows = torch.cat([torch.arange(b * win.block, (b + 1) * win.block, device=dev) for b in blocks])
    for k, excl in cases:
        d_k, i_k = hc._grid_knn_cuda(win, k, chunk=chunk, exclude_self=excl)
        d_p, i_p = hc.grid_knn_plain(win, k, chunk=chunk, exclude_self=excl, blocks=blocks)
        d_k, i_k = d_k[rows], i_k[rows]
        both = torch.isfinite(d_k) & torch.isfinite(d_p)
        res = {
            "bit_equal": bool(torch.equal(d_k, d_p) and torch.equal(i_k, i_p)),
            "index_mismatch": int((i_k != i_p).sum()),
            "max_abs_err": float((d_k - d_p).abs()[both].max()) if bool(both.any()) else 0.0,
            "finite_frac": float(torch.isfinite(d_k).float().mean()),
        }
        log(f"# grid kNN {tag} k={k} exclude_self={excl} rows={rows.numel()}: {json.dumps(res)}")
        check(res["bit_equal"] and res["index_mismatch"] == 0 and res["max_abs_err"] == 0.0, res)


def near_tie_feats(rows: int, gen) -> torch.Tensor:
    """(rows, 64) features built to flip a TF32 selection: norms spread
    over 1e-3..1e3, every 8th row an exact copy of the row 5 before it,
    and every 8th row (from row 3) one ulp above the row before it in
    every element."""
    dev = gen.device
    x = torch.randn((rows, 64), generator=gen, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    x = x * 10.0 ** (6.0 * torch.rand((rows, 1), generator=gen, device=dev) - 3.0)
    dup = torch.arange(8, rows, 8, device=dev)
    x[dup] = x[dup - 5]
    ulp = torch.arange(3, rows, 8, device=dev)
    x[ulp] = torch.nextafter(x[ulp - 1], torch.full_like(x[ulp - 1], torch.inf))
    return x


def knn_phase(dev, N: int, n_valid: int) -> dict:
    """Kernel 3 against its plain version, bit for bit: at the F2S3 tile's
    shape, at k = 8 with exclude_self and on a near-tie stress shape;
    prints the rescored candidates per row; times the kernel, the plain
    version (on ``KNN_PLAIN_ROWS`` query rows) and the composite library
    yardstick."""
    from fusion4landslide_tpu_torch.checks import knn_agreement
    from fusion4landslide_tpu_torch.ops import knn_cuda as kc

    # The check goes through the wrapper the F2S3 step calls (ref mask to
    # +inf norms, dispatch); the timing through the launcher alone.
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit_feats(rows: int) -> torch.Tensor:
        x = torch.randn((rows, 64), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    worst, rows = 0.0, KNN_PLAIN_ROWS
    n8 = min(65536, N)
    ns = min(32768, N)
    stress = near_tie_feats(ns, gen)
    shapes = (
        ("tile", unit_feats(N), unit_feats(N), n_valid, 1, False, rows),
        ("k8", unit_feats(n8), unit_feats(n8), n8 - n8 // 64, 8, True, rows),
        # Self-kNN of the stress rows: exact duplicates tie at distance 0.
        ("near_tie", stress, stress, ns, 8, True, ns),
    )
    rescored = {}
    for tag, fq, fr, m_valid, k, excl, rows_k in shapes:
        n_k = fq.shape[0]
        ref_mask = torch.arange(fr.shape[0], device=dev) < m_valid
        q2 = kc.sq_norms(fq)
        r2 = torch.where(ref_mask, kc.sq_norms(fr), torch.inf)
        d_k, i_k = kc.knn_feature(fq, fr, k, ref_mask, exclude_self=excl)
        rescored[tag] = int(kc.RESCORED[0]) / n_k
        # The first rows: local and global row numbers agree (exclude_self).
        d_p, i_p = kc.knn_plain(fq[:rows_k], fr, k + 1, q2[:rows_k], r2, exclude_self=excl)
        agr = knn_agreement(d_p[:, :k], i_p[:, :k], d_k[:rows_k], i_k[:rows_k], d_next=d_p[:, k])
        agr["bit_equal"] = bool(torch.equal(d_p[:, :k], d_k[:rows_k]) and torch.equal(i_p[:, :k], i_k[:rows_k]))
        agr["rescored_per_row"] = rescored[tag]
        log(f"# feature kNN {tag}: {n_k} x {fr.shape[0]} x 64 k={k} exclude_self={excl} "
            f"rows={rows_k}: {json.dumps(agr)}")
        check(agr["bit_equal"] and agr["finite_equal"] and agr["index_mismatch"] == 0, agr)
        worst = max(worst, agr["max_abs_err"])
        if tag == "tile":
            ms = cuda_ms(lambda: kc._knn_cuda(fq, fr, 1, q2, r2, exclude_self=False), reps=3)
            plain_ms = cuda_ms(lambda: kc.knn_plain(fq[:rows], fr, 1, q2[:rows], r2), reps=1)

            def library():
                # Composite yardstick (no single call): chunked matmul + min.
                for s0 in range(0, n_k, 2048):
                    torch.min(r2[None, :] - 2.0 * torch.matmul(fq[s0:s0 + 2048], fr.T), dim=1)

            library_ms = cuda_ms(library, reps=1)
            # Bound: the 3xTF32 products of the refs up to the last unmasked
            # one on the tensor cores; beside it the same dot in float32 off
            # the tensor cores and the epilogue's per-pair operations.
            in_out = 4 * (2 * n_k * 64 + 2 * n_k + 2 * n_k)
            pairs = n_k * m_valid
            b_ms, b_by = bound(in_out, 3 * 2.0 * pairs * 64, TF32_FLOPS)
            f32_ms, _ = bound(in_out, 2.0 * pairs * 64)
            epi_ms = OPS_KNN_EPILOGUE * pairs / F32_FLOPS * 1e3
    log(f"# phase feature kNN: kernel {ms:.3f} ms (before {MS_BEFORE['knn']} ms), plain "
        f"{plain_ms:.1f} ms on {rows} rows, composite matmul + min {library_ms:.1f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}, 3 x 2 n m D TF32 at 495 TF/s; float32 off the "
        f"tensor cores {f32_ms:.3f} ms, epilogue {epi_ms:.3f} ms), rescored per row "
        f"{json.dumps(rescored)}")
    return dict(
        name="knn", route="cuda", source="fusion4landslide_tpu_torch/csrc/knn.cu",
        replaces="fusion4landslide_tpu/ops/knn_pallas.py:50", max_abs_err=worst, ms=ms,
        plain_ms=plain_ms, plain_rows=rows, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, library="chunked torch.matmul + torch.min (composite, TF32 off)",
        bound_f32_ms=f32_ms, bound_epilogue_ms=epi_ms, rescored_per_row=rescored,
    )


#: The shipped configs the driver phases run, and what each phase changes
#: in them: only paths and file names, plus the RGB phase's camera size.
DRIVER_CONFIGS = {
    "cli_fusion3d": "fusion_3d_brienz.yaml",
    "cli_fusion_rgb": "fusion_brienz.yaml",
    "cli_f2s3": "f2s3_brienz.yaml",
    "cli_rgb_guided": "rgb_guided_brienz.yaml",
    "cli_piecewise": "piecewise_icp_brienz.yaml",
}
#: The two-tile epoch of the driver phases 9, 11 and 16 (and (n), (p),
#: (q)): ``DRIVER_EPOCH`` (145 m x 100 m, 1.45 M points per epoch) cut to
#: half its height, 0.725 M points per epoch, ~0.52 M after the shipped
#: configs' 0.1 m voxel filter; ``max_pts_per_tile`` (the shipped 1 000 000
#: would keep it whole) cuts it into two tiles along x, each holding both
#: halves of the planted shift. It was cut from the whole epoch to give
#: the run's time to phases (n)-(r).
CLI_EPOCH_HEIGHT = 50.0
CLI_TILE_PTS = 400_000
#: The shipped configs' ``min_pts_per_tile`` (phase (p) tiles with it).
CLI_TILE_MIN_PTS = 5000
#: The one-tile epoch (m) of the superpoint driver phase (k) and of the
#: rgb_guided phases: ~353 k points after the voxel filter; zero offset,
#: since the cameras project world coordinates in float32.
RGB_EPOCH = (70.0, 70.0)
#: The RGB+3D driver phase's epoch (m, phase 10), at zero offset for the
#: same reason: 1 345 600 points an epoch, which the shipped
#: ``fusion_brienz.yaml`` keeps whole, one tile of 972 456 / 972 286
#: points after its 0.1 m voxel filter, under its ``max_pts_per_tile`` of
#: 1 000 000 (117 m gives 989 355, 118 m two tiles):
#: ``tests/test_torch_full_tile.py`` holds it to 950 000-1 000 000.
FULL_TILE_EPOCH = (116.0, 116.0)


def write_epoch(root: str, width: float, height: float, offset) -> tuple:
    """An epoch pair (``synth_epoch_pair``) as binary PLY files under
    ``root/raw_pcd``; returns (src, tgt, moving_y) in world coordinates."""
    from fusion4landslide_tpu_torch.io.ply import write_ply
    from fusion4landslide_tpu_torch.synth import synth_epoch_pair

    src, tgt, _ = synth_epoch_pair(width, height, offset=offset)
    os.makedirs(os.path.join(root, "raw_pcd"), exist_ok=True)
    write_ply(os.path.join(root, "raw_pcd", "epoch1.ply"), src)
    write_ply(os.path.join(root, "raw_pcd", "epoch2.ply"), tgt)
    return src, tgt, offset[1] + height / 2


def write_rgb_epoch(root: str, width: float, height: float) -> tuple:
    """``write_epoch`` at zero offset with the RGB+3D driver's image inputs
    under ``root``: the 4096^2 nadir camera's intrinsics and poses, and
    pixel matches for half the source points (``synth_image_channel``,
    ``bench.py``'s recipe) as precomputed matches. Returns (src,
    moving_y, (M, 4) pixel matches, metres per pixel)."""
    from fusion4landslide_tpu_torch.synth import IMG_SIZE, PLANTED_SHIFT, synth_image_channel

    src, _, moving_y = write_epoch(root, width, height, (0.0, 0.0, 0.0))
    tgt_of_src = src.copy()
    tgt_of_src[src[:, 1] > moving_y] += PLANTED_SHIFT
    pix, K, E, m_per_px = synth_image_channel(src.astype(np.float32),
                                              tgt_of_src.astype(np.float32),
                                              len(src) // 2, IMG_SIZE)
    os.makedirs(os.path.join(root, "image", "transformations"))
    os.makedirs(os.path.join(root, "img_matching_results"))
    np.savetxt(os.path.join(root, "image", "camera_intrinsic.txt"), K, delimiter=" ")
    for epoch in (1, 2):
        np.savetxt(os.path.join(root, "image", "transformations", f"pose_epoch{epoch}.txt"),
                   np.linalg.inv(E.astype(np.float64)), delimiter=" ")
    np.savetxt(os.path.join(root, "img_matching_results", "pixel_matches.txt"), pix,
               fmt="%.6f")
    return src, moving_y, pix, m_per_px


#: The stages of the host RGB+3D tile phase 10 prints on a line of their own.
RGB_DRIVER_STAGES = ("median_resolution", "dips_features", "global_3d_matches", "rgb_2d",
                     "partition_l1", "sparse_assign", "write_tables")


def fusion_rgb_driver_phase(tmp: str, weights: str) -> dict:
    """Phase 10: ``main_fusion`` RGB+3D with ``fusion_brienz.yaml`` (only
    paths, file names and the camera's ``image_size`` changed) on
    ``FULL_TILE_EPOCH``, one tile at the shipped size on the host tile;
    returns its launches."""
    from fusion4landslide_tpu_torch.io.ply import read_ply
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.synth import IMG_SIZE

    data = os.path.join(tmp, "full_tile_epoch")
    t0 = time.perf_counter()
    src, moving_y, pix, m_per_px = write_rgb_epoch(data, *FULL_TILE_EPOCH)
    changes = {"input_root": data, "output_dir": os.path.join(tmp, "fusion_rgb"),
               "weight_dir": weights, "src_pcd": "epoch1.ply", "tgt_pcd": "epoch2.ply",
               "image_size": list(IMG_SIZE)}
    cfg = driver_config(DRIVER_CONFIGS["cli_fusion_rgb"], os.path.join(tmp, "rgb.yaml"), changes)
    log(f"# phase main_fusion RGB+3D: {DRIVER_CONFIGS['cli_fusion_rgb']} with "
        f"{sorted(changes)} changed; {FULL_TILE_EPOCH[0]:g} x {FULL_TILE_EPOCH[1]:g} m epoch, "
        f"{len(src)} points, written in {time.perf_counter() - t0:.2f} s; {len(pix)} pixel "
        f"matches, a {IMG_SIZE[0]}^2 camera, {m_per_px:.5f} m per pixel")
    summary, stdout = run_driver("main_fusion", cfg)
    log_driver("main_fusion RGB+3D", summary)
    check(summary["launches"]["grid_knn"] > 0 and summary["launches"]["radius_sample"] > 0,
          summary["launches"])
    check(sum(summary["overflow"].values()) == 0, f"window overflow {summary['overflow']}")
    vox = re.search(r"median_res=([\d.]+), voxels src=(\d+) tgt=(\d+)", stdout)
    check(vox, "main_fusion logged no voxel counts")
    n_vox = [int(vox.group(2)), int(vox.group(3))]
    out_root = os.path.join(tmp, "fusion_rgb", "demo_run")
    check(list(summary["tile_s"]) == ["0"], summary["tile_s"])
    sizes = [len(read_ply(os.path.join(out_root, "tiled_data", "non_overlap",
                                       f"{side}_tile_0.ply")).points)
             for side in ("source", "target")]
    check(all(950_000 <= k <= 1_000_000 for k in sizes), f"tile sizes {sizes}")
    stages = summary["stages_s"]["0"]
    log(f"# main_fusion RGB+3D tile 0 ({card()}): source / target {sizes[0]} / {sizes[1]} "
        f"points in buckets {bucket_size(sizes[0])} / {bucket_size(sizes[1])}; tile "
        f"{summary['tile_s']['0']:.2f} s, tiling {summary.get('tiling_s', 0.0):.2f} s, reading "
        f"tiles {summary['read_tiles_s']:.2f} s, process start "
        f"{summary['wall_s'] - summary['total_s']:.2f} s; stages (s) "
        + json.dumps({k: round(stages[k], 2) for k in RGB_DRIVER_STAGES if k in stages})
        + f"; median resolution {vox.group(1)} m, voxels {n_vox} (DIPs "
        f"{1e6 * stages['dips_features'] / sum(n_vox):.2f} us a voxel); peak "
        f"{summary['peak_mem_gib']:.2f} GiB, free / total after the run "
        f"{summary['mem_free_total_gib']} GiB")
    tables = tile_tables(out_root, "0", "c2f_")
    check("c2f_dvfms_from_global_2d_src2tgt_wo_pruning_visualize_tile_0.txt" in tables, tables)
    rec = driver_recovery(out_root, "0", "c2f_dvfs_src2tgt_tile_0.txt", moving_y)
    tol = RECOVERY_RGB["err_floor_m"] + RECOVERY_RGB["err_per_m_per_px"] * m_per_px
    log(f"# main_fusion RGB+3D tables {tables}; recovery {json.dumps(rec)} (bench.py's "
        f"targets: core assigned > {RECOVERY_RGB['core_assigned']}, median errors < "
        f"{tol:.5f} m)")
    check(rec["core_assigned"] > RECOVERY_RGB["core_assigned"], rec)
    check(rec["moving_err_m"] is not None and rec["moving_err_m"] < tol, rec)
    check(rec["static_err_m"] is not None and rec["static_err_m"] < tol, rec)
    return summary["launches"]


#: The keys a driver phase may add to a shipped config: no shipped YAML
#: has them, and the drivers read them (``cfg.get("use_mesh", "auto")``,
#: ``cfg.get("icp_type", "point2point")``).
ADDED_KEYS = ("use_mesh", "icp_type")


def driver_config(name: str, path: str, changes: dict) -> str:
    """``configs/landslide/<name>`` with ``changes`` set in the sections
    that hold each key (every key must exist, but ``ADDED_KEYS``, which go
    to the ``method`` section), written to ``path``."""
    import yaml

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "landslide", name)) as f:
        raw = yaml.safe_load(f)
    for key, val in changes.items():
        sections = [sec for sec in raw.values() if isinstance(sec, dict) and key in sec]
        if not sections and key in ADDED_KEYS:
            sections = [raw["method"]]
        check(sections, f"{name} has no key {key}")
        for sec in sections:
            sec[key] = val
    with open(path, "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)
    return path


def run_driver(module: str, cfg_path: str) -> tuple[dict, str]:
    """``python3 -m fusion4landslide_tpu_torch.<module> --config cfg_path``
    on the card; returns its ``run summary`` (plus ``wall_s``, process
    start included) and its standard output."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"fusion4landslide_tpu_torch.{module}",
                           "--config", cfg_path], cwd=here, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise RuntimeError(f"chip_smoke check failed: {module} exited {proc.returncode}")
    line = [x for x in proc.stdout.splitlines() if "run summary: " in x]
    check(line, f"{module} printed no run summary")
    summary = json.loads(line[-1].split("run summary: ", 1)[1])
    summary["wall_s"] = wall
    return summary, proc.stdout


def tile_tables(out_root: str, tid: str, prefix: str) -> list[str]:
    """The result tables of one tile whose names start with ``prefix``."""
    results = os.path.join(out_root, "results")
    own = re.compile(rf"tile_{tid}(\D|$)")
    return sorted(os.path.relpath(os.path.join(d, f), results)
                  for d, _, fs in os.walk(results) for f in fs
                  if own.search(f) and f.startswith(prefix))


def driver_recovery(out_root: str, tid: str, table: str, moving_y: float) -> dict:
    """Recovery readings of one driver tile from its written dvfs table."""
    from fusion4landslide_tpu_torch.checks import driver_tile_recovery
    from fusion4landslide_tpu_torch.io.ply import read_ply
    from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT

    core = read_ply(os.path.join(out_root, "tiled_data", "non_overlap",
                                 f"source_tile_{tid}.ply")).points
    rows = np.loadtxt(os.path.join(out_root, "results", table), ndmin=2).reshape(-1, 6)
    check(np.isfinite(rows).all() and len(rows) > 0, f"{table}: empty or not finite")
    return driver_tile_recovery(core, rows[:, :3], rows[:, 3:6] - rows[:, :3], moving_y,
                                PLANTED_SHIFT.astype(np.float64))


def log_driver(label: str, summary: dict) -> None:
    """The run's per-tile seconds and stage times, peak memory, tiling and
    reading seconds, launches."""
    stages = {tid: {k: round(v, 3) for k, v in st.items()}
              for tid, st in summary["stages_s"].items()}
    log(f"# {label}: wall {summary['wall_s']:.2f} s (process start included), driver "
        f"{summary['total_s']:.2f} s, runner {summary.get('runner_s', 0.0):.2f} s, tiling "
        f"{summary.get('tiling_s', 0.0):.2f} s, reading "
        f"tiles {summary['read_tiles_s']:.2f} s, loading weights "
        f"{summary.get('load_weights_s', 0.0):.2f} s, peak {summary['peak_mem_gib']} GiB, "
        f"launches {summary['launches']}, window overflow {summary['overflow']}")
    log(f"# {label} tile seconds: " + json.dumps({k: round(v, 2)
                                                 for k, v in summary["tile_s"].items()}))
    log(f"# {label} stages (s): " + json.dumps(stages))


def driver_phases(dips, agg, filt) -> dict:
    """Phases 9-11: the drivers from files on disk, as subprocesses on
    the card; returns their launches by path."""
    from fusion4landslide_tpu_torch.models.convert import write_reference_checkpoints
    from fusion4landslide_tpu_torch.synth import DRIVER_EPOCH

    here = os.path.dirname(os.path.abspath(__file__))
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        weights = os.path.join(tmp, "weights")
        write_reference_checkpoints(weights, dips=dips, agg=agg, filt=filt)
        data = os.path.join(tmp, "epoch")
        t0 = time.perf_counter()
        src, _, moving_y = write_epoch(data, DRIVER_EPOCH["width"], CLI_EPOCH_HEIGHT,
                                       DRIVER_EPOCH["offset"])
        log(f"# driver epoch: {len(src)} points per epoch over {DRIVER_EPOCH['width']:g} x "
            f"{CLI_EPOCH_HEIGHT:g} m, written in {time.perf_counter() - t0:.2f} s, "
            f"max_pts_per_tile {CLI_TILE_PTS}; checkpoints {sorted(os.listdir(weights))}")

        # ---- 9. main_fusion, 3D-only, use_mesh unset ---------------------
        changes = {"input_root": data, "output_dir": os.path.join(tmp, "fusion3d"),
                   "weight_dir": weights, "src_pcd": "epoch1.ply", "tgt_pcd": "epoch2.ply",
                   "max_pts_per_tile": CLI_TILE_PTS}
        cfg = driver_config(DRIVER_CONFIGS["cli_fusion3d"], os.path.join(tmp, "fusion3d.yaml"),
                            changes)
        log(f"# phase main_fusion 3D-only: {DRIVER_CONFIGS['cli_fusion3d']} with "
            f"{sorted(changes)} changed")
        summary, _ = run_driver("main_fusion", cfg)
        log_driver("main_fusion 3D-only", summary)
        by_path["cli_fusion3d"] = summary["launches"]
        check(summary["launches"]["grid_knn"] > 0 and summary["launches"]["radius_sample"] > 0,
              summary["launches"])
        out_root = os.path.join(tmp, "fusion3d", "demo_run")
        tiles = sorted(summary["tile_s"])
        check(len(tiles) == 2, f"the epoch should make two tiles, made {tiles}")
        for tid in tiles:
            tables = tile_tables(out_root, tid, "c2f_")
            for name in (f"c2f_dvfs_src2tgt_tile_{tid}.txt", f"c2f_dvfms_src2tgt_tile_{tid}.txt",
                         f"c2f_dvfms_src2tgt_visualize_tile_{tid}.txt",
                         f"c2f_dvfms_src2tgt_discrete_visualize_tile_{tid}.txt"):
                check(name in tables, (name, tables))
            rec = driver_recovery(out_root, tid, f"c2f_dvfs_src2tgt_tile_{tid}.txt", moving_y)
            log(f"# main_fusion 3D-only tile {tid} tables {tables}; recovery {json.dumps(rec)} "
                f"(floors {json.dumps(RECOVERY_CLI)})")
            check(rec["static_assigned"] > RECOVERY_CLI["static_assigned"], rec)
            check(rec["static_err_m"] < RECOVERY_CLI["static_err_m"], rec)
            check(rec["moving_err_m"] is not None
                  and rec["moving_err_m"] < RECOVERY_CLI["moving_err_m"], rec)
        again, out = run_driver("main_fusion", cfg)
        log(f"# main_fusion second run: {again['wall_s']:.2f} s, tiles run {sorted(again['tile_s'])}, "
            f"{out.count('already complete; skipping')} skipped")
        check(not again["tile_s"] and out.count("already complete; skipping") == 2, again)

        # ---- (p) the native tiler on the same epoch files -----------------
        t_new = time.perf_counter()
        native_tiler_phase(tmp, data, summary.get("tiling_s"))
        PHASES_N_R_S[0] += time.perf_counter() - t_new

        # ---- 10. main_fusion, RGB+3D, one tile at the shipped size ---------
        by_path["cli_fusion_rgb"] = fusion_rgb_driver_phase(tmp, weights)
        rgb_data = os.path.join(tmp, "rgb_epoch")
        _, _, r_moving_y = write_epoch(rgb_data, *RGB_EPOCH, (0.0, 0.0, 0.0))

        # ---- (k) main_fusion 3D-only with partition_type: superpoint ------
        t_new = time.perf_counter()
        summary, rec = superpoint_driver_run(tmp, rgb_data, weights, r_moving_y, "fusion_sp")
        by_path["cli_fusion3d_superpoint"] = summary["launches"]
        check(summary["launches"]["grid_knn"] > 0 and summary["launches"]["radius_sample"] > 0,
              summary["launches"])
        check(rec["static_assigned"] > RECOVERY_SUPERPOINT["static_assigned"], rec)
        check(rec["static_err_m"] is not None
              and rec["static_err_m"] < RECOVERY_SUPERPOINT["static_err_m"], rec)
        check(rec["moving_err_m"] is not None
              and rec["moving_err_m"] < RECOVERY_SUPERPOINT["moving_err_m"], rec)
        NEW_PHASE_S[0] += time.perf_counter() - t_new

        # ---- 11. main_f2s3, use_mesh unset -------------------------------
        changes = {"data_dir": data, "output_dir": os.path.join(tmp, "f2s3"),
                   "weight_dir": weights, "src_name": "epoch1.ply", "tgt_name": "epoch2.ply",
                   "max_pts_per_tile": CLI_TILE_PTS, "save_interim": True}
        cfg = driver_config(DRIVER_CONFIGS["cli_f2s3"], os.path.join(tmp, "f2s3.yaml"), changes)
        log(f"# phase main_f2s3: {DRIVER_CONFIGS['cli_f2s3']} with {sorted(changes)} changed")
        summary, _ = run_driver("main_f2s3", cfg)
        log_driver("main_f2s3", summary)
        by_path["cli_f2s3"] = summary["launches"]
        check(min(summary["launches"].values()) > 0, summary["launches"])
        out_root = os.path.join(tmp, "f2s3", "demo_run")
        check(sorted(summary["tile_s"]) == tiles, summary["tile_s"])
        for tid in tiles:
            tables = tile_tables(out_root, tid, "")
            for name in (f"f2s3_dvfs_of_tile_{tid}.txt", f"f2s3_dvfms_of_tile_{tid}.txt",
                         f"f2s3_dvfms_of_tile_{tid}_visualize_0_5.txt",
                         f"f2s3_dvfms_without_pruning_of_tile_{tid}.txt",
                         os.path.join("filtered_by_magnitude",
                                      f"f2s3_dvfms_filtered_by_median_mag_of_tile_{tid}.txt"),
                         os.path.join("combined_with_c2c",
                                      f"f2s3_dvfms_combined_with_c2c_of_tile_{tid}.txt")):
                check(name in tables, (name, tables))
            rec = driver_recovery(out_root, tid, f"f2s3_dvfs_of_tile_{tid}.txt", moving_y)
            log(f"# main_f2s3 tile {tid} recovery (kept = core_assigned): {json.dumps(rec)} "
                f"(floors {json.dumps(RECOVERY_CLI_F2S3)})")
            check(rec["core_assigned"] > RECOVERY_CLI_F2S3["kept"], rec)
            check(rec["static_err_m"] is not None
                  and rec["static_err_m"] < RECOVERY_CLI_F2S3["static_err_m"], rec)
            check(rec["moving_err_m"] is not None
                  and rec["moving_err_m"] < RECOVERY_CLI_F2S3["moving_err_m"], rec)

        # ---- (n) the F2S3 feature cache: tile 0 again, from its cache -----
        t_new = time.perf_counter()
        by_path["cli_f2s3_cache"] = f2s3_cache_phase(tmp, changes, summary)
        PHASES_N_R_S[0] += time.perf_counter() - t_new

        # ---- 13.-16. (b)-(e): rgb_guided and piecewise ICP ----------------
        by_path.update(rgb_guided_phases(tmp))
        by_path.update(piecewise_phases(tmp, data, moving_y,
                                        os.path.join(tmp, "fusion3d", "demo_run", "tiled_data")))
    return by_path


#: The F1 witness (ROADMAP.md queue 3): 200 000 targets uniform over
#: 50 m x 50 m with 2 cm of height noise, 3 000 uniform sources, centred on
#: the target mean (seed 0). Without the exact rerun 227 of its 3 000 1-NN
#: rows were over 1 mm off, by up to 28.45 m.
F1_WITNESS = {"targets": 200_000, "sources": 3000, "side_m": 50.0, "z_sigma_m": 0.02}


def nn1_overflow_phase(dev) -> dict:
    """(a) ``nn1_spatial`` on the F1 witness on the card against an exact
    float64 brute-force 1-NN: no row more than 1 mm off. Returns the
    launches of the call."""
    from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, hash_grid_knn, nn1_spatial

    w = F1_WITNESS
    rng = np.random.default_rng(0)
    t = np.column_stack([rng.uniform(0, w["side_m"], (w["targets"], 2)),
                         rng.normal(0, w["z_sigma_m"], w["targets"])]).astype(np.float32)
    q = np.column_stack([rng.uniform(0, w["side_m"], (w["sources"], 2)),
                         rng.normal(0, w["z_sigma_m"], w["sources"])]).astype(np.float32)
    c = t.mean(axis=0)
    td, qd = torch.from_numpy(t - c).to(dev), torch.from_numpy(q - c).to(dev)
    r0 = 4.0 * float(np.sqrt(w["side_m"] ** 2 / w["targets"]))
    first_overflow = int(hash_grid_knn(qd, build_hash_grid(td, r0), r0, 1)[2])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, idx = nn1_spatial(qd, td)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    exact = torch.cdist(qd.double(), td.double()).min(dim=1).values
    got = torch.linalg.norm(td[idx.long()].double() - qd.double(), dim=1)
    off = got - exact
    res = {"first_radius_overflow": first_overflow, "rows_over_1mm": int((off > 1e-3).sum()),
           "max_excess_m": float(off.max()), "seconds": secs, "launches": launches}
    log(f"# phase (a) nn1_spatial on the F1 witness ({w['sources']} x {w['targets']}), card vs "
        f"exact float64 1-NN: {json.dumps(res)}")
    check(first_overflow > 0 and res["rows_over_1mm"] == 0, res)
    check(launches["grid_knn"] > 0, launches)
    return launches


#: rgb_guided_brienz.yaml's camera (image_size [1920, 2560]), crops and
#: matcher settings; the phases change only paths, file names and
#: ``img_matching_type: zncc``.
RGB_GUIDED_IMAGE = (1920, 2560)
#: Recovery floors of the rgb_guided driver on ``RGB_EPOCH`` (its moving
#: half y > 35 m shifted by ``PLANTED_SHIFT``): the core fraction written,
#: and the error of each half's median displacement vector. On an H100
#: 80GB HBM3 (700 W) the sound host tile and runner write 99.999% of the
#: core, at 0.78 / 0.91 mm on the moving half and 0.83 / 0.79 mm on the
#: static half; with the source image as the target image (zero flow,
#: ``rgb_guided_broken_run``) the moving half reads 16.8 mm (ICP on the
#: chained target points still recovers part of the shift), the static half
#: 0.76 mm, 99.99% written. Only the moving half's floor separates the two;
#: the static and coverage floors are regression alarms above the sound
#: readings.
RECOVERY_RGB_GUIDED = {"core_assigned": 0.9, "moving_vec_err_m": 8e-3, "static_vec_err_m": 5e-3}
#: Recovery floors of the same driver run with the shipped matcher
#: (``img_matching_type: eloftr``, ``weights/eloftr_tiny.npz``; phase (h)).
#: On an H100 80GB HBM3 (700 W) the sound host tile writes 99.86% of the
#: core, at 9.66 mm on the moving half and 7.83 mm on the static half (ZNCC:
#: 0.78 / 0.83 mm); with the source image as the target image
#: (``eloftr_broken_run``) the moving half reads 26.1 mm, the static half
#: 7.79 mm, 99.99% written. Only the moving half's floor separates the two;
#: the static and coverage floors are regression alarms above the sound
#: readings.
RECOVERY_RGB_GUIDED_ELOFTR = {"core_assigned": 0.9, "moving_vec_err_m": 16e-3,
                              "static_vec_err_m": 12e-3}


def write_rgb_guided_epoch(root: str, broken: bool = False):
    """``RGB_EPOCH`` as PLY files, its textured image pair at
    ``RGB_GUIDED_IMAGE`` and camera files under ``root``; ``broken`` writes
    the source image as the target image too (zero flow). Returns
    (moving_y, src image, tgt image, metres per pixel, render seconds)."""
    from fusion4landslide_tpu_torch.synth import synth_textured_images, write_camera_files

    src, tgt, moving_y = write_epoch(root, *RGB_EPOCH, (0.0, 0.0, 0.0))
    t0 = time.perf_counter()
    img0, img1, K, E, m_per_px = synth_textured_images(src, tgt, RGB_GUIDED_IMAGE)
    if broken:
        img1 = img0
    write_camera_files(root, K, E, (img0, img1))
    return moving_y, img0, img1, m_per_px, time.perf_counter() - t0


def zncc_phase(dev, img0: np.ndarray, img1: np.ndarray) -> dict:
    """(b) ZNCC on the first crop pair of the rendered images
    (rgb_guided_brienz.yaml's crop and matcher defaults), card vs the
    port's CPU path. cuDNN and the CPU sum the correlations in other
    orders, so near-tie argmaxes (a flow between two integer offsets) and
    flat correlation surfaces may differ: the kept-set overlap, the rows
    whose flows differ by more than 0.05 px (counted, at most 1%), the
    median and largest flow gap on common rows, seconds per crop pair."""
    from fusion4landslide_tpu_torch.image.matching import zncc_grid_match

    ch, cw = 960, 1280
    c0, c1 = img0[:ch, :cw], img1[:ch, :cw]
    zncc_grid_match(c0, c1, device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = zncc_grid_match(c0, c1, device=dev)
    g_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = zncc_grid_match(c0, c1, device="cpu")
    c_s = time.perf_counter() - t0
    kg = {tuple(r): i for i, r in enumerate(g[:, :2].tolist())}
    kc = {tuple(r): i for i, r in enumerate(c[:, :2].tolist())}
    common = sorted(set(kg) & set(kc))
    gap = np.abs(g[[kg[k] for k in common], 2:] - c[[kc[k] for k in common], 2:]).max(axis=1)
    res = {"kept_card": len(g), "kept_cpu": len(c),
           "keep_overlap_frac": len(common) / max(len(g), len(c), 1),
           "rows_flow_gap_over_0.05px": int((gap > 0.05).sum()),
           "median_flow_gap_px": float(np.median(gap)), "max_flow_gap_px": float(gap.max()),
           "card_s_per_crop_pair": g_s, "cpu_s_per_crop_pair": c_s}
    log(f"# phase (b) ZNCC, first {ch}x{cw} crop pair, card vs CPU path: {json.dumps(res)}")
    check(res["keep_overlap_frac"] >= 0.999 and res["median_flow_gap_px"] <= 1e-4, res)
    check(res["rows_flow_gap_over_0.05px"] <= 0.01 * len(common), res)
    return res


#: The learned matchers' checkpoints in the repository (what
#: ``img_matching_type: eloftr`` / ``roma`` resolve to).
ELOFTR_WEIGHTS = os.path.join("weights", "eloftr_tiny.npz")
ROMA_WEIGHTS = os.path.join("weights", "roma_tiny.npz")
#: rgb_guided_brienz.yaml's crop.
CROP = (960, 1280)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def matcher_core(model):
    """(prepare, core) of a learned matcher module, E-LoFTR or classic
    LoFTR: ``prepare(c0, c1, device)`` -> the two images, ``core(model,
    t0, t1, mark)`` -> (u0, v0, u1, v1, confidence, ok) per coarse cell."""
    from fusion4landslide_tpu_torch.image.eloftr import eloftr_core, eloftr_prepare
    from fusion4landslide_tpu_torch.image.loftr_classic import (
        ClassicLoFTR,
        classic_loftr_core,
        classic_prepare,
    )

    if isinstance(model, ClassicLoFTR):
        return classic_prepare, lambda m, t0, t1, mark=None: classic_loftr_core(
            m, t0, t1, m.cfg.match_threshold, mark)
    return eloftr_prepare, eloftr_core


def eloftr_dense(model, c0: np.ndarray, c1: np.ndarray):
    """A learned matcher's dense outputs on one crop pair: ((S, 4) [u0 v0
    u1 v1] per coarse cell of img0, (S,) ok) as numpy."""
    prepare, core = matcher_core(model)
    out = core(model, *prepare(c0, c1, next(model.parameters()).device))
    return torch.stack(out[:4], dim=1).cpu().numpy(), out[5].cpu().numpy()


def eloftr_compare(g_model, c_model, c0: np.ndarray, c1: np.ndarray) -> dict:
    """Card vs CPU path on one crop pair: kept-set sizes and overlap (cells
    kept by both over the larger set; 1 when both are empty), |duv| (the
    largest of the four coordinate gaps) on the common cells (median, max,
    rows over 0.05 px and 1 px), and the same over every coarse cell."""
    ug, okg = eloftr_dense(g_model, c0, c1)
    uc, okc = eloftr_dense(c_model, c0, c1)
    gap = np.abs(ug - uc).max(axis=1)
    both = okg & okc
    big = max(int(okg.sum()), int(okc.sum()))
    g = gap[both]
    return {"cells": len(gap), "kept_card": int(okg.sum()), "kept_cpu": int(okc.sum()),
            "keep_overlap_frac": float(both.sum()) / big if big else 1.0,
            "median_duv_px": float(np.median(g)) if g.size else None,
            "max_duv_px": float(g.max()) if g.size else None,
            "rows_duv_over_0.05px": int((g > 0.05).sum()),
            "rows_duv_over_1px": int((g > 1.0).sum()),
            "all_cells_median_duv_px": float(np.median(gap)),
            "all_cells_over_1px": int((gap > 1.0).sum())}


def eloftr_timing(model, c0: np.ndarray, c1: np.ndarray, reps: int = 3) -> dict:
    """Seconds per crop pair on the card (warm, synchronised, the crop's
    upload included; the first call apart), one synchronised run split by
    stage, and the peak
    device memory of a call (absolute, and above what was allocated
    before it)."""
    eloftr_prepare, eloftr_core = matcher_core(model)
    dev = next(model.parameters()).device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eloftr_core(model, *eloftr_prepare(c0, c1, dev))  # warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        eloftr_core(model, *eloftr_prepare(c0, c1, dev))
    torch.cuda.synchronize()
    per_pair = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    stages: dict = {}
    inputs = eloftr_prepare(c0, c1, dev)
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    eloftr_core(model, *inputs, mark)
    return {"s_per_crop_pair": per_pair, "first_call_s": first, "stages_s": stages,
            "peak_gib": peak / 2**30,
            "peak_above_base_gib": (peak - base) / 2**30}


def eloftr_phase(dev, img0: np.ndarray, img1: np.ndarray) -> dict:
    """(f) E-LoFTR with the shipped weights on the first crop pair of the
    rendered images, card vs the port's CPU path. cuBLAS and the CPU sum in
    other orders, so near-tie cells of the exact mutual-max test and of the
    fine argmaxes may differ: counted, with the overlap held to >= 99% and
    the median |duv| to <= 1e-3 px."""
    from fusion4landslide_tpu_torch.image.eloftr import load_eloftr_weights

    here = os.path.dirname(os.path.abspath(__file__))
    c0, c1 = img0[:CROP[0], :CROP[1]], img1[:CROP[0], :CROP[1]]
    g_model = load_eloftr_weights(os.path.join(here, ELOFTR_WEIGHTS), dev)
    c_model = load_eloftr_weights(os.path.join(here, ELOFTR_WEIGHTS), "cpu")
    timing = eloftr_timing(g_model, c0, c1)
    t0 = time.perf_counter()
    res = eloftr_compare(g_model, c_model, c0, c1)
    res.update(timing, compare_s=time.perf_counter() - t0)
    res["known_shifts"] = eloftr_known_shifts(g_model, c0)
    log(f"# phase (f) E-LoFTR ({ELOFTR_WEIGHTS}), first {CROP[0]}x{CROP[1]} crop pair, card vs CPU "
        f"path ({card()}): {json.dumps(res)}")
    check(res["kept_card"] > 0 and res["keep_overlap_frac"] >= 0.99, res)
    check(res["median_duv_px"] is not None and res["median_duv_px"] <= 1e-3, res)
    return res


#: Shifts (dy, dx) in pixels of ``eloftr_known_shifts``: none, one coarse
#: cell, and a few pixels off the cell grid.
KNOWN_SHIFTS = ((0, 0), (0, 8), (3, -5))


def eloftr_known_shifts(model, c0: np.ndarray) -> dict:
    """E-LoFTR's flow error on the card where the true flow is known: the
    crop against itself rolled by each of ``KNOWN_SHIFTS``; per shift the
    kept matches at least 16 px inside the crop, their median end-point
    error and median flow error per axis (px)."""
    from fusion4landslide_tpu_torch.image.eloftr import eloftr_match

    out = {}
    for dy, dx in KNOWN_SHIFTS:
        uv, _ = eloftr_match(model, c0, np.roll(c0, (dy, dx), axis=(0, 1)))
        h, w = c0.shape[:2]
        inner = ((uv[:, 0] > 16) & (uv[:, 0] < w - 16) & (uv[:, 1] > 16) & (uv[:, 1] < h - 16))
        err = uv[inner, 2:] - uv[inner, :2] - np.array([dx, dy], np.float32)
        out[f"{dy},{dx}"] = {
            "kept": int(inner.sum()),
            "median_epe_px": float(np.median(np.linalg.norm(err, axis=1))) if len(err) else None,
            "median_err_xy_px": np.median(err, axis=0).tolist() if len(err) else None}
    return out


#: (g)'s card-vs-CPU crop (the top-left corner of the rendered images).
UPSTREAM_CHECK_CROP = (256, 320)


def eloftr_upstream_phase(dev, img0: np.ndarray, img1: np.ndarray) -> dict:
    """(g) E-LoFTR at the upstream width (``ELoFTRConfig()``: blocks
    (1, 2, 4, 14), channels (64, 64, 128, 256), hidden 256, 4 layers, 8
    heads) with ``seeded_eloftr(cfg, 0)``: seconds per crop pair and peak
    memory at the shipped crop on the card; card vs CPU on a smaller crop,
    over the kept cells (random weights may keep none) and every coarse
    cell."""
    from fusion4landslide_tpu_torch.image.eloftr import ELoFTRConfig, seeded_eloftr

    cfg = ELoFTRConfig()
    g_model = seeded_eloftr(cfg, 0, dev)
    res = eloftr_timing(g_model, img0[:CROP[0], :CROP[1]], img1[:CROP[0], :CROP[1]])
    h, w = UPSTREAM_CHECK_CROP
    t0 = time.perf_counter()
    res["check"] = eloftr_compare(g_model, seeded_eloftr(cfg, 0, "cpu"), img0[:h, :w], img1[:h, :w])
    res["compare_s"] = time.perf_counter() - t0
    log(f"# phase (g) E-LoFTR upstream width, seeded weights ({card()}): {CROP[0]}x{CROP[1]} "
        f"on the card, {h}x{w} card vs CPU path: {json.dumps(res)}")
    chk = res["check"]
    check(chk["keep_overlap_frac"] >= 0.99 and chk["all_cells_median_duv_px"] <= 1e-3, chk)
    check(chk["median_duv_px"] is None or chk["median_duv_px"] <= 1e-3, chk)
    return res


def roma_phase(dev, img0: np.ndarray, img1: np.ndarray) -> dict:
    """(i) RoMa with the shipped weights on the first crop pair, card vs
    the port's CPU path: the certainty-weighted forward-backward consistent
    fraction and the self-check at the shipped settings (the JAX package
    expects it to fail at production crops), seconds per crop pair, and
    whether ``match_epoch_images`` fell back to ZNCC; then the sampling
    path with the self-check off (``fb_min_frac=0``), the card's draws fed
    to the CPU path, the matches compared row by row. At ``work_size`` 224
    the GP's Gram matrix is ill-conditioned (condition ~8e5), so float32
    solves on the card and on the CPU differ and the warps move by about a
    crop pixel: the median row is held within one work-resolution pixel."""
    import logging

    from fusion4landslide_tpu_torch.image.matching import match_epoch_images, roma_crop_match
    from fusion4landslide_tpu_torch.image.roma import load_roma_weights

    here = os.path.dirname(os.path.abspath(__file__))
    c0, c1 = img0[:CROP[0], :CROP[1]], img1[:CROP[0], :CROP[1]]
    g_model = load_roma_weights(os.path.join(here, ROMA_WEIGHTS), dev)
    c_model = load_roma_weights(os.path.join(here, ROMA_WEIGHTS), "cpu")
    roma_crop_match(g_model, c0, c1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = roma_crop_match(g_model, c0, c1)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    c = roma_crop_match(c_model, c0, c1)
    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("chip_smoke.roma")
    logger.addHandler(handler)
    try:
        m = match_epoch_images(c0, c1, matcher="roma", weights=os.path.join(here, ROMA_WEIGHTS),
                               logger=logger, device=dev)
    finally:
        logger.removeHandler(handler)
    fell_back = any("falling back to the ZNCC matcher" in r.getMessage() for r in records)
    gs = roma_crop_match(g_model, c0, c1, fb_min_frac=0.0, min_certainty=0.0)
    cs = roma_crop_match(c_model, c0, c1, fb_min_frac=0.0, min_certainty=0.0,
                         sample_idx=gs.sample_idx.cpu())
    gap = np.abs(gs.matches - cs.matches).max(axis=1)
    res = {"fb_frac_card": g.fb_frac, "fb_frac_cpu": c.fb_frac, "self_check_card": g.passed,
           "self_check_cpu": c.passed, "card_s_per_crop_pair": g_s,
           "match_epoch_images_rows": len(m), "zncc_fallback_ran": fell_back,
           "sampled": len(gs.matches),
           "sampled_median_gap_px": float(np.median(gap)),
           "sampled_max_gap_px": float(gap.max()),
           "sampled_rows_gap_over_1px": int((gap > 1.0).sum())}
    log(f"# phase (i) RoMa ({ROMA_WEIGHTS}), first {CROP[0]}x{CROP[1]} crop pair, card vs CPU path "
        f"({card()}): {json.dumps(res)}")
    check(g.passed == c.passed and abs(g.fb_frac - c.fb_frac) <= 0.01, res)
    check(fell_back == (not g.passed) and len(m) > 0, res)
    check(res["sampled_median_gap_px"] <= CROP[1] / 224, res)
    return res


def rgb_guided_recovery(out_root: str, moving_y: float) -> dict:
    """Recovery readings of the rgb_guided driver's one tile."""
    return driver_recovery(out_root, "0", "rgb_guided_w_refinement_dvfs_src2tgt_tile_0.txt",
                           moving_y)


def rgb_guided_phases(tmp: str) -> dict:
    """(b)-(d) and (f)-(i): the rendered image pair's matcher checks (ZNCC,
    E-LoFTR shipped and at the upstream width, RoMa), then
    ``main_rgb_guided`` on ``RGB_EPOCH`` with ZNCC and ``use_mesh: auto``
    (host tile, reading the epoch's E57 copies written by (o)) and
    ``true`` (runner; the tiles copied from the first run),
    and with the shipped ``eloftr`` matcher and ``use_mesh: auto``. Returns
    the launches by path."""
    import re
    import shutil

    dev = torch.device("cuda")
    data = os.path.join(tmp, "rgb_guided_epoch")
    moving_y, img0, img1, m_per_px, render_s = write_rgb_guided_epoch(data)
    log(f"# rgb_guided epoch: {RGB_EPOCH[0]:g} x {RGB_EPOCH[1]:g} m, images "
        f"{RGB_GUIDED_IMAGE[0]}x{RGB_GUIDED_IMAGE[1]} at {m_per_px:.5f} m per pixel, rendered in "
        f"{render_s:.2f} s")
    t_new = time.perf_counter()
    e57_phase(data)
    PHASES_N_R_S[0] += time.perf_counter() - t_new
    zncc_phase(dev, img0, img1)
    t_new = time.perf_counter()
    eloftr_phase(dev, img0, img1)
    eloftr_upstream_phase(dev, img0, img1)
    roma_phase(dev, img0, img1)
    new_s = time.perf_counter() - t_new
    t_new = time.perf_counter()
    classic_loftr_phase(dev, img0, img1)
    NEW_PHASE_S[0] += time.perf_counter() - t_new
    torch.cuda.empty_cache()
    by_path = {}
    runs = (("c", "auto", "cli_rgb_guided", RECOVERY_RGB_GUIDED, {"img_matching_type": "zncc"}),
            ("d", True, "cli_rgb_guided_mesh", RECOVERY_RGB_GUIDED, {"img_matching_type": "zncc"}),
            ("h", "auto", "cli_rgb_guided_eloftr", RECOVERY_RGB_GUIDED_ELOFTR, {}),
            ("l", "auto", "cli_rgb_guided_point2plane", None,
             {"img_matching_type": "zncc", "icp_type": "point2plane"}))
    for phase, use_mesh, path, floors, matcher in runs:
        t0 = time.perf_counter()
        out = os.path.join(tmp, path)
        if use_mesh is True:
            shutil.copytree(os.path.join(tmp, "cli_rgb_guided", "demo_run", "tiled_data"),
                            os.path.join(out, "demo_run", "tiled_data"))
        # (o): the host tile of (c) reads its epoch from the E57 files.
        ext = "e57" if phase == "c" else "ply"
        changes = {"input_root": data, "output_dir": out, "src_pcd": f"epoch1.{ext}",
                   "tgt_pcd": f"epoch2.{ext}", "src_image": "epoch1.png", "tgt_image": "epoch2.png",
                   **matcher, "use_mesh": use_mesh}
        cfg = driver_config(DRIVER_CONFIGS["cli_rgb_guided"], os.path.join(tmp, f"{path}.yaml"),
                            changes)
        log(f"# phase ({phase}) main_rgb_guided, use_mesh {use_mesh}, "
            f"icp_type {matcher.get('icp_type', 'point2point')}: "
            f"{DRIVER_CONFIGS['cli_rgb_guided']} with {sorted(changes)} changed")
        summary, stdout = run_driver("main_rgb_guided", cfg)
        log_driver(f"main_rgb_guided ({phase}) use_mesh {use_mesh}{'' if matcher else ' eloftr'}",
                   summary)
        by_path[path] = summary["launches"]
        check(summary["launches"]["radius_sample"] > 0, summary["launches"])
        if use_mesh == "auto":
            check(summary["launches"]["grid_knn"] > 0 and list(summary["tile_s"]) == ["0"],
                  summary)
        else:
            check("runner_s" in summary and not summary["tile_s"], summary)
        out_root = os.path.join(out, "demo_run")
        tables = tile_tables(out_root, "0", "rgb_guided_")
        for name in ("rgb_guided_wo_refinement_dvfms_tile_0.txt",
                     "rgb_guided_w_refinement_dvfs_src2tgt_tile_0.txt",
                     "rgb_guided_w_refinement_dvfms_src2tgt_tile_0.txt",
                     "rgb_guided_w_refinement_dvfms_src2tgt_visualize_tile_0.txt"):
            check(name in tables, (name, tables))
        rec = rgb_guided_recovery(out_root, moving_y)
        n_matches = [int(x) for x in re.findall(r"tile \S+: (\d+) 2D matches", stdout)]
        log(f"# main_rgb_guided use_mesh {use_mesh} tables {tables}; {n_matches} 2D matches; "
            f"recovery {json.dumps(rec)} (floors {json.dumps(floors or RECOVERY_RGB_GUIDED)})")
        if floors is None:
            # point2plane: the reference's undamped step diverges on these
            # supervoxels (ROADMAP.md, known divergences); the reading
            # against RECOVERY_RGB_GUIDED is reported, the coverage held.
            check(rec["core_assigned"] > RECOVERY_RGB_GUIDED["core_assigned"], rec)
            NEW_PHASE_S[0] += time.perf_counter() - t0
            continue
        check(rec["core_assigned"] > floors["core_assigned"], rec)
        check(rec["moving_vec_err_m"] is not None
              and rec["moving_vec_err_m"] < floors["moving_vec_err_m"], rec)
        check(rec["static_vec_err_m"] is not None
              and rec["static_vec_err_m"] < floors["static_vec_err_m"], rec)
        if phase == "h":
            check(n_matches and n_matches[0] > 0, n_matches)
            new_s += time.perf_counter() - t0
    log(f"# phases (f)-(i): {new_s:.1f} s ({card()})")
    return by_path


def rgb_guided_broken_run(matcher: str = "zncc") -> dict:
    """The broken run that ``RECOVERY_RGB_GUIDED`` (``matcher`` ``zncc``)
    or ``RECOVERY_RGB_GUIDED_ELOFTR`` (``eloftr``, the shipped setting) is
    placed against: ``main_rgb_guided`` (host tile) on ``RGB_EPOCH`` with
    the source image written as the target image, so every flow is zero.
    Run it on a card as ``python3 -c "import chip_smoke;
    chip_smoke.rgb_guided_broken_run()"``."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        data = os.path.join(tmp, "rgb_guided_epoch")
        moving_y = write_rgb_guided_epoch(data, broken=True)[0]
        changes = {"input_root": data, "output_dir": os.path.join(tmp, "broken"),
                   "src_pcd": "epoch1.ply", "tgt_pcd": "epoch2.ply", "src_image": "epoch1.png",
                   "tgt_image": "epoch2.png"}
        if matcher != "eloftr":
            changes["img_matching_type"] = matcher
        cfg = driver_config(DRIVER_CONFIGS["cli_rgb_guided"], os.path.join(tmp, "broken.yaml"),
                            changes)
        summary, _ = run_driver("main_rgb_guided", cfg)
        rec = rgb_guided_recovery(os.path.join(tmp, "broken", "demo_run"), moving_y)
    log(f"# main_rgb_guided broken run ({matcher}, target image = source image): tile "
        f"{summary['tile_s']}, recovery {json.dumps(rec)}")
    return rec


def full_size_readings(runs=("fusion3d", "f2s3")) -> dict:
    """Readings at ``bench.py``'s 1 000 000-point core (``RGB_TILE``'s core
    and halo, symmetric 10 m margins as ``bench.py``'s ``e2e3d``: 1 440 062
    points a cloud, bucket 1 572 864), not checks: the 3D-only fusion
    runner with phase 6's configuration and the F2S3 runner with phase
    8's, once each (``runs``; ``"rgb"`` adds phase 7's tile and checks):
    seconds, stage seconds, peak and free memory, launches, window
    overflow by kernel, ``n_dropped``, and recovery against ``RECOVERY``
    / ``RECOVERY_F2S3``, whose floors were placed on the 250 000-point
    tile (reported as held or not). After the F2S3 tile, kernel 3 timed at
    that tile's feature-kNN shape on seeded unit features, with its bound
    reckoned as phase 4's. Run on a card as ``python3 -c "import
    chip_smoke; chip_smoke.full_size_readings()"``."""
    from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
    from fusion4landslide_tpu_torch.ops import cuda_build, knn_cuda as kc
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.parallel.pipeline import run_f2s3_tiles, run_fusion3d_tiles
    from fusion4landslide_tpu_torch.synth import synth_rgb_tile, synth_split_tile

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    log(f"# card: {card()}")
    cuda_build.build_all()
    dips, agg = seeded_models(0, dev)
    filt = seeded_filter(0, dev)
    readings = {}
    if "rgb" in runs:
        readings["rgb"] = fusion_rgb_tile(dev, dict(FUSION_CFG, **RGB_CFG), dips, agg,
                                          synth_rgb_tile(**RGB_TILE))
        torch.cuda.empty_cache()
    src, tgt, core, moving = synth_split_tile(RGB_TILE["n_core"], 10.0, 10.0,
                                              halo=RGB_TILE["halo"])
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    static = core & ~moving
    plan = (("fusion3d", run_fusion3d_tiles, FUSION_CFG, (dips, agg), RECOVERY, "valid"),
            ("f2s3", run_f2s3_tiles, F2S3_CFG, (dips, filt), RECOVERY_F2S3, "keep"))
    for name, runner, cfg, models, floors, kept_key in plan:
        if name not in runs:
            continue
        label = f"1M-core {name} tile"
        res, secs, timings, launches, peak, written = production_tile_run(
            runner, cfg, models, (src, tgt), dev, here)
        free, total = torch.cuda.mem_get_info()
        rec = production_recovery(res, n, core, moving, static, label, {}, kept_key=kept_key)
        held = {k: bool(rec[k] > f) if k in ("static_assigned", "kept") else bool(rec[k] < f)
                for k, f in floors.items()}
        row = {"points": [n, m], "buckets": [N, M], "tile_s": secs, "peak_gib": peak,
               "free_after_gib": free / 2**30, "total_gib": total / 2**30, "launches": launches,
               "overflow": res["overflow_by_source"], "n_dropped": res["n_dropped"],
               "tables": len(written), "recovery": rec, "floors_held": held}
        log(f"# {label} ({card()}): {json.dumps(row)}; stages (s): "
            + json.dumps({k: round(v, 3) for k, v in timings.items()}))
        readings[name] = row
        del res
        torch.cuda.empty_cache()
    if "f2s3" in runs:
        gen = torch.Generator(device=dev).manual_seed(0)
        fq = torch.randn((N, 64), generator=gen, device=dev)
        fr = torch.randn((M, 64), generator=gen, device=dev)
        fq, fr = fq / fq.norm(dim=1, keepdim=True), fr / fr.norm(dim=1, keepdim=True)
        q2 = kc.sq_norms(fq)
        r2 = torch.where(torch.arange(M, device=dev) < m, kc.sq_norms(fr), torch.inf)
        ms = cuda_ms(lambda: kc._knn_cuda(fq, fr, 1, q2, r2, exclude_self=False), reps=1)
        in_out = 4 * (N * 64 + m * 64 + 2 * N + 2 * m)
        b_ms, b_by = bound(in_out, 3 * 2.0 * N * m * 64, TF32_FLOPS)
        f32_ms, _ = bound(in_out, 2.0 * N * m * 64)
        readings["knn"] = {"shape": [N, M, 64], "ref_valid": m, "ms": ms, "bound_ms": b_ms,
                           "bound_by": b_by, "bound_f32_ms": f32_ms,
                           "rescored_per_row": int(kc.RESCORED[0]) / N}
        log(f"# kernel 3 at the 1M-core F2S3 tile's shape ({card()}): "
            f"{json.dumps(readings['knn'])}")
    log(f"# full-size readings in {time.perf_counter() - t_start:.1f} s")
    return readings


def eloftr_broken_run() -> dict:
    """``rgb_guided_broken_run`` with the shipped ``eloftr`` matcher: the
    reading ``RECOVERY_RGB_GUIDED_ELOFTR`` is placed against. Run it on a
    card as ``python3 -c "import chip_smoke; chip_smoke.eloftr_broken_run()"``."""
    return rgb_guided_broken_run("eloftr")


def piecewise_phases(tmp: str, data: str, moving_y: float, tiles_dir: str) -> dict:
    """(e) ``main_piecewise_icp`` on ``CLI_EPOCH`` (the tiles of phase
    9, copied) with ``use_mesh: auto`` and ``true``: tables, the stable
    and unstable fractions of each half's core, seconds per tile; no
    kernel launches; then (q)'s two streams over the same tiles. Returns
    the launches by path."""
    import shutil

    from fusion4landslide_tpu_torch.io.ply import read_ply

    by_path = {}
    for use_mesh, path in (("auto", "cli_piecewise"), (True, "cli_piecewise_mesh")):
        out = os.path.join(tmp, path)
        shutil.copytree(tiles_dir, os.path.join(out, "demo_run", "tiled_data"))
        changes = {"input_root": data, "output_dir": out, "src_pcd": "epoch1.ply",
                   "tgt_pcd": "epoch2.ply", "use_mesh": use_mesh}
        cfg = driver_config(DRIVER_CONFIGS["cli_piecewise"], os.path.join(tmp, f"{path}.yaml"),
                            changes)
        log(f"# phase (e) main_piecewise_icp, use_mesh {use_mesh}: "
            f"{DRIVER_CONFIGS['cli_piecewise']} with {sorted(changes)} changed")
        summary, _ = run_driver("main_piecewise_icp", cfg)
        log_driver(f"main_piecewise_icp use_mesh {use_mesh}", summary)
        by_path[path] = summary["launches"]
        check(sum(summary["launches"].values()) == 0, summary["launches"])
        out_root = os.path.join(out, "demo_run")
        for tid in ("0", "1"):
            tables = tile_tables(out_root, tid, "piecewise")
            check(len(tables) == 3, (tid, tables))
            rows = np.loadtxt(os.path.join(out_root, "results",
                                           f"piecewise_icp_dvfs_of_tile_{tid}.txt"), ndmin=2)
            check(np.isfinite(rows).all() and len(rows) > 0, f"piecewise tile {tid}")
            core = read_ply(os.path.join(out_root, "tiled_data", "non_overlap",
                                         f"source_tile_{tid}.ply")).points
            lo, hi = core.min(axis=0), core.max(axis=0)
            in_core = np.all((rows[:, :3] >= lo) & (rows[:, :3] <= hi), axis=1)
            stable = np.all(rows[:, 3:6] == rows[:, :3], axis=1)
            moving = rows[:, 1] > moving_y
            frac = {}
            for half, sel in (("static", in_core & ~moving), ("moving", in_core & moving)):
                n_half = max(int(sel.sum()), 1)
                frac[half] = {"rows": int(sel.sum()),
                              "stable": float((stable & sel).sum()) / n_half,
                              "unstable": float((~stable & sel).sum()) / n_half}
            log(f"# main_piecewise_icp use_mesh {use_mesh} tile {tid}: tables {tables}, "
                f"{len(rows)} rows, core halves {json.dumps(frac)}")
    t_new = time.perf_counter()
    by_path.update(piecewise_streams_phase(tmp, tiles_dir))
    PHASES_N_R_S[0] += time.perf_counter() - t_new
    return by_path


# ---------------------------------------------------------------------------
# Phases (j)-(m): superpoint partitions, the ICP variants, classic LoFTR.
# ---------------------------------------------------------------------------

#: Seconds of phases (j)-(m) spent inside ``driver_phases`` and
#: ``rgb_guided_phases`` ((k), (l)'s rgb_guided run, (m)).
NEW_PHASE_S = [0.0]
#: (j)'s small cloud: a split tile of ~12 k points, above the supervoxel
#: graph's 8 192-point brute-force bound (so its graph is kernel 1's).
SUPERPOINT_SMALL_CORE = 8000


def superpoint_small_run(d):
    """(j)'s small tile cloud through the superpoint generator on device
    ``d``: (labels per level, seconds)."""
    from fusion4landslide_tpu_torch.ops.superpoint import superpoint_hierarchy
    from fusion4landslide_tpu_torch.synth import synth_split_tile

    src, _, _, _ = synth_split_tile(SUPERPOINT_SMALL_CORE, 1.0, 1.0, halo=2.0)
    t0 = time.perf_counter()
    labels = superpoint_hierarchy(src, levels=3, device=d)
    return labels, time.perf_counter() - t0


def superpoint_small_compare(state: dict) -> dict:
    """(j) The superpoint generator (``ops/superpoint.py``) on a small tile
    cloud, card vs the port's CPU path (labels per level up to
    relabelling, differing points counted). Returns the card run's
    launches."""
    from fusion4landslide_tpu_torch.checks import partition_differing

    (g, _), (c, cpu_s) = state["card"], state["cpu"].result()
    small_launches = state["launches"]
    res = {"points": len(g[0]), "regions_card": [int(x.max()) + 1 for x in g],
           "regions_cpu": [int(x.max()) + 1 for x in c],
           "differing_points": [partition_differing(a, b) for a, b in zip(g, c)],
           "cpu_s": cpu_s, "launches": small_launches}
    log(f"# phase (j) superpoint generator, small cloud, card vs CPU path ({card()}): "
        f"{json.dumps(res)}")
    check(res["differing_points"][0] == 0, res)
    check(max(res["differing_points"]) <= 0.02 * res["points"], res)
    check(small_launches["radius_sample"] > 0 and small_launches["grid_knn"] > 0, small_launches)
    return small_launches


def superpoint_epoch_phase(dev) -> dict:
    """(j) The superpoint generator on ``RGB_EPOCH``'s source cloud:
    seconds of the 30-NN search, the features, the level-1 VCCS and the
    region merge, region counts per level, peak memory. Returns the
    launches."""
    from fusion4landslide_tpu_torch.ops.superpoint import superpoint_hierarchy
    from fusion4landslide_tpu_torch.synth import synth_epoch_pair

    src, _, _ = synth_epoch_pair(*RGB_EPOCH)
    timings: dict = {}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    labels = superpoint_hierarchy(src, levels=3, device=dev, timings=timings)
    total = time.perf_counter() - t0
    launches = read_launches()
    res = {"points": len(src), "total_s": total, "stages_s": timings,
           "regions": [int(x.max()) + 1 for x in labels],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_above_base_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "launches": launches}
    log(f"# phase (j) superpoint generator on RGB_EPOCH's source cloud ({card()}): "
        f"{json.dumps(res)}")
    counts = res["regions"]
    check(counts[0] > counts[1] > counts[2] >= 1, res)
    check(launches["radius_sample"] > 0, launches)
    return launches


def shuffle_partition_labels(path: str, seed: int = 0) -> None:
    """Permute the label columns of a 15-column partition table across its
    rows (every level by the same permutation), so each point carries
    another point's labels."""
    from fusion4landslide_tpu_torch.ops.partition_io import write_superpoint_partition

    data = np.loadtxt(path, ndmin=2)
    perm = np.random.default_rng(seed).permutation(len(data))
    levels = [data[perm, 2 + 4 * lv].astype(np.int64) for lv in (1, 2, 3)]
    write_superpoint_partition(path, data[:, :3], levels)


def superpoint_driver_run(tmp: str, data: str, weights: str, moving_y: float, label: str,
                          shuffled: bool = False) -> tuple[dict, dict]:
    """``main_fusion`` 3D-only (``fusion_3d_brienz.yaml`` with only paths,
    names and ``partition_type: superpoint`` changed, levels [1, 2, 3]) on
    the one-tile epoch under ``data``; with ``shuffled`` it runs once,
    shuffles the written partition tables' labels, and runs again from
    them. Returns (run summary, recovery)."""
    import shutil

    out = os.path.join(tmp, label)
    changes = {"input_root": data, "output_dir": out, "weight_dir": weights,
               "src_pcd": "epoch1.ply", "tgt_pcd": "epoch2.ply",
               "partition_type": "superpoint", "level_of_superpoint": [1, 2, 3]}
    cfg = driver_config(DRIVER_CONFIGS["cli_fusion3d"], os.path.join(tmp, f"{label}.yaml"),
                        changes)
    tag = " (shuffled)" if shuffled else ""
    log(f"# phase (k) main_fusion 3D-only, superpoint partition{tag}: "
        f"{DRIVER_CONFIGS['cli_fusion3d']} with {sorted(changes)} changed")
    summary, _ = run_driver("main_fusion", cfg)
    out_root = os.path.join(out, "demo_run")
    tables = [os.path.join(out_root, "superpoint_partition", f"partition_of_input_{w}_tile_0.txt")
              for w in ("src", "tgt")]
    check(all(os.path.exists(t) for t in tables), tables)
    if shuffled:
        for t in tables:
            shuffle_partition_labels(t)
        shutil.rmtree(os.path.join(out_root, "results"))
        summary, _ = run_driver("main_fusion", cfg)
    log_driver(f"main_fusion superpoint{' shuffled' if shuffled else ''}", summary)
    results = tile_tables(out_root, "0", "c2f_")
    dvfs = os.path.join(out_root, "results", "c2f_dvfs_src2tgt_tile_0.txt")
    check("c2f_dvfs_src2tgt_tile_0.txt" in results, results)
    if shuffled and os.path.getsize(dvfs) == 0:
        # Scattered "superpoints" fail the fine quality gate: nothing is
        # assigned, so there are no errors to read.
        rec = {"core_assigned": 0.0, "static_assigned": 0.0, "static_err_m": None,
               "moving_err_m": None}
    else:
        for name in ("c2f_dvfms_src2tgt_tile_0.txt",
                     "c2f_dvfms_src2tgt_discrete_visualize_tile_0.txt"):
            check(name in results, (name, results))
        rec = driver_recovery(out_root, "0", "c2f_dvfs_src2tgt_tile_0.txt", moving_y)
    log(f"# main_fusion superpoint{' shuffled' if shuffled else ''} tables {results}; recovery "
        f"{json.dumps(rec)} (floors {json.dumps(RECOVERY_SUPERPOINT)})")
    return summary, rec


def superpoint_broken_run() -> dict:
    """The broken run ``RECOVERY_SUPERPOINT`` is placed against: phase
    (k) with the written partition tables' labels shuffled. Run it on a
    card as ``python3 -c "import chip_smoke; chip_smoke.superpoint_broken_run()"``."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models, write_reference_checkpoints

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        weights = os.path.join(tmp, "weights")
        dips, agg = seeded_models(0, "cuda")
        write_reference_checkpoints(weights, dips=dips, agg=agg)
        data = os.path.join(tmp, "rgb_epoch")
        _, _, moving_y = write_epoch(data, *RGB_EPOCH, (0.0, 0.0, 0.0))
        _, rec = superpoint_driver_run(tmp, data, weights, moving_y, "broken", shuffled=True)
    return rec


def icp_small_run(d, icp_type: str, host: bool):
    """(l)'s small tile with metre-scale relief (``synth_rough_split_tile``,
    magnitude gate 0.3 m) through the step (``host`` False) or the host
    tile with ``icp_type`` on device ``d``: (moved source points, assigned
    mask), numpy."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step
    from fusion4landslide_tpu_torch.synth import synth_rough_split_tile

    src, tgt = synth_rough_split_tile()
    here = os.path.dirname(os.path.abspath(__file__))
    dm, am = seeded_models(0, d)
    if host:
        with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
            cfg = {"level_of_superpoint": [1, 2], "feat_patch_points": 128,
                   "feat_chunk": 512, "agg_max_points": 64,
                   "num_min_matches_for_small_patch": 3, "fine_max_matches": 64,
                   "max_magnitude": 0.3, "icp_threshold": 0.1, "voxel_size_init": 0.1,
                   "dataset": "brienz_tls", "icp_type": icp_type, "output_dir": tmp,
                   "output_folder": "run"}
            out = run_fusion3d_tile(cfg, dm, am, src, tgt, device=d)
        s = (src - src.mean(0)).astype(np.float32)
        return np.einsum("nij,nj->ni", out["R"], s) + out["t"], out["valid"]
    sb, sm, tb, tm, ns, _ = padded(src, tgt)
    out = fusion3d_tile_step(
        dm, am, *(torch.from_numpy(x).to(d) for x in (sb, sm, tb, tm)),
        0.3, 0.1, 0.1, 10, 10, 0.5, 0.15, device=d, levels=(1, 2), patch_points=128,
        chunk=512, k_neighbors=8, sv_cap=256, member_cap=128, agg_max_points=64,
        small_patch=3, icp_max_iter=30, fine_max_matches=64, icp_type=icp_type)
    return out.moved[:ns].cpu().numpy(), out.valid[:ns].cpu().numpy()


def icp_small_compare(state: dict, icp_type: str, host: bool) -> dict:
    """(l) ``icp_type`` on the small relief tile, card vs the port's CPU
    path: the assigned sets (which the ICP type does not decide) equal,
    finite outputs; the DVF gap reported. Returns the card run's
    launches."""
    (mg, vg), (mc, vc) = state["card"], state["cpu"].result()
    launches = state["launches"]
    common = vg & vc
    gap = np.linalg.norm(mg[common] - mc[common], axis=1)
    res = {"path": "host tile" if host else "step", "icp_type": icp_type,
           "points": len(vg), "assigned": [int(vg.sum()), int(vc.sum())],
           "same_assigned": bool((vg == vc).all()),
           "median_gap_m": float(np.median(gap)) if gap.size else None,
           "frac_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
           "launches": launches}
    log(f"# phase (l) {icp_type} small-tile {res['path']}, card vs CPU path: {json.dumps(res)}")
    check(res["same_assigned"] and vg.sum() > 0.02 * len(vg), res)
    check(np.isfinite(mg).all(), "non-finite moved points")
    return launches


#: Classic LoFTR's card-vs-CPU crop ((m); the CPU path at the upstream
#: width on a whole 960 x 1280 crop takes minutes).
CLASSIC_CHECK_CROP = (256, 320)


def classic_loftr_phase(dev, img0: np.ndarray, img1: np.ndarray) -> dict:
    """(m) Classic LoFTR at the upstream width (``ClassicLoFTRConfig()``)
    with ``seeded_classic(cfg, 0)``: seconds per crop pair by stage and
    peak memory on the first 960 x 1280 crop pair; card vs CPU on a
    smaller crop, the kept cells and |duv|."""
    from fusion4landslide_tpu_torch.image.loftr_classic import ClassicLoFTRConfig, seeded_classic

    cfg = ClassicLoFTRConfig()
    g_model = seeded_classic(cfg, 0, dev)
    res = eloftr_timing(g_model, img0[:CROP[0], :CROP[1]], img1[:CROP[0], :CROP[1]])
    h, w = CLASSIC_CHECK_CROP
    t0 = time.perf_counter()
    res["check"] = eloftr_compare(g_model, seeded_classic(cfg, 0, "cpu"), img0[:h, :w],
                                  img1[:h, :w])
    res["compare_s"] = time.perf_counter() - t0
    log(f"# phase (m) classic LoFTR upstream width, seeded weights ({card()}): "
        f"{CROP[0]}x{CROP[1]} on the card, {h}x{w} card vs CPU path: {json.dumps(res)}")
    chk = res["check"]
    check(chk["keep_overlap_frac"] >= 0.99 and chk["all_cells_median_duv_px"] <= 1e-3, chk)
    check(chk["median_duv_px"] is None or chk["median_duv_px"] <= 1e-3, chk)
    return res


# ---------------------------------------------------------------------------
# Phases (n)-(r): the F2S3 feature cache, E57, the native tiler, tile
# streams, nested_levels=False.
# ---------------------------------------------------------------------------

#: Seconds of phases (n)-(r), wherever they run.
PHASES_N_R_S = [0.0]


def tree_bytes(root: str) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def f2s3_cache_phase(tmp: str, changes: dict, first: dict) -> dict:
    """(n): phase 11 wrote ``features/features_tile_*.npz`` (``save_interim:
    true``); tile 0's tables are deleted and ``main_f2s3`` reruns it with
    ``feat_compute: false``. Checks: the cache files, no ``dips_features``
    stage, kernel 3 launched once, kernel 1 only for the supervoxel graph
    (the DIPs sampler's launches gone), the same tables; reports the tile
    seconds beside the computing run's and the largest gap between the two
    runs' tables. Returns the rerun's launches."""
    out_root = os.path.join(tmp, "f2s3", "demo_run")
    cached = sorted(os.listdir(os.path.join(out_root, "features")))
    check(cached == ["features_tile_0.npz", "features_tile_1.npz"], cached)
    results = os.path.join(out_root, "results")
    names = tile_tables(out_root, "0", "f2s3_")
    before = {n: np.loadtxt(os.path.join(results, n), ndmin=2) for n in names}
    for n in names:
        os.remove(os.path.join(results, n))
    cfg = driver_config(DRIVER_CONFIGS["cli_f2s3"], os.path.join(tmp, "f2s3_cache.yaml"),
                        {**changes, "feat_compute": False})
    summary, _ = run_driver("main_f2s3", cfg)
    log_driver("main_f2s3 (n) feature cache", summary)
    check(list(summary["tile_s"]) == ["0"], summary["tile_s"])
    after = {n: np.loadtxt(os.path.join(results, n), ndmin=2) for n in tile_tables(out_root, "0", "f2s3_")}
    check(sorted(after) == sorted(before), (sorted(after), sorted(before)))
    check(all(after[n].shape == before[n].shape for n in names),
          {n: (after[n].shape, before[n].shape) for n in names})
    gap = max(float(np.abs(after[n] - before[n]).max()) if after[n].size else 0.0 for n in names)
    stages = summary["stages_s"]["0"]
    launches = summary["launches"]
    rec = {"tile_s_cached": summary["tile_s"]["0"], "tile_s_computed": first["tile_s"]["0"],
           "dips_features_s_computed": first["stages_s"]["0"].get("dips_features"),
           "feature_cache_s_computed": first["stages_s"]["0"].get("feature_cache"),
           "feature_cache_s": stages.get("feature_cache"), "tables": len(names),
           "max_abs_table_gap": gap, "launches": launches,
           "launches_computing_run": first["launches"]}
    log(f"# phase (n) F2S3 feature cache ({card()}): {json.dumps(rec)}")
    check("dips_features" not in stages and "feature_cache" in stages, stages)
    check(launches["knn"] == 1, launches)
    check(launches["radius_sample"] < first["launches"]["radius_sample"] // 4, launches)
    return launches


def native_tiler_phase(tmp: str, data: str, driver_tiling_s) -> None:
    """(p): ``tiling.native`` builds ``cpp/tiler.cpp`` into ``_build/`` and
    tiles phase 9's epoch files; the numpy tiler tiles them without its
    voxel filter (as the native core), with the same ``max_pts``,
    ``min_pts`` and 20 m halo. Equal tile counts and equal core source
    point sets per tile; the halo sets are compared and reported."""
    from fusion4landslide_tpu_torch.io.ply import read_ply
    from fusion4landslide_tpu_torch.tiling import tile_point_clouds
    from fusion4landslide_tpu_torch.tiling.native import build_native, tile_point_clouds_native

    src, tgt = (os.path.join(data, "raw_pcd", f"epoch{i}.ply") for i in (1, 2))
    t0 = time.perf_counter()
    check(build_native(), "g++ build of cpp/tiler.cpp")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_cc = tile_point_clouds_native(src, tgt, CLI_TILE_PTS, CLI_TILE_MIN_PTS,
                                    os.path.join(tmp, "native"))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_py = tile_point_clouds(src, tgt, CLI_TILE_PTS, CLI_TILE_MIN_PTS, False, 0.0, 0.0, -1,
                             os.path.join(tmp, "numpy"))
    numpy_s = time.perf_counter() - t0

    def tile_sets(root: str, kind: str, name: str) -> list:
        sets = []
        for i in range(n_py):
            pts = read_ply(os.path.join(root, kind, name.format(i=i))).points
            sets.append(np.sort(np.ascontiguousarray(pts).view("f8,f8,f8")[:, 0]))
        return sorted(sets, key=lambda a: (len(a), a[0].tolist() if len(a) else ()))

    same = {}
    for kind, name in (("non_overlap", "source_tile_{i}.ply"), ("non_overlap", "target_tile_{i}.ply"),
                       ("overlap", "source_tile_{i}_overlap.ply")):
        a = tile_sets(os.path.join(tmp, "native"), kind, name)
        b = tile_sets(os.path.join(tmp, "numpy"), kind, name)
        same[name] = all(len(x) == len(y) and bool((x == y).all()) for x, y in zip(a, b))
    rec = {"tiles": [n_cc, n_py], "build_s": build_s, "native_s": native_s, "numpy_s": numpy_s,
           "numpy_with_voxel_filter_in_phase_9_s": driver_tiling_s, "equal_point_sets": same}
    log(f"# phase (p) native tiler ({card()}): {json.dumps(rec)}")
    check(n_cc == n_py == 2, rec)
    check(same["source_tile_{i}.ply"] and same["target_tile_{i}.ply"], rec)


def e57_phase(root: str) -> None:
    """(o): each epoch's PLY arrays written as E57 (``io.e57.write_e57``)
    beside it and read back through ``read_point_cloud``, bit-equal;
    seconds per million points."""
    from fusion4landslide_tpu_torch.io import read_point_cloud
    from fusion4landslide_tpu_torch.io.e57 import write_e57

    rec = {}
    for name in ("epoch1", "epoch2"):
        ply = read_point_cloud(os.path.join(root, "raw_pcd", f"{name}.ply"))
        path = os.path.join(root, "raw_pcd", f"{name}.e57")
        t0 = time.perf_counter()
        write_e57(path, ply.points, ply.colors)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = read_point_cloud(path)
        read_s = time.perf_counter() - t0
        mpts = len(ply.points) / 1e6
        rec[name] = {"points": len(ply.points), "mib": os.path.getsize(path) / 2**20,
                     "write_s_per_mpts": write_s / mpts, "read_s_per_mpts": read_s / mpts,
                     "colors": ply.colors is not None}
        check(back.points.dtype == np.float64
              and np.array_equal(back.points, ply.points.astype(np.float64)), f"{name} xyz")
        check((back.colors is None) == (ply.colors is None)
              and (ply.colors is None or np.array_equal(back.colors, ply.colors)), f"{name} rgb")
    log(f"# phase (o) E57 round trip, bit-equal to the PLY arrays: {json.dumps(rec)}")


def f2s3_streams_phase(dev, dips, filt, n_core: int, margin: float, halo: float,
                       density: float) -> dict:
    """(q) on the F2S3 runner: two small tiles (``n_core`` core points)
    through one stream
    and through two on the card (``devices=[dev, dev]``: two threads, each
    with its model copies and stream); results, tables and launches equal.
    Returns both runs' launches by path."""
    from fusion4landslide_tpu_torch.parallel.pipeline import run_f2s3_tiles
    from fusion4landslide_tpu_torch.synth import synth_split_tile

    tiles = []
    for i in range(2):
        src, tgt, _, _ = synth_split_tile(n_core, margin, margin, halo=halo, density=density,
                                          seed=i)
        tiles.append((str(i), src + [500.0 * i, 0.0, 0.0], tgt + [500.0 * i, 0.0, 0.0]))
    here = os.path.dirname(os.path.abspath(__file__))
    runs, launches, seconds, written = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        for label, kw in (("one", dict(device=dev)), ("two", dict(devices=[dev, dev]))):
            cfg = dict(F2S3_CFG, output_dir=os.path.join(tmp, label), output_folder="smoke")
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label] = run_f2s3_tiles(cfg, dips, filt, tiles, **kw)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
            launches[label] = read_launches()
            written[label] = tree_bytes(os.path.join(tmp, label))
    equal = list(runs["one"]) == list(runs["two"]) == ["0", "1"] and all(
        np.array_equal(runs["one"][t][k], runs["two"][t][k])
        for t in runs["one"] for k in ("dvfs", "magnitudes", "keep"))
    rec = {"points": [len(t[1]) for t in tiles], "seconds": seconds, "launches": launches,
           "results_equal": equal, "tables_equal": written["one"] == written["two"],
           "tables": len(written["one"])}
    log(f"# phase (q) F2S3 runner, one stream vs two on one card ({card()}): {json.dumps(rec)}")
    check(equal and rec["tables_equal"] and rec["tables"] == 12, rec)
    check(launches["one"] == launches["two"] and min(launches["one"].values()) > 0, rec)
    return {"f2s3_streams_one": launches["one"], "f2s3_streams_two": launches["two"]}


def piecewise_streams_phase(tmp: str, tiles_dir: str, dev=torch.device("cuda")) -> dict:
    """(q) on ``run_piecewise_tiles``: phase 16's tiles (the halo clouds
    the driver reads) through one stream and two on the card; results and
    tables equal, no kernel launched."""
    from fusion4landslide_tpu_torch.io.ply import read_ply
    from fusion4landslide_tpu_torch.parallel.pipeline import run_piecewise_tiles

    tiles = [(str(i), *(read_ply(os.path.join(tiles_dir, "overlap",
                                              f"{side}_tile_{i}_overlap.ply")).points
                        for side in ("source", "target"))) for i in range(2)]
    cfg = {"smax": 5.0, "number_points_min": 10, "dataset": "brienz_tls", "output_folder": "run"}
    runs, seconds, written, launches = {}, {}, {}, {}
    for label, kw in (("one", dict(device=dev)), ("two", dict(devices=[dev, dev]))):
        out = os.path.join(tmp, f"piecewise_streams_{label}")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = run_piecewise_tiles(dict(cfg, output_dir=out), tiles, **kw)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        launches[label] = read_launches()
        written[label] = tree_bytes(out)
    equal = list(runs["one"]) == list(runs["two"]) == ["0", "1"] and all(
        np.array_equal(runs["one"][t]["dvfs"], runs["two"][t]["dvfs"]) for t in runs["one"])
    rec = {"points": [[len(t[1]), len(t[2])] for t in tiles], "seconds": seconds,
           "results_equal": equal, "tables_equal": written["one"] == written["two"],
           "tables": len(written["one"]), "launches": launches}
    log(f"# phase (q) piecewise runner, one stream vs two on one card ({card()}): "
        f"{json.dumps(rec)}")
    check(equal and rec["tables_equal"] and rec["tables"] == 6, rec)
    check(sum(launches["one"].values()) == sum(launches["two"].values()) == 0, rec)
    return {"piecewise_streams_one": launches["one"], "piecewise_streams_two": launches["two"]}


# ---- Phases (s) DIPs branches, (t) 'knn' at full width, (u) bf16,
# (v) matcher training --------------------------------------------------

#: Seconds spent in phases (s)-(v).
PHASES_S_V_S = [0.0]


#: ``feat_k_max`` of phase (s)'s small tiles: the card-vs-CPU comparison
#: of the grid branches at a quarter of the production neighbour table
#: (the CPU path's time), the same ``cap`` (48) as at 512.
SMALL_K_MAX = 128


def card_draws(dev, priority: str, rows: int, k_max: int = SMALL_K_MAX, chunk: int = 512,
               gen=None):
    """The DIPs grid branch's draws for one padded cloud of ``rows`` rows,
    drawn on the card (the same tensors then feed the CPU path): 'knn'
    (rows rounded up to whole chunks, k_max) uniform priorities, 'random'
    a support permutation and a hash seed."""
    from fusion4landslide_tpu_torch.pipelines.f2s3 import DipsDraws

    if priority == "knn":
        n_rows = -(-rows // min(chunk, rows)) * min(chunk, rows)
        return DipsDraws(priorities=torch.rand((n_rows, k_max), generator=gen, device=dev))
    return DipsDraws(perm=torch.randperm(rows, generator=gen, device=dev),
                     seed=int(torch.randint(0, 2**31 - 1, (), generator=gen, device=dev)))


def draws_on(draws, d):
    from fusion4landslide_tpu_torch.pipelines.f2s3 import DipsDraws

    return tuple(None if x is None else DipsDraws(*(v.to(d) if torch.is_tensor(v) else v
                                                    for v in x)) for x in draws)


def descriptor_pair(d, priority: str, sb, sm, tb, tm, ns: int, nt: int, radius: float,
                    dtype=None, draws=None) -> tuple:
    """The DIPs descriptors of a small tile's two clouds (query = support,
    as in the F2S3 step) on device ``d``, at patch 96 with ``draws`` (or,
    at patch 128, kernel 1's fixed seed), as CPU tensors."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import dips_features_device

    kw = dict(patch_points=96 if draws is not None else 128, chunk=512, sample_priority=priority,
              dtype=dtype, k_max=SMALL_K_MAX)
    dm, _ = seeded_models(0, d)
    dr = draws_on(draws, d) if draws is not None else (None, None)
    pair = []
    for x, m, nv, dw in ((sb, sm, ns, dr[0]), (tb, tm, nt, dr[1])):
        xt = torch.from_numpy(x).to(d)
        f, _ = dips_features_device(dm, xt, xt, torch.from_numpy(m).to(d),
                                    torch.tensor(radius, device=d), query_count=nv,
                                    draws=dw, **kw)
        pair.append(f.cpu())
    return tuple(pair)


def descriptor_readings(card_pair, cpu_pair, ns: int, nt: int) -> dict:
    """Max abs descriptor error and the source -> target 1-NN agreement of
    the card's and the CPU path's descriptors."""
    from fusion4landslide_tpu_torch.ops.knn import knn

    (gs, gt), (cs, ct) = card_pair, cpu_pair
    err = float((gs[:ns] - cs[:ns]).abs().max())
    _, nn_g = knn(gs[:ns], gt[:nt], 1)
    _, nn_c = knn(cs[:ns], ct[:nt], 1)
    return {"feat_max_abs_err": err, "nn1_equal_frac": float((nn_g == nn_c).double().mean())}


def branch_small_tile(pipeline: str):
    """Phase (s)'s padded small tile of ``pipeline`` (numpy)."""
    return padded_small_tile(1.0 if pipeline == "fusion" else 1.5, 1.5)


def branch_small_step(d, pipeline: str, priority: str, draws) -> tuple:
    """Phase (s)'s small fusion or F2S3 step at patch 96 on device ``d``
    with ``draws``: (result with CPU tensors, seconds)."""
    from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
    from fusion4landslide_tpu_torch.pipelines.f2s3_device import f2s3_tile_step
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

    sb, sm, tb, tm, _, _ = branch_small_tile(pipeline)
    kw = dict(patch_points=96, chunk=512, sample_priority=priority, k_max=SMALL_K_MAX)
    dm, am = seeded_models(0, d)
    args = [torch.from_numpy(x).to(d) for x in (sb, sm, tb, tm)]
    t0 = time.perf_counter()
    if pipeline == "fusion":
        o = fusion3d_tile_step(dm, am, *args, 5.0, 0.1, 0.1, 10, 10, 0.5, 0.15, device=d,
                               dips_draws=draws_on(draws, d), levels=(1, 2), k_neighbors=8,
                               sv_cap=256, member_cap=128, agg_max_points=64, small_patch=3,
                               icp_max_iter=8, fine_max_matches=64, **kw)
    else:
        o = f2s3_tile_step(dm, seeded_filter(0, d), *args, 5.0, 0.1, device=d,
                           dips_draws=draws_on(draws, d), k_neighbors=30, sv_cap=256,
                           member_cap=256, **kw)
    if d.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return o._replace(**{k: v.cpu() for k, v in o._asdict().items() if torch.is_tensor(v)}), secs


def _numpy_fields(t):
    """A NamedTuple's tensor fields as numpy arrays (to cross a process)."""
    return None if t is None else t._replace(**{k: v.numpy() for k, v in t._asdict().items()
                                                 if torch.is_tensor(v)})


def _tensor_fields(t):
    return None if t is None else t._replace(**{k: torch.from_numpy(v) for k, v in
                                                 t._asdict().items() if isinstance(v, np.ndarray)})


def branch_cpu_side(pipeline: str, priority: str, draws, descriptor_draws: dict) -> tuple:
    """Phase (s)'s CPU path in a worker process: the step on the card's
    ``draws`` and the descriptors per entry of ``descriptor_draws``
    (priority -> draws), leaving two cores to the process driving the
    card. Returns (numpy step result, seconds, {priority: descriptors})."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - 2))
    cpu = torch.device("cpu")
    draws = tuple(_tensor_fields(x) for x in draws)
    out, secs = branch_small_step(cpu, pipeline, priority, draws)
    sb, sm, tb, tm, ns, nt = branch_small_tile(pipeline)
    radius = float(np.sqrt(3.0) * 10.0 * float(out.median_res))
    descriptors = {
        prio: tuple(f.numpy() for f in descriptor_pair(
            cpu, prio, sb, sm, tb, tm, ns, nt, radius,
            draws=tuple(_tensor_fields(x) for x in dr)))
        for prio, dr in descriptor_draws.items()}
    return _numpy_fields(out), secs, descriptors


def dips_branch_card_side(dev, pipeline: str, priority: str, pool,
                          descriptors: bool = False) -> dict:
    """Phase (s), card side: the small fusion or F2S3 step at
    ``feat_patch_points`` 96 with ``sample_priority`` ``priority`` (k_max
    ``SMALL_K_MAX``) on the card's draws (with ``descriptors``, also both
    branches' descriptors of its tile); the CPU path on the same draws is
    submitted to ``pool`` (``branch_cpu_side``). Returns the state that
    ``dips_branch_compare`` scores."""
    gen = torch.Generator(device=dev).manual_seed(0)
    sb, _, tb, _, _, _ = branch_small_tile(pipeline)
    draws = (card_draws(dev, priority, len(sb), gen=gen), card_draws(dev, priority, len(tb), gen=gen))
    desc_draws = {prio: draws if prio == priority else
                  (card_draws(dev, prio, len(sb), gen=gen), card_draws(dev, prio, len(tb), gen=gen))
                  for prio in (("knn", "random") if descriptors else ())}
    to_cpu = lambda dr: tuple(_numpy_fields(draws_on((x,), "cpu")[0]) for x in dr)  # noqa: E731
    future = pool.submit(branch_cpu_side, pipeline, priority, to_cpu(draws),
                         {prio: to_cpu(dr) for prio, dr in desc_draws.items()})
    reset_launches()
    g, card_s = branch_small_step(dev, pipeline, priority, draws)
    launches = read_launches()
    return dict(pipeline=pipeline, priority=priority, g=g, card_s=card_s, launches=launches,
                desc_draws=desc_draws, future=future, dev=dev)


def dips_branch_compare(state: dict) -> dict:
    """Phase (s), scored: the card against the port's CPU path on the
    card's draws, as ``tools/parity_check.py`` scores two paths (F2S3: as
    ``f2s3_small_compare``; with descriptors, also both branches'
    descriptors of the tile). Returns the card run's launches."""
    pipeline, priority, g, launches = (state[k] for k in ("pipeline", "priority", "g",
                                                          "launches"))
    fusion = pipeline == "fusion"
    sb, sm, tb, tm, ns, nt = branch_small_tile(pipeline)
    c_np, cpu_s, cpu_desc = state["future"].result()
    c = _tensor_fields(c_np)
    radius = float(np.sqrt(3.0) * 10.0 * float(c.median_res))
    parity = dict(points=ns, card_s=state["card_s"], cpu_s=cpu_s, launches=launches,
                  overflow=[g.overflow_by_source, c.overflow_by_source],
                  median_res_rel=abs(float(g.median_res) - float(c.median_res)) / float(c.median_res))
    if fusion:
        vg, vc = g.valid[:ns].numpy(), c.valid[:ns].numpy()
        common = vg & vc
        gap = np.linalg.norm((g.moved[:ns] - c.moved[:ns]).numpy()[common], axis=1)
        parity.update(n_vox=[int(g.n_vox_src), int(c.n_vox_src), int(g.n_vox_tgt), int(c.n_vox_tgt)],
                      assigned=[int(vg.sum()), int(vc.sum())])
        finite = bool(torch.isfinite(g.moved).all())
    else:
        # As in f2s3_small_compare: supervoxels with a near-tie 1-NN swap
        # are left out. Besides, a supervoxel's robust re-fit test
        # (>= 5 inliers under the residual median) can fall the other way
        # on the two devices' float32 sums, and then all its members
        # change together: such supervoxels are counted, and left out.
        lab = c.labels[:ns].numpy()
        nn_same = (g.nn_tgt[:ns] == c.nn_tgt[:ns]).all(1).numpy()
        same = ~np.isin(lab, lab[~nn_same & (lab >= 0)])
        kg, kc_ = g.keep[:ns].numpy(), c.keep[:ns].numpy()
        flipped = np.unique(lab[same & (kg != kc_) & (lab >= 0)])
        same &= ~np.isin(lab, flipped)
        vg, vc = kg & same, kc_ & same
        common = vg & vc
        gap = np.linalg.norm((g.new_tgt[:ns] - c.new_tgt[:ns]).numpy()[common], axis=1)
        parity.update(labels_equal_frac=float((g.labels[:ns] == c.labels[:ns]).double().mean()),
                      nn_equal_frac=float(nn_same.mean()), kept_all=[int(kg.sum()), int(kc_.sum())],
                      flipped_supervoxels=int(flipped.size),
                      flipped_points=int(np.isin(lab, flipped).sum()),
                      kept=[int(vg.sum()), int(vc.sum())])
        finite = bool(torch.isfinite(g.new_tgt).all())
        for prio, dr in state["desc_draws"].items():
            card_pair = descriptor_pair(state["dev"], prio, sb, sm, tb, tm, ns, nt, radius,
                                        draws=dr)
            cpu_pair = tuple(torch.from_numpy(f) for f in cpu_desc[prio])
            parity[prio] = descriptor_readings(card_pair, cpu_pair, ns, nt)
    parity.update(overlap_frac=float(common.sum()) / max(int(vg.sum()), int(vc.sum()), 1),
                  median_delta_m=float(np.median(gap)) if gap.size else None,
                  frac_gt_10mm=float((gap > 0.01).mean()) if gap.size else None)
    log(f"# phase (s) small-tile {pipeline} step, patch 96 '{priority}', card vs CPU path on the "
        f"card's draws ({card()}): {json.dumps(parity)}")
    check(finite and parity["median_res_rel"] <= 1e-6 and vg.sum() > 0.01 * ns, parity)
    check(parity["overlap_frac"] >= 0.99 and parity["median_delta_m"] < 1e-4, parity)
    check(parity["frac_gt_10mm"] <= 0.01, parity)
    if fusion:
        check(parity["n_vox"][0] == parity["n_vox"][1], parity)
    else:
        check(parity["labels_equal_frac"] >= 0.99 and parity["nn_equal_frac"] >= 0.99, parity)
        check(parity["flipped_supervoxels"] <= 2, parity)
        for prio in state["desc_draws"]:
            check(parity[prio]["feat_max_abs_err"] <= 1e-3, parity)
            check(parity[prio]["nn1_equal_frac"] >= 0.99, parity)
    return launches


def production_recovery(out: dict, n: int, core, moving, static, label: str,
                        floors: dict, kept_key: str = "valid") -> dict:
    """Recovery of the planted shift on a production tile's core, held to
    ``floors`` (``RECOVERY`` for the fusion runner, ``RECOVERY_F2S3`` for
    the F2S3 runner)."""
    from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT

    ok = out[kept_key]
    disp = np.zeros((n, 3))
    disp[ok] = out["dvfs"][:, 3:6] - out["dvfs"][:, :3]
    err_mov = np.linalg.norm(disp[core & moving & ok] - PLANTED_SHIFT, axis=1)
    err_sta = np.linalg.norm(disp[static & ok], axis=1)
    rec = {"static_assigned": float(ok[static].mean()), "core_assigned": float(ok[core].mean()),
           "kept": float(ok.mean()),
           "moving_err_m": float(np.median(err_mov)) if err_mov.size else float("inf"),
           "static_err_m": float(np.median(err_sta)) if err_sta.size else float("inf")}
    log(f"# {label} recovery: {json.dumps(rec)} (floors {json.dumps(floors)})")
    check(np.isfinite(disp).all(), f"{label}: non-finite displacements")
    for key, floor in floors.items():
        if key in ("static_assigned", "kept"):
            check(rec[key] > floor, (label, key, rec))
        else:
            check(rec[key] < floor, (label, key, rec))
    return rec


def production_tile_run(runner, cfg: dict, models, tile, dev, here: str,
                        out_dir: str | None = None) -> tuple:
    """One production tile through ``runner`` (``run_fusion3d_tiles`` or
    ``run_f2s3_tiles``): (result, seconds, stage seconds, launches, peak
    GiB, the result tables written, relative to the results folder). The
    tables go to a temporary directory, or stay under ``out_dir``."""
    timings: dict = {}
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        root = out_dir or tmp
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runner(dict(cfg, output_dir=root, output_folder="smoke"), *models, [(0, *tile)],
                     device=dev, timings=timings)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        results = os.path.join(root, "smoke", "results")
        written = sorted(os.path.relpath(os.path.join(d, f), results)
                         for d, _, fs in os.walk(results) for f in fs)
    return res[0], secs, timings, launches, peak, written


def bf16_small_run(d):
    """Phase (u)'s small tile's bf16 descriptors (kernel 1, patch 128) on
    device ``d``, numpy."""
    from fusion4landslide_tpu_torch.ops.hashgrid import median_nn_distance_traced

    sb, sm, tb, tm, ns, nt = padded_small_tile(1.5, 1.5)
    med, _ = median_nn_distance_traced(torch.from_numpy(sb), torch.from_numpy(sm))
    radius = float(np.sqrt(3.0) * 10.0 * float(med))
    return tuple(f.numpy() for f in descriptor_pair(d, "knn", sb, sm, tb, tm, ns, nt, radius,
                                                    dtype="bfloat16"))


def bf16_small_compare(state: dict) -> dict:
    """Phase (u) on a small tile: bf16 descriptors on the card against
    the CPU path (descriptor error, source -> target 1-NN agreement)."""
    _, _, _, _, ns, nt = padded_small_tile(1.5, 1.5)
    pairs = [tuple(torch.from_numpy(f) for f in x) for x in (state["card"], state["cpu"].result())]
    rows = {"bfloat16": descriptor_readings(*pairs, ns, nt)}
    log(f"# phase (u) small-tile DIPs descriptors, card vs CPU path ({card()}): "
        f"{json.dumps(rows)}")
    check(rows["bfloat16"]["feat_max_abs_err"] <= 1e-2, rows)
    check(rows["bfloat16"]["nn1_equal_frac"] >= 0.9, rows)
    return rows


def training_phase(dev, tmp: str) -> dict:
    """Phase (v): E-LoFTR at ``tests/test_eloftr_train.py``'s TINY size for
    60 steps and RoMa at ``tests/test_roma.py``'s TINY for 120 steps, on
    the card from ``flax_default_init`` (seed 0): steps per second, the
    loss history, the JAX tests' checks (coarse CE < 0.7x, EPE < 0.6x the
    first), the first step's loss and gradient norms on the card against
    the CPU path, and the checkpoints (written under ``tmp``) read back
    through the port's loaders."""
    from fusion4landslide_tpu_torch.image import eloftr as te
    from fusion4landslide_tpu_torch.image import eloftr_train as tet
    from fusion4landslide_tpu_torch.image import roma as tr
    from fusion4landslide_tpu_torch.image import roma_train as trt
    from fusion4landslide_tpu_torch.image.flax_bridge import (
        flat_grads_from_module,
        flax_default_init,
    )

    runs = {
        "eloftr": dict(
            cfg=te.ELoFTRConfig(stage_num_blocks=(1, 1, 1, 1), out_features=(8, 8, 16, 32),
                                hidden_size=32, num_attention_layers=1, fine_matching_slice_dim=4),
            settings=trt.TrainSettings(size=64, steps=60, lr=3e-3, batch=2, max_rot=0.05,
                                       max_shift=0.15),
            module=te.EfficientLoFTR, is_norm=te._is_norm, train=tet.train_eloftr,
            loss=tet.eloftr_batch_loss, save=te.save_eloftr_weights, load=te.load_eloftr_weights,
            to_flax=te.eloftr_to_flax, ratio=0.7, log_every=15),
        "roma": dict(
            cfg=tr.RoMaConfig(enc_channels=(8, 16, 24), gp_dim=32, coord_freqs=4, anchors=8,
                              decoder_channels=32, decoder_blocks=2, refine_channels=(16, 12)),
            settings=trt.TrainSettings(size=48, steps=120, lr=3e-3, max_rot=0.05),
            module=tr.RoMaMatcher, is_norm=tr._is_norm, train=trt.train_roma,
            loss=lambda m, b: trt.roma_batch_loss(m, b, 3.0 * 2.0 / 48),
            save=tr.save_roma_weights, load=tr.load_roma_weights, to_flax=tr.roma_to_flax,
            ratio=0.6, log_every=20),
    }
    def leaf_err(ga: dict, gb: dict) -> tuple:
        """(worst leaf's |a - b| / |b|, floored at 1e-4 of the largest
        leaf norm; that leaf's name)."""
        gnorm = max(np.linalg.norm(v) for v in gb.values())
        errs = {k: float(np.linalg.norm(ga[k] - gb[k]) / max(np.linalg.norm(gb[k]), 1e-4 * gnorm))
                for k in gb}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    out = {}
    for name, r in runs.items():
        # The first step on the card twice and on the CPU: the same init,
        # the same batch. The card's runs use cuDNN's deterministic
        # algorithms; the ops with no deterministic CUDA backward are
        # named by torch's warnings, and the two card runs' gap is their
        # spread from run to run.
        first = []
        det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for d in (dev, dev, torch.device("cpu")):
                    model = flax_default_init(r["module"](r["cfg"]), 0, r["is_norm"]).to(d).train()
                    rng = np.random.default_rng(0)
                    trt.make_pair(rng, r["settings"])
                    loss, aux = r["loss"](model, trt.sample_batch(rng, r["settings"], d))
                    loss.backward()
                    grads = flat_grads_from_module(model, r["is_norm"])
                    first.append((float(loss.detach()), [float(a.detach()) for a in aux], grads))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        nondeterministic = sorted({str(w.message).split(" does not have a deterministic")[0][:120]
                                   for w in caught if "deterministic" in str(w.message)})
        (lg, ag, gg), (_, _, gg2), (lc, ac, gc) = first
        grad_err, grad_worst = leaf_err(gg, gc)
        spread, spread_worst = leaf_err(gg2, gg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, _, hist = r["train"](r["settings"], r["cfg"], seed=0, log_every=r["log_every"],
                                    device=dev, logger=None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        path = os.path.join(tmp, f"{name}_tiny.npz")
        r["save"](path, model)
        back = r["load"](path, device=dev)
        same = all(np.array_equal(v, r["to_flax"](model)[k]) for k, v in r["to_flax"](back).items())
        curve = [h[0] if isinstance(h, tuple) else h for h in hist]
        out[name] = {
            "steps": r["settings"].steps, "steps_per_s": r["settings"].steps / secs,
            "history": curve, "ratio": curve[-1] / curve[0], "ratio_bound": r["ratio"],
            "first_loss": [lg, lc], "first_parts": [ag, ac],
            "first_loss_rel_err": abs(lg - lc) / abs(lc), "first_grad_rel_err": grad_err,
            "first_grad_worst_leaf": grad_worst, "first_grad_card_spread": spread,
            "first_grad_card_spread_worst_leaf": spread_worst,
            "nondeterministic_ops": nondeterministic,
            "checkpoint_reloads_equal": same,
        }
        log(f"# phase (v) {name} training ({card()}): {json.dumps(out[name])}")
        check(np.isfinite(curve).all() and out[name]["ratio"] < r["ratio"], out[name])
        check(out[name]["first_loss_rel_err"] <= 1e-3 and grad_err <= 1e-2, out[name])
        check(same and not os.path.abspath(path).startswith(os.path.abspath("weights")), out[name])
    return out


# ---- Phases (w) host vs runner parity, (x) matcher evaluation, (y) the
# hard scene --------------------------------------------------------------

#: Seconds spent in phases (w)-(y).
PHASES_W_Y_S = [0.0]
#: ``tools/matcher_eval.py``'s scene: the nadir view of a 150 m extent at
#: the reference image size, a planted shift of ~25 px.
EVAL_IMAGE, EVAL_EXTENT, EVAL_SHIFT_PX = (1920, 2560), 150.0, 25.0
EVAL_OVERLAP = (480, 640)


def host_parity_phase(dev, cfg: dict, models, tile, runner_table: str, runner_s: float,
                      n_core: int, halo: float, here: str) -> dict:
    """(w): the host tile (``parity_check.run_path('host')``) on phase 6's
    production tile and configuration, joined with phase 6's runner table
    as ``tools/parity_check.py`` joins them (``parity_check.parity_readings``:
    the tool's keys; ``mesh`` is the runner)."""
    from fusion4landslide_tpu_torch import parity_check

    timings: dict = {}
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        table, host_s, out = parity_check.run_path("host", cfg, *models, *tile, tmp, dev, timings)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = parity_check.parity_readings(table, runner_table,
                                           parity_check.planted_truth(n_core, halo))
    rec.update(tile_points=int(len(tile[0])), host_seconds=host_s, mesh_seconds=runner_s,
               host_peak_gib=peak, host_overflow=out["overflow_by_source"], launches=launches)
    log(f"# phase (w) host tile vs runner on phase 6's production tile ({card()}): "
        f"{json.dumps(rec)}; host stages (s): "
        + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    check(launches["radius_sample"] > 0 and launches["grid_knn"] > 0, launches)
    check(rec["common"] > 0 and rec["host_assigned"] > 0.1 * len(tile[0]), rec)
    check(all(np.isfinite(rec[k]) for k in ("median_delta_disp_m", "max_delta_disp_m",
                                            "host_median_err_vs_truth_m",
                                            "mesh_median_err_vs_truth_m")), rec)
    return launches


def matcher_eval_phase(dev, scene) -> dict:
    """(x): ``matcher_eval`` at the production crops (960 x 1280, overlap
    480 x 640) on the rendered nadir scene, one warm repeat per matcher."""
    from fusion4landslide_tpu_torch import matcher_eval

    by_path = {}
    for matcher in ("zncc", "eloftr", "roma"):
        reset_launches()
        row = matcher_eval.evaluate_matcher(scene, matcher, CROP, EVAL_OVERLAP, EVAL_SHIFT_PX,
                                            repeats=1, device=dev)
        by_path[f"matcher_eval_{matcher}"] = read_launches()
        log(f"# phase (x) matcher_eval {matcher}, {scene.image_size[0]}x{scene.image_size[1]} "
            f"in {CROP[0]}x{CROP[1]} crops ({card()}): {json.dumps(row)}")
        check(row["n_matches"] > 100 and np.isfinite(row["epe_mean_px"]), row)
        if matcher != "roma":
            check(not row["zncc_fallback"] and row["epe_median_px"] < 3.0, row)
    return by_path


def hard_scene_phase(dev, dips, agg, here: str) -> dict:
    """(y): the host fusion tile on the hard pair of the repository's
    ``tests/test_synth_hard.py`` (``synth.HARD_PAIR``,
    ``synth.HARD_TILE_CFG``), held to that test's bars."""
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile
    from fusion4landslide_tpu_torch.synth import (
        HARD_PAIR,
        HARD_TILE_CFG,
        hard_tile_readings,
        make_epoch_pair_hard,
    )

    src, tgt, _, moving, true_disp = make_epoch_pair_hard(**HARD_PAIR)
    timings: dict = {}
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_fusion3d_tile(dict(HARD_TILE_CFG, output_dir=tmp), dips, agg, src, tgt,
                                tile_id="hard", device=dev, timings=timings)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
    rec = dict(hard_tile_readings(out, moving, true_disp), points=int(len(src)),
               n_vox=list(out["n_vox"]), tile_s=secs, overflow=out["overflow_by_source"],
               launches=launches)
    log(f"# phase (y) hard scene host tile ({card()}): {json.dumps(rec)}; stages (s): "
        + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    check(launches["radius_sample"] > 0 and launches["grid_knn"] > 0, launches)
    check(rec["assigned"] > 0.7 and rec["static_err_m"] < 5e-3 and rec["moving_err_m"] < 1e-2,
          rec)
    return launches


def padded_cloud(dev, cloud: np.ndarray, centre: np.ndarray):
    """(bucket, 3) float32 on the card, ``cloud - centre`` then zeros, and
    its row mask."""
    from fusion4landslide_tpu_torch.ops.segments import bucket_size

    n = cloud.shape[0]
    N = bucket_size(n)
    pts = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    pts[:n] = torch.from_numpy(cloud - centre).to(dev)
    return pts, torch.arange(N, device=dev) < n


def grid_knn_bound(w, chunk: int) -> tuple[float, str, int]:
    """Kernel 2's bound on window ``w``: each block reads its window once
    (x, y, z, |r|^2, index: 20 B per position), each query its position
    and row, each output 8 B; ``OPS_GRID_KNN`` per candidate. Returns
    (ms, what bounds it, candidate evaluations)."""
    positions, cands = window_work(w, chunk)
    b = bound(positions * 20 + w.n_pad * (12 + 4) + w.n_pad * 8, cands * OPS_GRID_KNN)
    return b[0], b[1], cands


def sampler_phase(pts, mask, chunk: int, tag: str, *, plain: bool) -> dict:
    """Kernel 1 on a padded cloud at its DIPs patch radius (sqrt(3) * 10 *
    median resolution, the window fitted as the step fits it), against
    its plain version: P = 256 ``'random'`` and P = 128 ``'distance'`` on
    every 8th block and the widest one. Timed at the main path's launch
    shapes: one range of 128 query blocks at P = 256 ``'random'`` (the
    DIPs patch sampler) and every block at P = 128 ``'distance'`` (the
    supervoxel graph); with ``plain`` the plain version is timed on the
    128 blocks too. Returns the ``kernels`` row's numbers."""
    from fusion4landslide_tpu_torch.checks import sample_agreement, sampler_borderline_rows
    from fusion4landslide_tpu_torch.ops import hashgrid_cuda as hc
    from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, median_nn_distance_traced

    dev = pts.device
    med, _ = median_nn_distance_traced(pts, mask)
    radius = float(torch.sqrt(torch.tensor(3.0)) * 10.0 * med.cpu())
    win = hc.window_prologue(pts, build_hash_grid(pts, radius, mask), 512, 32768,
                             fit_chunk=chunk)
    cen = hc.block_centres(win)
    r2 = torch.tensor(radius, dtype=torch.float32, device=dev) ** 2
    wide = int(win.wmeta[1].argmax())
    log(f"# sampler {tag}: radius {radius:.4f} m, {win.nb} blocks, window {win.window} "
        f"({int((win.wmeta[1] > 32768).sum())} blocks past 32768), overflow "
        f"{int(win.overflow)}")
    check(int(win.overflow) == 0, (tag, "sampler window overflow"))
    sub = sorted(set(range(0, win.nb, 8)) | {wide})
    rows = torch.cat([torch.arange(b * 512, (b + 1) * 512, device=dev) for b in sub])
    worst = 0.0
    for P, prio in ((256, "random"), (128, "distance")):
        i_k, v_k, x_k = hc._radius_sample_cuda(win, cen, r2, P, 0, prio, chunk=chunk, b0=0,
                                               b1=win.nb)
        i_k, v_k, x_k = i_k[rows], v_k[rows], x_k[rows]
        i_p, v_p, x_p = hc.radius_sample_plain(win, cen, r2, P, 0, prio, chunk=chunk, blocks=sub)
        border = sampler_borderline_rows(win, cen, r2, P, prio, chunk=chunk, blocks=sub)
        agr = sample_agreement(i_p, v_p, i_k, v_k, border)
        same = v_p & v_k & (i_p == i_k)
        err = float((x_p - x_k).abs()[same].max()) if bool(same.any()) else 0.0
        agr["max_abs_err_xyz"] = err
        agr["valid_slots_per_query"] = float(v_k.sum()) / rows.numel()
        log(f"# sampler {tag} P={P} {prio}: {json.dumps(agr)}")
        check(agr["exact_frac"] >= 0.999 and agr["unexplained_rows"] == 0, agr)
        worst = max(worst, err)
        del i_k, v_k, x_k

    def sampler_bound(b1: int, P: int) -> tuple[float, str]:
        positions, cands = window_work(win, chunk, 0, b1)
        rows_out = b1 * 512
        return bound(positions * 20 + rows_out * 12 + rows_out * P * 20,
                     cands * OPS_RADIUS_SAMPLE + positions * OPS_RADIUS_STAGE)

    b1 = min(128, win.nb)
    ms = cuda_ms(lambda: hc._radius_sample_cuda(win, cen, r2, 256, 0, "random", chunk=chunk,
                                                b0=0, b1=b1))
    plain_ms = (cuda_ms(lambda: hc.radius_sample_plain(win, cen, r2, 256, 0, "random",
                                                       chunk=chunk, blocks=range(b1)), reps=1)
                if plain else None)
    b_ms, b_by = sampler_bound(b1, 256)
    sv_ms = cuda_ms(lambda: hc._radius_sample_cuda(win, cen, r2, 128, 0, "distance",
                                                   chunk=chunk, b0=0, b1=win.nb))
    sv_b_ms, sv_b_by = sampler_bound(win.nb, 128)
    plain_txt = f", plain {plain_ms:.1f} ms" if plain else ""
    log(f"# phase sampler {tag}: kernel {ms:.3f} ms per {b1}-block P = 256 'random' launch "
        f"(before {MS_BEFORE['radius_sample']} ms){plain_txt}, bound "
        f"{b_ms:.3f} ms ({b_by}, {window_work(win, chunk, 0, b1)[1]} evaluations x "
        f"{OPS_RADIUS_SAMPLE} + {window_work(win, chunk, 0, b1)[0]} block positions x "
        f"{OPS_RADIUS_STAGE} f32 ops); supervoxel-graph launch ({win.nb} blocks, P = 128 "
        f"'distance') {sv_ms:.3f} ms, bound {sv_b_ms:.3f} ms ({sv_b_by}, "
        f"{window_work(win, chunk)[1]} evaluations)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                graph_ms=sv_ms, graph_bound_ms=sv_b_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from fusion4landslide_tpu_torch import resolve_device
    from fusion4landslide_tpu_torch.checks import (
        knn_agreement,
        sample_agreement,
        sampler_borderline_rows,
    )
    from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
    from fusion4landslide_tpu_torch.ops import cuda_build, hashgrid_cuda as hc, knn_cuda as kc
    from fusion4landslide_tpu_torch.ops.hashgrid import (
        _density_radius,
        build_hash_grid,
        median_nn_distance_traced,
    )
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.parallel.pipeline import run_f2s3_tiles, run_fusion3d_tiles
    from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile
    from fusion4landslide_tpu_torch.synth import IMG_SIZE, PLANTED_SHIFT, synth_rgb_tile, synth_split_tile

    dev = resolve_device("cuda")
    # bench.py's RGB headline tile (phase 7; its launches in phases 2 and
    # 3) is built on a thread while the kernels build.
    rgb_built_s = [0.0]

    def build_rgb_tile():
        t0 = time.perf_counter()
        tile = synth_rgb_tile(**RGB_TILE)
        rgb_built_s[0] = time.perf_counter() - t0
        return tile

    tile_pool = ThreadPoolExecutor(max_workers=1)
    rgb_future = tile_pool.submit(build_rgb_tile)
    log(f"# card: {card()}")
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    for name in cuda_build.SOURCES:
        lib = cuda_build.load(name)
        check(lib is not None, f"{name} did not load")
        # One line per source: each template instance's registers, stack
        # frame and spills, from -Xptxas -v.
        lines = logs[name].splitlines()
        regs = [int(x.split("Used ")[1].split()[0]) for x in lines if "Used " in x]
        stack = [int(x.split()[0]) for x in lines if "bytes stack frame" in x]
        spills = sum(int(x.split(",")[1].split()[0]) for x in lines if "spill stores" in x)
        log(f"# nvcc {name}: {len(regs)} instances, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, stack frame <= {max(stack, default=0)} B, "
            f"spill stores {spills} B")
    log(f"# phase build: {len(cuda_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")

    # The production tile (phases 6 and 8) also supplies the
    # production-density cloud for the kernel checks.
    halo, density, margin, n_core = 20.0, 100.0, 10.0, 250_000
    src, tgt, core, moving = synth_split_tile(n_core, margin, margin, halo=halo, density=density)
    n = src.shape[0]
    N = bucket_size(n)
    pts, mask = padded_cloud(dev, src, src.mean(axis=0))
    log(f"# tile: src {n} pts, tgt {tgt.shape[0]} pts, bucket {N}")

    kernels: dict[str, dict] = {}

    log_elapsed(t_start, "the build")

    # ---- 2. kernel 2: grid kNN -------------------------------------------
    chunk = 2048
    r0 = _density_radius(pts, mask)
    grid = build_hash_grid(pts, r0, mask)
    win = hc.window_prologue(pts, grid, 512, 32768)
    log(f"# grid kNN: radius {float(r0):.4f} m, {win.nb} blocks, overflow {int(win.overflow)}")
    check(int(win.overflow) == 0, "production grid window overflow")
    all_cases = [(k, excl) for k in (1, 3, 32) for excl in (True, False)]
    grid_knn_bit_check(win, "production", all_cases, chunk)
    # Near ties: a terrain patch with a third of its points duplicated
    # and a fifth repeated one ulp away.
    gen = np.random.default_rng(1)
    base = gen.uniform(-5.0, 5.0, size=(20000, 3)).astype(np.float32)
    base[:, 2] *= 0.1
    dup = np.concatenate([base, base[::3], np.nextafter(base[::5], np.float32(np.inf)), base[::7]])
    dup_t = torch.from_numpy(dup.astype(np.float32)).to(dev)
    win_tie = hc.window_prologue(dup_t, build_hash_grid(dup_t, 0.3), 512, 32768)
    grid_knn_bit_check(win_tie, "near_tie", all_cases, chunk)
    # bench.py's RGB headline tile (phase 7), built on a thread since the
    # start: its source cloud's median-resolution launch and its
    # pixel-space launch (kernel 2 on 2D points), windows fitted as the
    # step fits them.
    r_src, r_tgt, r_core, r_moving, pix, K_img, E_img, m_per_px = rgb_future.result()
    tile_pool.shutdown()
    log(f"# RGB tile ({RGB_TILE}): src {r_src.shape[0]} pts in bucket {bucket_size(len(r_src))}, "
        f"tgt {r_tgt.shape[0]} pts in bucket {bucket_size(len(r_tgt))}, {pix.shape[0]} pixel "
        f"matches in bucket {bucket_size(len(pix))}, {m_per_px:.5f} m per pixel, built in "
        f"{rgb_built_s[0]:.2f} s off the card's path")
    pts1, mask1 = padded_cloud(dev, r_src, r_src.mean(axis=0))
    win1 = hc.window_prologue(pts1, build_hash_grid(pts1, _density_radius(pts1, mask1), mask1),
                              512, 32768, fit_chunk=chunk)
    log(f"# grid kNN RGB tile source: {win1.nb} blocks, window {win1.window}, overflow "
        f"{int(win1.overflow)}")
    grid_knn_bit_check(win1, "RGB tile", [(1, True), (1, False)], chunk)
    win_pix, n_vox = pixel_window(dev, r_src, r_tgt, pix, K_img, E_img, IMG_SIZE)
    log(f"# grid kNN pixel space: {n_vox} source voxels as queries, {pix.shape[0]} pixel "
        f"matches as refs, {win_pix.nb} blocks, window {win_pix.window}, overflow "
        f"{int(win_pix.overflow)}")
    grid_knn_bit_check(win_pix, "pixel", all_cases, chunk)
    ms = cuda_ms(lambda: hc._grid_knn_cuda(win, 1, chunk=chunk, exclude_self=True), reps=10)
    plain_ms = cuda_ms(lambda: hc.grid_knn_plain(win, 1, chunk=chunk, exclude_self=True), reps=1)
    ms_1m = cuda_ms(lambda: hc._grid_knn_cuda(win1, 1, chunk=chunk, exclude_self=True), reps=5)
    pix_ms = cuda_ms(lambda: hc._grid_knn_cuda(win_pix, 1, chunk=chunk, exclude_self=False), reps=10)
    b_ms, b_by, cands = grid_knn_bound(win, chunk)
    b_1m, b_1m_by, cands_1m = grid_knn_bound(win1, chunk)
    pix_b_ms, pix_b_by, pix_cands = grid_knn_bound(win_pix, chunk)
    kernels["grid_knn"] = dict(
        name="grid_knn", route="cuda",
        source="fusion4landslide_tpu_torch/csrc/grid_knn.cu",
        replaces="fusion4landslide_tpu/ops/hashgrid_pallas.py:43",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, pixel_ms=pix_ms, pixel_bound_ms=pix_b_ms,
        rgb_tile_ms=ms_1m, rgb_tile_bound_ms=b_1m,
    )
    log(f"# phase grid kNN: kernel {ms:.3f} ms (before {MS_BEFORE['grid_knn']} ms), plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), {cands} candidate evaluations; "
        f"RGB tile source launch ({win1.n_pad} queries) {ms_1m:.3f} ms, bound {b_1m:.3f} ms "
        f"({b_1m_by}), {cands_1m} candidate evaluations; pixel-space launch ({win_pix.n_pad} "
        f"queries) {pix_ms:.3f} ms, bound {pix_b_ms:.3f} ms ({pix_b_by}), {pix_cands} candidate "
        "evaluations")
    del win, grid, win_tie, win_pix, dup_t, win1

    # ---- 3. kernel 1: radius sampler -------------------------------------
    # The production cloud's windows (the plain version timed there), then
    # the RGB tile's source cloud, windows fitted as the step fits them.
    kernels["radius_sample"] = dict(
        name="radius_sample", route="cuda",
        source="fusion4landslide_tpu_torch/csrc/radius_sample.cu",
        replaces="fusion4landslide_tpu/ops/hashgrid_pallas.py:288", library_ms=None,
        **sampler_phase(pts, mask, chunk, "production", plain=True))
    rgb_row = sampler_phase(pts1, mask1, chunk, "RGB tile", plain=False)
    kernels["radius_sample"].update(
        max_abs_err=max(kernels["radius_sample"]["max_abs_err"], rgb_row["max_abs_err"]),
        rgb_tile_ms=rgb_row["ms"], rgb_tile_bound_ms=rgb_row["bound_ms"],
        rgb_tile_graph_ms=rgb_row["graph_ms"], rgb_tile_graph_bound_ms=rgb_row["graph_bound_ms"])
    del pts1, mask1
    torch.cuda.empty_cache()

    # ---- 4. kernel 3: feature-space kNN ----------------------------------
    kernels["knn"] = knn_phase(dev, N, n)
    torch.cuda.empty_cache()

    log_elapsed(t_start, "the kernel checks")

    # ---- 12. (a) nn1_spatial's exact rerun on the F1 witness -------------
    f1_launches = nn1_overflow_phase(dev)

    # ---- 5. small tiles: card vs the port's CPU path ---------------------
    # Every small tile's CPU path runs in a worker process while the card
    # works on: the fusion steps', (r)'s and (s)'s are scored after the
    # production fusion tiles, the rest (phase 5's F2S3 tiles, (u)'s
    # descriptors, (j)'s and (l)'s small tiles, queued behind them) after
    # phases (q), (x) and (y).
    cpu_pool = ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn"))
    fusion_states = {
        "fusion3d_small": fusion_small_card_side(dev, cpu_pool, global_gated=True),
        "fusion3d_ungated_small": fusion_small_card_side(dev, cpu_pool, global_gated=False),
        "fusion_rgb_small": fusion_small_card_side(dev, cpu_pool, global_gated=True,
                                                   lifting="nn_search"),
        "fusion_rgb_interp_small": fusion_small_card_side(dev, cpu_pool, global_gated=True,
                                                          lifting="interpolation"),
    }
    by_path = {"nn1_spatial_f1": f1_launches}

    # ---- (r) nested_levels=False on the small tile -------------------------
    t_new = time.perf_counter()
    fusion_states["fusion3d_flat_levels_small"] = fusion_small_card_side(
        dev, cpu_pool, global_gated=True, nested_levels=False, levels=(1, 2, 3))
    PHASES_N_R_S[0] += time.perf_counter() - t_new

    # ---- (s) the DIPs grid branches at patch 96 ----------------------------
    t_new = time.perf_counter()
    branch_states = [
        dips_branch_card_side(dev, pipeline, priority, cpu_pool,
                              descriptors=(pipeline, priority) == ("f2s3", "random"))
        for pipeline in ("fusion", "f2s3") for priority in ("knn", "random")]
    PHASES_S_V_S[0] += time.perf_counter() - t_new

    # ---- 5. the F2S3 tiles; (u) bf16 descriptors; (j), (l) small tiles ----
    late_states = {"f2s3_small": split_run(dev, cpu_pool, f2s3_small_run),
                   "f2s3_host_small": split_run(dev, cpu_pool, f2s3_host_small_run)}
    t_new = time.perf_counter()
    late_states["bf16_small"] = split_run(dev, cpu_pool, bf16_small_run)
    PHASES_S_V_S[0] += time.perf_counter() - t_new
    t_new = time.perf_counter()
    late_states["superpoint_small"] = split_run(dev, cpu_pool, superpoint_small_run)
    icp_cases = [(icp_type, host) for icp_type in ("point2plane", "generalized")
                 for host in (False, True)]
    for icp_type, host in icp_cases:
        late_states[f"{icp_type}_{'host' if host else 'step'}_small"] = split_run(
            dev, cpu_pool, icp_small_run, icp_type, host)
    by_path["superpoint_rgb_epoch"] = superpoint_epoch_phase(dev)
    new_phase_s = time.perf_counter() - t_new
    log_elapsed(t_start, "the small tiles' card sides")
    torch.cuda.empty_cache()

    # ---- 6. the production tile through the fusion runner ---------------
    # Phase (x)'s scene is rendered by numpy in a process of its own while
    # the card works through the production tiles (after the phases whose
    # CPU sides it would slow).
    from fusion4landslide_tpu_torch.matcher_eval import Scene

    render_pool = ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn"))
    scene_future = render_pool.submit(Scene, EVAL_IMAGE, EVAL_EXTENT, EVAL_SHIFT_PX)
    cfg = FUSION_CFG
    dips, agg = seeded_models(0, dev)
    here = os.path.dirname(os.path.abspath(__file__))
    static = core & ~moving
    # Phase 6's tables stay until phase (w) has joined them with the host tile's.
    runner_dir = tempfile.TemporaryDirectory(prefix="_smoke_", dir=here)
    out, step_s, timings, launches, peak, written = production_tile_run(
        run_fusion3d_tiles, cfg, (dips, agg), (src, tgt), dev, here, out_dir=runner_dir.name)
    by_path["fusion3d"] = launches
    log(f"# tile step: {step_s:.2f} s, peak {peak:.2f} GiB, overflow "
        f"{out['overflow']}, n_dropped {out['n_dropped']}, launches {launches}")
    log("# stages (s): " + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    log(f"# tables: {written}")
    check(launches["grid_knn"] > 0 and launches["radius_sample"] > 0, launches)
    check("c2f_dvfs_src2tgt_tile_0.txt" in written, written)
    production_recovery(out, n, core, moving, static, "phase 6 production fusion tile",
                        RECOVERY)
    ok = out["valid"]

    log_elapsed(t_start, "phase 6")

    # ---- (w) the host tile against phase 6's runner tile -----------------
    t_new = time.perf_counter()
    by_path["fusion3d_host_parity"] = host_parity_phase(
        dev, cfg, (dips, agg), (src, tgt),
        os.path.join(runner_dir.name, "smoke", "results", "c2f_dvfs_src2tgt_tile_0.txt"),
        step_s, n_core, halo, here)
    runner_dir.cleanup()
    PHASES_W_Y_S[0] += time.perf_counter() - t_new

    # ---- (l) the same tile with icp_type: generalized ----------------------
    t_new = time.perf_counter()
    g_out, g_s, g_t, g_l, _, _ = production_tile_run(
        run_fusion3d_tiles, dict(cfg, icp_type="generalized"), (dips, agg), (src, tgt), dev,
        here)
    by_path["fusion3d_generalized"] = g_l
    g_rec = {"tile_s": g_s, "fine_s": g_t.get("fine"), "point2point_tile_s": step_s,
             "point2point_fine_s": timings.get("fine"), "launches": g_l}
    log(f"# phase (l) production tile, icp_type generalized ({card()}): {json.dumps(g_rec)}; "
        "stages (s): " + json.dumps({k: round(v, 3) for k, v in g_t.items()}))
    # The fine pairs' validity is decided before ICP: the same points are
    # assigned whatever the ICP type.
    check(bool((g_out["valid"] == ok).all()), g_rec)
    # Reported, not held to RECOVERY: generalized ICP moves the errors
    # (16.0 / 34.2 mm static / moving on an H100 80GB HBM3 at 700 W).
    production_recovery(g_out, n, core, moving, static, "phase (l) generalized", {})
    new_phase_s += time.perf_counter() - t_new

    # ---- (t) the DIPs 'knn' branch at full width; (u) bf16 descriptors ---
    t_new = time.perf_counter()
    tile = (src, tgt)
    for label, changes in (("(t) patch 192 'knn', k_max 512",
                            {"feat_patch_points": 192, "feat_k_max": 512}),
                           ("(u) feat_dtype bfloat16", {"feat_dtype": "bfloat16"})):
        v_out, v_s, v_t, v_l, v_peak, _ = production_tile_run(
            run_fusion3d_tiles, dict(cfg, **changes), (dips, agg), tile, dev, here)
        row = {"tile_s": v_s, "dips_features_s": v_t.get("dips_features"),
               "float32_256_tile_s": step_s, "float32_256_dips_features_s":
               timings.get("dips_features"), "peak_gib": v_peak, "float32_256_peak_gib": peak,
               "overflow": v_out["overflow_by_source"], "launches": v_l}
        log(f"# phase {label}, production fusion tile ({card()}): {json.dumps(row)}; stages "
            "(s): " + json.dumps({k: round(v, 3) for k, v in v_t.items()}))
        check(v_l["radius_sample"] > 0 and v_l["grid_knn"] > 0, v_l)
        production_recovery(v_out, n, core, moving, static, f"phase {label}", RECOVERY)
        by_path["fusion3d_patch192_knn" if "192" in label else "fusion3d_bf16"] = v_l
    PHASES_S_V_S[0] += time.perf_counter() - t_new

    log_elapsed(t_start, "phases (w), (l), (t) and (u)")

    # ---- 5., (r), (s) scored: the CPU paths from the worker process -------
    t_new = time.perf_counter()
    for key, st in fusion_states.items():
        by_path[key] = fusion_small_compare(st)
    check(by_path["fusion3d_ungated_small"]["knn"] > 0, by_path)
    for st in branch_states:
        by_path[f"{st['pipeline']}_patch96_{st['priority']}_small"] = dips_branch_compare(st)
    log(f"# the CPU paths of phases 5, (r) and (s) scored after {time.perf_counter() - t_new:.1f} "
        "s of waiting")
    PHASES_S_V_S[0] += time.perf_counter() - t_new

    # ---- 7. bench.py's RGB tile through the fusion runner ----------------
    log_elapsed(t_start, "phase 7")
    by_path["fusion_rgb"] = fusion_rgb_tile(
        dev, dict(cfg, **RGB_CFG), dips, agg,
        (r_src, r_tgt, r_core, r_moving, pix, K_img, E_img, m_per_px),
    )
    del r_src, r_tgt, r_core, r_moving, pix
    torch.cuda.empty_cache()
    log_elapsed(t_start, "phase 7 done")

    # ---- 8. the production tile through the F2S3 runner -----------------
    filt = seeded_filter(0, dev)
    out, step_s, f_timings, launches, peak, written = production_tile_run(
        run_f2s3_tiles, F2S3_CFG, (dips, filt), (src, tgt), dev, here)
    by_path["f2s3"] = launches
    log(f"# F2S3 tile step: {step_s:.2f} s, peak {peak:.2f} GiB, overflow "
        f"{out['overflow']}, n_dropped {out['n_dropped']}, launches {launches}, "
        f"kernel 3 rescored {int(kc.RESCORED[0]) / N:.2f} candidates per row")
    log("# F2S3 stages (s): " + json.dumps({k: round(v, 3) for k, v in f_timings.items()}))
    log(f"# F2S3 tables: {written}")
    check(min(launches.values()) > 0, launches)
    for name in ("f2s3_dvfs_of_tile_0.txt", "f2s3_dvfms_of_tile_0.txt",
                 "f2s3_dvfms_of_tile_0_visualize_0_5.txt",
                 "f2s3_dvfms_without_pruning_of_tile_0.txt",
                 os.path.join("filtered_by_magnitude", "f2s3_dvfms_filtered_by_median_mag_of_tile_0.txt"),
                 os.path.join("combined_with_c2c", "f2s3_dvfms_combined_with_c2c_of_tile_0.txt")):
        check(name in written, (name, written))
    check(out["keep"].any() and np.isfinite(out["magnitudes"]).all(),
          "F2S3 outputs empty or not finite")
    production_recovery(out, n, core, moving, static, "phase 8 production F2S3 tile",
                        RECOVERY_F2S3, kept_key="keep")

    # ---- (u) the F2S3 tile with bf16 descriptors; (v) matcher training ---
    t_new = time.perf_counter()
    u_out, u_s, u_t, u_l, u_peak, _ = production_tile_run(
        run_f2s3_tiles, dict(F2S3_CFG, feat_dtype="bfloat16"), (dips, filt), (src, tgt), dev, here)
    row = {"tile_s": u_s, "dips_features_s": u_t.get("dips_features"), "float32_tile_s": step_s,
           "float32_dips_features_s": f_timings.get("dips_features"), "peak_gib": u_peak,
           "float32_peak_gib": peak, "launches": u_l,
           "keep_equal_float32_frac": float((u_out["keep"] == out["keep"]).mean())}
    log(f"# phase (u) feat_dtype bfloat16, production F2S3 tile ({card()}): {json.dumps(row)}; "
        "stages (s): " + json.dumps({k: round(v, 3) for k, v in u_t.items()}))
    check(min(u_l.values()) > 0, u_l)
    production_recovery(u_out, n, core, moving, static, "phase (u) F2S3 bfloat16",
                        RECOVERY_F2S3, kept_key="keep")
    by_path["f2s3_bf16"] = u_l
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        training_phase(dev, tmp)
    PHASES_S_V_S[0] += time.perf_counter() - t_new

    # A quarter-size tile through the host tile (main_f2s3 on one device:
    # unpadded clouds, uncapped supervoxel buckets); phase 11 runs it at
    # full size from the driver.
    src, tgt, _, _ = synth_split_tile(n_core // 4, margin, margin, halo=halo, density=density)
    n = src.shape[0]
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        f_cfg = dict(F2S3_CFG, output_dir=tmp, output_folder="smoke")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_f2s3_tile(f_cfg, dips, filt, src, tgt, device=dev)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        results = os.path.join(tmp, "smoke", "results")
        h_written = sorted(
            os.path.relpath(os.path.join(d, f), results)
            for d, _, fs in os.walk(results) for f in fs
        )
    by_path["f2s3_host"] = launches
    keep = out["keep"]
    # keep is the pruning's; the max-magnitude gate then drops rows of the
    # written table (the device step's keep includes the gate).
    log(f"# F2S3 host tile ({n} pts): {step_s:.2f} s, peak {peak:.2f} GiB, launches {launches}, "
        f"kernel 3 rescored {int(kc.RESCORED[0]) / n:.2f} candidates per row, "
        f"{int(out['labels'].max()) + 1} supervoxels, pruning kept {keep.mean():.6f} of "
        f"the tile, {out['dvfs'].shape[0] / n:.6f} written after the magnitude gate")
    check(min(launches.values()) > 0, launches)
    check(h_written == written, (h_written, written))
    check(keep.any() and np.isfinite(out["dvfs"]).all() and np.isfinite(out["magnitudes"]).all(),
          "host F2S3 outputs empty or not finite")

    log_elapsed(t_start, "the host F2S3 tile")

    # ---- (q) two tile streams on the one card: the F2S3 runner -------------
    t_new = time.perf_counter()
    by_path.update(f2s3_streams_phase(dev, dips, filt, n_core // 16, margin / 2, halo, density))
    PHASES_N_R_S[0] += time.perf_counter() - t_new

    # ---- (x) matcher_eval at production crops; (y) the hard scene --------
    t_new = time.perf_counter()
    scene = scene_future.result()
    render_pool.shutdown()
    by_path.update(matcher_eval_phase(dev, scene))
    by_path["hard_host"] = hard_scene_phase(dev, dips, agg, here)
    PHASES_W_Y_S[0] += time.perf_counter() - t_new

    log_elapsed(t_start, "phases (q), (x) and (y)")

    # ---- 5., (u), (j), (l) scored: the rest of the worker's CPU paths -------
    t_wait = time.perf_counter()
    by_path["f2s3_small"] = f2s3_small_compare(late_states.pop("f2s3_small"))
    by_path["f2s3_host_small"] = f2s3_host_small_compare(late_states.pop("f2s3_host_small"))
    bf16_small_compare(late_states.pop("bf16_small"))
    by_path["superpoint_small"] = superpoint_small_compare(late_states.pop("superpoint_small"))
    for icp_type, host in icp_cases:
        key = f"{icp_type}_{'host' if host else 'step'}_small"
        by_path[key] = icp_small_compare(late_states.pop(key), icp_type, host)
    cpu_pool.shutdown()
    log(f"# the CPU paths of phases 5, (u), (j) and (l) scored after "
        f"{time.perf_counter() - t_wait:.1f} s of waiting")
    log_elapsed(t_start, "the small tiles scored")

    # ---- 9.-11. the drivers from files on disk ---------------------------
    by_path.update(driver_phases(dips, agg, filt))
    log(f"# phases (j)-(m) in the main script: {new_phase_s + NEW_PHASE_S[0]:.1f} s ({card()})")
    log(f"# phases (n)-(r): {PHASES_N_R_S[0]:.1f} s ({card()})")
    log(f"# phases (s)-(v): {PHASES_S_V_S[0]:.1f} s ({card()})")
    log(f"# phases (w)-(y): {PHASES_W_Y_S[0]:.1f} s ({card()})")

    # ---- 17. kernels line + 18. result line ------------------------------
    log(f"# chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s, the kernel build "
        "included")
    for name, row in kernels.items():
        row["ms_before"] = MS_BEFORE[name]
        # Launches on the main path, bench.py's RGB tile through the fusion
        # runner (phase 7); kernel 3 is not on it (the gated match is plain,
        # as in JAX), so its count is the F2S3 production tile's (phase 8).
        row["launches_path"] = "fusion_rgb" if by_path["fusion_rgb"][name] else "f2s3"
        row["launches"] = by_path[row["launches_path"]][name]
        row["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        {**{k: row[k] for k in order}, **{k: v for k, v in row.items() if k not in order}}
        for row in kernels.values()
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
