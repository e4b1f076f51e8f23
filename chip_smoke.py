#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fusion4landslide_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel in ``fusion4landslide_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel, into ``fusion4landslide_tpu_torch/_build``);
2. kernel 2 (grid kNN) against its plain PyTorch version on the card, on
   a production-density grid: k = 1 with and without ``exclude_self``,
   and k = 3;
3. kernel 1 (radius sampler) against its plain version: P = 256
   ``'random'`` and P = 128 ``'distance'``;
4. the whole tile step on a small tile, on the card against the port's
   CPU path (the path the CPU tests hold against the JAX package), scored
   as ``tools/parity_check.py`` scores two paths;
5. one production-shaped 3D-only tile (a 250 000-point core at
   100 pts/m^2 with symmetric 10 m margins, ~490 k points per cloud,
   bucket 524288) through ``run_fusion3d_tiles`` with the
   ``fusion_3d_brienz.yaml`` statics and seeded random weights: asserts
   both kernels launched during the step, finite outputs, and recovery of
   the planted displacement between the sound and the broken readings of
   random-init descriptors (see ``RECOVERY``);
6. a ``kernels`` JSON line: launches on the tile step, time, plain-version
   time, the least time the card could take (bound) and what bounds it;
7. last line: ``{"ok": true, "device": {...}}``.

It imports neither ``jax`` nor ``fusion4landslide_tpu``, and never falls
back to the CPU or to the plain versions.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
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
#: float32 operations per candidate evaluation in each kernel.
OPS_GRID_KNN = 7  # 3 mul + 3 add for the score, 1 compare
OPS_RADIUS_SAMPLE = 19  # centring, |r|^2, score, d^2, 2 compares


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_work(win, chunk: int, b0: int = 0, b1: int | None = None) -> tuple[int, int]:
    """(candidate positions summed over blocks [b0, b1), the same times the
    block's query count) for this run's windows."""
    from fusion4landslide_tpu_torch.ops.hashgrid_cuda import _scan_len

    scans = _scan_len(win.wmeta[1], chunk, win.window)[b0:b1]
    return int(scans.sum()), int(scans.sum()) * win.block


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from fusion4landslide_tpu_torch import resolve_device
    from fusion4landslide_tpu_torch.checks import (
        knn_agreement,
        sample_agreement,
        sampler_borderline_rows,
    )
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.ops import cuda_build, hashgrid_cuda as hc
    from fusion4landslide_tpu_torch.ops.hashgrid import (
        _density_radius,
        build_hash_grid,
        median_nn_distance_traced,
    )
    from fusion4landslide_tpu_torch.ops.segments import bucket_size
    from fusion4landslide_tpu_torch.parallel.pipeline import run_fusion3d_tiles
    from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT, synth_split_tile

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"# card: {smi}")
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    for name in cuda_build.SOURCES:
        lib = cuda_build.load(name)
        check(lib is not None, f"{name} did not load")
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"# nvcc {name}: {line.strip()}")
    log(f"# phase build: {len(cuda_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")

    # The production tile (phase 5) also supplies the production-density
    # cloud for the kernel checks.
    halo, density, margin, n_core = 20.0, 100.0, 10.0, 250_000
    src, tgt, core, moving = synth_split_tile(n_core, margin, margin, halo=halo, density=density)
    n = src.shape[0]
    N = bucket_size(n)
    centre = src.mean(axis=0)
    pts = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    pts[:n] = torch.from_numpy(src - centre).to(dev)
    mask = torch.arange(N, device=dev) < n
    log(f"# tile: src {n} pts, tgt {tgt.shape[0]} pts, bucket {N}")

    kernels: dict[str, dict] = {}

    # ---- 2. kernel 2: grid kNN -------------------------------------------
    chunk = 2048
    r0 = _density_radius(pts, mask)
    grid = build_hash_grid(pts, r0, mask)
    win = hc.window_prologue(pts, grid, 512, 32768)
    log(f"# grid kNN: radius {float(r0):.4f} m, {win.nb} blocks, overflow {int(win.overflow)}")
    sub = list(range(0, win.nb, 16))
    worst = 0.0
    for k, excl, blocks in ((1, True, None), (1, False, sub), (3, False, sub)):
        d_k, i_k = hc._grid_knn_cuda(win, k, chunk=chunk, exclude_self=excl)
        d_p, i_p = hc.grid_knn_plain(win, k + 1, chunk=chunk, exclude_self=excl, blocks=blocks)
        rows = (
            torch.arange(win.n_pad, device=dev) if blocks is None
            else torch.cat([torch.arange(b * 512, (b + 1) * 512, device=dev) for b in blocks])
        )
        agr = knn_agreement(d_p[:, :k], i_p[:, :k], d_k[rows], i_k[rows], d_next=d_p[:, k])
        log(f"# grid kNN k={k} exclude_self={excl} rows={rows.numel()}: {json.dumps(agr)}")
        check(agr["finite_equal"] and agr["dist_ok"] and agr["index_mismatch"] == 0, agr)
        worst = max(worst, agr["max_abs_err"])
    ms = cuda_ms(lambda: hc._grid_knn_cuda(win, 1, chunk=chunk, exclude_self=True))
    plain_ms = cuda_ms(lambda: hc.grid_knn_plain(win, 1, chunk=chunk, exclude_self=True), reps=1)
    positions, cands = window_work(win, chunk)
    b_ms, b_by = bound(
        positions * 20 + win.n_pad * (12 + 4) + win.n_pad * 8,
        cands * OPS_GRID_KNN,
    )
    kernels["grid_knn"] = dict(
        name="grid_knn", route="cuda",
        source="fusion4landslide_tpu_torch/csrc/grid_knn.cu",
        replaces="fusion4landslide_tpu/ops/hashgrid_pallas.py:43",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )
    log(f"# phase grid kNN: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}), {cands} candidate evaluations")

    # ---- 3. kernel 1: radius sampler -------------------------------------
    # The DIPs patch radius of this cloud: sqrt(3) * 10 * median resolution.
    med, _ = median_nn_distance_traced(pts, mask)
    radius = float(torch.sqrt(torch.tensor(3.0)) * 10.0 * med.cpu())
    grid_r = build_hash_grid(pts, radius, mask)
    win_r = hc.window_prologue(pts, grid_r, 512, 32768)
    cen = hc.block_centres(win_r)
    r2 = torch.tensor(radius, dtype=torch.float32, device=dev) ** 2
    log(f"# sampler: radius {radius:.4f} m, {win_r.nb} blocks, overflow {int(win_r.overflow)}")
    sub_r = list(range(0, win_r.nb, 8))
    worst = 0.0
    for P, prio in ((256, "random"), (128, "distance")):
        i_k, v_k, x_k = hc._radius_sample_cuda(win_r, cen, r2, P, 0, prio, chunk=chunk, b0=0, b1=win_r.nb)
        i_p, v_p, x_p = hc.radius_sample_plain(win_r, cen, r2, P, 0, prio, chunk=chunk, blocks=sub_r)
        rows = torch.cat([torch.arange(b * 512, (b + 1) * 512, device=dev) for b in sub_r])
        border = sampler_borderline_rows(win_r, cen, r2, P, prio, chunk=chunk, blocks=sub_r)
        agr = sample_agreement(i_p, v_p, i_k[rows], v_k[rows], border)
        same = v_p & v_k[rows] & (i_p == i_k[rows])
        err = float((x_p - x_k[rows]).abs()[same].max()) if bool(same.any()) else 0.0
        agr["max_abs_err_xyz"] = err
        agr["valid_slots_per_query"] = float(v_k.sum()) / win_r.n_pad
        log(f"# sampler P={P} {prio}: {json.dumps(agr)}")
        check(agr["exact_frac"] >= 0.999 and agr["unexplained_rows"] == 0, agr)
        worst = max(worst, err)
    # Timed at the main path's launch shape: one range of 128 query blocks,
    # P = 256 'random' (the DIPs patch sampler).
    b1 = min(128, win_r.nb)
    ms = cuda_ms(lambda: hc._radius_sample_cuda(win_r, cen, r2, 256, 0, "random", chunk=chunk, b0=0, b1=b1))
    plain_ms = cuda_ms(lambda: hc.radius_sample_plain(win_r, cen, r2, 256, 0, "random", chunk=chunk, blocks=range(b1)), reps=1)
    positions, cands = window_work(win_r, chunk, 0, b1)
    rows_out = b1 * 512
    b_ms, b_by = bound(positions * 20 + rows_out * 12 + rows_out * 256 * 20, cands * OPS_RADIUS_SAMPLE)
    kernels["radius_sample"] = dict(
        name="radius_sample", route="cuda",
        source="fusion4landslide_tpu_torch/csrc/radius_sample.cu",
        replaces="fusion4landslide_tpu/ops/hashgrid_pallas.py:288",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )
    log(f"# phase sampler: kernel {ms:.3f} ms per {b1}-block launch, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), {cands} candidate evaluations")
    del win, win_r, grid, grid_r, cen
    torch.cuda.empty_cache()

    # ---- 4. whole step on a small tile: card vs the port's CPU path ------
    from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

    s_src, s_tgt, _, _ = synth_split_tile(1000, 1.0, 1.5, halo=2.0)
    ns, mt_ = s_src.shape[0], s_tgt.shape[0]
    Ns, Mt = bucket_size(ns), bucket_size(mt_)
    sb = torch.zeros((Ns, 3))
    sb[:ns] = torch.from_numpy(s_src - s_src.mean(0))
    tb = torch.zeros((Mt, 3))
    tb[:mt_] = torch.from_numpy(s_tgt - s_src.mean(0))
    small = dict(levels=(1, 2), patch_points=128, chunk=512, k_neighbors=8,
                 sv_cap=256, member_cap=128, agg_max_points=64, small_patch=3,
                 icp_max_iter=8, fine_max_matches=64)
    outs = []
    for d in (dev, torch.device("cpu")):
        dm, am = seeded_models(0, d)
        outs.append(fusion3d_tile_step(
            dm, am, sb.to(d), (torch.arange(Ns) < ns).to(d), tb.to(d),
            (torch.arange(Mt) < mt_).to(d), 5.0, 0.1, 0.1, 10, 10, 0.5, 0.15,
            device=d, **small,
        ))
    g, c = outs
    vg, vc = g.valid[:ns].cpu().numpy(), c.valid[:ns].numpy()
    common = vg & vc
    gap = np.linalg.norm(g.moved[:ns].cpu().numpy()[common] - c.moved[:ns].numpy()[common], axis=1)
    parity = {
        "n_vox": [int(g.n_vox_src), int(c.n_vox_src), int(g.n_vox_tgt), int(c.n_vox_tgt)],
        "median_res_rel": abs(float(g.median_res) - float(c.median_res)) / float(c.median_res),
        "assigned": [int(vg.sum()), int(vc.sum())],
        "overlap_frac": float(common.sum()) / max(int(vg.sum()), int(vc.sum()), 1),
        "median_delta_disp_m": float(np.median(gap)) if gap.size else None,
        "frac_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
    }
    log(f"# phase small-tile parity (card vs CPU path, {ns} pts): {json.dumps(parity)}")
    nv = parity["n_vox"]
    check(nv[0] == nv[1] and nv[2] == nv[3], parity)
    check(parity["median_res_rel"] <= 1e-6 and vg.sum() > 0.1 * ns, parity)
    check(parity["overlap_frac"] >= 0.99 and parity["median_delta_disp_m"] < 1e-4, parity)
    check(parity["frac_gt_10mm"] <= 0.01, parity)
    check(bool(torch.isfinite(g.moved).all()), "non-finite moved points")

    # ---- 5. the production tile through the runner ----------------------
    cfg = {
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
    dips, agg = seeded_models(0, dev)
    timings: dict = {}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=here) as tmp:
        cfg.update(output_dir=tmp, output_folder="smoke")
        for key in hc.LAUNCHES:
            hc.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_fusion3d_tiles(cfg, dips, agg, [(0, src, tgt)], device=dev, timings=timings)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = dict(hc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        written = sorted(os.listdir(os.path.join(tmp, "smoke", "results")))
    out = res[0]
    log(f"# tile step: {step_s:.2f} s, peak {peak:.2f} GiB, overflow "
        f"{out['overflow']}, n_dropped {out['n_dropped']}, launches {launches}")
    log("# stages (s): " + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    log(f"# tables: {written}")
    check(launches["grid_knn"] > 0 and launches["radius_sample"] > 0, launches)
    check("c2f_dvfs_src2tgt_tile_0.txt" in written, written)

    ok = out["valid"]
    disp = out["dvfs"][:, 3:6] - out["dvfs"][:, :3]
    disp_all = np.zeros((n, 3))
    disp_all[ok] = disp
    check(np.isfinite(disp).all(), "non-finite displacements")
    static = core & ~moving
    err_mov = np.linalg.norm(disp_all[core & moving & ok] - PLANTED_SHIFT, axis=1)
    err_sta = np.linalg.norm(disp_all[static & ok], axis=1)
    log(f"# recovery: static core assigned {ok[static].mean():.4f}, core assigned "
        f"{ok[core].mean():.4f}, median err moving {np.median(err_mov):.3e} m, "
        f"static {np.median(err_sta):.3e} m (floors {json.dumps(RECOVERY)})")
    check(float(ok[static].mean()) > RECOVERY["static_assigned"], "static core assignment")
    check(float(np.median(err_sta)) < RECOVERY["static_err_m"], "static displacement error")
    check(err_mov.size and float(np.median(err_mov)) < RECOVERY["moving_err_m"], "moving displacement error")

    # ---- 6. kernels line + 7. result line --------------------------------
    for name, row in kernels.items():
        row["launches"] = launches[name]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kernels[n_][k] for k in order} for n_ in kernels]}))
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
