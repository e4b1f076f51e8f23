"""Host tile against runner: DVF parity on one production-shaped tile.

The port's twin of the repository's ``tools/parity_check.py``. One
fusion_3d tile, a core of ``--n-core`` points plus its +-``--halo`` m ring
at 100 pts/m^2 (``synth.synth_overlap_tile``, the overlap cloud
``main_fusion`` feeds per tile), runs through both execution paths with
the tool's configuration (3 nested levels, ``feat_k_max`` 512, 256-point
patches, ``feat_dtype: bfloat16``) and seeded random weights
(``models.convert.seeded_models(0)``):

- host: ``pipelines.fusion.run_fusion3d_tile`` (stage by stage, host
  bookkeeping between the stages);
- runner: ``parallel.pipeline.run_fusion3d_tiles`` (the padded tile step
  that ``use_mesh: true`` runs; the tool's "mesh" path, under its keys).

The two written ``c2f_dvfs_src2tgt_tile_0.txt`` tables are joined on exact
source coordinates (``join_disp``), and one JSON line reports the overlap
of the assigned sets, the median / p95 / max displacement gap, the share
of gaps over 10 mm, each path's error against the planted field and the
seconds of both paths, with the device they ran on.

Usage::

    python -m fusion4landslide_tpu_torch.parity_check [--n-core 100000] [--halo 20]
        [--no-halo] [--device cuda|cpu] [--workdir DIR]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one. Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT

__all__ = ["BASE_CFG", "join_disp", "parity_readings", "planted_truth", "run_parity",
           "run_path"]

#: The tool's production configuration (``tools/parity_check.py``).
BASE_CFG = {
    "max_magnitude": 5.0,
    "icp_threshold": 0.1,
    "level_of_superpoint": [1, 2, 3],
    "num_min_fine_match": 10,
    "num_min_matches_for_quality_check": 10,
    "thres_dist_diff": 0.5,
    "thres_inlier_ratio": 0.15,
    "num_min_matches_for_small_patch": 10,
    "voxel_size_init": 0.1,
    "assign_type": "assign_then_nn",
    "output_tgt2src": False,
    "save_interim": False,
    "feat_dtype": "bfloat16",
    "output_folder": "run",
    "dataset": "brienz_tls",
}
TABLE = "c2f_dvfs_src2tgt_tile_0.txt"


def join_disp(path_a: str, path_b: str, truth_fn=None):
    """Join two (x y z x' y' z') DVF tables on exact source coordinates
    (the float32 bits of each row's first three values). Returns (rows of
    a, rows of b, common rows, (common,) |displacement a - displacement
    b|, errors): with ``truth_fn(xyz) -> (n, 3)`` displacement truth,
    each table's median error and share under 10 mm, keyed ``host_*``
    for ``a`` and ``mesh_*`` for ``b``."""
    a = np.loadtxt(path_a, ndmin=2, dtype=np.float64)
    b = np.loadtxt(path_b, ndmin=2, dtype=np.float64)
    ka = {r[:3].astype(np.float32).tobytes(): i for i, r in enumerate(a)}
    kb = {r[:3].astype(np.float32).tobytes(): i for i, r in enumerate(b)}
    common = [k for k in ka if k in kb]
    ia = np.asarray([ka[k] for k in common], np.int64)
    ib = np.asarray([kb[k] for k in common], np.int64)
    gap = np.linalg.norm((a[ia, 3:6] - a[ia, 0:3]) - (b[ib, 3:6] - b[ib, 0:3]), axis=1)
    errs = {}
    if truth_fn is not None:
        for name, tbl in (("host", a), ("mesh", b)):
            err = np.linalg.norm(tbl[:, 3:6] - tbl[:, 0:3] - truth_fn(tbl[:, 0:3]), axis=1)
            errs[f"{name}_median_err_vs_truth_m"] = float(np.median(err))
            errs[f"{name}_frac_err_lt_10mm"] = float((err < 0.01).mean())
    return len(a), len(b), len(common), gap, errs


def planted_truth(n_core: int, halo: float, density: float = 100.0):
    """The planted field of ``synth_overlap_tile`` (and of its split
    crops): the half-plane x > full / 2 moves by ``PLANTED_SHIFT``."""
    full = float(np.sqrt(n_core / density)) + 2.0 * halo

    def truth_fn(xyz):
        return (xyz[:, 0] > full / 2)[:, None] * PLANTED_SHIFT.astype(np.float64)

    return truth_fn


def parity_readings(host_table: str, runner_table: str, truth_fn=None) -> dict:
    """The tool's readings of two DVF tables (``join_disp``)."""
    n_h, n_m, n_common, gap, errs = join_disp(host_table, runner_table, truth_fn)
    some = len(gap) > 0
    return {
        "host_assigned": n_h,
        "mesh_assigned": n_m,
        "common": n_common,
        "overlap_frac": n_common / max(min(n_h, n_m), 1),
        "median_delta_disp_m": float(np.median(gap)) if some else None,
        "p95_delta_disp_m": float(np.quantile(gap, 0.95)) if some else None,
        "max_delta_disp_m": float(gap.max()) if some else None,
        "disagree_frac_gt_10mm": float((gap > 0.01).mean()) if some else None,
        **errs,
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_path(path: str, cfg: dict, dips, agg, src: np.ndarray, tgt: np.ndarray, out_dir: str,
             device, timings: dict | None = None) -> tuple[str, float, dict]:
    """One tile through the ``'host'`` tile or the ``'runner'`` under
    ``out_dir``: (its DVF table, seconds, result)."""
    from fusion4landslide_tpu_torch.parallel.pipeline import run_fusion3d_tiles
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile

    dev = resolve_device(device)
    cfg = dict(cfg, output_dir=out_dir)
    _sync(dev)
    t0 = time.perf_counter()
    if path == "host":
        out = run_fusion3d_tile(cfg, dips, agg, src, tgt, tile_id=0, rng_seed=0, device=dev,
                                timings=timings)
    else:
        out = run_fusion3d_tiles(cfg, dips, agg, [(0, src, tgt)], device=dev, rng_seed=0,
                                 timings=timings)[0]
    _sync(dev)
    seconds = time.perf_counter() - t0
    return osp.join(out_dir, str(cfg.get("output_folder", "run")), "results", TABLE), seconds, out


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_parity(n_core: int = 100_000, halo: float = 20.0, *, device=None,
               workdir=None) -> dict:
    """Both paths on one ``synth_overlap_tile(n_core, halo)`` with
    ``seeded_models(0)`` and ``BASE_CFG``: the tool's JSON record."""
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.synth import synth_overlap_tile

    dev = resolve_device(device)
    dips, agg = seeded_models(0, dev)
    src, tgt, _, _ = synth_overlap_tile(n_core, halo=halo)
    print(f"# tile: core {n_core}, halo +-{halo} m -> {len(src)} pts on {_device_name(dev)}",
          file=sys.stderr)
    root = workdir or tempfile.mkdtemp(prefix="f4l_parity_")
    try:
        tables, secs = {}, {}
        for path in ("host", "runner"):
            tables[path], secs[path], _ = run_path(path, BASE_CFG, dips, agg, src, tgt,
                                                   osp.join(root, path), dev)
            print(f"# {path} path: {secs[path]:.1f} s", file=sys.stderr)
        readings = parity_readings(tables["host"], tables["runner"], planted_truth(n_core, halo))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"n_core": n_core, "halo_m": halo, "tile_points": int(len(src)), **readings,
            "host_seconds": secs["host"], "mesh_seconds_cold": secs["runner"],
            "device": _device_name(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-core", type=int, default=100_000)
    ap.add_argument("--halo", type=float, default=20.0)
    ap.add_argument("--no-halo", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None, help="where the two paths write (default: a "
                    "temporary directory); removed afterwards")
    args = ap.parse_args(argv)
    halo = 0.0 if args.no_halo else args.halo
    print(json.dumps(run_parity(args.n_core, halo, device=args.device, workdir=args.workdir)),
          flush=True)


if __name__ == "__main__":
    main()
