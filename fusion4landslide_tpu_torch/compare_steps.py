"""Time the production tile's three card paths for two checkouts on one card.

    python3 -m fusion4landslide_tpu_torch.compare_steps PATH_A PATH_B [--pairs 1]

Each run is a fresh process started in a checkout's root, which builds
that checkout's kernels and runs ``chip_smoke.py``'s production tile (a
250 000-point core, seeded random weights) through ``run_fusion3d_tiles``,
``run_f2s3_tiles`` and ``run_f2s3_tile``, timing each with the host clock
after ``torch.cuda.synchronize()``. Runs alternate A, B, B, A per pair, so
two versions are compared inside one call on one card. Prints one JSON
line per run (step seconds and stage seconds per path) and the card's
name and power limit. Uses only entry points both checkouts have.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_RUN = r"""
import json, os, sys, tempfile, time
import torch
sys.path.insert(0, os.getcwd())
from chip_smoke import F2S3_CFG
from fusion4landslide_tpu_torch.models.convert import seeded_filter, seeded_models
from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.parallel.pipeline import run_f2s3_tiles, run_fusion3d_tiles
from fusion4landslide_tpu_torch.pipelines.f2s3 import run_f2s3_tile
from fusion4landslide_tpu_torch.synth import synth_split_tile

cuda_build.build_all()
dev = torch.device("cuda")
src, tgt, _, _ = synth_split_tile(250_000, 10.0, 10.0, halo=20.0, density=100.0)
dips, agg = seeded_models(0, dev)
filt = seeded_filter(0, dev)
fusion_cfg = {
    "dataset": "brienz_tls", "voxel_size_init": 0.1, "level_of_superpoint": [1, 2, 3],
    "num_min_matches_for_small_patch": 10, "remove_low_quality_patch_matches": True,
    "num_min_matches_for_quality_check": 10, "thres_dist_diff": 0.5,
    "thres_inlier_ratio": 0.15, "coarse_refinement_3d_type": "nn_mutual",
    "num_min_fine_match": 10, "icp_refine": True, "output_tgt2src": False,
    "assign_type": "assign_then_nn", "icp_threshold": 0.1, "max_magnitude": 5,
    "feat_patch_points": 256, "feat_chunk": 2048, "member_cap": 512,
    "agg_max_points": 512, "fine_max_matches": 256, "global_matching_gated": True,
}
out = {}
with tempfile.TemporaryDirectory(prefix="_smoke_", dir=os.getcwd()) as tmp:
    for name, fn in (
        ("fusion3d", lambda t: run_fusion3d_tiles(dict(fusion_cfg, output_dir=tmp, output_folder="a"), dips, agg, [(0, src, tgt)], device=dev, timings=t)),
        ("f2s3", lambda t: run_f2s3_tiles(dict(F2S3_CFG, output_dir=tmp, output_folder="b"), dips, filt, [(0, src, tgt)], device=dev, timings=t)),
        ("f2s3_host", lambda t: run_f2s3_tile(dict(F2S3_CFG, output_dir=tmp, output_folder="c"), dips, filt, src, tgt, device=dev)),
    ):
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(timings)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "stages": timings}
print("RESULT " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", help="root of the first checkout")
    ap.add_argument("b", help="root of the second checkout")
    ap.add_argument("--pairs", type=int, default=1, help="A B B A rounds")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"# card: {smi}", flush=True)
    for _ in range(args.pairs):
        for label, root in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
            proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                                  capture_output=True, text=True, check=False)
            line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
            if proc.returncode or not line:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            res = json.loads(line[0][len("RESULT "):])
            print(json.dumps({"run": label, "root": root, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
