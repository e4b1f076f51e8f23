#!/usr/bin/env python3
"""The readings that the limits of a cell are set from (``limits/``).

    python3 benchmark/calibrate.py --workload <name> --seeds <a> <b> ... --control <n> \
        [--faults <n>]

In one process, on one GPU: a warm tile, then for every seed one tile of
the cell's traffic through the program, judged as a run judges its
window tiles (the lower readings); for the first ``--control`` seeds the
same tile judged with the reference in TF32 in the program's place (the
control's readings, which set the upper ends); and for the first
``--faults`` seeds the tile again with each of the cell's faults
(``faults.py``) planted beneath the probes. Prints one JSON line per
reading.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import run


def _tile(spec, seed, device, workdir, warm: bool, faults=()):
    """(pipeline, tile, its record, seconds) of tile 1 of ``seed``."""
    import torch

    from fusion4landslide_tpu_torch.ops import knn_cuda

    pipe, tiles, probes = run.build(spec, seed, device, workdir, n_tiles=1, faults=faults)
    try:
        if warm:
            pipe.run_tile(tiles[0], 0, None)
        knn_cuda.RESCORED[0] = None
        t0 = time.perf_counter()
        rec = pipe.run_tile(tiles[1], 1, None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tile_s = time.perf_counter() - t0
        if knn_cuda.RESCORED[0] is not None:  # kernel 3's rescored candidates
            rec["knn_rescored"] = int(knn_cuda.RESCORED[0])
    finally:
        probes.remove()
        shutil.rmtree(os.path.join(workdir, "run", "results"), ignore_errors=True)
    return pipe, tiles[1], rec, tile_s


def readings(spec: dict, seeds, n_control: int, device, workdir: str, faults=None,
             n_faults: int = 0):
    """Yield (seed, kind, numbers) for each seed: kind 'program'; for the
    first ``n_control`` seeds 'control'; for the first ``n_faults``
    seeds 'fault:<name>' for each of ``faults`` ({name: fault})."""
    for i, seed in enumerate(seeds):
        pipe, tile, rec, tile_s = _tile(spec, seed, device, workdir, warm=i == 0)
        t0 = time.perf_counter()
        numbers = pipe.judge(tile, rec)
        extra = {"knn_rescored": rec["knn_rescored"]} if "knn_rescored" in rec else {}
        yield seed, "program", dict(numbers, tile_s=tile_s, judge_s=time.perf_counter() - t0,
                                    **extra)
        if i < n_control:
            yield seed, "control", pipe.judge(tile, rec, control=True)
        for name, fault in (faults or {}).items() if i < n_faults else ():
            pipe, tile, rec, _ = _tile(spec, seed, device, workdir, False, [fault])
            yield seed, f"fault:{name}", pipe.judge(tile, rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = run.load_cell(args.workload)
    workdir = tempfile.mkdtemp(prefix="f4l_calib_", dir=os.environ.get("TMPDIR"))
    try:
        from faults import FAULTS

        for seed, kind, numbers in readings(spec, args.seeds, args.control,
                                            torch.device("cuda", 0), workdir,
                                            FAULTS.get(args.workload), args.faults):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
