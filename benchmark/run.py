#!/usr/bin/env python3
"""The benchmark of fusion4landslide_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: its configuration
(``benchmark/configs/<config>.json``, which names the pipeline,
``benchmark/pipelines/<method>.py``) under its traffic
(``benchmark/traffic/<traffic>.json``). Set-up makes the tiles, the
weights and one warm tile from the seed; the window then runs whole tiles
back to back and starts no tile that, by the longest tile of the window
so far, would end after ``--seconds`` (at least one tile always runs).
Once the window has closed, the judge compares what the window's tiles
produced with the plain reference (``benchmark/reference``) against the
cell's limits (``benchmark/limits/<workload>.json``). The last line of standard output
is one JSON object: the end-to-end metrics, or with ``--trace 1`` the
per-layer metrics (each read by ``benchmark/metrics/<name>.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "fusion4landslide_tpu")
#: Keys of a configuration file that describe it rather than run it.
META_KEYS = ("source", "method", "reduced", "assumed")


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """Everything a cell is made of, found by name from BENCHMARK.json."""
    spec = read_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = read_json(ROOT, conf["file"])
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload])
             and any(e["name"] == m["moves"] for e in e2e)]
    return {"cell": cell, "config": config, "end_to_end": e2e, "per_layer": layer,
            "traffic": read_json(HERE, "traffic", cell["traffic"] + ".json"),
            "limits": read_json(HERE, "limits", workload + ".json")}


def run_config(config: dict, workdir: str) -> dict:
    cfg = {k: v for k, v in config.items() if k not in META_KEYS}
    cfg.update(output_dir=workdir, output_folder="run")
    return cfg


def tile_shape(cfg: dict, traffic: dict) -> dict:
    """A tile as the drivers cut it: a core of ``max_pts_per_tile``
    points, the source cropped to the core + the largest displacement,
    the target to the core + twice it (``halo_split_spec``)."""
    mm = float(cfg.get("max_magnitude", cfg.get("max_disp_magnitude")))
    return dict(traffic, n_core=int(cfg["max_pts_per_tile"]), src_margin=mm, tgt_margin=2 * mm)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, tiles, window_s, trace, peaks):
        self.tiles, self.window_s, self.trace, self.peaks = tiles, window_s, trace, peaks

    def stage_s(self, *names: str) -> float | None:
        """Mean seconds per tile of the named stages (a name ending in
        ``*`` takes every stage it starts); None where no tile has one."""
        def hit(stage):
            return any(stage == n or (n.endswith("*") and stage.startswith(n[:-1]))
                       for n in names)
        vals = [[v for k, v in t["timings"].items() if hit(k)] for t in self.tiles]
        if not any(vals):
            return None
        return sum(map(sum, vals)) / len(vals)

    def count(self, key: str) -> float:
        return sum(t["counters"].get(key, 0) for t in self.tiles)


def build(spec: dict, seed: int, device, workdir: str, n_tiles: int | None = None,
          faults=()):
    """The cell's pipeline with its weights, its tiles (index 0 is the warm
    tile) and its probes, all from ``seed``. ``faults``: (module attribute,
    function of the call's result) pairs that the tests plant beneath the
    probes, so the judge sees what a broken program would produce."""
    import tiles as tilegen
    from probes import Probes

    config, traffic = spec["config"], spec["traffic"]
    cfg = run_config(config, workdir)
    shape = tile_shape(cfg, traffic)
    pipe_mod = importlib.import_module(f"pipelines.{config['method']}")
    pipe = pipe_mod.Pipeline(cfg, seed, device, int(traffic["judge_rows"]))
    n_tiles = int(traffic["tiles"]) if n_tiles is None else n_tiles
    tiles = {i: tilegen.make_tile(seed, i, shape, cfg.get("image_size"))
             for i in range(n_tiles + 1)}
    probes = Probes()
    for name, alter in faults:
        probes.wrap(pipe_mod.Pipeline.module, name, name, None, alter=alter)
    captures = dict(pipe.captures())
    spans = dict(pipe_mod.SPANS)
    for name in list(spans) + [n for n in captures if n not in spans]:
        probes.wrap(pipe_mod.Pipeline.module, name, spans.get(name, name), captures.get(name))
    return pipe, tiles, probes


def verdict(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}): every number at or under its
    limit; a number the run did not produce reads inf."""
    out = {k: {"value": checks.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in out.values()), out


def measure(args, spec: dict, device, workdir: str, faults=()) -> dict:
    import torch

    pipe, tiles, probes = build(spec, args.seed, device, workdir, faults=faults)
    n_tiles = len(tiles) - 1
    results_dir = os.path.join(workdir, "run", "results")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one_tile(index: int, timings):
        rec = pipe.run_tile(tiles[index], index, timings)
        sync()
        shutil.rmtree(results_dir, ignore_errors=True)
        return rec

    t0 = time.perf_counter()
    one_tile(0, None)  # builds the kernels on a checkout's first run
    t_warm = time.perf_counter() - t0

    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        probes.tracing = True
        span = record_function("bench.window")
        span.__enter__()
    setup_s = time.perf_counter() - T_START
    w0 = time.perf_counter()
    done, longest = [], 0.0
    while not done or time.perf_counter() - w0 + longest <= args.seconds:
        index = 1 + len(done) % n_tiles
        timings = {} if args.trace else None
        t1 = time.perf_counter()
        done.append((index, one_tile(index, timings), timings))
        longest = max(longest, time.perf_counter() - t1)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace = None
    if prof is not None:
        span.__exit__(None, None, None)
        probes.tracing = False
        prof.__exit__(None, None, None)
        import devtrace
        trace = devtrace.reduce(prof)
        prof = None
    probes.remove()

    checks = {}
    for index, rec, _ in done:
        for k, v in pipe.judge(tiles[index], rec).items():
            checks[k] = max(checks.get(k, -math.inf), v)
    per_tile = [{"timings": timings or {}, "counters": pipe.counters(tiles[index], rec)}
                for index, rec, timings in done]
    n_core = sum(t["counters"]["n_core"] for t in per_tile)
    return {"setup_s": setup_s, "window_s": window_s, "t_warm": t_warm, "peak": peak,
            "n_core": n_core, "tiles": per_tile, "trace": trace, "checks": checks,
            "leaked": forbidden_modules()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_cell(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="f4l_bench_", dir=os.environ.get("TMPDIR"))
    try:
        m = measure(args, spec, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if m["leaked"]:
        print(f"forbidden modules loaded: {m['leaked']}", file=sys.stderr)
        return 3

    correct, checks = verdict(m["checks"], spec["limits"])
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": int(m["peak"])}
    if args.trace:
        import flops
        run = Run(m["tiles"], m["window_s"], m["trace"], flops.PEAKS)
        metrics = {}
        for spec_m in spec["per_layer"]:
            reader = importlib.import_module(f"metrics.{spec_m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[spec_m["name"]] = {"value": value, "unit": spec_m["unit"]}
        device_info.update(busy_s=m["trace"]["busy_s"], window_s=m["trace"]["window_s"])
    else:
        values = {"core_pts_per_s": m["n_core"] / m["window_s"],
                  "peak_gib": m["peak"] / 2**30, "setup_s": m["setup_s"]}
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e in spec["end_to_end"]}
    result = {"correct": correct, "attempted": len(m["tiles"]), "failed": 0,
              "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = {"device_ops": m["trace"]["device_ops"],
                               "idle_gaps": m["trace"]["idle_gaps"]}
    result["checks"] = checks
    print(f"tiles {len(m['tiles'])}, window {m['window_s']:.3f} s, warm tile {m['t_warm']:.3f} s",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
