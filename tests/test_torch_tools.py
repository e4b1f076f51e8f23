"""The port's measuring modules against the repository's tools, and the
host tile's random patch figures:

- ``parity_check.join_disp`` equals ``tools/parity_check.py::_join_disp``
  on the same two DVF tables (every output exactly);
- ``matcher_eval`` rows hold to ``tools/matcher_eval.py``'s (the JAX
  matchers) on a 240 x 320 image pair in 120 x 160 crops, for ``zncc``
  and ``eloftr`` (``weights/eloftr_tiny.npz``): match counts within 2%,
  median EPE within 0.05 px, mean EPE within 0.1 px, precisions within
  0.01;
- the host fusion tile with ``visualize_patch`` and ``random_choice``
  draws its figures with the tile's ``rng_seed``: the names it writes at
  ``rng_seed=1`` are those JAX's selection (``patch_visualization_requests``
  at that seed) gives for each level's pair count.
- both modules run on the GPU by default and raise without one.
"""

import importlib.util
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch import matcher_eval, parity_check

ROOT = Path(__file__).resolve().parents[1]


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_join_equals_the_tool(tmp_path):
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 90, size=(3000, 3)).astype(np.float32).astype(np.float64)
    disp = np.where(src[:, :1] > 45, [0.05, -0.02, 0.01], 0.0)
    a = np.hstack([src, src + disp + rng.normal(scale=2e-3, size=src.shape)])
    b = np.hstack([src, src + disp + rng.normal(scale=2e-3, size=src.shape)])
    b[::7, 3:] += 0.3  # rows the paths disagree on
    keep_a, keep_b = rng.random(3000) < 0.8, rng.random(3000) < 0.7
    pa, pb = tmp_path / "a.txt", tmp_path / "b.txt"
    np.savetxt(pa, rng.permutation(a[keep_a]), fmt="%.6f")
    np.savetxt(pb, b[keep_b], fmt="%.6f")
    truth = parity_check.planted_truth(8100, 0.0)
    want = _tool("parity_check")._join_disp(str(pa), str(pb), truth_fn=truth)
    got = parity_check.join_disp(str(pa), str(pb), truth_fn=truth)
    assert got[:3] == want[:3] and got[2] == int((keep_a & keep_b).sum())
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4] and len(got[4]) == 4
    readings = parity_check.parity_readings(str(pa), str(pb), truth)
    assert readings["overlap_frac"] == got[2] / min(got[0], got[1])
    assert abs(readings["disagree_frac_gt_10mm"] - 1 / 7) < 0.02


SMALL = dict(image_size=(240, 320), crop=(120, 160), overlap=(60, 80), shift_px=8.0,
             extent=40.0)


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """The JAX tool's rows on the small scene (no warm repeat: only the
    accuracy is compared)."""
    tool = _tool("matcher_eval")
    argv = ["matcher_eval", "--image-size", "240", "320", "--crop", "120", "160", "--overlap",
            "60", "80", "--shift-px", "8", "--extent", "40", "--repeats", "0", "--matchers",
            "zncc", "eloftr"]
    out = tmp_path_factory.mktemp("tool") / "stdout.txt"
    old_argv, old_stdout = sys.argv, sys.stdout
    with open(out, "w") as f:
        sys.argv, sys.stdout = argv, f
        try:
            tool.main()
        finally:
            sys.argv, sys.stdout = old_argv, old_stdout
    summary = json.loads(out.read_text().strip().splitlines()[-1])
    return {row["matcher"]: row for row in summary["results"]}


@pytest.mark.parametrize("matcher", ["zncc", "eloftr"])
def test_matcher_eval_rows_hold_to_the_tool(jax_rows, matcher):
    summary = matcher_eval.evaluate((matcher,), repeats=0, device="cpu", **SMALL)
    assert summary["crop"] == [120, 160] and summary["image_size"] == [240, 320]
    (row,), want = summary["results"], jax_rows[matcher]
    assert not row["zncc_fallback"] and row["device"] == "cpu"
    assert row["n_crop_pairs"] == want["n_crop_pairs"] == 9
    assert set(want) <= set(row)
    assert abs(row["n_matches"] - want["n_matches"]) <= 0.02 * want["n_matches"]
    assert want["n_matches"] > 200
    assert abs(row["epe_median_px"] - want["epe_median_px"]) <= 0.05
    assert abs(row["epe_mean_px"] - want["epe_mean_px"]) <= 0.1
    for key in ("precision_3px", "precision_5px"):
        assert abs(row[key] - want[key]) <= 0.01, key


def test_modules_need_a_gpu_by_default():
    with pytest.raises(RuntimeError, match="CUDA"):
        parity_check.main(["--n-core", "100"])
    with pytest.raises(RuntimeError, match="CUDA"):
        matcher_eval.main(["--image-size", "64", "64"])


def test_host_tile_draws_its_patch_figures_with_rng_seed(tmp_path):
    """The host tile at patch 128 (kernel 1's path: its sampler seed does
    not depend on ``rng_seed``) with ``rng_seed=1``; each level's pair
    count is read from the tile's log."""
    from fusion4landslide_tpu.utils.visualization import patch_visualization_requests
    from fusion4landslide_tpu_torch.models.convert import seeded_models
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion3d_tile
    from fusion4landslide_tpu_torch.synth import synth_small_rgb_tile
    from test_torch_fusion_host import CFG

    class Pairs(logging.Handler):
        def __init__(self):
            super().__init__()
            self.pairs = {}

        def emit(self, record):
            if "matched pairs" in record.msg:
                _, level, _, n_pairs, _ = record.args
                self.pairs[level] = n_pairs

    logger = logging.getLogger("f3_witness")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    seen = Pairs()
    logger.addHandler(seen)
    dips, agg = seeded_models(0, "cpu")
    src, tgt = synth_small_rgb_tile()[:2]
    cfg = {**CFG, "visualize_patch": True, "random_choice": True,
           "num_of_visualize_samples": 2, "output_dir": str(tmp_path)}
    try:
        run_fusion3d_tile(cfg, dips, agg, src, tgt, tile_id=5, device="cpu", rng_seed=1,
                          logger=logger)
    finally:
        logger.removeHandler(seen)
    want = sorted(f"patch_match_tile_5_l{level}_{k}.png" for level, n in seen.pairs.items()
                  for k in patch_visualization_requests(cfg, n, seed=1))
    got = sorted(p.name for p in (tmp_path / "run" / "visualization").iterdir())
    assert got == want
    # The witness tells the seeds apart: seed 0 picks other pairs here.
    assert any(n > 2 for n in seen.pairs.values())
    assert want != sorted(f"patch_match_tile_5_l{level}_{k}.png" for level, n in
                          seen.pairs.items() for k in patch_visualization_requests(cfg, n, seed=0))
