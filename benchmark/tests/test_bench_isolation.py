"""What a run loads: never JAX, jaxlib, flax or the JAX package (top-level
module names compared whole), and a reference that imports nothing of the
program."""

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

_PROBE = r"""
import importlib, json, os, pkgutil, sys
sys.path[:0] = [{bench!r}, {root!r}]
for pkg in {packages!r}:
    importlib.import_module(pkg)
    for m in pkgutil.iter_modules([os.path.join({bench!r}, pkg)]):
        importlib.import_module(pkg + "." + m.name)
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(packages, modules):
    code = _PROBE.format(bench=BENCH, root=ROOT, packages=packages, modules=modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    names = _top_level(["pipelines", "metrics", "reference"],
                       ["run", "calibrate", "devtrace", "faults", "flops", "probes", "tiles",
                        "weights"])
    assert "fusion4landslide_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "fusion4landslide_tpu"}


def test_reference_imports_nothing_of_the_program():
    names = _top_level(["reference"], ["tiles", "flops", "weights"])
    assert not names & {"fusion4landslide_tpu_torch", "fusion4landslide_tpu", "jax", "flax"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "fusion_rgb.interior", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
