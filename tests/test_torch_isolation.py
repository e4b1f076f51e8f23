"""The port and ``chip_smoke.py`` import neither JAX nor the JAX package:
every module of the port (the drivers ``main_fusion``, ``main_f2s3``,
``main_rgb_guided`` and ``main_piecewise_icp`` and the learned image
matchers, the superpoint partition, the registration solvers, classic
LoFTR, the E57 reader, the native tiler binding and the figure writers
among them, the matcher trainers, and the measuring modules ``parity_check``
and ``matcher_eval``), nor the repository's ``tools/`` and ``bench.py``.
Every module also imports without matplotlib (the card's
machine has none): the figure writers import it inside their functions."""

import subprocess
import sys
from pathlib import Path

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["matplotlib"] = None
sys.path.insert(0, {root!r})
import fusion4landslide_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("config", "main_fusion", "main_f2s3", "io.ply", "io.las", "io.images",
             "tiling.bsp", "pipelines.driver", "pipelines.run_summary", "image.cameras",
             "ops.merge", "utils.logging", "main_rgb_guided", "main_piecewise_icp",
             "image.matching", "ops.clustering", "pipelines.rgb_guided",
             "pipelines.rgb_guided_device", "pipelines.piecewise_icp", "image.eloftr",
             "image.roma", "image.crop", "image.flax_bridge", "ops.superpoint",
             "ops.partition_io", "ops.registration", "image.loftr", "image.loftr_classic",
             "io.e57", "tiling.native", "utils.visualization", "utils.metrics",
             "utils.timing", "utils.profiling", "image.eloftr_train", "image.roma_train",
             "parity_check", "matcher_eval"):
    assert "fusion4landslide_tpu_torch." + name in names, name
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None
    and (m in ("fusion4landslide_tpu", "bench", "synth_scene", "tools")
         or m.startswith(("fusion4landslide_tpu.", "jax", "flax", "matplotlib", "tools.")))
)
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


def test_port_sources_name_no_jax_import():
    pkg = ROOT / "fusion4landslide_tpu_torch"
    files = list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.startswith(("import jax", "from jax", "import flax", "from flax")), f
                if not line.startswith((" ", "\t")):
                    assert not s.startswith(("import matplotlib", "from matplotlib")), (f, s)
                mod = s.split()[1]
                assert not (mod == "fusion4landslide_tpu" or mod.startswith("fusion4landslide_tpu.")), (f, s)
                assert mod.split(".")[0] not in ("tools", "bench", "synth_scene"), (f, s)
