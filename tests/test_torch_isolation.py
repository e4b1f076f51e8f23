"""The port and ``chip_smoke.py`` import neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
import fusion4landslide_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None
    and (m == "fusion4landslide_tpu" or m.startswith(("fusion4landslide_tpu.", "jax", "flax")))
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
                mod = s.split()[1]
                assert not (mod == "fusion4landslide_tpu" or mod.startswith("fusion4landslide_tpu.")), (f, s)
