"""The PyTorch port imports neither JAX nor the JAX package."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["scalable_e3_gnn_tpu"] = None
import scalable_e3_gnn_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "scalable_e3_gnn_tpu"))
               for m, mod in sys.modules.items() if mod is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every subpackage and module was imported


def test_port_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|scalable_e3_gnn_tpu)\b", re.M)
    files = list((REPO / "scalable_e3_gnn_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(f) for f in files if f.exists() and pat.search(f.read_text())]
    assert hits == []
