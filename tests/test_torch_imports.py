"""The PyTorch port imports neither JAX nor the JAX package, and its GPU
check script ``chip_smoke.py`` refuses to run without a GPU or without the
package beside it."""

import os
import pathlib
import shutil
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
print(" ".join(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 26  # every subpackage and module was imported
    for name in ("train", "train.pipeline", "kernels.fused_message", "utils.params",
                 "data", "data.nbody", "data.qm9", "graph.batching", "core.rotations",
                 "train.checkpoint", "train.metrics", "train.runners", "utils.config",
                 "cli", "__main__", "utils.profiling", "examples.train_nbody",
                 "examples.train_pointcloud"):
        assert f"scalable_e3_gnn_torch.{name}" in names


def test_port_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|scalable_e3_gnn_tpu)\b", re.M)
    files = list((REPO / "scalable_e3_gnn_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(f) for f in files if f.exists() and pat.search(f.read_text())]
    assert hits == []


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device: the script exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
