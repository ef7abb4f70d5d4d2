"""The PyTorch port imports neither JAX nor the JAX package, nor does the
worker it spawns for the multi-process path, and its GPU check script
``chip_smoke.py`` refuses to run without a GPU or without the package beside
it."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 52  # every subpackage and module was imported
    for name in ("train", "train.pipeline", "kernels.fused_message", "utils.params",
                 "data", "data.nbody", "data.qm9", "graph.batching", "core.rotations",
                 "train.checkpoint", "train.metrics", "train.runners", "utils.config",
                 "cli", "__main__", "utils.profiling", "examples.train_nbody",
                 "examples.train_pointcloud", "parallel.multihost", "parallel.failover",
                 "parallel.dense_worker", "data.native_loader"):
        assert f"scalable_e3_gnn_torch.{name}" in names


_WORKER_RUN = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["scalable_e3_gnn_tpu"] = None
sys.argv = ["dense_worker", sys.argv[1], sys.argv[2], "--device", "cpu"]
try:
    runpy.run_module("scalable_e3_gnn_torch.parallel.dense_worker", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert not any(m == "jax" or m.startswith(("jax.", "scalable_e3_gnn_tpu"))
               for m, mod in sys.modules.items() if mod is not None)
print("NO_JAX")
"""


def test_spawned_worker_runs_without_jax(tmp_path):
    """The worker of the multi-process path, run as it is spawned (as
    ``__main__``), here one process over two partitions for one step."""
    from scalable_e3_gnn_torch import DenseEdgeGraph, SEGNN, radius_graph_brute
    from scalable_e3_gnn_torch.parallel.dense_worker import write_inputs

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((48, 3)).astype(np.float32))
    g = DenseEdgeGraph.from_radius_edges(torch.ones(48, 5), pts,
                                         radius_graph_brute(pts, 1.0, 6, device="cpu"))
    kw = dict(input_irreps="2x0e+1x1o", hidden_irreps="4x0e+2x1o", output_irreps="1x1o",
              num_layers=1)
    write_inputs(tmp_path / "in", g.positions, g.nodes, g.senders, g.edge_mask,
                 torch.zeros(48, 3), kw, SEGNN(**kw, device="cpu").state_dict(), num_parts=2,
                 steps=1, lr=0.1, compute_dtype="float32")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    out = subprocess.run([sys.executable, "-c", _WORKER_RUN, str(tmp_path / "in"),
                          str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**env, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "DENSE_WORKER " in out.stdout and "NO_JAX" in out.stdout


def test_spawned_worker_runs_ring_without_jax(tmp_path):
    """The worker with ``"backend": "ring"`` in ``run.json``, run as it is
    spawned, with JAX blocked: the forward and a step through the ring's
    plain version, and the backend in its readings."""
    from scalable_e3_gnn_torch import DenseEdgeGraph, SEGNN, radius_graph_brute
    from scalable_e3_gnn_torch.parallel.dense_worker import write_inputs

    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.standard_normal((48, 3)).astype(np.float32))
    g = DenseEdgeGraph.from_radius_edges(torch.ones(48, 5), pts,
                                         radius_graph_brute(pts, 1.0, 6, device="cpu"))
    kw = dict(input_irreps="2x0e+1x1o", hidden_irreps="4x0e+2x1o", output_irreps="1x1o",
              num_layers=1)
    write_inputs(tmp_path / "in", g.positions, g.nodes, g.senders, g.edge_mask,
                 torch.zeros(48, 3), kw, SEGNN(**kw, device="cpu").state_dict(), num_parts=2,
                 steps=1, lr=0.1, compute_dtype="float32", backend="ring")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    out = subprocess.run([sys.executable, "-c", _WORKER_RUN, str(tmp_path / "in"),
                          str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**env, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX" in out.stdout
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("DENSE_WORKER "))
    res = json.loads(line[len("DENSE_WORKER "):])
    assert res["backend"] == "ring" and len(res["losses"]) == 1
    assert res["ring_ms_per_step"] == []  # no ring kernel on the CPU


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


def test_spawned_worker_runs_coo_clouds_without_jax(tmp_path):
    """The worker on the COO layout with two clouds and the serialized
    exchange, run as it is spawned, with JAX blocked."""
    from scalable_e3_gnn_torch import SEGNN, radius_graph_brute
    from scalable_e3_gnn_torch.parallel.dense_worker import write_inputs

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((2, 48, 3)).astype(np.float32))
    edges = [radius_graph_brute(p, 1.0, 6, device="cpu") for p in pts]
    stack = lambda f: torch.stack([getattr(e, f) for e in edges])
    kw = dict(input_irreps="2x0e+1x1o", hidden_irreps="4x0e+2x1o", output_irreps="1x1o",
              num_layers=1)
    write_inputs(tmp_path / "in", pts, torch.ones(2, 48, 5), stack("senders"),
                 stack("mask"), torch.zeros(2, 48, 3), kw,
                 SEGNN(**kw, device="cpu").state_dict(), receivers=stack("receivers"),
                 num_parts=2, steps=1, lr=0.1, compute_dtype="float32", layout="coo",
                 num_clouds=2, serialize_exchange=True)
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    out = subprocess.run([sys.executable, "-c", _WORKER_RUN, str(tmp_path / "in"),
                          str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**env, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX" in out.stdout
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("DENSE_WORKER "))
    res = json.loads(line[len("DENSE_WORKER "):])
    assert (res["layout"], res["serialize_exchange"], res["clouds"]) == ("coo", True, [0, 2])
    assert np.load(tmp_path / "out" / "rank0.npz")["forward"].shape[:2] == (2, 2)
