"""PyTorch port, the user entry points against the JAX package's: the CLI
(``python -m scalable_e3_gnn_torch``), the examples and
``run_qm9_protocol``.

- ``configs`` prints the JAX CLI's lines; ``info`` reports the port's
  version, torch, CUDA and the devices, with or without a GPU.
- ``train`` for every config with ``--device cpu`` prints one JSON line
  with the JAX CLI's keys (the runners' dicts are held against the JAX
  runners in ``test_torch_runners.py`` and ``test_torch_entry*.py``);
  ``train`` and ``qm9-eval`` without a GPU and without ``--device`` exit
  non-zero with the device message.
- The examples, run as modules in subprocesses at ``tests/test_examples.py``'s
  sizes with ``--device cpu``, print their "final loss" line.
- ``run_qm9_protocol`` from JAX's initial weights on ``tests/test_qm9.py``'s
  40-file download (two of them listed as uncharacterized): the same split
  sizes, exclusions and standardisation (bit for bit: the same parsed
  targets in float64), the loss curve within 1e-5 and the MAEs within 1e-4
  relative (fp32 gradients summed in another order, then Adam; the MAE is
  one forward further and scaled to meV).
- ``utils.profiling``: an annotated range lands in the written trace.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scalable_e3_gnn_tpu import cli as jcli
from scalable_e3_gnn_tpu.train import runners as jrunners
from scalable_e3_gnn_torch import __version__
from scalable_e3_gnn_torch import cli as tcli
from scalable_e3_gnn_torch.train import runners as trunners
from scalable_e3_gnn_torch.utils import config as tconfig
from scalable_e3_gnn_torch.utils.params import params_from_jax
from tests.test_qm9 import _write_xyz
from tests.test_torch_runners import _jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOUD_KEYS = ["config", "final_loss", "steps", "edges", "eval_mse"]
TINY = {
    "nbody": ["--steps", "3", "--graphs", "8"],
    "qm9": ["--steps", "3", "--molecules", "8", "--batch-size", "4"],
    "cloud100k": ["--steps", "2", "--points", "2000"],
    "cloud1m": ["--steps", "2", "--points", "2000"],
    "cloud10m": ["--steps", "2", "--points", "2000"],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX runners' persistent compile cache stays off (it would write
    outside the checkout)."""
    monkeypatch.setattr(jrunners, "_setup", lambda: None)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_configs_print_jax_lines(capsys):
    assert jcli.main(["configs"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["configs"]) == 0
    assert capsys.readouterr().out == want


def test_info_reports_torch(capsys, monkeypatch):
    assert tcli.main(["info"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["version"] == __version__
    assert rec["torch"] == torch.__version__ and rec["cuda"] == torch.version.cuda
    assert rec["device_count"] == len(rec["devices"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["info"]) == 0  # a report: no GPU is no error
    assert json.loads(capsys.readouterr().out)["device_count"] == 0


@pytest.mark.parametrize("config", sorted(TINY))
def test_train_prints_jax_keys(config, capsys, tmp_path, monkeypatch, no_jax_cache):
    args = ["train", "--config", config, *TINY[config]]
    assert tcli.main(args + ["--device", "cpu", "--log", str(tmp_path / "m.jsonl")]) == 0
    rec = _last_json(capsys.readouterr().out)
    if config in ("nbody", "qm9"):  # the COO configs: the JAX CLI itself, in seconds
        assert jcli.main(args) == 0
        assert list(rec) == list(_last_json(capsys.readouterr().out))
    else:
        assert list(rec) == CLOUD_KEYS and rec["edges"] > 0
    assert rec["config"] == config and rec["steps"] == int(TINY[config][1])
    assert np.isfinite(rec["final_loss"])
    assert (tmp_path / "m.jsonl").exists()


@pytest.mark.parametrize("cmd", [["train", "--config", "cloud100k", "--steps", "1"],
                                 ["qm9-eval", "--data-dir", "."]])
def test_entry_needs_a_device(cmd, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(cmd) != 0
    assert "device='cpu'" in capsys.readouterr().err


def _run(args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def test_module_entry_runs():
    r = _run(["scalable_e3_gnn_torch", "configs"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert [ln.split(":")[0] for ln in r.stdout.splitlines()] == list(tcli._CONFIGS)


def test_example_train_nbody(tmp_path):
    r = _run(["scalable_e3_gnn_torch.examples.train_nbody", "--steps", "12", "--graphs", "8",
              "--ckpt-dir", str(tmp_path), "--log", str(tmp_path / "m.jsonl"),
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final loss" in r.stdout
    assert (tmp_path / "m.jsonl").exists()


def test_example_train_pointcloud():
    r = _run(["scalable_e3_gnn_torch.examples.train_pointcloud", "--points", "2000", "--steps",
              "2", "--neighbors", "8", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final loss" in r.stdout


def test_run_qm9_protocol_matches_jax(tmp_path, monkeypatch, no_jax_cache):
    rng = np.random.default_rng(0)
    for i in range(1, 41):
        _write_xyz(tmp_path / f"dsgdb9nsd_{i:06d}.xyz", i, rng)
    (tmp_path / "uncharacterized.txt").write_text(
        "list of molecules that failed consistency\n\n"
        "  3   text text\n  7   text text\n\n3054 molecules\n")
    cfg = tconfig.qm9_config()
    params = _jax_init(cfg, "graph")  # jax.random.key(0): the protocol's seed 0
    make = trunners._model
    monkeypatch.setattr(trunners, "_model", lambda c, d, task="node", seed=None:
                        params_from_jax(make(c, d, task, seed), params))
    kw = dict(target="U0", steps=4, batch_size=8, seed=0)
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    want = jrunners.run_qm9_protocol(str(tmp_path), log=jlog, **kw)
    got = trunners.run_qm9_protocol(str(tmp_path), log=tlog, device="cpu", **kw)
    assert list(got) == list(want)
    for key in ("target", "unit", "n_train", "n_val", "n_test", "n_excluded", "steps",
                "standardize_mean", "standardize_std"):
        assert got[key] == want[key], key
    assert got["unit"] == "meV" and got["n_excluded"] == 3
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-5)
    for key in ("val_mae", "test_mae"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    recs = [[json.loads(ln) for ln in open(p)] for p in (jlog, tlog)]
    assert [set(r) for r in recs[1]] == [set(r) for r in recs[0]]
    np.testing.assert_allclose([r["loss"] for r in recs[1][:4]],
                               [r["loss"] for r in recs[0][:4]], rtol=1e-5)


def test_profiling_hooks(tmp_path):
    """``utils.profiling``: an annotated range inside ``trace_to`` lands in
    the trace written to the directory; ``StepTimer`` counts from its first
    tick."""
    from scalable_e3_gnn_torch.utils.profiling import StepTimer, annotate, trace_to

    timer = StepTimer()
    assert timer.tick() == 0.0
    with trace_to(str(tmp_path)):
        with annotate("graph_build"):
            torch.ones(8).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and "graph_build" in files[0].read_text()
    assert timer.tick(torch.ones(2)) > 0.0
