"""PyTorch port, ``parallel/failover.py``: the counterparts of JAX's
``tests/test_failover.py`` (heartbeats, staleness, the supervisor recovering
from a crash, a hang and a lost exit code, and giving up), one parity case
against JAX's ``read_heartbeats``/``stale_processes`` on the same beat
directory, and the kill-one-host test on the port's two-process dense train
step (``parallel/dense_worker.py``, gloo on the CPU): rank 1 dies by
``inject_failure`` after the checkpoint of step 3; the supervisor restarts
the world once, the ranks resume from their checkpoints, and the final
parameters equal an uninterrupted two-process run's bit for bit."""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from scalable_e3_gnn_tpu.parallel import failover as jfailover
from scalable_e3_gnn_torch import DenseEdgeGraph, SEGNN, radius_graph_brute
from scalable_e3_gnn_torch.parallel import dense_worker as dw
from scalable_e3_gnn_torch.parallel.failover import (Heartbeat, Supervisor, read_heartbeats,
                                                     stale_processes)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers on the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


def test_heartbeat_roundtrip(tmp_path):
    hb = Heartbeat(str(tmp_path), 3)
    hb.beat(17, now=1000.0)
    beats = read_heartbeats(str(tmp_path))
    assert beats[3]["step"] == 17
    assert beats[3]["t"] == 1000.0


def test_stale_detection(tmp_path):
    d = str(tmp_path)
    Heartbeat(d, 0).beat(5, now=1000.0)
    Heartbeat(d, 1).beat(5, now=1090.0)
    # process 2 never started
    assert stale_processes(d, 3, timeout_s=60.0, now=1100.0) == [0]
    assert stale_processes(d, 3, timeout_s=60.0, now=1100.0, require_started=True) == [0, 2]
    assert stale_processes(d, 3, timeout_s=200.0, now=1100.0) == []


def test_heartbeats_match_jax(tmp_path):
    """The same beat directory (beats of both packages, a torn file, a
    missing process) reads the same through JAX's functions and the port's."""
    d = str(tmp_path)
    Heartbeat(d, 0).beat(3, now=1000.0)
    jfailover.Heartbeat(d, 1).beat(4, now=1050.0)
    Heartbeat(d, 3).beat(1, now=1099.0)
    (tmp_path / "hb_2.json").write_text('{"process_id": 2, "st')  # torn mid-replace
    assert read_heartbeats(d) == jfailover.read_heartbeats(d)
    for timeout in (10.0, 55.0, 200.0):
        for started in (False, True):
            kw = dict(timeout_s=timeout, now=1100.0, require_started=started)
            assert stale_processes(d, 5, **kw) == jfailover.stale_processes(d, 5, **kw)


# ---------------------------------------------------------------------------
# the supervisor with cheap workers (no torch): crash, hang, lost exit code
# ---------------------------------------------------------------------------

_CHEAP_WORKER = textwrap.dedent(
    """
    import importlib.util, json, os, sys, time
    # load failover.py alone: the package would import torch
    _spec = importlib.util.spec_from_file_location(
        "e3_failover", os.path.join(
            os.environ["E3GNN_REPO"], "scalable_e3_gnn_torch", "parallel", "failover.py"))
    _failover = importlib.util.module_from_spec(_spec)
    sys.modules["e3_failover"] = _failover  # dataclass resolves its module
    _spec.loader.exec_module(_failover)
    Heartbeat = _failover.Heartbeat

    pid = int(os.environ["E3GNN_PID"])
    work = os.environ["E3GNN_WORK"]
    incarnation = int(os.environ["E3GNN_INCARNATION"])
    hb = Heartbeat(os.path.join(work, "hb"), pid)
    ckpt = os.path.join(work, "ckpt.json")
    v, start = (0, 0)
    if os.path.exists(ckpt):
        with open(ckpt) as f:
            v, start = json.load(f)

    # the trigger is start-aware: workers resume from the checkpoint pid 0
    # writes, so under load the victim may start past a step-exact trigger
    victim = int(os.environ.get("E3GNN_DIE_PROCESS", "0"))
    mode = ("hang" if os.environ.get("E3GNN_HANG") == "1" else
            "exit0" if "E3GNN_EXIT0_AT_STEP" in os.environ else
            "die" if "E3GNN_DIE_AT_STEP" in os.environ else None)
    trig = int(os.environ.get("E3GNN_DIE_AT_STEP")
               or os.environ.get("E3GNN_EXIT0_AT_STEP") or 4)
    armed = mode is not None and incarnation == 0 and pid == victim
    t_eff = min(max(trig, start), 9)

    def act():
        if mode == "hang":
            time.sleep(3600)
        os._exit(0 if mode == "exit0" else 42)

    for s in range(start, 10):
        hb.beat(s)
        v = v * 3 + 1  # a deterministic chain: an interruption must not change it
        if pid == 0:
            with open(ckpt + ".tmp", "w") as f:
                json.dump([v, s + 1], f)
            os.replace(ckpt + ".tmp", ckpt)
        if armed and s == t_eff:
            act()
        time.sleep(0.02)
    if armed and start >= 10:
        act()  # resumed past the whole loop: still fault once
    if pid == 0:
        with open(os.path.join(work, "final.json"), "w") as f:
            json.dump(v, f)
    hb.done()
    """
)


def _load_slack():
    """Budget multiplier from the measured load: a bare interpreter's start
    against about 50 ms on an idle machine."""
    t0 = time.time()
    subprocess.run([sys.executable, "-c", "pass"], check=True)
    return min(max(1.0, (time.time() - t0) / 0.05), 20.0)


def _run_cheap_world(tmp_path, extra_env, heartbeat_timeout_s=60.0):
    worker = tmp_path / "worker.py"
    worker.write_text(_CHEAP_WORKER)
    work = str(tmp_path)

    def launch(pid, incarnation):
        env = dict(os.environ)
        env.update(E3GNN_PID=str(pid), E3GNN_WORK=work, E3GNN_INCARNATION=str(incarnation),
                   E3GNN_REPO=str(REPO), **extra_env)
        return subprocess.Popen([sys.executable, str(worker)], env=env)

    slack = _load_slack()
    sup = Supervisor(launch, num_processes=2, heartbeat_dir=os.path.join(work, "hb"),
                     heartbeat_timeout_s=heartbeat_timeout_s * slack, max_restarts=2,
                     poll_s=0.05, wall_timeout_s=120.0 * slack, require_done=True,
                     startup_timeout_s=30.0 * slack)
    return sup.run(), work


def _uninterrupted_chain(steps=10):
    v = 0
    for _ in range(steps):
        v = v * 3 + 1
    return v


def test_supervisor_recovers_from_crash(tmp_path):
    report, work = _run_cheap_world(tmp_path, {"E3GNN_DIE_AT_STEP": "4",
                                               "E3GNN_DIE_PROCESS": "1"})
    assert report.ok, report
    assert report.restarts == 1, report
    assert len(report.failed_at) == 1
    with open(os.path.join(work, "final.json")) as f:
        assert json.load(f) == _uninterrupted_chain()


def test_supervisor_recovers_from_hang(tmp_path):
    report, work = _run_cheap_world(tmp_path, {"E3GNN_HANG": "1", "E3GNN_DIE_PROCESS": "1"},
                                    heartbeat_timeout_s=2.0)
    assert report.ok, report
    assert report.restarts == 1, report
    assert "stale heartbeats [1]" in report.events[1], report.events
    with open(os.path.join(work, "final.json")) as f:
        assert json.load(f) == _uninterrupted_chain()


def test_supervisor_catches_lost_exit_code(tmp_path):
    """require_done: a worker that exits 0 without the done sentinel (what a
    crash whose exit code was reaped looks like) restarts the world."""
    report, work = _run_cheap_world(tmp_path, {"E3GNN_EXIT0_AT_STEP": "4",
                                               "E3GNN_DIE_PROCESS": "1"})
    assert report.ok, report
    assert report.restarts == 1, report
    assert "done sentinel" in report.events[1], report.events
    with open(os.path.join(work, "final.json")) as f:
        assert json.load(f) == _uninterrupted_chain()


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    worker = tmp_path / "dieworker.py"
    worker.write_text("import os\nos._exit(9)\n")

    def launch(pid, incarnation):
        return subprocess.Popen([sys.executable, str(worker)])

    sup = Supervisor(launch, num_processes=1, heartbeat_dir=str(tmp_path / "hb"),
                     max_restarts=2, poll_s=0.05, wall_timeout_s=60.0)
    report = sup.run()
    assert not report.ok
    assert report.reason == "max restarts exceeded"
    assert len(report.failed_at) == 3


# ---------------------------------------------------------------------------
# kill one host: the two-process dense train step
# ---------------------------------------------------------------------------

STEPS, DIE_AT = 5, 2  # rank 1 dies after the checkpoint of step DIE_AT + 1


def _inputs(in_dir):
    """128 points, radius 0.8, K=8, 2x0e+1x1o -> 8x0e+4x1o -> 1x1o, 2 layers,
    seeded weights, the message kernels' dispatch (their plain versions on
    the CPU), P=4, Adam 1e-3 in fp32."""
    rng = np.random.default_rng(5)
    n = 128
    pts = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    g = DenseEdgeGraph.from_radius_edges(feats, pts, radius_graph_brute(pts, 0.8, 8,
                                                                         device="cpu"))
    kw = dict(input_irreps="2x0e+1x1o", hidden_irreps="8x0e+4x1o", output_irreps="1x1o",
              num_layers=2, layout="cm", use_pallas=True)
    model = SEGNN(**kw, device="cpu", generator=torch.Generator().manual_seed(5))
    dw.write_inputs(in_dir, g.positions, g.nodes, g.senders, g.edge_mask,
                    rng.standard_normal((n, 3)).astype(np.float32), kw, model.state_dict(),
                    num_parts=4, steps=STEPS, lr=1e-3, compute_dtype="float32")


def _params(out_dir, rank):
    with np.load(out_dir / f"rank{rank}.npz") as f:
        return {k: f[k] for k in f.files if k.startswith("param/")}


def test_kill_one_host_recovers_bit_for_bit(tmp_path):
    _inputs(tmp_path / "in")
    env = {"OMP_NUM_THREADS": "1"}
    clean, clean_res = dw.run_world(tmp_path / "in", tmp_path / "clean", 2, device="cpu",
                                    env=env, wall_timeout_s=240.0)
    assert clean.ok and clean.restarts == 0, clean
    report, res = dw.run_world(
        tmp_path / "in", tmp_path / "killed", 2, device="cpu", wall_timeout_s=240.0,
        env={**env, "E3GNN_DIE_AT_STEP": str(DIE_AT), "E3GNN_DIE_PROCESS": "1"})
    logs = "\n".join(p.read_text()[-2000:] for p in sorted((tmp_path / "killed").glob("log_*")))
    assert report.ok, (report, logs)
    assert report.restarts == 1, report
    assert "exit codes" in report.events[1] and "42" in report.events[1], report.events
    assert sorted(res) == [0, 1]
    assert [res[r]["start_step"] for r in (0, 1)] in ([DIE_AT + 1] * 2, [DIE_AT] * 2)
    assert res[0]["losses"] == clean_res[0]["losses"][-len(res[0]["losses"]):]
    assert res[0]["state_sha"] == res[1]["state_sha"] == clean_res[0]["state_sha"]
    want = _params(tmp_path / "clean", 0)
    for rank in (0, 1):
        got = _params(tmp_path / "killed", rank)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (rank, k)
