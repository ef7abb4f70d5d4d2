"""Failure detection and restart-the-world recovery for multi-process runs.

Counterpart of ``scalable_e3_gnn_tpu/parallel/failover.py``.  A process group
has no communicator shrink here either: the sound recovery from a lost
process is to restart every process from the last checkpoint, which the
per-rank checkpoints of ``train.checkpoint`` make exact.  Three small parts:

1. **Heartbeat**: each process writes an atomic per-process beat file
   (timestamp and step) into a shared directory.  A process stuck in a dead
   collective goes stale just like a crashed one, so liveness is observed
   from outside the collectives.
2. **stale_processes / read_heartbeats**: the detection predicate the
   supervisor (or an outside orchestrator) polls.
3. **Supervisor**: a launcher loop that starts one worker per process,
   watches exit codes and heartbeats, and on any failure kills the exact
   processes it spawned and relaunches them all; workers resume from the
   latest checkpoint through ``resume_or_init``.

Fault injection for tests: ``inject_failure(step)`` kills the calling
process hard (``os._exit(42)``) when ``E3GNN_DIE_AT_STEP`` and
``E3GNN_DIE_PROCESS`` select it (the process's rank from ``RANK``), only in
the first incarnation (``E3GNN_INCARNATION``), so the restarted run
survives.

This module imports nothing of the package at import time, so a worker can
load it alone.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "Heartbeat",
    "read_heartbeats",
    "stale_processes",
    "resume_or_init",
    "inject_failure",
    "Supervisor",
    "SupervisorReport",
]


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


class Heartbeat:
    """Atomic per-process beat file: ``<dir>/hb_<pid>.json``.

    Call ``beat(step)`` once per training step (cheap: one tiny file rename).
    Liveness is judged by wall-clock age of the last beat, so the staleness
    timeout must exceed the slowest legitimate step (first-compile steps
    included — pass a generous timeout or beat once before compiling).
    """

    def __init__(self, directory: str, process_id: int) -> None:
        self.directory = directory
        self.process_id = process_id
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"hb_{process_id}.json")

    def beat(self, step: int, now: Optional[float] = None) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "process_id": self.process_id,
                    "step": int(step),
                    "t": time.time() if now is None else now,
                },
                f,
            )
        os.replace(tmp, self.path)

    def done(self) -> None:
        """Clean-completion sentinel: ``<dir>/done_<pid>``.

        Exit codes are lossy evidence — if anything else in the launcher
        process reaps children (a library SIGCHLD handler, an ECHILD race),
        ``Popen.poll()`` silently reports 0 for a crashed worker (CPython
        returns 0 on ECHILD), and codes get mangled across SSH/container
        layers on real clusters.  A worker that writes ``done()`` as its
        last act gives the Supervisor positive evidence of clean completion
        (``require_done=True``)."""
        with open(os.path.join(self.directory,
                               f"done_{self.process_id}"), "w") as f:
            f.write("ok")


def read_heartbeats(directory: str) -> Dict[int, dict]:
    """{process_id: last beat dict} for every beat file present."""
    beats: Dict[int, dict] = {}
    if not os.path.isdir(directory):
        return beats
    for name in os.listdir(directory):
        if not (name.startswith("hb_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                b = json.load(f)
            beats[int(b["process_id"])] = b
        except (ValueError, KeyError, OSError, json.JSONDecodeError):
            # torn read of a beat mid-replace: treat as absent this poll
            continue
    return beats


def stale_processes(
    directory: str,
    num_processes: int,
    timeout_s: float,
    now: Optional[float] = None,
    require_started: bool = False,
) -> List[int]:
    """Process ids whose last beat is older than ``timeout_s`` (or missing).

    ``require_started=False`` (default) does NOT flag processes that have
    never beaten: start-up (process-group set-up, the kernels' first load)
    is not a failure.  Set it once all processes have been observed alive.
    """
    t = time.time() if now is None else now
    beats = read_heartbeats(directory)
    out = []
    for pid in range(num_processes):
        b = beats.get(pid)
        if b is None:
            if require_started:
                out.append(pid)
            continue
        if t - float(b["t"]) > timeout_s:
            out.append(pid)
    return out


# ---------------------------------------------------------------------------
# resume + fault injection (worker side)
# ---------------------------------------------------------------------------


def resume_or_init(ckpt_dir: str, init_state, init_step: int = 0):
    """(state, start_step): the latest checkpoint restored into
    ``init_state`` (a ``TrainState``, in place) if one exists, else
    ``init_state`` and ``init_step``.

    The worker-side half of recovery: every incarnation starts here, so a
    restarted world continues exactly where the last checkpoint left off.
    An incomplete or foreign checkpoint raises (``restore_checkpoint``).
    """
    from ..train.checkpoint import restore_checkpoint

    try:
        state, step = restore_checkpoint(ckpt_dir, init_state)
        return state, step
    except FileNotFoundError:
        return init_state, init_step


def inject_failure(step: int) -> None:
    """Test-only fault injection: die hard at a configured step.

    Active when ``E3GNN_DIE_AT_STEP`` is set, this process's rank
    (``RANK``, else ``E3GNN_PID``) equals ``E3GNN_DIE_PROCESS``, and
    ``E3GNN_INCARNATION`` (set by the launcher) is 0, so the fault fires
    exactly once and the restarted world survives.  ``os._exit`` (no atexit,
    no process-group shutdown) models a host dropping dead between
    collectives.
    """
    die_at = os.environ.get("E3GNN_DIE_AT_STEP")
    if die_at is None or int(die_at) != step:
        return
    me = int(os.environ.get("RANK", os.environ.get("E3GNN_PID", "0")))
    victim = int(os.environ.get("E3GNN_DIE_PROCESS", "0"))
    incarnation = int(os.environ.get("E3GNN_INCARNATION", "0"))
    if me == victim and incarnation == 0:
        os._exit(42)


# ---------------------------------------------------------------------------
# supervisor (launcher side)
# ---------------------------------------------------------------------------


@dataclass
class SupervisorReport:
    ok: bool
    restarts: int
    reason: str = ""
    events: List[str] = field(default_factory=list)
    failed_at: List[float] = field(default_factory=list)  # time.time() of each detection


class Supervisor:
    """Restart-the-world launcher with heartbeat + exit-code failure detection.

    ``launch(process_id, incarnation) -> subprocess.Popen`` starts one worker
    (the caller builds the command and environment, and passes the
    incarnation on as ``E3GNN_INCARNATION`` so workers and fault injection
    can tell restarts apart).  Success = every worker of one incarnation exits 0.  Failure =
    any worker exits nonzero, or any heartbeat goes stale once seen — then
    every still-running worker of that incarnation is killed *by exact PID*
    and the world relaunches, up to ``max_restarts`` times.
    """

    def __init__(
        self,
        launch: Callable[[int, int], subprocess.Popen],
        num_processes: int,
        heartbeat_dir: str,
        heartbeat_timeout_s: float = 60.0,
        max_restarts: int = 2,
        poll_s: float = 0.2,
        wall_timeout_s: float = 600.0,
        require_done: bool = False,
        startup_timeout_s: Optional[float] = None,
    ) -> None:
        self.launch = launch
        self.num_processes = num_processes
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.wall_timeout_s = wall_timeout_s
        # require_done: workers call Heartbeat.done() as their last act; a
        # zero exit WITHOUT the sentinel counts as failure.  Exit codes are
        # lossy (ECHILD -> Popen.poll()==0 if anything else in this process
        # reaps children; mangled codes across container/SSH layers).
        self.require_done = require_done
        # startup_timeout_s: a worker that hangs BEFORE its first beat (stuck
        # process-group set-up, wedged import under load) is invisible to the
        # staleness check, whose default never flags never-beaten processes,
        # and would burn the whole wall budget.  With a startup window set, once
        # ``startup_timeout_s`` has elapsed since the incarnation launched,
        # still-running processes that have NEVER beaten are treated as
        # stale.  None (default) keeps the lenient behavior.
        self.startup_timeout_s = startup_timeout_s

    def _start_world(self, incarnation: int) -> List[subprocess.Popen]:
        # clear stale beats/sentinels from the previous incarnation so a
        # dead process's old beat can't look fresh
        for pid in range(self.num_processes):
            for name in (f"hb_{pid}.json", f"done_{pid}"):
                p = os.path.join(self.heartbeat_dir, name)
                if os.path.exists(p):
                    os.remove(p)
        return [self.launch(pid, incarnation) for pid in range(self.num_processes)]

    @staticmethod
    def _kill_world(procs: Sequence[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def run(self) -> SupervisorReport:
        deadline = time.time() + self.wall_timeout_s
        events: List[str] = []
        failed_at: List[float] = []
        for incarnation in range(self.max_restarts + 1):
            procs = self._start_world(incarnation)
            world_t0 = time.time()
            events.append(f"incarnation {incarnation}: started "
                          f"{self.num_processes} processes")
            failed = None
            while True:
                if time.time() > deadline:
                    self._kill_world(procs)
                    return SupervisorReport(
                        False, incarnation, "wall timeout", events, failed_at)
                codes = [p.poll() for p in procs]
                if any(c is not None and c != 0 for c in codes):
                    failed = "exit codes " + str(codes)
                    break
                if all(c == 0 for c in codes):
                    missing = [
                        pid for pid in range(self.num_processes)
                        if not os.path.exists(os.path.join(
                            self.heartbeat_dir, f"done_{pid}"))
                    ] if self.require_done else []
                    if missing:
                        failed = (f"exit 0 without done sentinel {missing} "
                                  "(crash with reaped/lost exit code)")
                        break
                    events.append(f"incarnation {incarnation}: clean exit")
                    return SupervisorReport(True, incarnation, "", events, failed_at)
                # heartbeat staleness: only meaningful for processes that
                # have beaten at least once (startup/compile is not failure)
                # AND are still running — a worker that already exited 0
                # stops beating legitimately while stragglers finish
                # (a spurious restart of the world otherwise)
                running = {i for i, p in enumerate(procs)
                           if p.poll() is None}
                req_started = (
                    self.startup_timeout_s is not None
                    and time.time() - world_t0 > self.startup_timeout_s
                )
                stale = [i for i in stale_processes(
                    self.heartbeat_dir, self.num_processes,
                    self.heartbeat_timeout_s,
                    require_started=req_started) if i in running]
                if stale:
                    failed = f"stale heartbeats {stale}"
                    break
                time.sleep(self.poll_s)
            failed_at.append(time.time())
            events.append(f"incarnation {incarnation}: FAILURE ({failed}); "
                          "killing world")
            self._kill_world(procs)
        return SupervisorReport(
            False, self.max_restarts + 1, "max restarts exceeded", events, failed_at)
