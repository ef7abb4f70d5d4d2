"""Tracing and profiling hooks.

Counterpart of ``scalable_e3_gnn_tpu/utils/profiling.py`` over
``torch.profiler``: named trace annotations around the phases of a run, a
step timer that waits for the device, and a trace of a block written to a
directory (Chrome trace format, one file per trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["annotate", "StepTimer", "trace_to"]


def annotate(name: str):
    """Trace annotation context: a named range in the profiler's timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block (host operators, and CUDA kernels when a GPU
    is present) and write it to ``logdir/trace_<pid>_<ns>.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step timing with device synchronization.

    Usage::
        timer = StepTimer()
        for batch in data:
            metrics = step(*batch)
            dt = timer.tick(metrics["loss"])   # waits for it, returns seconds
    """

    def __init__(self) -> None:
        self._last: Optional[float] = None

    def tick(self, sync_on: Optional[torch.Tensor] = None) -> float:
        """Seconds since the previous tick (0.0 on the first); with
        ``sync_on``, first wait for the device that tensor lives on."""
        if sync_on is not None and sync_on.device.type == "cuda":
            torch.cuda.synchronize(sync_on.device)
        now = time.time()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        return dt
