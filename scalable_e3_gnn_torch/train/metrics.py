"""Structured per-step metrics: JSON lines and stdout.

A copy of ``scalable_e3_gnn_tpu/train/metrics.py`` (plain Python): one JSON
object per ``log`` call with ``step``, ``time_s`` (host seconds since the
previous call), every scalar as a float and, given ``edges``,
``edges_per_s``.  ``float()`` of a tensor on the GPU waits for it, so each
``log`` call is a host sync, as reading a JAX array is.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(
        self,
        path: Optional[str] = None,
        stdout_every: int = 100,
        stream: Optional[IO] = None,
    ) -> None:
        self._file = open(path, "a") if path else None
        self._stdout_every = stdout_every
        self._stream = stream or sys.stdout
        self._t_last = time.time()

    def log(self, step: int, scalars: dict, edges: Optional[int] = None) -> None:
        now = time.time()
        dt = now - self._t_last
        self._t_last = now
        rec = {"step": step, "time_s": round(dt, 5)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if edges is not None and dt > 0:
            rec["edges_per_s"] = round(edges / dt, 1)
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stdout_every and step % self._stdout_every == 0:
            print(line, file=self._stream, flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
