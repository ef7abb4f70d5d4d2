"""Stress and fault check of kernel #15 between processes on one card.

    python -m scalable_e3_gnn_torch.parallel.ring_stress [--world 2]
        [--exchanges 200] [--shapes 2x3234x80:bfloat16,2x3234x80:float32,2x37x13:bfloat16]
        [--skip-at 5] [--timeout-s 2]

Starts ``--world`` processes on this host (gloo over localhost, every rank
on ``cuda:0``).  Per shape ``[P_local, H, F]:dtype``, the ranks make an
``IpcRing`` of the group of every rank (a ring holds one size), and each
rank runs ``--exchanges`` exchanges back to back with no host
synchronisation between them (seeded exports drawn on the card, then a
seeded random device spin of up to about 50 us before each publish, so the
ranks drift apart and the two staging buffers are reused under load),
keeping every pool; then it checks each pool bit for bit against the
all-gather of the same exports by the group's ``PartitionGroup``: the gloo
``all_gather`` that the program runs for a CPU tensor.  Read per shape: the publish and gather device ms of every
exchange (CUDA events; a gather's includes its wait for the peers and the
card's time slices to the other processes), the gather's device ms once
every flag is up (the same exchange gathered again after a barrier: the
copy alone), the host ms of the gloo all-gather of the same exports, and
the device ms of PyTorch's ``copy_`` of the exports into a buffer (what the
publish kernel does).

Then, unless ``--skip-at -1``, the fault, on a ring of the first shape:
with a wait bound of ``--timeout-s``, every rank runs ``--skip-at``
exchanges, and the last
rank skips the publish of the last one (through the ring's API: it begins
the exchange and gathers it without publishing); every rank must raise
``RuntimeError`` from ``raise_if_failed`` after the synchronisation, naming
the last rank, within the bound plus a margin, instead of hanging.

Each rank prints one ``RING_STRESS {json}`` line; the launcher (no
``--rank``) prints one JSON line with every rank's readings and ``fails``
(what failed), and exits 0 iff every check passed.  ``run_world`` is the same from Python.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import halo_ring as hr
from .halo import PartitionGroup
from .multihost import card_identities, check_one_card

__all__ = ["run_world", "main", "SHAPES", "RESULT_PREFIX"]

RESULT_PREFIX = "RING_STRESS "
# config 3's bf16 exports of two partitions a rank ([2, H, 80]), the same in
# fp32, and odd H and F (the 2-byte path)
SHAPES = "2x3234x80:bfloat16,2x3234x80:float32,2x37x13:bfloat16"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SPIN_CYCLES = 80_000  # the most a rank spins before a publish (about 50 us)
_REGATHER = 20  # gathers of an exchange whose flags are all up, for the copy's time
_GLOO_REPS = 10


def _parse_shapes(text: str):
    out = []
    for item in text.split(","):
        dims, dtype = item.split(":")
        out.append((tuple(int(x) for x in dims.split("x")), _DTYPES[dtype]))
    return out


def _median(xs):
    return statistics.median(xs) if xs else None


def _shape_run(ring: hr.IpcRing, group: PartitionGroup, rank: int, shape, dtype,
               exchanges: int, seed: int) -> dict:
    dev, pg, full = ring.device, group.process_group, (*shape, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + rank)
    spins = np.random.default_rng(seed * 1000 + rank).integers(0, _SPIN_CYCLES, exchanges)
    exports, pools = [], []
    ring.events = []
    torch.cuda.synchronize()
    dist.barrier(group=pg)
    t0 = time.perf_counter()
    for i in range(exchanges):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        torch.cuda._sleep(int(spins[i]))
        e = ring.begin()
        ring.publish(x, e)
        pools.append(ring.gather(e, full))
        exports.append(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ring.raise_if_failed()
    publish_ms = [a.elapsed_time(b) for k, a, b in ring.events if k == "publish"]
    gather_ms = [a.elapsed_time(b) for k, a, b in ring.events if k == "gather"]
    # the copy alone: the last exchange again, every flag already up (no rank
    # publishes into its buffer before the next exchange but one)
    dist.barrier(group=pg)
    ring.events = []
    for _ in range(_REGATHER):
        ring.gather(ring.epoch, full)
    torch.cuda.synchronize()
    copy_ms = [a.elapsed_time(b) for k, a, b in ring.events if k == "gather"]
    ring.events = None
    bad, err = [], 0.0
    for i, (x, pool) in enumerate(zip(exports, pools)):
        ref = group.all_gather(x)
        if not torch.equal(pool, ref):
            bad.append(i)
            err = max(err, float((pool.float() - ref.float()).abs().max()))
    buf = torch.empty_like(exports[-1])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(_REGATHER):
        buf.copy_(exports[-1])
    end.record()
    torch.cuda.synchronize()
    copy_torch_ms = start.elapsed_time(end) / _REGATHER
    gloo_ms = []
    for _ in range(_GLOO_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        group.all_gather(exports[-1])
        gloo_ms.append((time.perf_counter() - t1) * 1e3)
    nbytes = exports[-1].numel() * exports[-1].element_size()
    return dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""), exchanges=exchanges,
                epochs=[ring.epoch - exchanges + 1, ring.epoch], mismatched=bad,
                max_abs_err=err, torch_copy_ms=copy_torch_ms,
                bytes_per_rank=nbytes, wall_ms=wall_ms,
                publish_ms_median=_median(publish_ms), publish_ms_max=max(publish_ms),
                gather_ms_median=_median(gather_ms), gather_ms_max=max(gather_ms),
                gather_ms_p90=float(np.percentile(gather_ms, 90)),
                gather_copy_ms_median=_median(copy_ms), gather_copy_ms_min=min(copy_ms),
                gloo_all_gather_host_ms_median=_median(gloo_ms),
                gloo_all_gather_host_ms=gloo_ms)


def _fault_run(ring: hr.IpcRing, pg, rank: int, world: int, shape, dtype, skip_at: int) -> dict:
    """``skip_at`` exchanges; the last rank does not publish the last."""
    dev, timeout_s = ring.device, ring.timeout_s
    x = torch.randn(shape, device=dev).to(dtype)
    torch.cuda.synchronize()
    dist.barrier(group=pg)
    skipper = world - 1
    for i in range(skip_at):
        e = ring.begin()
        if not (rank == skipper and i == skip_at - 1):
            ring.publish(x, e)
        t0 = time.perf_counter()
        pool = ring.gather(e, (*shape, dtype))
    torch.cuda.synchronize()
    waited_s = time.perf_counter() - t0
    error, raised = ring.error(), None
    try:
        ring.raise_if_failed()
    except RuntimeError as err:
        raised = str(err)
    peer = (error & 0xFFFF) - 1 if error else None
    nan_slots = [q for q in range(world)
                 if bool(torch.isnan(pool[q * shape[0]:(q + 1) * shape[0]].float()).all())]
    return dict(skip_at=skip_at, skipper=skipper, timeout_s=timeout_s, waited_s=waited_s,
                error_word=error, error_exchange=error >> 16 if error else None,
                error_peer=peer, raised=raised, nan_slots=nan_slots,
                raised_within_bound=raised is not None and waited_s <= timeout_s + 10.0)


def _rank_main(args) -> int:
    world, rank = args.world, args.rank
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    pg = dist.group.WORLD
    check_one_card(card_identities(dev, pg))
    out = dict(rank=rank, world=world, shapes=[])
    shapes = _parse_shapes(args.shapes)
    for i, (shape, dtype) in enumerate(shapes):
        ring = hr.IpcRing(pg, world, rank, dev)
        group = PartitionGroup(world * shape[0], dev, pg)
        out["shapes"].append(_shape_run(ring, group, rank, shape, dtype, args.exchanges, i))
        ring.close()
    out["launches"] = {k.name: k.launches for k in hr.KERNELS}
    if args.skip_at > 0:
        shape, dtype = shapes[0]
        ring = hr.IpcRing(pg, world, rank, dev, timeout_s=args.timeout_s)
        out["fault"] = _fault_run(ring, pg, rank, world, shape, dtype, args.skip_at)
        ring.close()
    print(RESULT_PREFIX + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def _ok(res: Dict[int, dict], world: int, skip_at: int) -> List[str]:
    """What failed, empty when every check passed."""
    fails = []
    if sorted(res) != list(range(world)):
        return [f"ranks reported: {sorted(res)}"]
    for r, out in res.items():
        for s in out["shapes"]:
            if s["mismatched"]:
                fails.append(f"rank {r} {s['shape']} {s['dtype']}: pools differ from gloo's "
                             f"at exchanges {s['mismatched'][:8]}")
        if skip_at > 0:
            f = out["fault"]
            if not f["raised_within_bound"] or f["error_peer"] != world - 1:
                fails.append(f"rank {r}: the skipped publish gave {f}")
    return fails


def run_world(world: int = 2, exchanges: int = 200, shapes: str = SHAPES, skip_at: int = 5,
              timeout_s: float = 2.0, wall_timeout_s: float = 300.0) -> dict:
    """Start the ranks, wait for them (killing all past ``wall_timeout_s``),
    and return ``{"ranks": {rank: readings}, "fails": [...], "wall_s"}``."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    cmd = lambda r: [sys.executable, "-m", "scalable_e3_gnn_torch.parallel.ring_stress",
                     "--world", str(world), "--rank", str(r), "--port", str(port),
                     "--exchanges", str(exchanges), "--shapes", shapes,
                     "--skip-at", str(skip_at), "--timeout-s", str(timeout_s)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd(r), env=env, cwd=root, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(world)]
    res, logs = {}, []
    try:
        for r, p in enumerate(procs):
            left = max(1.0, wall_timeout_s - (time.perf_counter() - t0))
            out, err = p.communicate(timeout=left)
            logs.append(f"rank {r} exit {p.returncode}: {err[-2000:]}")
            for ln in out.splitlines():
                if ln.startswith(RESULT_PREFIX):
                    res[r] = json.loads(ln[len(RESULT_PREFIX):])
    except subprocess.TimeoutExpired:
        logs.append(f"killed after {wall_timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    fails = _ok(res, world, skip_at)
    if fails:
        fails += logs
    return dict(ranks=res, fails=fails, wall_s=time.perf_counter() - t0)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--exchanges", type=int, default=200)
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--skip-at", type=int, default=5)
    ap.add_argument("--timeout-s", type=float, default=2.0)
    ap.add_argument("--rank", type=int, default=None, help="set by the launcher")
    ap.add_argument("--port", type=int, default=None, help="set by the launcher")
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    if not torch.cuda.is_available():
        print("ring_stress: no CUDA device", file=sys.stderr)
        return 2
    got = run_world(args.world, args.exchanges, args.shapes, args.skip_at, args.timeout_s)
    print(json.dumps(got), flush=True)
    return 0 if not got["fails"] else 1


if __name__ == "__main__":
    sys.exit(main())
