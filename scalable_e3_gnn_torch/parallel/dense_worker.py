"""One rank of the multi-process partitioned train step, and its launcher.

By hand, one process a rank, with PyTorch's variables (``LOCAL_RANK`` picks
the card, ``RANK`` by default):

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \\
        python -m scalable_e3_gnn_torch.parallel.dense_worker IN_DIR OUT_DIR

or every rank at once under the restart-the-world ``Supervisor`` of
``parallel.failover`` by ``run_world``.  Without ``WORLD_SIZE`` one process
runs every cloud and partition.  ``IN_DIR`` holds what every rank reads,
written once by ``write_inputs``:

- ``graph.npz``: the whole graph as host arrays (``positions`` [N, 3],
  ``nodes`` [N, F], ``senders`` and ``edge_mask``: [N, K] in the dense
  layout, [E] in the COO one, which also has ``receivers`` [E], sorted) and
  its ``target`` [N, F_out]; with several clouds, each array has a leading
  cloud axis (COO edge lists padded to one length, the padding masked);
- ``weights.npz``: the model's initial state dict;
- ``run.json``: the ``SEGNN`` arguments (``model``), ``num_parts``,
  ``steps``, Adam's ``lr``, ``compute_dtype`` (``"float32"`` or
  ``"bfloat16"``: bf16 compute on fp32 master weights; the COO layout is
  fp32 only), and optionally ``layout`` (``"dense"``, the default, or
  ``"coo"``), ``num_clouds`` (1 by default), ``serialize_exchange``
  (false by default: the exchange overlaps the interior work) and
  ``backend`` (``"all_gather"``, the default, or ``"ring"``).

The exchange is the process group's all-gather (``backend="all_gather"``)
or kernel #15 between the processes of a graph group that share one card
(``backend="ring"``: ``kernels.halo_ring.IpcRing``; on the CPU its plain
version, the all-gather), and the optimizer is Adam.  With several
clouds the ranks are laid out dp-major over ``gcd(world, num_clouds)`` dp
rows (rank = row * G + g for G = world / rows graph ranks): each row owns a
contiguous range of the clouds and exchanges halos within its own process
group (``multihost.dp_graph_group``); the step gathers over every rank.

Each rank partitions every cloud (``partition_graph_dense`` or
``partition_graph``; the same arrays on every rank; with several clouds
under the caps ``shared_caps`` unifies), keeps its own clouds and
partitions, runs their forward once in the compute dtype, then the train
steps: a heartbeat before each step, its own checkpoint after each
(``OUT_DIR/ckpt``), then ``inject_failure``; a restarted rank resumes from
the latest complete checkpoint.  It writes ``OUT_DIR/rank<r>.npz`` (its
forward outputs as fp32, [P_local, Np, F_out], with a leading local-cloud
axis when there are several clouds; its final parameters) and prints one
line ``DENSE_WORKER {json}`` with its readings: the losses, step times
(CUDA events on the card), host seconds in collectives, kernel launches per
step (#15's publish and gather under ``"ring"``), the ring's publish and
gather device ms per step (CUDA events around each launch, the gather's
wait for the peers included), and digests of the partition and of the
final state.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import fused_message as fm
from ..kernels import fused_message_generic as fmg
from ..kernels import halo_ring as hr
from ..models.segnn import SEGNN
from ..train.checkpoint import save_checkpoint
from ..train.pipeline import TrainState, make_train_state
from .failover import Heartbeat, Supervisor, SupervisorReport, inject_failure, resume_or_init
from .halo import (CloudGroup, PartitionGroup, make_dist_forward, make_dist_forward_dense,
                   make_dist_geometry_dense, make_dist_train_step, make_dist_train_step_dense,
                   shard_partitioned, shard_partitioned_dense)
from .multihost import dp_graph_group, init_distributed, rank_device, world_size_and_rank
from .partition import partition_graph, partition_graph_dense, shared_caps

__all__ = ["Rank", "setup", "write_inputs", "partition_digest", "run_world", "main"]

RESULT_PREFIX = "DENSE_WORKER "
_KERNELS = fm.KERNELS + fmg.KERNELS + hr.KERNELS
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_LAYOUTS = {"dense": ("positions", "nodes", "senders", "edge_mask"),
            "coo": ("positions", "nodes", "senders", "receivers", "edge_mask")}


def write_inputs(in_dir, positions, nodes, senders, edge_mask, target, model_kwargs: dict,
                 state_dict: dict, receivers=None, **run) -> None:
    """Write ``IN_DIR``: the graph and its target (``receivers`` for the COO
    layout), the initial weights, and ``run.json`` (``model_kwargs`` as
    ``model``, then ``run``)."""
    in_dir = Path(in_dir)
    in_dir.mkdir(parents=True, exist_ok=True)
    host = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    extra = {} if receivers is None else {"receivers": host(receivers)}
    np.savez(in_dir / "graph.npz", positions=host(positions), nodes=host(nodes),
             senders=host(senders), edge_mask=host(edge_mask), target=host(target), **extra)
    np.savez(in_dir / "weights.npz", **{k: host(v) for k, v in state_dict.items()})
    (in_dir / "run.json").write_text(json.dumps({"model": model_kwargs, **run}))


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def partition_digest(*parts) -> str:
    """SHA-256 of every array of partitioned graphs (one per cloud, in
    order): equal on every rank that partitions the same graphs."""
    return _digest(a for part in parts for a in part if isinstance(a, np.ndarray))


def _state_digest(state) -> str:
    tensors = [p.detach() for p in state.model.parameters()]
    for entry in state.optimizer.state_dict()["state"].values():
        tensors += [v for v in entry.values() if torch.is_tensor(v)]
    return _digest(t.cpu().numpy() for t in tensors)


def _launches() -> Dict[str, int]:
    return {k.name: k.launches for k in _KERNELS}


@dataclasses.dataclass
class Rank:
    """What one rank holds: its groups (``dp`` with several clouds, else
    None), its clouds' partitions (``shards``, their geometry ``attrs`` and
    ``targets``, in the compute dtype; nested per local cloud when ``dp`` is
    set, as the train step takes them), the model and its train state, the
    train step ``step(shards, targets, attrs)``, and a digest of every
    cloud's partition."""

    run: dict
    group: PartitionGroup
    dp: Optional[CloudGroup]
    shards: list
    attrs: list
    targets: torch.Tensor
    model: SEGNN
    state: TrainState
    step: Callable
    dtype: torch.dtype
    partition_sha: str

    @property
    def layout(self) -> str:
        return self.run.get("layout", "dense")

    @property
    def serialize(self) -> bool:
        return bool(self.run.get("serialize_exchange", False))

    @property
    def backend(self) -> str:
        return self.run.get("backend", "all_gather")

    def clouds(self):
        """The local clouds' (shards, attrs) pairs."""
        if self.dp is None:
            return [(self.shards, self.attrs)]
        return list(zip(self.shards, self.attrs))

    def comm_seconds(self) -> float:
        return self.group.comm_seconds + (self.dp.comm_seconds if self.dp is not None else 0.0)


def _groups(run: dict, multi: bool, dev):
    """The partitions' group and, with several clouds, the clouds' group:
    ``gcd(world, num_clouds)`` dp rows, rank-major."""
    clouds = run.get("num_clouds", 1)
    world, _ = world_size_and_rank()
    graph_ranks = world // math.gcd(world, clouds)
    pg = None
    if multi and graph_ranks > 1:
        pg = dp_graph_group(graph_ranks)[0] if graph_ranks < world else dist.group.WORLD
    group = PartitionGroup(run["num_parts"], dev, pg)
    dp = CloudGroup(clouds, group, dist.group.WORLD if multi else None) if clouds > 1 else None
    return group, dp


def setup(in_dir, device=None) -> Rank:
    """Join the process group (``init_distributed``: one process without
    ``WORLD_SIZE``), partition every cloud of ``in_dir``, keep this rank's
    clouds and partitions on its device (``device``, else its card), and
    build the model from the weights, the optimizer and the train step."""
    in_dir = Path(in_dir)
    run = json.loads((in_dir / "run.json").read_text())
    layout = run.get("layout", "dense")
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(_LAYOUTS)}, not {layout!r}")
    dense = layout == "dense"
    if not dense and run["compute_dtype"] != "float32":
        raise ValueError("the COO layout trains in float32 only")
    multi = init_distributed()
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dtype = _DTYPES[run["compute_dtype"]]
    group, dp = _groups(run, multi, dev)
    num_clouds = run.get("num_clouds", 1)

    with np.load(in_dir / "graph.npz") as g:
        data = {k: g[k] for k in g.files}
    clouds = ([{k: v[c] for k, v in data.items()} for c in range(num_clouds)]
              if num_clouds > 1 else [data])
    partition = partition_graph_dense if dense else partition_graph
    arrays = lambda c: [c[k] for k in _LAYOUTS[layout]]
    parts = [partition(*arrays(c), num_parts=run["num_parts"]) for c in clouds]
    if num_clouds > 1:
        caps = shared_caps(parts)
        parts = [partition(*arrays(c), num_parts=run["num_parts"], **caps) for c in clouds]
    lo, hi = (dp.lo, dp.hi) if dp is not None else (0, 1)
    shard = shard_partitioned_dense if dense else shard_partitioned
    shards = [shard(part, group) for part in parts[lo:hi]]
    targets = torch.stack([
        torch.from_numpy(c["target"][np.clip(part.global_ids[group.lo:group.hi], 0, None)])
        for c, part in zip(clouds[lo:hi], parts[lo:hi])]).to(dev)

    model = SEGNN(**run["model"], device=dev)
    with np.load(in_dir / "weights.npz") as w:
        model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
    serialize = bool(run.get("serialize_exchange", False))
    backend = run.get("backend", "all_gather")
    opt = torch.optim.Adam(model.parameters(), lr=run["lr"])
    if dense:
        attrs = [make_dist_geometry_dense(model, group)(s) for s in shards]
        if dtype != torch.float32:
            shards = [[sh._replace(nodes=sh.nodes.to(dtype),
                                   positions_ext=sh.positions_ext.to(dtype)) for sh in s]
                      for s in shards]
            attrs = [[tuple(a.to(dtype) for a in at) for at in ats] for ats in attrs]
        step = make_dist_train_step_dense(
            model, opt, group, backend, compute_dtype=None if dtype == torch.float32 else dtype,
            dp=dp, _serialize_exchange=serialize)
    else:
        attrs = [None] * len(shards)
        coo_step = make_dist_train_step(model, opt, group, backend, dp=dp,
                                        _serialize_exchange=serialize)
        step = lambda shards_, targets_, attrs_=None: coo_step(shards_, targets_)
    if dp is None:
        shards, attrs, targets = shards[0], attrs[0], targets[0]
    return Rank(run=run, group=group, dp=dp, shards=shards, attrs=attrs, targets=targets,
                model=model, state=make_train_state(model, opt), step=step, dtype=dtype,
                partition_sha=partition_digest(*parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("in_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    r = setup(args.in_dir, args.device)
    group, run = r.group, r.run
    state, start = resume_or_init(str(out_dir / "ckpt"), r.state)
    world, rank = world_size_and_rank()
    result = dict(rank=rank, world=world, device=str(group.device),
                  incarnation=int(os.environ.get("E3GNN_INCARNATION", "0")),
                  layout=r.layout, serialize_exchange=r.serialize, backend=r.backend,
                  partitions=[group.lo, group.hi],
                  clouds=[r.dp.lo, r.dp.hi] if r.dp is not None else [0, 1],
                  partition_sha=r.partition_sha, start_step=start)
    saved = {}
    if start == 0:
        with torch.no_grad():
            fwd_model = copy.deepcopy(r.model).to(r.dtype)
            if r.layout == "dense":
                fwd = make_dist_forward_dense(fwd_model, group, r.backend,
                                              _serialize_exchange=r.serialize)
            else:
                coo = make_dist_forward(fwd_model, group, r.backend,
                                        _serialize_exchange=r.serialize)
                fwd = lambda shards, attrs: coo(shards)
            outs = [fwd(s, a).float().cpu().numpy() for s, a in r.clouds()]
            saved["forward"] = np.stack(outs) if r.dp is not None else outs[0]
            del fwd_model, outs

    hb = Heartbeat(str(out_dir / "hb"), rank)
    cuda = group.device.type == "cuda"
    ring = group.ipc_ring() if cuda and r.backend == "ring" and group.world > 1 else None
    if ring is not None:
        ring.events = []
    losses, step_ms, comm_ms, launches, ring_ms = [], [], [], [], []
    result["resumed_at"] = time.time()
    for s in range(start, run["steps"]):
        hb.beat(s)
        before, comm0 = _launches(), r.comm_seconds()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
        t0 = time.perf_counter()
        m = r.step(r.shards, r.targets, r.attrs)
        if cuda:
            ev[1].record()
        losses.append(m["loss"].item())
        if cuda:
            torch.cuda.synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
        else:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        comm_ms.append((r.comm_seconds() - comm0) * 1e3)
        now = _launches()
        launches.append({k: v - before[k] for k, v in now.items() if v != before[k]})
        if ring is not None:
            ring_ms.append({kind: sum(a.elapsed_time(b) for k, a, b in ring.events if k == kind)
                            for kind in ("publish", "gather")})
            ring.events.clear()
        state.step = s + 1
        save_checkpoint(str(out_dir / "ckpt"), s + 1, state)
        inject_failure(s)

    result.update(losses=losses, step_ms=step_ms, comm_ms=comm_ms, launches_per_step=launches,
                  ring_ms_per_step=ring_ms, state_sha=_state_digest(state))
    saved.update({f"param/{nm}": p.detach().cpu().numpy()
                  for nm, p in r.model.named_parameters()})
    np.savez(out_dir / f"rank{rank}.npz", **saved)
    print(RESULT_PREFIX + json.dumps(result), flush=True)
    hb.done()
    group.close()
    if world > 1:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_results(out_dir, incarnation: int, world_size: int) -> Dict[int, dict]:
    """``{rank: result}`` from the ``DENSE_WORKER`` lines of one incarnation's
    logs (a rank without such a line is left out)."""
    results = {}
    for rank in range(world_size):
        log = Path(out_dir) / f"log_i{incarnation}_r{rank}.txt"
        if not log.exists():
            continue
        for line in log.read_text().splitlines():
            if line.startswith(RESULT_PREFIX):
                results[rank] = json.loads(line[len(RESULT_PREFIX):])
    return results


def run_world(in_dir, out_dir, world_size: int, device: Optional[str] = None,
              env: Optional[dict] = None, heartbeat_timeout_s: float = 120.0,
              startup_timeout_s: float = 300.0, wall_timeout_s: float = 900.0,
              max_restarts: int = 2) -> Tuple[SupervisorReport, Dict[int, dict]]:
    """Run ``world_size`` ranks of this worker on ``in_dir`` under a
    ``Supervisor``: a fresh port on this host for each incarnation, every
    rank's output in ``out_dir/log_i<incarnation>_r<rank>.txt``, the
    heartbeats in ``out_dir/hb``.  ``env`` adds to each worker's environment
    (``E3GNN_DIE_AT_STEP`` and ``E3GNN_DIE_PROCESS`` inject a failure).
    Returns the report and the results of the last incarnation."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = str(Path(__file__).resolve().parents[2])
    ports: Dict[int, int] = {}

    def launch(rank: int, incarnation: int) -> subprocess.Popen:
        port = ports.setdefault(incarnation, _free_port())
        wenv = {**os.environ, **(env or {}), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port), "WORLD_SIZE": str(world_size), "RANK": str(rank),
                "LOCAL_RANK": str(rank), "E3GNN_INCARNATION": str(incarnation),
                "PYTHONPATH": os.pathsep.join(
                    [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                              if p])}
        cmd = [sys.executable, "-m", "scalable_e3_gnn_torch.parallel.dense_worker",
               str(in_dir), str(out_dir)] + (["--device", device] if device else [])
        with open(out_dir / f"log_i{incarnation}_r{rank}.txt", "w") as log:
            return subprocess.Popen(cmd, env=wenv, stdout=log, stderr=subprocess.STDOUT,
                                    cwd=root)

    report = Supervisor(launch, world_size, str(out_dir / "hb"),
                        heartbeat_timeout_s=heartbeat_timeout_s, max_restarts=max_restarts,
                        wall_timeout_s=wall_timeout_s, require_done=True,
                        startup_timeout_s=startup_timeout_s).run()
    return report, _read_results(out_dir, report.restarts, world_size)


if __name__ == "__main__":
    sys.exit(main())
