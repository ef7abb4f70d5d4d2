"""PyTorch port, the halo exchange overlapped with the interior work.

In place of JAX's jaxpr proof (``tests/test_overlap_structure.py``): with a
recording fake of the partition group's asynchronous gather (a one-process
group that claims two ranks), every layer of the dense and the COO runner
starts the gather, runs every local partition's interior block or local
edges, waits, then runs the boundary blocks or remote edges; with
``_serialize_exchange=True`` the wait comes before the interior work.
Overlapped and serialized runs give the same bits: the forward, the losses
and the parameters after two Adam steps, in one process (both layouts, both
backends, the plain message path and the kernels' dispatch) and in a
2-process gloo world (both layouts).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from scalable_e3_gnn_torch import DenseEdgeGraph, SEGNN, SEGNNLayer, radius_graph_brute
from scalable_e3_gnn_torch.parallel import dense_worker as dw
from scalable_e3_gnn_torch.parallel import halo
from scalable_e3_gnn_torch.parallel.partition import partition_graph, partition_graph_dense

REPO = Path(__file__).resolve().parents[1]
N, PARTS, LAYERS = 96, 4, 2
MODEL = dict(input_irreps="2x0e+1x1o", hidden_irreps="8x0e+4x1o", output_irreps="1x1o",
             num_layers=LAYERS, layout="cm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    """A 96-point cloud (K=8, radius 0.35 in the unit cube): the dense and
    the COO arrays, and a target."""
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.random((N, 3)).astype(np.float32))
    order = torch.argsort(pts[:, 0])  # contiguous ranges are slabs
    pts = pts[order]
    e = radius_graph_brute(pts, 0.35, 8, device="cpu")
    feats = torch.from_numpy(rng.standard_normal((N, 5)).astype(np.float32))
    g = DenseEdgeGraph.from_radius_edges(feats, pts, e)
    dense = (g.positions, g.nodes, g.senders, g.edge_mask)
    coo = (pts, feats, e.senders, e.receivers, e.mask)
    tgt = rng.standard_normal((N, 3)).astype(np.float32)
    return [np.asarray(a) for a in dense], [np.asarray(a) for a in coo], tgt


def _setup(layout, use_pallas=False):
    dense, coo, tgt = _graph()
    model = SEGNN(**MODEL, use_pallas=use_pallas, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    group = halo.PartitionGroup(PARTS, "cpu")
    if layout == "dense":
        part = partition_graph_dense(*dense, num_parts=PARTS)
        shards = halo.shard_partitioned_dense(part, group)
    else:
        part = partition_graph(*coo, num_parts=PARTS)
        shards = halo.shard_partitioned(part, group)
    targets = torch.from_numpy(tgt[np.clip(part.global_ids, 0, None)])
    return model, group, shards, targets


_FORWARD = {"dense": halo.make_dist_forward_dense, "coo": halo.make_dist_forward}
_STEP = {"dense": halo.make_dist_train_step_dense, "coo": halo.make_dist_train_step}
_HALVES = {"dense": ("apply_dense_interior", "apply_dense_boundary"),
           "coo": ("apply_split_local", "apply_split_remote")}


class _RecordingGather:
    """Stands in for a group's asynchronous gather across two ranks: the
    "gathered" pool is the local exports (the group owns every partition),
    and every start and wait is recorded."""

    def __init__(self, group, events):
        self.group, self.events = group, events

    def start(self, x):
        self.events.append("start")
        return x.clone(), object()

    def wait(self, work):
        self.events.append("wait")


@pytest.mark.parametrize("serialize", [False, True], ids=["overlap", "serialized"])
@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_each_layer_runs_its_interior_work_while_the_gather_is_in_flight(layout, serialize,
                                                                         monkeypatch):
    model, group, shards, _ = _setup(layout)
    with torch.no_grad():
        want = _FORWARD[layout](model, group)(shards)
    events = []
    fake = _RecordingGather(group, events)
    group.world = 2  # as a group of two ranks: the exchange gathers asynchronously
    monkeypatch.setattr(group, "all_gather_start", fake.start)
    monkeypatch.setattr(group, "wait", fake.wait)
    for name, tag in zip(_HALVES[layout], ("first", "second")):
        orig = getattr(SEGNNLayer, name)

        def rec(self, *args, _orig=orig, _tag=tag, **kw):
            events.append(_tag)
            return _orig(self, *args, **kw)

        monkeypatch.setattr(SEGNNLayer, name, rec)
    with torch.no_grad():
        got = _FORWARD[layout](model, group, _serialize_exchange=serialize)(shards)
    one = (["start", "wait"] + ["first"] * PARTS if serialize
           else ["start"] + ["first"] * PARTS + ["wait"]) + ["second"] * PARTS
    assert events == one * LAYERS
    assert torch.equal(got, want)


def _run(layout, backend, serialize, use_pallas=False):
    model, group, shards, targets = _setup(layout, use_pallas)
    with torch.no_grad():
        out = _FORWARD[layout](model, group, backend, _serialize_exchange=serialize)(shards)
    step = _STEP[layout](model, torch.optim.Adam(model.parameters(), lr=1e-3), group, backend,
                         _serialize_exchange=serialize)
    losses = [step(shards, targets)["loss"].item() for _ in range(2)]
    return out, losses, [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("backend", halo.BACKENDS)
@pytest.mark.parametrize("layout,use_pallas", [("dense", False), ("dense", True),
                                               ("coo", False)],
                         ids=["dense", "dense-kernels", "coo"])
def test_overlapped_equals_serialized_in_one_process(layout, use_pallas, backend):
    a = _run(layout, backend, False, use_pallas)
    b = _run(layout, backend, True, use_pallas)
    assert torch.equal(a[0], b[0])
    assert a[1] == b[1]
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


_WORKER = textwrap.dedent(
    """
    import hashlib, json, sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[1])
    import test_torch_overlap as t
    from scalable_e3_gnn_torch.parallel import halo
    from scalable_e3_gnn_torch.parallel.multihost import init_distributed

    torch.set_num_threads(1)
    assert init_distributed()
    out = {}
    for layout in ("dense", "coo"):
        runs = []
        for serialize in (False, True):
            model, group1, shards, targets = t._setup(layout)
            group = halo.PartitionGroup(t.PARTS, "cpu", dist.group.WORLD)
            shards, targets = shards[group.lo:group.hi], targets[group.lo:group.hi]
            with torch.no_grad():
                fwd = t._FORWARD[layout](model, group, _serialize_exchange=serialize)(shards)
            step = t._STEP[layout](model, torch.optim.Adam(model.parameters(), lr=1e-3), group,
                                   _serialize_exchange=serialize)
            losses = [step(shards, targets)["loss"].item() for _ in range(2)]
            h = hashlib.sha256()
            for p in model.parameters():
                h.update(p.detach().numpy().tobytes())
            runs.append(dict(forward=hashlib.sha256(fwd.numpy().tobytes()).hexdigest(),
                             losses=losses, params=h.hexdigest(),
                             comm_s=group.comm_seconds))
        out[layout] = runs
    print("OVERLAP " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    """
)


def test_overlapped_equals_serialized_across_two_processes(tmp_path):
    script = tmp_path / "overlap_worker.py"
    script.write_text(_WORKER)
    port = dw._free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(rank),
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen([sys.executable, str(script), str(REPO / "tests")],
                                      env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("two-process overlap run timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(next(json.loads(ln[len("OVERLAP "):]) for ln in out.splitlines()
                         if ln.startswith("OVERLAP ")))
    for layout in ("dense", "coo"):
        ranks = [o[layout] for o in outs]
        for overlap, serial in ranks:
            for key in ("forward", "losses", "params"):
                assert overlap[key] == serial[key], (layout, key)
            assert overlap["comm_s"] > 0 and serial["comm_s"] > 0
        assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
        assert ranks[0][0]["params"] == ranks[1][0]["params"]
        # and the one-process run's losses (the same forward and ordered sums;
        # the gradients are summed over the ranks in another order)
        one = _run(layout, "all_gather", False)
        np.testing.assert_allclose(ranks[0][0]["losses"], one[1], rtol=1e-6)
        assert ranks[0][0]["losses"][0] == one[1][0]
