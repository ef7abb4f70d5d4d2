"""PyTorch port, kernel #15 between processes (``backend="ring"`` across a
``torch.distributed`` group; ``kernels/halo_ring.py::IpcRing`` on a card).

On the CPU the ring between processes is its plain version, the group's gloo
all-gather, so one 2-process gloo world (P=4, two partitions a rank; the
setup of ``tests/test_torch_multihost.py``: 128 points, radius 0.8, K=8,
2x0e+1x1o -> 8x0e+4x1o -> 1x1o, 2 layers, ``jax.random.key(0)`` weights;
free ports, OMP on one thread) runs the worker's ``setup`` with
``"backend": "ring"`` in ``run.json`` and holds:
- its fp32 forward (overlapped and serialized) and 3-step Adam curve bit for
  bit the ``all_gather`` runners' of the same processes, the final
  parameters too;
- both within 1e-6 of JAX's ``make_dist_forward_dense`` /
  ``make_dist_train_step_dense`` with ``backend="rdma", interpret=True`` (the
  Pallas ring in interpret mode) on 4 virtual CPU devices, as
  ``tests/test_distributed_dense.py:261-273`` runs it;
- a COO forward (``tests/test_distributed.py``'s graph, a 1-layer model, P=4)
  under ring bit for bit the all_gather one, and within 1e-6 of JAX's
  ``make_dist_forward`` with ``backend="rdma", interpret=True``;
- the plain version, the group's ``all_gather_start``/``wait`` that
  ``_Exchange`` runs for a CPU tensor, as the ranks' exports stacked;
- the runners reading the ring's error word at the end of every forward
  (``PartitionGroup.raise_if_exchange_failed``, counted).
And in one process: the offset, copy-plan and parity arithmetic of the
ring's launches, the exchange counter across layers and steps, the error
word's message, and the card-identity check (UUIDs monkeypatched).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.parallel import halo as jhalo
from scalable_e3_gnn_tpu.parallel.partition import partition_graph as j_partition_coo
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition
from scalable_e3_gnn_tpu.train.pipeline import make_train_state as j_train_state
from scalable_e3_gnn_torch.kernels import halo_ring as hr
from scalable_e3_gnn_torch.models.segnn import SEGNN
from scalable_e3_gnn_torch.parallel import dense_worker as dw
from scalable_e3_gnn_torch.parallel import halo
from scalable_e3_gnn_torch.parallel import multihost as mh
from scalable_e3_gnn_torch.utils.params import params_from_jax

REPO = Path(__file__).resolve().parents[1]
N, PARTS, WORLD, STEPS = 128, 4, 2, 3
MODEL = dict(input_irreps="2x0e+1x1o", hidden_irreps="8x0e+4x1o", output_irreps="1x1o",
             num_layers=2, layout="cm")
COO_N, COO_HIDDEN = 512, "8x0e+8x1o"
TOL_JAX = 1e-6  # fp32: the same math, summed in another order


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread, as the workers (OMP_NUM_THREADS=1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ring's arithmetic, the counter, the card check (one process)
# ---------------------------------------------------------------------------


def test_parity_alternates_from_the_first_exchange():
    assert [hr.ipc_parity(e) for e in range(1, 7)] == [1, 0, 1, 0, 1, 0]
    with pytest.raises(ValueError, match="count from 1"):
        hr.ipc_parity(0)


def test_exchange_counter_runs_on_across_layers_and_steps():
    """The ring's counter over a forward and 4 train steps of two layers
    (one exchange a layer, none in the backward): it never restarts, so the
    steps take exchanges 3-4, 5-6, ...; each buffer's consecutive exchanges
    are two apart (the two-buffer argument)."""
    ring = hr.IpcRing(None, 2, 0, "cpu")
    forward = [ring.begin() for _ in range(2)]
    steps = [[ring.begin() for _ in range(2)] for _ in range(4)]
    assert forward == [1, 2] and steps == [[3, 4], [5, 6], [7, 8], [9, 10]]
    every = forward + [e for s in steps for e in s]
    for b in (0, 1):
        mine = [e for e in every if hr.ipc_parity(e) == b]
        assert all(y - x == 2 for x, y in zip(mine, mine[1:]))


@pytest.mark.parametrize("stage_bytes", [1, 256, 257, 2 * 3234 * 80 * 2, 4 * 3221 * 80 * 4])
def test_region_layout(stage_bytes):
    lay = hr.ipc_layout(stage_bytes)
    stride = lay["stride"]
    assert stride % hr.IPC_ALIGN == 0 and stage_bytes <= stride < stage_bytes + hr.IPC_ALIGN
    assert lay["flags"] == (0, 8) and lay["counts"] == (16, 20)
    # what csrc/halo_ipc.cu's launches accept: u64 flags and u32 counts in
    # the header, staging buffers past it on 16 bytes
    assert all(x % 8 == 0 and x + 8 <= hr.IPC_HEADER for x in lay["flags"])
    assert all(x % 4 == 0 and x + 4 <= hr.IPC_HEADER for x in lay["counts"])
    assert all(x >= hr.IPC_HEADER and x % 16 == 0 for x in lay["stages"])
    assert lay["stages"] == (hr.IPC_HEADER, hr.IPC_HEADER + stride)
    assert lay["bytes"] == lay["stages"][1] + stride
    with pytest.raises(ValueError):
        hr.ipc_layout(0)


@pytest.mark.parametrize("exchange,peer", [(7, 1), (1, 0), (40_000, 3)])
def test_error_word_names_the_peer_and_the_exchange(monkeypatch, exchange, peer):
    """The gather kernel stores ``(exchange << 16) | (peer + 1)``; 0 is no
    failure."""
    ring = hr.IpcRing(None, 4, 0, "cpu", timeout_s=2.0)
    ring.raise_if_failed()
    monkeypatch.setattr(ring, "error", lambda: (exchange << 16) | (peer + 1))
    with pytest.raises(RuntimeError, match=f"rank {peer}'s exchange {exchange};"):
        ring.raise_if_failed()


@pytest.mark.parametrize("nbytes,ptr,vec", [(2 * 3234 * 80 * 2, 512, 16), (2 * 37 * 13 * 4, 512, 8),
                                            (37 * 13 * 2, 512, 2), (2 * 37 * 13 * 2, 512, 4),
                                            (4096, 8, 8)])
def test_copy_plan(nbytes, ptr, vec):
    plan = hr.ipc_plan(nbytes, (ptr,))
    assert plan["vec_bytes"] == vec and plan["words"] * vec == nbytes
    assert 1 <= plan["blocks"] <= hr.IPC_MAX_BLOCKS
    assert plan["blocks"] == min(hr.IPC_MAX_BLOCKS, -(-plan["words"] // hr.THREADS))


def test_card_check_passes_one_card_and_raises_for_distinct_cards():
    mh.check_one_card(["GPU-1234"] * 3)
    with pytest.raises(NotImplementedError, match="A3b"):
        mh.check_one_card(["GPU-1234", "GPU-5678"])


def test_card_identities_in_one_process(monkeypatch):
    monkeypatch.setattr(mh, "card_identity", lambda dev: "GPU-abcd")
    assert mh.card_identities("cuda") == ["GPU-abcd"]


def test_group_ring_is_made_once_after_the_card_check(monkeypatch):
    """A two-rank group on a card: equal UUIDs make the group's ring (no CUDA
    call until its first publish), once; the runners share it."""
    seen = []
    monkeypatch.setattr(halo, "card_identities",
                        lambda dev, pg: seen.append(dev) or ["GPU-abcd", "GPU-abcd"])
    group = halo.PartitionGroup(PARTS, "cpu")
    group.world, group.rank = 2, 1  # as rank 1 of a two-rank group would be
    group.device = torch.device("cuda", 0)
    model = SEGNN(**MODEL, device="cpu")
    halo.make_dist_forward_dense(model, group, "ring")
    halo.make_dist_forward(model, group, "ring")
    ring = group.ipc_ring()
    assert seen == [torch.device("cuda", 0)]
    assert (ring.world, ring.rank, ring.epoch, ring.error()) == (2, 1, 0, 0)
    assert [ring.begin() for _ in range(3)] == [1, 2, 3]
    ring.raise_if_failed()
    group.close()
    assert group._ring is None


def test_ring_rejects_what_it_does_not_take():
    ring = hr.IpcRing(None, 2, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring.publish(torch.zeros(2, 3, 4), ring.begin())
    with pytest.raises(RuntimeError, match="before any publish"):
        ring.gather(1, (2, 3, 4, torch.float32))
    with pytest.raises(ValueError, match="ranks"):
        hr.IpcRing(None, hr.IPC_MAX_WORLD + 1, 0, "cpu")


# ---------------------------------------------------------------------------
# the 2-process world against the all_gather runners and JAX's Pallas ring
# ---------------------------------------------------------------------------


def _jax_dense_model():
    return JSEGNN(JIrreps("2x0e+1x1o"), JIrreps("8x0e+4x1o"), JIrreps("1x1o"), num_layers=2,
                  layout="cm")


def _jax_coo_model():
    return JSEGNN(JIrreps("2x0e+1x1o"), JIrreps(COO_HIDDEN), JIrreps("1x1o"), num_layers=1)


@functools.lru_cache(maxsize=None)
def _dense_inputs():
    """JAX's setup of tests/test_multihost.py:64-90: the graph arrays, the
    target and the weights."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    e = radius_graph_brute(jnp.asarray(pts), 0.8, max_neighbors=8)
    feats = rng.standard_normal((N, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), jnp.asarray(pts), e)
    tgt = rng.standard_normal((N, 3)).astype(np.float32)
    arrays = tuple(np.array(x) for x in (g.positions, g.nodes, g.senders, g.edge_mask))
    return arrays, tgt, jax.tree.map(np.asarray, _jax_dense_model().init(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _dense_problem():
    """On a 4-device mesh, JAX's rdma (Pallas ring in interpret mode)
    forward and 3-step Adam 1e-3 curve of ``_dense_inputs``."""
    arrays, tgt, params = _dense_inputs()
    jm = _jax_dense_model()
    part = j_partition(*arrays, num_parts=PARTS)
    mesh = Mesh(np.array(jax.devices()[:PARTS]).reshape(PARTS), ("graph",))
    args = jhalo.shard_partitioned_dense(part, mesh)
    attrs = jhalo.make_dist_geometry_dense(jm, mesh)(args)
    fwd = np.asarray(jhalo.make_dist_forward_dense(jm, mesh, backend="rdma", interpret=True)(
        params, args, attrs))
    opt = optax.adam(1e-3)
    step = jhalo.make_dist_train_step_dense(jm, opt, mesh, backend="rdma", interpret=True)
    st = j_train_state(jax.tree.map(jnp.copy, params), opt)
    t_sh = jnp.asarray(tgt[np.clip(part.global_ids, 0, None)])
    losses = []
    for _ in range(STEPS):
        st, m = step(st, args, t_sh, attrs)
        losses.append(float(m["loss"]))
    return fwd, losses


@functools.lru_cache(maxsize=None)
def _coo_inputs():
    """tests/test_distributed.py's COO graph (512 points, radius 0.7, K=32;
    the points unsorted) and a 1-layer 8x0e+8x1o model (``jax.random.key(1)``
    weights)."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((COO_N, 3)).astype(np.float32)
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=32))(jnp.asarray(pts))
    feats = rng.standard_normal((COO_N, 5)).astype(np.float32)
    arrays = (pts, feats, np.array(e.senders), np.array(e.receivers), np.array(e.mask))
    return arrays, jax.tree.map(np.asarray, _jax_coo_model().init(jax.random.key(1)))


@functools.lru_cache(maxsize=None)
def _coo_problem():
    """JAX's rdma COO forward of ``_coo_inputs`` at P=4."""
    arrays, params = _coo_inputs()
    part = j_partition_coo(*arrays, num_parts=PARTS)
    mesh = Mesh(np.array(jax.devices()[:PARTS]).reshape(PARTS), ("graph",))
    return np.asarray(jhalo.make_dist_forward(_jax_coo_model(), mesh, backend="rdma",
                                              interpret=True)(
        params, jhalo.shard_partitioned(part, mesh)))


_RANK = textwrap.dedent(
    """
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from scalable_e3_gnn_torch.kernels import halo_ring as hr
    from scalable_e3_gnn_torch.models.segnn import SEGNN
    from scalable_e3_gnn_torch.parallel import halo
    from scalable_e3_gnn_torch.parallel.dense_worker import setup
    from scalable_e3_gnn_torch.parallel.partition import partition_graph

    in_dir, coo_dir, out = sys.argv[1:4]
    r = setup(in_dir, "cpu")  # run.json: backend "ring"
    assert r.backend == "ring"
    group, rank = r.group, r.group.rank
    reads = []  # the runners' reads of the ring's error word, one a forward
    check = group.raise_if_exchange_failed
    group.raise_if_exchange_failed = lambda: reads.append(1) or check()
    init = {k: v.detach().clone() for k, v in r.model.state_dict().items()}
    saved = {}
    with torch.no_grad():
        for tag, backend, ser in (("ring", "ring", False), ("ring_serialized", "ring", True),
                                  ("all_gather", "all_gather", False)):
            fwd = halo.make_dist_forward_dense(r.model, group, backend, _serialize_exchange=ser)
            saved[f"fwd_{tag}"] = fwd(r.shards, r.attrs).numpy()
    curves = {"ring": [r.step(r.shards, r.targets, r.attrs)["loss"].item() for _ in range(3)]}
    saved.update({f"ring/{k}": v.detach().numpy() for k, v in r.model.state_dict().items()})
    model = SEGNN(**r.run["model"], device="cpu")
    model.load_state_dict(init)
    step = halo.make_dist_train_step_dense(
        model, torch.optim.Adam(model.parameters(), lr=r.run["lr"]), group, "all_gather")
    curves["all_gather"] = [step(r.shards, r.targets, r.attrs)["loss"].item() for _ in range(3)]
    saved.update({f"all_gather/{k}": v.detach().numpy() for k, v in model.state_dict().items()})

    with np.load(coo_dir + "/graph.npz") as g:
        arrays = [g[k] for k in ("positions", "nodes", "senders", "receivers", "edge_mask")]
    coo = SEGNN("2x0e+1x1o", "8x0e+8x1o", "1x1o", num_layers=1, device="cpu")
    with np.load(coo_dir + "/weights.npz") as w:
        coo.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
    shards = halo.shard_partitioned(partition_graph(*arrays, num_parts=4), group)
    with torch.no_grad():
        for backend in ("ring", "all_gather"):
            saved[f"coo_{backend}"] = halo.make_dist_forward(coo, group, backend)(shards).numpy()

    x = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(
        (2, 5, 3)).astype(np.float32))
    pool, work = group.all_gather_start(x)
    group.wait(work)
    saved["plain_gather"] = pool.numpy()
    np.savez(out + f"/rank{rank}.npz", **saved)
    print("RING " + json.dumps(dict(rank=rank, partitions=[group.lo, group.hi], curves=curves,
                                    launches={k.name: k.launches for k in hr.KERNELS},
                                    error_word_reads=len(reads))),
          flush=True)
    group.close()
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    """Both ranks' readings and files.  JAX's references are computed while
    the ranks run."""
    base = tmp_path_factory.mktemp("ring")
    arrays, tgt, params = _dense_inputs()
    model = params_from_jax(SEGNN(**MODEL, device="cpu"), params)
    dw.write_inputs(base / "in", *arrays, tgt, MODEL, model.state_dict(), num_parts=PARTS,
                    steps=STEPS, lr=1e-3, compute_dtype="float32", backend="ring")
    c_arrays, c_params = _coo_inputs()
    (base / "coo").mkdir()
    np.savez(base / "coo" / "graph.npz", **dict(zip(
        ("positions", "nodes", "senders", "receivers", "edge_mask"), c_arrays)))
    cmodel = params_from_jax(SEGNN("2x0e+1x1o", COO_HIDDEN, "1x1o", num_layers=1, device="cpu"),
                             c_params)
    np.savez(base / "coo" / "weights.npz",
             **{k: v.detach().numpy() for k, v in cmodel.state_dict().items()})
    script = base / "rank.py"
    script.write_text(_RANK)
    port = dw._free_port()
    procs = []
    for rank in range(WORLD):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(WORLD), "RANK": str(rank),
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(base / "in"), str(base / "coo"), str(base)],
            env=env, cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    _dense_problem()
    _coo_problem()
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("the 2-process ring world timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    res = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("RING "):
                got = json.loads(ln[len("RING "):])
                res[got["rank"]] = got
    assert sorted(res) == list(range(WORLD))
    files = {r: dict(np.load(base / f"rank{r}.npz")) for r in range(WORLD)}
    return res, files


def test_ring_world_forward_is_the_all_gather_forward_bit_for_bit(ring_world):
    res, files = ring_world
    for r in range(WORLD):
        assert res[r]["partitions"] == [2 * r, 2 * r + 2]
        want = files[r]["fwd_all_gather"]
        for tag in ("fwd_ring", "fwd_ring_serialized"):
            assert files[r][tag].shape == want.shape
            assert files[r][tag].tobytes() == want.tobytes(), (r, tag)
        # no kernel on the CPU: the ring's plain version is the all-gather
        assert all(v == 0 for v in res[r]["launches"].values())


def test_ring_world_curve_is_the_all_gather_curve_bit_for_bit(ring_world):
    res, files = ring_world
    for r in range(WORLD):
        assert res[r]["curves"]["ring"] == res[r]["curves"]["all_gather"]
        assert res[r]["curves"]["ring"] == res[0]["curves"]["ring"]
        keys = [k[len("ring/"):] for k in files[r] if k.startswith("ring/")]
        assert keys
        for k in keys:
            assert files[r][f"ring/{k}"].tobytes() == files[r][f"all_gather/{k}"].tobytes(), k
            assert files[r][f"ring/{k}"].tobytes() == files[0][f"ring/{k}"].tobytes(), k


def test_ring_world_matches_jax_rdma(ring_world):
    res, files = ring_world
    fwd, losses = _dense_problem()
    scale = max(1.0, float(np.abs(fwd).max()))
    for r in range(WORLD):
        lo, hi = res[r]["partitions"]
        err = float(np.abs(files[r]["fwd_ring"] - fwd[lo:hi]).max())
        assert err <= TOL_JAX * scale, (r, err)
    np.testing.assert_allclose(res[0]["curves"]["ring"], losses, rtol=TOL_JAX)
    assert losses[-1] < losses[0]


def test_ring_world_coo_forward(ring_world):
    res, files = ring_world
    fwd = _coo_problem()
    scale = max(1.0, float(np.abs(fwd).max()))
    for r in range(WORLD):
        lo, hi = res[r]["partitions"]
        assert files[r]["coo_ring"].tobytes() == files[r]["coo_all_gather"].tobytes(), r
        err = float(np.abs(files[r]["coo_ring"] - fwd[lo:hi]).max())
        assert err <= TOL_JAX * scale, (r, err)


def test_runners_read_the_error_word_after_every_forward(ring_world):
    """3 dense forwards, 3 steps under ring and 3 under all_gather (one
    forward each), 2 COO forwards: 11 reads a rank (a group without a ring
    reads nothing but calls all the same)."""
    res, _ = ring_world
    for r in range(WORLD):
        assert res[r]["error_word_reads"] == 3 + 2 * STEPS + 2


def test_plain_exchange_stacks_the_ranks_exports(ring_world):
    _, files = ring_world
    want = np.concatenate([np.random.default_rng(10 + r).standard_normal((2, 5, 3)).astype(
        np.float32) for r in range(WORLD)])
    for r in range(WORLD):
        assert files[r]["plain_gather"].tobytes() == want.tobytes()
