"""PyTorch port, one partition range per process over ``torch.distributed``.

``parallel/multihost.py`` in one process, then two gloo processes on the CPU
(``parallel/dense_worker.py`` under the ``Supervisor``; free ports, OMP on
one thread so the CPU GEMMs are the parent's) running the dense partitioned
train step with 2 ranks x 2 partitions (P=4) on the setup of JAX's
``tests/test_multihost.py`` (128 points, radius 0.8, K=8, 2x0e+1x1o ->
8x0e+4x1o -> 1x1o, 2 layers, ``jax.random.key(0)`` weights), 3 Adam 1e-3
steps in fp32:
- both ranks build the same partition (its digest) and report the same
  losses; their final parameters and optimizer states are equal bit for bit;
- the fp32 forward of each rank's partitions equals the one-process P=4
  runner's bit for bit (the exchange's gather moves bytes; no sum changes
  order);
- the loss curve lies within 1e-6 relative of JAX's
  ``make_dist_train_step_dense`` on a 4-device mesh and of the port's
  one-process P=4 runner (the parameter gradients are summed over the ranks
  in another order than one process's autograd sums them);
then the per-rank checkpoints, with JAX's protocol of
``test_two_process_sharded_checkpoint``: save after step 1, continue, restore
the saved step and continue again, bit for bit; the shard files and the
manifest; a restore under another world size raises.
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
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition
from scalable_e3_gnn_tpu.train.pipeline import make_train_state as j_train_state
from scalable_e3_gnn_torch.models.segnn import SEGNN
from scalable_e3_gnn_torch.parallel import dense_worker as dw
from scalable_e3_gnn_torch.parallel import halo
from scalable_e3_gnn_torch.parallel import multihost as mh
from scalable_e3_gnn_torch.parallel.partition import partition_graph_dense
from scalable_e3_gnn_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                                     save_checkpoint)
from scalable_e3_gnn_torch.train.pipeline import make_train_state
from scalable_e3_gnn_torch.utils.params import params_from_jax

REPO = Path(__file__).resolve().parents[1]
N, PARTS, WORLD, STEPS = 128, 4, 2, 3
MODEL = dict(input_irreps="2x0e+1x1o", hidden_irreps="8x0e+4x1o", output_irreps="1x1o",
             num_layers=2, layout="cm")
RUN = dict(num_parts=PARTS, steps=STEPS, lr=1e-3, compute_dtype="float32")
WORKER_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread, as the workers (OMP_NUM_THREADS=1):
    the suite runs several workers on the same cores, and a CPU GEMM's bits
    may depend on its thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# multihost in one process
# ---------------------------------------------------------------------------


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mh.init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mh.init_distributed() is False
    assert mh.world_size_and_rank() == (1, 0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_shard_slice(world):
    got = [mh.local_shard_slice(4, world, r) for r in range(world)]
    per = 4 // world
    assert got == [(r * per, (r + 1) * per) for r in range(world)]
    assert mh.local_shard_slice(4) == (0, 4)  # no process group: everything


def test_local_shard_slice_rejects_uneven_worlds():
    with pytest.raises(ValueError, match="do not divide"):
        mh.local_shard_slice(4, 3, 0)
    with pytest.raises(ValueError, match="outside"):
        mh.local_shard_slice(4, 2, 2)


def test_rank_device(monkeypatch):
    assert mh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mh.rank_device()


def test_ring_raises_across_processes(monkeypatch):
    """The ring between processes runs on one card shared by the ranks: a
    group whose ranks name distinct cards raises when its runner is built
    (peer-mapped pools across cards are ROADMAP.md section 2, A3b)."""
    model = SEGNN(**MODEL, device="cpu")
    group = halo.PartitionGroup(PARTS, "cpu")
    group.world = 2  # as a two-rank group would be
    group.device = torch.device("cuda", 0)  # as the ranks' cards would be
    monkeypatch.setattr(halo, "card_identities", lambda dev, pg: ["GPU-0aaa", "GPU-1bbb"])
    with pytest.raises(NotImplementedError, match="A3b"):
        halo.make_dist_forward_dense(model, group, "ring")
    with pytest.raises(NotImplementedError, match="A3b"):
        halo.make_dist_train_step_dense(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                        group, "ring")
    assert group._ring is None


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _problem():
    """JAX's worker setup (tests/test_multihost.py:64-90): graph arrays,
    target, JAX weights, and JAX's 3-step curve on a 4-device mesh."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    e = radius_graph_brute(jnp.asarray(pts), 0.8, max_neighbors=8)
    feats = rng.standard_normal((N, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), jnp.asarray(pts), e)
    tgt = rng.standard_normal((N, 3)).astype(np.float32)
    arrays = (np.array(g.positions), np.array(g.nodes), np.array(g.senders),
              np.array(g.edge_mask))
    jm = JSEGNN(JIrreps("2x0e+1x1o"), JIrreps("8x0e+4x1o"), JIrreps("1x1o"), num_layers=2,
                layout="cm")
    params = jm.init(jax.random.key(0))
    part = j_partition(*arrays, num_parts=PARTS)
    mesh = Mesh(np.array(jax.devices()[:PARTS]).reshape(PARTS), ("graph",))
    args = jhalo.shard_partitioned_dense(part, mesh)
    attrs = jhalo.make_dist_geometry_dense(jm, mesh)(args)
    opt = optax.adam(1e-3)
    step = jhalo.make_dist_train_step_dense(jm, opt, mesh)
    st = j_train_state(jax.tree.map(jnp.copy, params), opt)
    t_sh = jnp.asarray(tgt[np.clip(part.global_ids, 0, None)])
    losses = []
    for _ in range(STEPS):
        st, m = step(st, args, t_sh, attrs)
        losses.append(float(m["loss"]))
    return arrays, tgt, jax.tree.map(np.asarray, params), losses


def _port_model(params, use_pallas=False):
    model = SEGNN(**MODEL, use_pallas=use_pallas, device="cpu")
    return params_from_jax(model, params)


@functools.lru_cache(maxsize=None)
def _one_process():
    """The port's one-process P=4 runner on the same weights: the fp32
    forward and the 3-step curve."""
    arrays, tgt, params, _ = _problem()
    model = _port_model(params)
    part = partition_graph_dense(*arrays, num_parts=PARTS)
    group = halo.PartitionGroup(PARTS, "cpu")
    shards = halo.shard_partitioned_dense(part, group)
    attrs = halo.make_dist_geometry_dense(model, group)(shards)
    targets = torch.from_numpy(tgt[np.clip(part.global_ids, 0, None)])
    with torch.no_grad():
        fwd = halo.make_dist_forward_dense(model, group)(shards, attrs).numpy()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = halo.make_dist_train_step_dense(model, opt, group)
    losses = [step(shards, targets, attrs)["loss"].item() for _ in range(STEPS)]
    return part, fwd, losses


def write_problem(in_dir, use_pallas=False, **run):
    arrays, tgt, params, _ = _problem()
    dw.write_inputs(in_dir, *arrays, tgt, {**MODEL, "use_pallas": use_pallas},
                    _port_model(params, use_pallas).state_dict(), **{**RUN, **run})


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """The 2-process run: (report, results by rank, rank files, out dir)."""
    base = tmp_path_factory.mktemp("mh")
    write_problem(base / "in")
    report, results = dw.run_world(base / "in", base / "out", WORLD, device="cpu",
                                   env=WORKER_ENV, wall_timeout_s=240.0)
    assert report.ok and report.restarts == 0, (report, _logs(base / "out"))
    files = {r: dict(np.load(base / "out" / f"rank{r}.npz")) for r in range(WORLD)}
    return report, results, files, base / "out"


def _logs(out_dir) -> str:
    return "\n".join(p.read_text()[-3000:] for p in sorted(Path(out_dir).glob("log_*.txt")))


def test_two_process_ranks_agree(world_run):
    _, results, files, _ = world_run
    assert sorted(results) == list(range(WORLD))
    part, _, _ = _one_process()
    sha = dw.partition_digest(part)
    assert [results[r]["partition_sha"] for r in range(WORLD)] == [sha] * WORLD
    assert [results[r]["partitions"] for r in range(WORLD)] == [[0, 2], [2, 4]]
    assert results[0]["losses"] == results[1]["losses"]
    assert results[0]["state_sha"] == results[1]["state_sha"]
    params = [k for k in files[0] if k.startswith("param/")]
    assert params
    for k in params:
        assert files[0][k].tobytes() == files[1][k].tobytes(), k


def test_two_process_forward_is_the_one_process_forward_bit_for_bit(world_run):
    _, results, files, _ = world_run
    _, fwd, _ = _one_process()
    for r in range(WORLD):
        lo, hi = results[r]["partitions"]
        got = files[r]["forward"]
        assert got.shape == fwd[lo:hi].shape
        assert got.view(np.uint32).tobytes() == fwd[lo:hi].view(np.uint32).tobytes(), r


def test_two_process_loss_curve_matches_jax_and_one_process(world_run):
    _, results, _, _ = world_run
    got = results[0]["losses"]
    _, _, _, want_jax = _problem()
    _, _, want_port = _one_process()
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want_jax, rtol=1e-6)
    np.testing.assert_allclose(got, want_port, rtol=1e-6)
    assert got[0] == want_port[0]  # same forward, same ordered sum
    assert want_jax[2] < want_jax[0]


def test_two_process_run_writes_per_rank_checkpoints(world_run):
    _, _, _, out = world_run
    names = set(os.listdir(out / "ckpt"))
    for s in range(1, STEPS + 1):
        assert {f"ckpt_{s}.p0.npz", f"ckpt_{s}.p1.npz", f"ckpt_{s}.json"} <= names
    manifest = json.loads((out / "ckpt" / f"ckpt_{STEPS}.json").read_text())
    assert manifest["num_processes"] == WORLD and manifest["step"] == STEPS
    assert latest_step(str(out / "ckpt")) == STEPS


def test_single_rank_process_group_is_the_one_process_runner():
    """A gloo group of one rank owns every partition and runs the
    one-process path: the same forward and losses, bit for bit."""
    import torch.distributed as dist

    arrays, tgt, params, _ = _problem()
    part, fwd, losses = _one_process()
    assert mh.init_distributed(f"tcp://127.0.0.1:{dw._free_port()}", world_size=1) is False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{dw._free_port()}",
                            world_size=1, rank=0)
    try:
        group = halo.PartitionGroup(PARTS, "cpu", dist.group.WORLD)
        assert (group.world, group.lo, group.hi, group.num_local) == (1, 0, PARTS, PARTS)
        model = _port_model(params)
        shards = halo.shard_partitioned_dense(part, group)
        attrs = halo.make_dist_geometry_dense(model, group)(shards)
        with torch.no_grad():
            got = halo.make_dist_forward_dense(model, group)(shards, attrs).numpy()
        assert got.tobytes() == fwd.tobytes()
        step = halo.make_dist_train_step_dense(
            model, torch.optim.Adam(model.parameters(), lr=1e-3), group)
        targets = torch.from_numpy(tgt[np.clip(part.global_ids, 0, None)])
        assert [step(shards, targets, attrs)["loss"].item() for _ in range(STEPS)] == losses
    finally:
        dist.destroy_process_group()


def test_checkpoint_completeness(tmp_path):
    """A step counts once its manifest exists; a manifest without this
    process's file is an incomplete checkpoint, an error."""
    _, _, params, _ = _problem()
    model = _port_model(params)
    state = make_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1))
    save_checkpoint(str(tmp_path), 1, state)
    (tmp_path / "ckpt_2.p0.npz").write_bytes((tmp_path / "ckpt_1.npz").read_bytes())
    assert latest_step(str(tmp_path)) == 1  # step 2's ranks never all wrote
    (tmp_path / "ckpt_1.npz").unlink()
    with pytest.raises(ValueError, match="incomplete"):
        restore_checkpoint(str(tmp_path), state, step=1)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), state, step=7)


def test_restore_under_another_world_size_raises(world_run):
    """This process is a world of one; the checkpoint was written by two."""
    _, _, _, out = world_run
    _, _, params, _ = _problem()
    model = _port_model(params)
    state = make_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    with pytest.raises(ValueError, match="written by 2 processes, not 1"):
        restore_checkpoint(str(out / "ckpt"), state)


_CKPT_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np, torch
    from scalable_e3_gnn_torch.parallel.dense_worker import setup
    from scalable_e3_gnn_torch.train.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint)

    r = setup(sys.argv[1], "cpu")
    ckdir = sys.argv[2]
    params = lambda: [p.detach().clone() for p in r.model.parameters()]
    opt_state = lambda: [v.clone() for e in r.state.optimizer.state_dict()["state"].values()
                         for v in e.values()]
    r.step(r.shards, r.targets, r.attrs)
    r.state.step = 1
    save_checkpoint(ckdir, 1, r.state, extra={"tag": "mh"})
    assert latest_step(ckdir) == 1
    snap, snap_opt = params(), opt_state()
    # branch A: continue without restore
    la = r.step(r.shards, r.targets, r.attrs)["loss"].item()
    pa = params()
    # branch B: restore the saved step and continue
    _, got = restore_checkpoint(ckdir, r.state)
    assert got == 1 and r.state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(snap, params()))
    assert all(torch.equal(a, b) for a, b in zip(snap_opt, opt_state()))
    lb = r.step(r.shards, r.targets, r.attrs)["loss"].item()
    assert la == lb, (la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, params()))
    print("CKLOSS " + json.dumps([r.group.rank, la]), flush=True)
    torch.distributed.destroy_process_group()
    """
)


def test_two_process_checkpoint_round_trip(tmp_path):
    """JAX's protocol (tests/test_multihost.py:231-276) on the port's
    per-rank checkpoints: both branches continue bit for bit."""
    write_problem(tmp_path / "in")
    script = tmp_path / "ck_worker.py"
    script.write_text(_CKPT_WORKER)
    port = dw._free_port()
    ckdir = tmp_path / "ckpts"
    procs = []
    for rank in range(WORLD):
        env = {**os.environ, **WORKER_ENV, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(WORLD), "RANK": str(rank),
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen([sys.executable, str(script), str(tmp_path / "in"),
                                       str(ckdir)], env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("two-process checkpoint run timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    got = [json.loads(ln[len("CKLOSS "):]) for out in outs for ln in out.splitlines()
           if ln.startswith("CKLOSS ")]
    assert sorted(r for r, _ in got) == [0, 1]
    assert got[0][1] == got[1][1]
    names = set(os.listdir(ckdir))
    assert {"ckpt_1.p0.npz", "ckpt_1.p1.npz", "ckpt_1.json"} <= names
    assert json.loads((ckdir / "ckpt_1.json").read_text())["extra"] == {"tag": "mh"}
