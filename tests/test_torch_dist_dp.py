"""PyTorch port, data parallelism over clouds on the partitioned train steps.

- The dense dp step (``make_dist_train_step_dense(..., dp=CloudGroup(2))``)
  on the setup of JAX's ``test_dense_dp_times_graph_mesh`` (two 256-point
  clouds, P=4, halo_cap=160, interior_cap=96, boundary_cap=96, the reverse
  tables padded to one width): its SGD(1.0) gradients within 5e-5 of JAX's
  ``dp_axis="dp"`` step and of the gradient of the mean of the two clouds'
  losses, on the plain message path and with the message kernels' dispatch
  (their plain versions here).
- ``CloudGroup``: the (cloud, partition) order of values gathered in rank
  order, and its errors.
- A 4-process gloo world on the CPU (``dense_worker.run_world``; 2 dp rows x
  2 graph ranks, each rank one cloud and two of the four partitions; two
  128-point clouds, fp32, 3 Adam 1e-3 steps): each rank's forward equals the
  one-process forward of its cloud's partitions bit for bit; the ranks'
  parameters and optimizer states are equal bit for bit; the losses lie
  within 1e-6 relative of the one-process dp curve (the first bit for bit).
"""

import functools
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
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.parallel import halo as jhalo
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition
from scalable_e3_gnn_tpu.train.pipeline import make_train_state, mse_loss as j_mse
from scalable_e3_gnn_torch.models.segnn import SEGNN
from scalable_e3_gnn_torch.parallel import dense_worker as dw
from scalable_e3_gnn_torch.parallel import halo
from scalable_e3_gnn_torch.parallel.partition import partition_graph_dense, shared_caps
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

LO, HI = (-4.0,) * 3, (4.0,) * 3
CAPS = dict(halo_cap=160, interior_cap=96, boundary_cap=96)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread, as the workers (OMP_NUM_THREADS=1):
    the suite runs several workers on the same cores, and a CPU GEMM's bits
    may depend on its thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem(n=256, seed=0, radius=0.7, k=16):
    """JAX's tests/test_distributed_dense.py::_problem: the graph arrays
    (numpy), JAX's graph and the target."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, radius, max_neighbors=k))(tree.points)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), tree.points, e)
    tgt = rng.standard_normal((n, 3)).astype(np.float32)
    arrays = (np.array(g.positions), np.array(g.nodes), np.array(g.senders),
              np.array(g.edge_mask))
    return arrays, g, tgt


def _pad_rev(parts):
    """The reverse tables of every cloud padded to one width (+1 encoding:
    0 is empty, so zero columns are exact), as JAX's dp test stacks them."""
    def pad(a, q):
        out = np.zeros(a.shape[:-1] + (q,), a.dtype)
        out[..., :a.shape[-1]] = a
        return out

    qi = max(p.rev_int.shape[-1] for p in parts)
    qb = max(p.rev_ext.shape[-1] for p in parts)
    return [p._replace(rev_int=pad(p.rev_int, qi), rev_ext=pad(p.rev_ext, qb)) for p in parts]


@functools.lru_cache(maxsize=None)
def _jax_dp():
    jm = JSEGNN(JIrreps("2x0e+1x1o"), JIrreps("16x0e+8x1o"), JIrreps("1x1o"), num_layers=1,
                layout="cm", use_pallas=False, lmax_attr=1)
    params = jm.init(jax.random.key(6))
    clouds = [_problem(seed=20 + d) for d in range(2)]
    parts = _pad_rev([j_partition(*c[0], num_parts=4, **CAPS) for c in clouds])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "graph"))
    stacked = tuple(jnp.stack([a, b]) for a, b in
                    zip(jhalo._shard_args_dense(parts[0]), jhalo._shard_args_dense(parts[1])))
    tgt_sh = jnp.stack([jnp.asarray(c[2][np.clip(p.global_ids, 0, None)])
                        for p, c in zip(parts, clouds)])
    step = jhalo.make_dist_train_step_dense(jm, optax.sgd(1.0), mesh, dp_axis="dp")
    st = make_train_state(jax.tree.map(jnp.copy, params), optax.sgd(1.0))
    st2, m = step(st, stacked, tgt_sh)
    ref_loss = lambda p: sum(j_mse(jm(p, c[1]), jnp.asarray(c[2])) for c in clouds) / 2.0
    loss, gs = jax.jit(jax.value_and_grad(ref_loss))(params)
    gd = jax.tree.map(lambda a, b: np.asarray(a - b), params, st2.params)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, gs), gd,
            float(m["loss"]), float(loss))


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_dense_dp_step_matches_jax(use_pallas):
    params, gs, gd, jloss, loss = _jax_dp()
    tm = SEGNN("2x0e+1x1o", "16x0e+8x1o", "1x1o", num_layers=1, layout="cm",
               use_pallas=use_pallas, device="cpu")
    params_from_jax(tm, params)
    group = halo.PartitionGroup(4, device="cpu")
    dp = halo.CloudGroup(2, group)
    clouds = [_problem(seed=20 + d) for d in range(2)]
    parts = _pad_rev([partition_graph_dense(*c[0], num_parts=4, **CAPS) for c in clouds])
    shards = [halo.shard_partitioned_dense(p, group) for p in parts]
    targets = torch.stack([torch.from_numpy(c[2][np.clip(p.global_ids, 0, None)])
                           for p, c in zip(parts, clouds)])
    step = halo.make_dist_train_step_dense(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                           group, dp=dp)
    m = step(shards, targets)
    got = params_to_jax(tm, grad=True)
    assert _max_diff(got, gs) < 5e-5
    assert _max_diff(got, gd) < 5e-5
    np.testing.assert_allclose(m["loss"].item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-6)


def test_cloud_group_orders_values_cloud_major():
    group = halo.PartitionGroup(4, device="cpu")
    dp = halo.CloudGroup(2, group)
    assert (dp.world, dp.rows, dp.lo, dp.hi) == (1, 1, 0, 2)
    # as two graph ranks of one dp row would hold them: rank r has clouds 0
    # and 1, partitions 2r and 2r+1
    dp.world, dp.graph_ranks = 2, 2
    rank_order = torch.tensor([0, 1, 4, 5, 2, 3, 6, 7])  # c*4 + p
    assert dp.cloud_major(rank_order).tolist() == list(range(8))
    # two dp rows of two graph ranks, one cloud each
    dp.world, dp.rows, dp.lo, dp.hi = 4, 2, 0, 1
    assert dp.cloud_major(torch.arange(8)).tolist() == list(range(8))


def test_cloud_group_errors():
    group = halo.PartitionGroup(4, device="cpu")
    with pytest.raises(ValueError, match="at least 1"):
        halo.CloudGroup(0, group)
    group.world = 2  # as a two-rank group would be
    with pytest.raises(ValueError, match="every rank"):
        halo.CloudGroup(2, group)
    model = SEGNN("2x0e+1x1o", "4x0e+2x1o", "1x1o", num_layers=1, device="cpu")
    with pytest.raises(ValueError, match="graph ranks"):
        halo.make_dist_train_step_dense(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                        group, dp=halo.CloudGroup(2, halo.PartitionGroup(4, "cpu")))


# ---------------------------------------------------------------------------
# four gloo processes: 2 dp rows x 2 graph ranks
# ---------------------------------------------------------------------------

WORLD, PARTS, CLOUDS, STEPS = 4, 4, 2, 3
MODEL = dict(input_irreps="2x0e+1x1o", hidden_irreps="8x0e+4x1o", output_irreps="1x1o",
             num_layers=2, layout="cm")


@functools.lru_cache(maxsize=None)
def _clouds():
    """Two 128-point clouds (K=8, radius 0.8, the setup of
    tests/test_multihost.py) and seeded weights."""
    clouds = [_problem(n=128, seed=s, radius=0.8, k=8) for s in (30, 31)]
    model = SEGNN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(0))
    return clouds, {k: v.clone() for k, v in model.state_dict().items()}


def _model(weights):
    model = SEGNN(**MODEL, device="cpu")
    model.load_state_dict(weights)
    return model


@functools.lru_cache(maxsize=None)
def _one_process():
    """The one-process dp runner: each cloud's forward and the 3-step curve."""
    clouds, weights = _clouds()
    parts = [partition_graph_dense(*c[0], num_parts=PARTS) for c in clouds]
    caps = shared_caps(parts)
    parts = [partition_graph_dense(*c[0], num_parts=PARTS, **caps) for c in clouds]
    model = _model(weights)
    group = halo.PartitionGroup(PARTS, "cpu")
    dp = halo.CloudGroup(CLOUDS, group)
    shards = [halo.shard_partitioned_dense(p, group) for p in parts]
    attrs = [halo.make_dist_geometry_dense(model, group)(s) for s in shards]
    targets = torch.stack([torch.from_numpy(c[2][np.clip(p.global_ids, 0, None)])
                           for p, c in zip(parts, clouds)])
    with torch.no_grad():
        fwd = halo.make_dist_forward_dense(model, group)
        outs = [fwd(s, a).numpy() for s, a in zip(shards, attrs)]
    step = halo.make_dist_train_step_dense(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                           group, dp=dp)
    losses = [step(shards, targets, attrs)["loss"].item() for _ in range(STEPS)]
    return parts, outs, losses


def _logs(out_dir) -> str:
    return "\n".join(p.read_text()[-3000:] for p in sorted(Path(out_dir).glob("log_*.txt")))


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    """The 4-process run: (results by rank, rank files)."""
    base = tmp_path_factory.mktemp("dp")
    clouds, weights = _clouds()
    stack = lambda i: np.stack([c[0][i] for c in clouds])
    dw.write_inputs(base / "in", stack(0), stack(1), stack(2), stack(3),
                    np.stack([c[2] for c in clouds]), MODEL, weights, num_parts=PARTS,
                    steps=STEPS, lr=1e-3, compute_dtype="float32", num_clouds=CLOUDS)
    report, results = dw.run_world(base / "in", base / "out", WORLD, device="cpu",
                                   env={"OMP_NUM_THREADS": "1"}, wall_timeout_s=240.0)
    assert report.ok and report.restarts == 0, (report, _logs(base / "out"))
    files = {r: dict(np.load(base / "out" / f"rank{r}.npz")) for r in range(WORLD)}
    return results, files


def test_dp_world_layout_is_dp_major(dp_world):
    results, _ = dp_world
    assert sorted(results) == list(range(WORLD))
    for r in range(WORLD):
        d, g = divmod(r, 2)
        assert results[r]["clouds"] == [d, d + 1]
        assert results[r]["partitions"] == [2 * g, 2 * g + 2]
    parts, _, _ = _one_process()
    sha = dw.partition_digest(*parts)
    assert all(results[r]["partition_sha"] == sha for r in range(WORLD))


def test_dp_world_forward_is_the_one_process_forward_bit_for_bit(dp_world):
    results, files = dp_world
    _, outs, _ = _one_process()
    for r in range(WORLD):
        (d, _), (lo, hi) = results[r]["clouds"], results[r]["partitions"]
        got = files[r]["forward"]
        want = outs[d][lo:hi][None]
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes(), r


def test_dp_world_ranks_hold_equal_parameters(dp_world):
    results, files = dp_world
    params = [k for k in files[0] if k.startswith("param/")]
    assert params
    for r in range(1, WORLD):
        assert results[r]["state_sha"] == results[0]["state_sha"]
        for k in params:
            assert files[r][k].tobytes() == files[0][k].tobytes(), (r, k)


def test_dp_world_losses_match_the_one_process_curve(dp_world):
    results, _ = dp_world
    _, _, want = _one_process()
    got = results[0]["losses"]
    assert all(results[r]["losses"] == got for r in range(WORLD))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == want[0]  # the same forward, the same ordered sum
    assert want[2] < want[0]
