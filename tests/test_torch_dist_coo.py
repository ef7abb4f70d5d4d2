"""PyTorch port, the COO partitioned path.

Against the JAX package on its 8-virtual-CPU mesh, on the graphs and models
of ``tests/test_distributed.py`` (512 points, radius 0.7, K=32; 2x0e+1x1o ->
8x0e+8x1o -> 1x1o), the JAX weights carried over by ``params_from_jax`` (the
COO path reads the same ``SEGNN`` parameters as the unpartitioned model):
- ``SEGNNLayer.apply_split`` on one partition against JAX's: 1e-6;
- the forward (``make_dist_forward``) at P = 2, 4, 8 against JAX's
  ``make_dist_forward`` and against the unpartitioned model (JAX's and the
  port's): 2e-5, JAX's ``test_partition_invariance_forward`` limit; ``ring``
  (kernel #15's plain version here) equals ``all_gather`` bit for bit, and
  the runner's own plans equal the shards';
- the SGD(1.0) step (``make_dist_train_step``) at P=8: the gradients against
  JAX's step and JAX's unpartitioned gradients within 5e-5 and the loss
  within 1e-6 relative (``test_gradient_parity_through_halo``);
- dp 2 x graph 4 (``CloudGroup``) on ``test_dp_times_graph_mesh``'s clouds
  and caps: the gradients against JAX's ``dp_axis`` step and the gradient
  of the mean of the two clouds' losses within 5e-5;
- a ``vel_attr`` model's forward with velocities against JAX's
  ``_local_forward`` with them: 2e-5;
- ``ring`` across processes on distinct cards raises.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.graph.container import SteerableGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.parallel import halo as jhalo
from scalable_e3_gnn_tpu.parallel.partition import partition_graph as j_partition
from scalable_e3_gnn_tpu.train.pipeline import make_train_state, mse_loss as j_mse
from scalable_e3_gnn_torch.graph.container import SteerableGraph
from scalable_e3_gnn_torch.models.segnn import SEGNN
from scalable_e3_gnn_torch.parallel import halo
from scalable_e3_gnn_torch.parallel.partition import partition_graph
from scalable_e3_gnn_torch.train.pipeline import mse_loss
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

LO, HI = (-4.0,) * 3, (4.0,) * 3
HIDDEN = "8x0e+8x1o"
DP_CAPS = dict(halo_cap=256, edges_per_part=6000, local_edges_per_part=5000,
               remote_edges_per_part=3000)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem(n=512, seed=0, radius=0.7):
    """JAX's tests/test_distributed.py::_problem: the graph arrays (numpy),
    JAX's graph and the target."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, radius, max_neighbors=32))(tree.points)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    g = JGraph(nodes=jnp.asarray(feats), positions=tree.points, senders=e.senders,
               receivers=e.receivers, node_graph=jnp.zeros(n, jnp.int32),
               node_mask=jnp.ones(n, bool), edge_mask=e.mask, n_graphs=1)
    tgt = rng.standard_normal((n, 3)).astype(np.float32)
    arrays = (np.array(tree.points), feats, np.array(e.senders), np.array(e.receivers),
              np.array(e.mask))
    return arrays, g, tgt


def _jax_model(num_layers=2, vel_attr=False):
    return JSEGNN(JIrreps("2x0e+1x1o"), JIrreps(HIDDEN), JIrreps("1x1o"),
                  num_layers=num_layers, vel_attr=vel_attr)


def _port_model(params, num_layers=2, vel_attr=False):
    model = SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=num_layers, vel_attr=vel_attr,
                  device="cpu")
    return params_from_jax(model, jax.tree.map(np.asarray, params))


def _port_graph(arrays):
    pts, feats, s, r, m = (torch.from_numpy(np.asarray(a)) for a in arrays)
    n = pts.shape[0]
    return SteerableGraph(nodes=feats, positions=pts, senders=s, receivers=r,
                          node_graph=torch.zeros(n, dtype=torch.int32),
                          node_mask=torch.ones(n, dtype=torch.bool), edge_mask=m)


def _mesh(num_parts):
    return Mesh(np.array(jax.devices()[:num_parts]).reshape(num_parts), ("graph",))


def _shards(arrays, num_parts, **caps):
    part = partition_graph(*arrays, num_parts=num_parts, **caps)
    group = halo.PartitionGroup(num_parts, device="cpu")
    return part, group, halo.shard_partitioned(part, group)


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True))


def test_apply_split_matches_jax():
    """One layer on partition 0 of P=2, random local and halo features."""
    arrays, _, _ = _problem()
    jm = _jax_model()
    params = jm.init(jax.random.key(3))
    tm = _port_model(params)
    part, _, shards = _shards(arrays, 2)
    sh = shards[0]
    rng = np.random.default_rng(5)
    f = tm.hidden_irreps.dim
    h = rng.standard_normal((part.n_per_part, f)).astype(np.float32)
    h_ext = np.concatenate([h, rng.standard_normal((part.halo_cap, f)).astype(np.float32)])
    attrs = [a.numpy() for a in halo.local_attrs(tm, sh)]
    na = attrs[4]
    loc = (part.senders_loc[0], part.receivers_loc[0], part.mask_loc[0], attrs[0], attrs[1])
    rem = (part.senders_rem[0], part.receivers_rem[0], part.mask_rem[0], attrs[2], attrs[3])
    nm = part.node_mask[0]
    want = np.asarray(jax.jit(lambda p, *xs: jm.layers[0].apply_split(p, *xs))(
        params["layer_0"], h, h_ext, tuple(map(jnp.asarray, loc)), tuple(map(jnp.asarray, rem)),
        na, nm))
    t = torch.from_numpy
    with torch.no_grad():
        got = tm.layers[0].apply_split(t(h), t(h_ext), tuple(map(t, loc)), tuple(map(t, rem)),
                                       t(na), t(nm), *sh.plans)
        halves = tm.layers[0].apply_split_remote(
            t(h), t(h_ext), tm.layers[0].apply_split_local(t(h), tuple(map(t, loc))),
            tuple(map(t, rem)), t(na), t(nm))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(got, halves)  # the halves, plans made on the fly


@functools.lru_cache(maxsize=None)
def _jax_forward(num_parts):
    arrays, g, _ = _problem()
    jm = _jax_model()
    params = jm.init(jax.random.key(0))
    ref = np.array(jax.jit(jm.__call__)(params, g))
    mesh = _mesh(num_parts)
    jpart = j_partition(*arrays, num_parts=num_parts)
    out = np.array(jhalo.make_dist_forward(jm, mesh)(params, jhalo.shard_partitioned(jpart,
                                                                                    mesh)))
    return params, ref, out


@pytest.mark.parametrize("num_parts", [2, 4, 8])
def test_dist_forward_matches_jax(num_parts):
    arrays, _, _ = _problem()
    params, ref, jout = _jax_forward(num_parts)
    tm = _port_model(params)
    _, group, shards = _shards(arrays, num_parts)
    with torch.no_grad():
        out = halo.make_dist_forward(tm, group)(shards).numpy()
        uni = tm(_port_graph(arrays)).numpy()
    assert out.shape == jout.shape
    np.testing.assert_allclose(out, jout, atol=2e-5)
    got = out.reshape(-1, ref.shape[-1])[:ref.shape[0]]
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, uni, atol=2e-5)
    np.testing.assert_allclose(uni, ref, atol=2e-5)


def test_ring_equals_all_gather_and_plans_made_on_the_fly():
    arrays, _, _ = _problem()
    params, _, _ = _jax_forward(4)
    tm = _port_model(params)
    _, group, shards = _shards(arrays, 4)
    with torch.no_grad():
        ag = halo.make_dist_forward(tm, group, "all_gather")(shards)
        ring = halo.make_dist_forward(tm, group, "ring")(shards)
        bare = halo.make_dist_forward(tm, group)([sh._replace(plans=None) for sh in shards])
    assert torch.equal(ring, ag)
    assert torch.equal(bare, ag)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's test_gradient_parity_through_halo: the unpartitioned gradients
    and loss, and the P=8 SGD(1.0) step's parameter change and loss."""
    arrays, g, tgt = _problem()
    jm = _jax_model()
    params = jm.init(jax.random.key(1))
    loss, gs = jax.jit(jax.value_and_grad(lambda p: j_mse(jm(p, g), jnp.asarray(tgt))))(params)
    mesh = _mesh(8)
    jpart = j_partition(*arrays, num_parts=8)
    st = make_train_state(jax.tree.map(jnp.copy, params), optax.sgd(1.0))
    st2, m = jhalo.make_dist_train_step(jm, optax.sgd(1.0), mesh)(
        st, jhalo.shard_partitioned(jpart, mesh), jnp.asarray(tgt.reshape(8, -1, 3)))
    gd = jax.tree.map(lambda a, b: np.asarray(a - b), params, st2.params)
    return params, float(loss), jax.tree.map(np.asarray, gs), gd, float(m["loss"])


@pytest.mark.parametrize("backend", halo.BACKENDS)
def test_dist_train_step_gradients_match_jax(backend):
    arrays, _, tgt = _problem()
    params, loss, gs, gd, jloss = _jax_step()
    tm = _port_model(params)
    part, group, shards = _shards(arrays, 8)
    targets = torch.from_numpy(tgt[np.clip(part.global_ids, 0, None)])
    step = halo.make_dist_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0), group,
                                     backend)
    m = step(shards, targets)
    got = params_to_jax(tm, grad=True)
    assert _max_diff(got, gs) < 5e-5
    assert _max_diff(got, gd) < 5e-5
    np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-6)
    np.testing.assert_allclose(m["loss"].item(), jloss, rtol=1e-6)
    # the port's unpartitioned gradients too
    ref = _port_model(params)
    mse_loss(ref(_port_graph(arrays)), torch.from_numpy(tgt)).backward()
    assert _max_diff(got, params_to_jax(ref, grad=True)) < 5e-5


@functools.lru_cache(maxsize=None)
def _jax_dp():
    """JAX's test_dp_times_graph_mesh: two clouds (seeds 10, 11) x P=4 under
    fixed caps; the gradient of the mean of their losses and the dp step's
    parameter change."""
    jm = _jax_model(num_layers=1)
    params = jm.init(jax.random.key(2))
    clouds = [_problem(seed=10 + d) for d in range(2)]
    jparts = [j_partition(*c[0], num_parts=4, **DP_CAPS) for c in clouds]
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "graph"))
    stacked = tuple(jnp.stack([a, b]) for a, b in
                    zip(jhalo._shard_args(jparts[0]), jhalo._shard_args(jparts[1])))
    tgt_sh = jnp.stack([jnp.asarray(c[2].reshape(4, -1, 3)) for c in clouds])
    step = jhalo.make_dist_train_step(jm, optax.sgd(1.0), mesh, dp_axis="dp")
    st = make_train_state(jax.tree.map(jnp.copy, params), optax.sgd(1.0))
    st2, m = step(st, stacked, tgt_sh)
    ref_loss = lambda p: sum(j_mse(jm(p, c[1]), jnp.asarray(c[2])) for c in clouds) / 2.0
    gs = jax.jit(jax.grad(ref_loss))(params)
    gd = jax.tree.map(lambda a, b: np.asarray(a - b), params, st2.params)
    return params, jax.tree.map(np.asarray, gs), gd, float(m["loss"])


def test_dp_times_graph_matches_jax():
    params, gs, gd, jloss = _jax_dp()
    tm = _port_model(params, num_layers=1)
    group = halo.PartitionGroup(4, device="cpu")
    dp = halo.CloudGroup(2, group)
    assert (dp.lo, dp.hi, dp.rows) == (0, 2, 1)
    clouds = [_problem(seed=10 + d) for d in range(2)]
    parts = [partition_graph(*c[0], num_parts=4, **DP_CAPS) for c in clouds]
    shards = [halo.shard_partitioned(p, group) for p in parts]
    targets = torch.stack([torch.from_numpy(c[2].reshape(4, -1, 3)) for c in clouds])
    step = halo.make_dist_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0), group,
                                     dp=dp)
    m = step(shards, targets)
    got = params_to_jax(tm, grad=True)
    assert _max_diff(got, gs) < 5e-5
    assert _max_diff(got, gd) < 5e-5
    np.testing.assert_allclose(m["loss"].item(), jloss, rtol=1e-6)


def test_vel_attr_forward_matches_jax():
    """Velocities enter the node attributes (sh(v) added to the mean of the
    edge attributes over both lists, the scalar channel then 1)."""
    arrays, _, _ = _problem()
    jm = _jax_model(vel_attr=True)
    params = jm.init(jax.random.key(4))
    jpart = j_partition(*arrays, num_parts=4)
    vel = np.random.default_rng(7).standard_normal((arrays[0].shape[0], 3)).astype(np.float32)
    vel_sh = vel[np.clip(jpart.global_ids, 0, None)]
    mesh = _mesh(4)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(), (P("graph"),) * 11, P("graph")),
                       out_specs=P("graph"), check_vma=False)
    def fwd(p, shard, v):
        shard = tuple(x[0] for x in shard)
        return jhalo._local_forward(jm, p, shard, "graph", velocities=v[0], num_devices=4)[None]

    want = np.asarray(jax.jit(fwd)(params, jhalo.shard_partitioned(jpart, mesh),
                                   jnp.asarray(vel_sh)))
    tm = _port_model(params, vel_attr=True)
    _, group, shards = _shards(arrays, 4)
    with torch.no_grad():
        run = halo.make_dist_forward(tm, group)
        got = run(shards, torch.from_numpy(vel_sh)).numpy()
        still = run(shards).numpy()
        uni = tm(_port_graph(arrays), velocities=torch.from_numpy(vel)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got.reshape(-1, 3)[:vel.shape[0]], uni, atol=2e-5)
    assert np.abs(got - still).max() > 1e-3  # the velocities do reach the output


def test_ring_raises_across_processes(monkeypatch):
    """Ranks on distinct cards: the COO runners raise when built (the ring
    between processes maps its peers' memory on one card)."""
    tm = SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=1, device="cpu")
    group = halo.PartitionGroup(4, "cpu")
    group.world = 2  # as a two-rank group would be
    group.device = torch.device("cuda", 0)  # as the ranks' cards would be
    monkeypatch.setattr(halo, "card_identities", lambda dev, pg: ["GPU-0aaa", "GPU-1bbb"])
    with pytest.raises(NotImplementedError, match="A3b"):
        halo.make_dist_forward(tm, group, "ring")
    with pytest.raises(NotImplementedError, match="A3b"):
        halo.make_dist_train_step(tm, torch.optim.SGD(tm.parameters(), lr=0.1), group, "ring")
