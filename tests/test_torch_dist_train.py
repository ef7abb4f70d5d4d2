"""PyTorch port, the dense partitioned train step.

Against the JAX package on its 8-virtual-CPU mesh, with the JAX weights
carried over by ``params_from_jax``:
- the gradients of ``make_dist_train_step_dense`` (both exchange backends,
  P = 1, 2, 4, the plain message path; and P = 4 with the message kernels'
  dispatch, their plain versions here, at lmax 1 and 2) against the
  gradients of JAX's unpartitioned plain model: max abs 5e-5, the limit of
  ``test_dense_gradient_parity_through_halo``; the loss rtol 1e-6;
- a 3-step loss curve (Adam 1e-3) against JAX's ``make_dist_train_step_dense``
  at P = 4: fp32 losses within 1e-6 relative (one reduction in another
  order), and with bf16 compute on fp32 masters within 3e-4 (the bf16 loss
  rtol of the port's other loss curves: bf16 rounds at other places in the
  two frameworks).
"""

import functools

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
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.parallel import halo as thalo
from scalable_e3_gnn_torch.parallel.partition import partition_graph_dense
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

LO, HI = (-4.0,) * 3, (4.0,) * 3
N = 256
HIDDEN = {1: "16x0e+8x1o", 2: "8x0e+4x1o+2x2e"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem():
    """The graph and target of tests/test_distributed_dense.py at n=256."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=16))(tree.points)
    feats = rng.standard_normal((N, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), tree.points, e)
    tgt = rng.standard_normal((N, 3)).astype(np.float32)
    arrays = (np.array(g.positions), np.array(g.nodes), np.array(g.senders),
              np.array(g.edge_mask))
    return g, tgt, arrays


def _jax_model(lmax):
    return JSEGNN(JIrreps("2x0e+1x1o"), JIrreps(HIDDEN[lmax]), JIrreps("1x1o"), num_layers=2,
                  layout="cm", use_pallas=False, lmax_attr=lmax)


@functools.lru_cache(maxsize=None)
def _jax_grads(lmax):
    """JAX's unpartitioned plain model: (params, loss, gradients)."""
    g, tgt, _ = _problem()
    jm = _jax_model(lmax)
    params = jm.init(jax.random.key(2))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_mse(jm(p, g), jnp.asarray(tgt))))(params)
    return params, float(loss), jax.tree.map(np.asarray, grads)


def _port(lmax, use_pallas, params, num_parts):
    _, tgt, arrays = _problem()
    tm = TSEGNN("2x0e+1x1o", HIDDEN[lmax], "1x1o", num_layers=2, layout="cm",
                use_pallas=use_pallas, lmax_attr=lmax, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    part = partition_graph_dense(*arrays, num_parts=num_parts)
    group = thalo.PartitionGroup(num_parts, device="cpu")
    shards = thalo.shard_partitioned_dense(part, group)
    targets = torch.from_numpy(tgt[np.clip(part.global_ids, 0, None)])
    return tm, group, shards, targets


def _check_grads(tm, step, shards, targets, lmax):
    params, loss, ref = _jax_grads(lmax)
    m = step(shards, targets)
    got = params_to_jax(tm, grad=True)
    worst = max(float(np.abs(a - b).max()) for a, b in
                zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True))
    assert worst < 5e-5, worst
    np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-6)


@pytest.mark.parametrize("backend", thalo.BACKENDS)
@pytest.mark.parametrize("num_parts", [1, 2, 4])
def test_dist_gradients_match_jax_unpartitioned(num_parts, backend):
    """The plain message path through the halo exchange (JAX's
    test_dense_gradient_parity_through_halo)."""
    params, _, _ = _jax_grads(1)
    tm, group, shards, targets = _port(1, False, params, num_parts)
    step = thalo.make_dist_train_step_dense(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                            group, backend)
    _check_grads(tm, step, shards, targets, 1)


@pytest.mark.parametrize("backend", thalo.BACKENDS)
@pytest.mark.parametrize("lmax", [1, 2])
def test_dist_gradients_kernels_engaged_match_jax_unpartitioned(lmax, backend):
    """P=4 through the message kernels' autograd Functions (#3/#5 at lmax 1,
    #11/#12 at lmax 2; plain versions on the CPU) and take_dense_rev."""
    params, _, _ = _jax_grads(lmax)
    tm, group, shards, targets = _port(lmax, True, params, 4)
    step = thalo.make_dist_train_step_dense(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                            group, backend)
    _check_grads(tm, step, shards, targets, lmax)


def _bf16_inputs(shards, attrs):
    bf = torch.bfloat16
    shards = [sh._replace(nodes=sh.nodes.to(bf), positions_ext=sh.positions_ext.to(bf))
              for sh in shards]
    return shards, [tuple(a.to(bf) for a in at) for at in attrs]


@functools.lru_cache(maxsize=None)
def _jax_loss_curve(bf16):
    """Three steps of JAX's make_dist_train_step_dense at P=4 (plain, "xla",
    Adam 1e-3, precomputed attributes; bf16 as bench_scaling.py's measure)."""
    _, tgt, arrays = _problem()
    jm = _jax_model(1)
    params = jm.init(jax.random.key(9))
    part = j_partition(*arrays, num_parts=4)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("graph",))
    args = jhalo.shard_partitioned_dense(part, mesh)
    attrs = jhalo.make_dist_geometry_dense(jm, mesh)(args)
    compute_dtype = None
    if bf16:
        bf = jnp.bfloat16
        args = tuple(x.astype(bf) if x.dtype == jnp.float32 else x for x in args)
        attrs = jax.tree.map(lambda x: x.astype(bf) if x.dtype == jnp.float32 else x, attrs)
        compute_dtype = bf
    opt = optax.adam(1e-3)
    step = jhalo.make_dist_train_step_dense(jm, opt, mesh, compute_dtype=compute_dtype)
    st = make_train_state(jax.tree.map(jnp.copy, params), opt)
    tgt_sh = jnp.asarray(tgt[np.clip(part.global_ids, 0, None)])
    losses = []
    for _ in range(3):
        st, m = step(st, args, tgt_sh, attrs)
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.parametrize("backend", thalo.BACKENDS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_dist_loss_curve_matches_jax(bf16, backend):
    params, want = _jax_loss_curve(bf16)
    tm, group, shards, targets = _port(1, False, params, 4)
    attrs = thalo.make_dist_geometry_dense(tm, group)(shards)
    if bf16:
        shards, attrs = _bf16_inputs(shards, attrs)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    step = thalo.make_dist_train_step_dense(tm, opt, group, backend,
                                            compute_dtype=torch.bfloat16 if bf16 else None)
    got = [step(shards, targets, attrs)["loss"].item() for _ in range(3)]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(got, want, rtol=3e-4 if bf16 else 1e-6)
    assert want[2] < want[0]
