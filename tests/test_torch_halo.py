"""PyTorch port, the halo exchange and the dense partitioned forward.

Against the JAX package on its 8-virtual-CPU mesh (``tests/conftest.py``):
- kernel #15's plain version (``kernels.halo_ring``) against
  ``ring_all_gather(interpret=True)`` at P = 2 and 4: the pools bit for bit
  (it only copies); the gradient, the reduce-scatter, as
  ``test_ring_all_gather_gradient`` checks JAX's;
- ``exchange_halo`` with both backends against JAX's ``exchange_halo``
  (``"xla"``, its hand transpose) on a real partition's index arrays: the
  extended features bit for bit, the gradients within 1e-6 (fp32 sums);
- ``make_dist_forward_dense`` with both backends against JAX's at P = 1, 2,
  4 (plain message path), and with the message kernels engaged (their plain
  versions here) at P = 4 for lmax 1 and 2 against JAX's unpartitioned plain
  forward, with the launches of the dispatch counted: atol 2e-5, the limit
  of JAX's own invariance tests (the same fp32 math, summed in another
  order);
- the partition geometry against JAX's, and precomputed attributes giving
  the same forward as attributes computed on the fly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.kernels.halo_rdma import ring_all_gather as j_ring
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.parallel import halo as jhalo
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition
from scalable_e3_gnn_torch.kernels import fused_message as tfm
from scalable_e3_gnn_torch.kernels import fused_message_generic as tfmg
from scalable_e3_gnn_torch.kernels import halo_ring
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.parallel import halo as thalo
from scalable_e3_gnn_torch.parallel.partition import partition_graph_dense
from scalable_e3_gnn_torch.utils.params import params_from_jax

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


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n), ("graph",))


@functools.lru_cache(maxsize=None)
def _graph():
    """The JAX dense graph of tests/test_distributed_dense.py (n=256, K=16,
    not symmetrized) and its arrays for the partitioner."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=16))(tree.points)
    feats = rng.standard_normal((N, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), tree.points, e)
    arrays = (np.array(g.positions), np.array(g.nodes), np.array(g.senders),
              np.array(g.edge_mask))
    return g, arrays


@functools.lru_cache(maxsize=None)
def _models(lmax, use_pallas, seed=1):
    jm = JSEGNN(JIrreps("2x0e+1x1o"), JIrreps(HIDDEN[lmax]), JIrreps("1x1o"), num_layers=2,
                layout="cm", use_pallas=False, lmax_attr=lmax)
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN("2x0e+1x1o", HIDDEN[lmax], "1x1o", num_layers=2, layout="cm",
                use_pallas=use_pallas, lmax_attr=lmax, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _jax_reference(lmax):
    """JAX's unpartitioned plain forward, [N, 3]."""
    g, _ = _graph()
    jm, params, _ = _models(lmax, False)
    return np.asarray(jax.jit(jm.__call__)(params, g))


@functools.lru_cache(maxsize=None)
def _jax_dist_forward(num_parts):
    """JAX's make_dist_forward_dense (plain, lmax 1) at P, [P, Np, 3]."""
    _, arrays = _graph()
    jm, params, _ = _models(1, False)
    part = j_partition(*arrays, num_parts=num_parts)
    mesh = _mesh(num_parts)
    fwd = jhalo.make_dist_forward_dense(jm, mesh)
    return np.asarray(fwd(params, jhalo.shard_partitioned_dense(part, mesh)))


def _port_shards(num_parts):
    _, arrays = _graph()
    part = partition_graph_dense(*arrays, num_parts=num_parts)
    group = thalo.PartitionGroup(num_parts, device="cpu")
    return part, group, thalo.shard_partitioned_dense(part, group)


def _unpermute(out, part):
    """[P, Np, F] partition rows -> [N, F] input order."""
    gids = part.global_ids.ravel()
    flat = out.reshape(-1, out.shape[-1])
    res = np.zeros((N, out.shape[-1]), flat.dtype)
    res[gids[gids >= 0]] = flat[gids >= 0]
    return res


@pytest.mark.parametrize("num_parts", [2, 4])
def test_ring_plain_matches_jax_ring_bitwise(num_parts):
    h, f = 8, 16
    x = np.random.default_rng(num_parts).standard_normal((num_parts, h, f)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:num_parts]).reshape(num_parts), ("x",))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                       check_vma=False)
    def ring(xb):
        return j_ring(xb[0], "x", num_parts, interpret=True)[None]

    ref = np.asarray(jax.jit(ring)(jnp.asarray(x)))
    got = halo_ring.ring_all_gather(torch.from_numpy(x))
    assert got.shape == (num_parts, num_parts, h, f)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(halo_ring.ring_all_gather_plain(torch.from_numpy(x)).numpy(),
                                  ref)


def test_ring_gradient_is_the_reduce_scatter():
    """As test_ring_all_gather_gradient: d/dx of sum_r |pool_r|^2 = 2 P x."""
    n = 4
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 8, 16))
                         .astype(np.float32)).requires_grad_(True)
    (halo_ring.ring_all_gather(x) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * n * x.detach().numpy(), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_exchange():
    """JAX exchange_halo ("xla", its hand transpose) at P=4 on the graph's
    partition arrays: (h, bidx, hmap, cotangent, h_ext, d_h)."""
    _, arrays = _graph()
    part = j_partition(*arrays, num_parts=4)
    rng = np.random.default_rng(7)
    npp, hcap = part.n_per_part, part.halo_cap
    h = rng.standard_normal((4, npp, 12)).astype(np.float32)
    ct = rng.standard_normal((4, npp + hcap, 12)).astype(np.float32)
    mesh = _mesh(4)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("graph"),) * 4,
                       out_specs=P(), check_vma=False)
    def loss(hb, bb, mb, cb):
        ext = jhalo.exchange_halo(hb[0], bb[0], mb[0], "graph", num_devices=4)
        return jax.lax.psum((ext * cb[0]).sum(), "graph")

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("graph"),) * 3,
                       out_specs=P("graph"), check_vma=False)
    def ext(hb, bb, mb):
        return jhalo.exchange_halo(hb[0], bb[0], mb[0], "graph", num_devices=4)[None]

    bidx, hmap = part.boundary_idx, part.halo_map
    out = np.asarray(jax.jit(ext)(h, bidx, hmap))
    d_h = np.asarray(jax.jit(jax.grad(loss))(h, bidx, hmap, ct))
    return h, bidx, hmap, ct, out, d_h


@pytest.mark.parametrize("backend", thalo.BACKENDS)
def test_exchange_halo_matches_jax(backend):
    h, bidx, hmap, ct, ref, d_ref = _jax_exchange()
    hs = [torch.from_numpy(x).requires_grad_(True) for x in h]
    ext = thalo.exchange_halo(hs, torch.from_numpy(bidx).long(), torch.from_numpy(hmap).long(),
                              backend)
    got = torch.stack(ext)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    (got * torch.from_numpy(ct)).sum().backward()
    d_got = np.stack([x.grad.numpy() for x in hs])
    np.testing.assert_allclose(d_got, d_ref, rtol=1e-6, atol=1e-6)


def test_exchange_halo_rejects_an_unknown_backend():
    _, _, shards = _port_shards(2)
    hs = [sh.nodes for sh in shards]
    bidx = torch.stack([sh.boundary_idx for sh in shards])
    hmap = torch.stack([sh.halo_map for sh in shards])
    with pytest.raises(ValueError):
        thalo.exchange_halo(hs, bidx, hmap, backend="xla")


@pytest.mark.parametrize("backend", thalo.BACKENDS)
@pytest.mark.parametrize("num_parts", [1, 2, 4])
def test_dist_forward_matches_jax(num_parts, backend):
    """The plain message path: partition rows against JAX's distributed
    forward, and un-permuted against JAX's unpartitioned forward."""
    _, _, tm = _models(1, False)
    part, group, shards = _port_shards(num_parts)
    with torch.no_grad():
        out = thalo.make_dist_forward_dense(tm, group, backend)(shards)
    assert out.shape == (num_parts, part.n_per_part, 3)
    np.testing.assert_allclose(out.numpy(), _jax_dist_forward(num_parts), atol=2e-5)
    np.testing.assert_allclose(_unpermute(out.numpy(), part), _jax_reference(1), atol=2e-5)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("backend", thalo.BACKENDS)
@pytest.mark.parametrize("lmax", [1, 2])
def test_dist_forward_kernels_engaged_match_jax_unpartitioned(monkeypatch, lmax, backend):
    """P=4 with the message kernels' dispatch (use_pallas; their plain
    versions on the CPU): 2 blocks x 4 partitions x 2 layers of the untabled
    forward (#3 at lmax 1, #11 at lmax 2), against JAX's unpartitioned plain
    forward."""
    _, _, tm = _models(lmax, True)
    assert tm.layers[0].use_pallas if lmax == 1 else tm.layers[0].use_pallas_generic
    if lmax == 1:
        calls = _count_calls(monkeypatch, tfm, "fused_message_aggregate_km_fwd")
    else:
        calls = _count_calls(monkeypatch, tfmg, "generic_fwd")
    part, group, shards = _port_shards(4)
    with torch.no_grad():
        out = thalo.make_dist_forward_dense(tm, group, backend)(shards)
    assert len(calls) == 2 * 4 * 2
    np.testing.assert_allclose(_unpermute(out.numpy(), part), _jax_reference(lmax), atol=2e-5)


@pytest.mark.parametrize("lmax", [1, 2])
def test_partition_geometry_matches_jax(lmax):
    """local_attrs_dense against JAX's _local_attrs_dense per partition
    (1e-6: the sh and the K-sums in another order), and precomputed
    attributes giving the forward of attributes computed on the fly."""
    _, arrays = _graph()
    jm, _, tm = _models(lmax, False)
    jpart = j_partition(*arrays, num_parts=4)
    part, group, shards = _port_shards(4)
    geo = thalo.make_dist_geometry_dense(tm, group)(shards)
    for p in range(4):
        ref = jhalo._local_attrs_dense(jm, tuple(jnp.asarray(x[p]) for x in
                                                 jhalo._shard_args_dense(jpart)))
        for a, b in zip(geo[p], ref, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    fwd = thalo.make_dist_forward_dense(tm, group)
    with torch.no_grad():
        torch.testing.assert_close(fwd(shards, geo), fwd(shards), rtol=0, atol=0)


def test_partition_group_runs_on_the_card_unless_told(monkeypatch):
    """Without a GPU and without ``device=``, the group (and so every
    partitioned entry point) raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        thalo.PartitionGroup(2)
    assert thalo.PartitionGroup(2, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        thalo.PartitionGroup(0, device="cpu")


def test_apply_dense_split_empty_block_and_rev_entry(monkeypatch):
    """A block without rows gives zeros and launches nothing: every row sent
    through the boundary block (the interior one empty) gives the layer of
    the two blocks, with one dispatch instead of two.  The fifth edge entry
    (the transpose table, take_dense_rev) gives the forward of the plain
    gather bit for bit and its gradients within 1e-6."""
    _, _, tm = _models(1, True)
    layer = tm.layers[0]
    _, group, shards = _port_shards(4)
    sh = shards[1]
    ai, d2i, ab, d2b, na = thalo.local_attrs_dense(tm, sh)
    rng = np.random.default_rng(11)
    npp, hcap = sh.nodes.shape[0], sh.halo_map.shape[0]
    h = torch.from_numpy(rng.standard_normal((npp, 40)).astype(np.float32))
    h_ext = torch.cat([h, torch.from_numpy(rng.standard_normal((hcap, 40)).astype(np.float32))])
    ints = (sh.senders_int, ai, d2i, sh.mask_int)
    bnds = (sh.senders_bnd, ab, d2b, sh.mask_bnd)
    calls = _count_calls(monkeypatch, tfm, "fused_message_aggregate_km_fwd")
    with torch.no_grad():
        two = layer.apply_dense_split(h, h_ext, ints, bnds, na, sh.node_mask)
        assert len(calls) == 2
        empty = tuple(x[:0] for x in ints)
        merged = tuple(torch.cat([a, b]) for a, b in zip(ints, bnds))
        one = layer.apply_dense_split(h, h_ext, empty, merged, na, sh.node_mask)
        assert len(calls) == 3
    torch.testing.assert_close(one, two, rtol=0, atol=1e-6)

    grads = []
    for rev in (False, True):
        x = h.clone().requires_grad_(True)
        xe = torch.cat([x, h_ext[npp:]])
        ie = ints + ((sh.rev_int,) if rev else ())
        be = bnds + ((sh.rev_ext,) if rev else ())
        out = layer.apply_dense_split(x, xe, ie, be, na, sh.node_mask)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append((out.detach(), x.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=0, atol=1e-6)
