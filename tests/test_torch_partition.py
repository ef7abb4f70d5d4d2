"""PyTorch port, the dense partitioner and the reverse-table gather.

``parallel.partition.partition_graph_dense`` against the JAX package's (which
runs its native helpers where they are built): every array bit for bit at P =
1, 2, 4, on a symmetrized and an unsymmetrized graph.  ``ops.gather_scatter.
take_dense_rev`` against the JAX ``take_dense_rev``: the forward bit for bit,
the VJP bit for bit in fp32 with the one-shot column sum (q <= 16) and the
16-column blocks (q > 16), and in bf16 likewise (both sum each block's
columns in fp32 and round once, as the port's reverse-slot gathers do).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.ops.gather_scatter import take_dense_rev as j_take_dense_rev
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition
from scalable_e3_gnn_torch.ops.gather_scatter import rev_gather_sum, take_dense_rev
from scalable_e3_gnn_torch.parallel.partition import (DensePartitionedGraph,
                                                      partition_graph_dense)

LO, HI = (-4.0,) * 3, (4.0,) * 3


@functools.lru_cache(maxsize=None)
def _graph_arrays(symmetrize, n=256, k=16, seed=0):
    """(positions, features, senders, edge_mask) of a JAX dense graph, numpy."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=k))(tree.points)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), tree.points, e, symmetrize=symmetrize)
    return (np.array(g.positions), np.array(g.nodes), np.array(g.senders),
            np.array(g.edge_mask))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("num_parts", [1, 2, 4])
def test_partition_matches_jax_bitwise(num_parts, symmetrize):
    args = _graph_arrays(symmetrize)
    ref = j_partition(*args, num_parts=num_parts)
    got = partition_graph_dense(*args, num_parts=num_parts)
    assert isinstance(got, DensePartitionedGraph)
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert got.n_per_part == ref.n_per_part


def test_partition_structures():
    """Every valid edge lies in exactly one block, interior senders are
    local, every node appears once, halo slots hold their owners' positions."""
    pos, feats, senders, mask = _graph_arrays(False)
    part = partition_graph_dense(pos, feats, senders, mask, num_parts=4)
    assert int(part.mask_int.sum()) + int(part.mask_bnd.sum()) == int(mask.sum())
    npp, hcap = part.n_per_part, part.halo_cap
    assert (part.senders_int[part.mask_int] < npp).all()
    gids = part.global_ids[part.global_ids >= 0]
    assert sorted(gids.tolist()) == list(range(len(pos)))
    for p in range(4):
        for j in range(hcap):
            if (part.positions_ext[p, npp + j] == 0).all():
                continue
            q, slot = divmod(int(part.halo_map[p, j]), hcap)
            gid = part.global_ids[q, part.boundary_idx[q, slot]]
            np.testing.assert_array_equal(part.positions_ext[p, npp + j], pos[gid])


def _rev_case(which):
    """(h rows M, senders [R, K], rev [M, Q]) of one receiver block: the
    unsymmetrized graph's P=1 interior block has q = 22 (> 16: the blocked
    sum), its P=4 interior block q = 10."""
    args = _graph_arrays(False)
    if which == "q>16":
        part = partition_graph_dense(*args, num_parts=1)
    else:
        part = partition_graph_dense(*args, num_parts=4)
    s, rev = part.senders_int[0], part.rev_int[0]
    return part.n_per_part, s, rev


@pytest.mark.parametrize("which", ["q<=16", "q>16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_dense_rev_matches_jax_bitwise(which, dtype):
    m, senders, rev = _rev_case(which)
    assert (rev.shape[1] > 16) == (which == "q>16")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((m, 12)).astype(np.float32)
    g = rng.standard_normal(senders.shape + (12,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jh, jg = jnp.asarray(h, jdt), jnp.asarray(g, jdt)
    out, vjp = jax.vjp(lambda x: j_take_dense_rev(x, jnp.asarray(senders), jnp.asarray(rev)), jh)
    (d_ref,) = vjp(jg)

    th = torch.from_numpy(h).to(tdt).requires_grad_(True)
    got = take_dense_rev(th, torch.from_numpy(senders), torch.from_numpy(rev))
    got.backward(torch.from_numpy(g).to(tdt))
    as_np = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    np.testing.assert_array_equal(got.detach().float().numpy(), as_np(out))
    np.testing.assert_array_equal(th.grad.float().numpy(), as_np(d_ref))
    # the gradient is the reverse-table sum on its own
    d2 = rev_gather_sum(torch.from_numpy(g).to(tdt), torch.from_numpy(rev))
    assert torch.equal(d2, th.grad)
