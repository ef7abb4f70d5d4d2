"""PyTorch port, the COO partitioner and the caps of both partitioners.

``parallel.partition.partition_graph`` against the JAX package's: every
field bit for bit at P = 1, 2, 4, 8, without caps and with caps above the
need, on the graph of ``tests/test_distributed.py`` (512 points, radius 0.7,
K=32, brute force); every cap error raised where JAX raises it; the
structures of JAX's ``test_partitioner_structures``.  ``partition_graph_dense``
with caps: bit for bit JAX's, with the native helpers and without, and
JAX's errors.  ``shared_caps``: the caps under which two clouds partition to
the same shapes.
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
from scalable_e3_gnn_tpu.parallel.partition import partition_graph as j_partition
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition_dense
from scalable_e3_gnn_torch.data import native_loader
from scalable_e3_gnn_torch.parallel.partition import (PartitionedGraph, partition_graph,
                                                      partition_graph_dense, shared_caps)

LO, HI = (-4.0,) * 3, (4.0,) * 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _coo(n=512, seed=0, radius=0.7):
    """(positions, features, senders, receivers, edge_mask) of JAX's
    ``tests/test_distributed.py::_problem``, numpy."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, radius, max_neighbors=32))(tree.points)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    return (np.array(tree.points), feats, np.array(e.senders), np.array(e.receivers),
            np.array(e.mask))


@functools.lru_cache(maxsize=None)
def _dense(n=256, seed=0):
    """(positions, features, senders, edge_mask) of JAX's dense graph of
    ``tests/test_distributed_dense.py::_problem``, numpy."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=16))(tree.points)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    g = JGraph.from_radius_edges(jnp.asarray(feats), tree.points, e)
    return (np.array(g.positions), np.array(g.nodes), np.array(g.senders),
            np.array(g.edge_mask))


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def _coo_needs(part):
    return dict(halo_cap=part.halo_cap, edges_per_part=part.senders.shape[1],
                local_edges_per_part=part.senders_loc.shape[1],
                remote_edges_per_part=part.senders_rem.shape[1])


@pytest.mark.parametrize("capped", [False, True], ids=["auto", "caps"])
@pytest.mark.parametrize("num_parts", [1, 2, 4, 8])
def test_partition_graph_matches_jax_bitwise(num_parts, capped):
    args = _coo()
    caps = {}
    if capped:
        need = _coo_needs(j_partition(*args, num_parts=num_parts))
        caps = {k: v + 3 + i for i, (k, v) in enumerate(need.items())}
    want = j_partition(*args, num_parts=num_parts, **caps)
    got = partition_graph(*args, num_parts=num_parts, **caps)
    assert isinstance(got, PartitionedGraph)
    _assert_same(got, want)
    if capped:
        assert got.halo_cap == caps["halo_cap"]
        assert got.senders.shape[1] == caps["edges_per_part"]


@pytest.mark.parametrize("cap", ["halo_cap", "edges_per_part", "local_edges_per_part",
                                 "remote_edges_per_part"])
def test_partition_graph_cap_below_the_need_raises_as_jax(cap):
    args = _coo()
    need = _coo_needs(j_partition(*args, num_parts=4))
    # the automatic halo cap is the larger of the import and export counts;
    # JAX checks the import count first
    below = {cap: need[cap] - 1}
    with pytest.raises(ValueError) as want:
        j_partition(*args, num_parts=4, **below)
    with pytest.raises(ValueError) as got:
        partition_graph(*args, num_parts=4, **below)
    assert str(got.value) == str(want.value)


def _exporter_coo():
    """Three partitions of two nodes; partition 1 exports node 2 to
    partition 0 and node 3 to partition 2: each halo holds one node, the
    export set two."""
    pos = np.arange(18, dtype=np.float32).reshape(6, 3)
    feats = np.ones((6, 2), np.float32)
    senders = np.array([2, 3], np.int32)
    receivers = np.array([0, 4], np.int32)
    return pos, feats, senders, receivers, np.ones(2, bool)


def test_partition_graph_export_count_over_the_halo_cap_raises_as_jax():
    args = _exporter_coo()
    with pytest.raises(ValueError, match="export count 2 exceeds halo_cap 1") as want:
        j_partition(*args, num_parts=3, halo_cap=1)
    with pytest.raises(ValueError) as got:
        partition_graph(*args, num_parts=3, halo_cap=1)
    assert str(got.value) == str(want.value)
    _assert_same(partition_graph(*args, num_parts=3), j_partition(*args, num_parts=3))


def test_partition_graph_structures():
    """JAX's test_partitioner_structures: every valid edge once, receivers
    sorted, halo slots at their owners' positions; and the split lists hold
    the same edges."""
    pts, feats, senders, receivers, mask = _coo(n=200)
    part = partition_graph(pts, feats, senders, receivers, mask, num_parts=4)
    assert int(part.edge_mask.sum()) == int(mask.sum())
    assert int(part.mask_loc.sum()) + int(part.mask_rem.sum()) == int(mask.sum())
    npp, hcap = part.n_per_part, part.halo_cap
    for p in range(4):
        r = part.receivers[p][part.edge_mask[p]]
        assert (np.diff(r) >= 0).all()
        for rr, mm in ((part.receivers_loc[p], part.mask_loc[p]),
                       (part.receivers_rem[p], part.mask_rem[p])):
            assert (np.diff(rr[mm]) >= 0).all()
        assert (part.senders_loc[p][part.mask_loc[p]] < npp).all()
        assert (part.senders_rem[p][part.mask_rem[p]] >= npp).all()
        for j in range(hcap):
            pool = part.halo_map[p, j]
            q, slot = pool // hcap, pool % hcap
            gid = q * npp + part.boundary_idx[q, slot]
            if (part.positions_ext[p, npp + j] != 0).any():
                np.testing.assert_array_equal(part.positions_ext[p, npp + j], pts[gid])
    # every input edge, by (receiver, sender) in input ids, exactly once
    keys = []
    for p in range(4):
        gid = np.concatenate([part.global_ids[p], np.full(hcap + 1, -1)])
        s, r, m = part.senders[p], part.receivers[p], part.edge_mask[p]
        pool = part.halo_map[p][np.clip(s - npp, 0, hcap - 1)]
        halo_gid = pool // hcap * npp + part.boundary_idx[pool // hcap, pool % hcap]
        send = np.where(s < npp, gid[np.minimum(s, npp - 1)], halo_gid)
        keys.append((gid[r[m]].astype(np.int64) * 200 + send[m]))
    want = np.sort(receivers[mask].astype(np.int64) * 200 + senders[mask])
    np.testing.assert_array_equal(np.sort(np.concatenate(keys)), want)


def _dense_caps(part, slack=0):
    return dict(halo_cap=part.halo_cap + slack, interior_cap=part.n_interior + 2 * slack,
                boundary_cap=part.n_boundary + 3 * slack)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("num_parts", [2, 4])
def test_partition_graph_dense_with_caps_matches_jax_bitwise(num_parts, native, monkeypatch):
    args = _dense()
    caps = _dense_caps(j_partition_dense(*args, num_parts=num_parts), slack=5)
    want = j_partition_dense(*args, num_parts=num_parts, **caps)
    if not native:
        monkeypatch.setattr(native_loader, "_get", lambda: None)
    assert native_loader.available() is native
    got = partition_graph_dense(*args, num_parts=num_parts, **caps)
    _assert_same(got, want)
    assert (got.halo_cap, got.n_interior, got.n_boundary) == tuple(caps.values())


@pytest.mark.parametrize("cap", ["halo_cap", "interior_cap", "boundary_cap"])
def test_partition_graph_dense_cap_below_the_need_raises_as_jax(cap):
    args = _dense()
    need = _dense_caps(j_partition_dense(*args, num_parts=4))
    with pytest.raises(ValueError) as want:
        j_partition_dense(*args, num_parts=4, **{cap: need[cap] - 1})
    with pytest.raises(ValueError) as got:
        partition_graph_dense(*args, num_parts=4, **{cap: need[cap] - 1})
    assert str(got.value) == str(want.value)


def test_partition_graph_dense_export_count_over_the_halo_cap_raises_as_jax():
    pos, feats, senders, receivers, _ = _exporter_coo()
    s = np.zeros((6, 1), np.int32)
    m = np.zeros((6, 1), bool)
    s[receivers, 0] = senders
    m[receivers, 0] = True
    with pytest.raises(ValueError, match="export count 2 exceeds halo_cap 1") as want:
        j_partition_dense(pos, feats, s, m, num_parts=3, halo_cap=1)
    with pytest.raises(ValueError) as got:
        partition_graph_dense(pos, feats, s, m, num_parts=3, halo_cap=1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_shared_caps_give_both_clouds_one_shape(layout):
    if layout == "coo":
        clouds = [_coo(seed=s) for s in (0, 1)]
        fn = partition_graph
    else:
        clouds = [_dense(seed=s) for s in (0, 1)]
        fn = partition_graph_dense
    caps = shared_caps([fn(*c, num_parts=4) for c in clouds])
    parts = [fn(*c, num_parts=4, **caps) for c in clouds]
    jfn = j_partition if layout == "coo" else j_partition_dense
    for c, part in zip(clouds, parts):
        _assert_same(part, jfn(*c, num_parts=4, **caps))
    for name in parts[0]._fields:
        a, b = getattr(parts[0], name), getattr(parts[1], name)
        if isinstance(a, np.ndarray) and not name.startswith("rev_"):
            assert a.shape == b.shape, name
