"""PyTorch port, graph builders: every array equals the JAX package's exactly.

A ~2k-point uniform cloud in the unit cube (the config-3 geometry at a
smaller size): Morton codes, the octree, the cell and brute-force radius
graphs, symmetrization and every gather-table array must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_e3_gnn_tpu.graph import morton as jm
from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree as j_octree
from scalable_e3_gnn_tpu.graph.radius import (radius_graph_brute as j_brute,
                                              radius_graph_cell as j_cell,
                                              suggest_cell_capacity as j_cap)
from scalable_e3_gnn_torch.graph import morton as tm
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph as TGraph
from scalable_e3_gnn_torch.graph.octree import build_octree as t_octree
from scalable_e3_gnn_torch.graph.radius import (radius_graph_brute as t_brute,
                                                radius_graph_cell as t_cell,
                                                suggest_cell_capacity as t_cap)

N = 2048
LO, HI = (0.0,) * 3, (1.0,) * 3
RADIUS, K, LEVELS = 0.1, 16, 5


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


@pytest.fixture(scope="module")
def built():
    pts = np.random.default_rng(0).random((N, 3)).astype(np.float32)
    jt = jax.jit(lambda p: j_octree(p, LO, HI, num_levels=LEVELS))(jnp.asarray(pts))
    tt = t_octree(pts, LO, HI, num_levels=LEVELS, device="cpu")
    cap = j_cap(jt, RADIUS, LO, HI)
    je = jax.jit(lambda t: j_cell(t, RADIUS, LO, HI, max_neighbors=K, cell_capacity=cap))(jt)
    te = t_cell(tt, RADIUS, LO, HI, max_neighbors=K, cell_capacity=t_cap(tt, RADIUS, LO, HI))
    return pts, jt, tt, je, te


def test_morton_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.random((500, 3)).astype(np.float32)
    _eq(jm.morton_encode_points(jnp.asarray(pts), LO, HI),
        tm.morton_encode_points(torch.from_numpy(pts), LO, HI))
    q = rng.integers(0, 1024, (500, 3)).astype(np.int32)
    codes = jm.morton_encode(jnp.asarray(q))
    _eq(codes, tm.morton_encode(torch.from_numpy(q)))
    _eq(jm.morton_decode(codes), tm.morton_decode(torch.from_numpy(np.asarray(codes))))


@pytest.mark.parametrize("field", ["points", "order", "codes", "leaf_level"])
def test_octree_point_arrays_match_jax(built, field):
    _, jt, tt, _, _ = built
    _eq(getattr(jt, field), getattr(tt, field))


@pytest.mark.parametrize("field", ["point_cell", "cell_start", "cell_count", "cell_code",
                                   "num_cells"])
def test_octree_level_arrays_match_jax(built, field):
    _, jt, tt, _, _ = built
    for a, b in zip(getattr(jt, field), getattr(tt, field), strict=True):
        _eq(a, b)


def test_cell_capacity_matches_jax(built):
    _, jt, tt, _, _ = built
    assert j_cap(jt, RADIUS, LO, HI) == t_cap(tt, RADIUS, LO, HI)


@pytest.mark.parametrize("field", ["senders", "receivers", "mask", "num_edges"])
def test_radius_graph_cell_matches_jax(built, field):
    _, _, _, je, te = built
    _eq(getattr(je, field), getattr(te, field))


def test_radius_graph_brute_matches_jax(built):
    _, jt, tt, je, te = built
    jb = jax.jit(lambda p: j_brute(p, RADIUS, max_neighbors=K, block_size=512))(jt.points)
    tb = t_brute(tt.points, RADIUS, max_neighbors=K, block_size=512, device="cpu")
    for field in ("senders", "receivers", "mask", "num_edges"):
        _eq(getattr(jb, field), getattr(tb, field))
    # the cell builder finds the brute-force neighbour lists
    assert (te.senders == tb.senders).float().mean() > 0.999


@pytest.fixture(scope="module")
def graphs(built):
    pts, jt, tt, je, te = built
    feats = np.random.default_rng(2).standard_normal((N - 48, 5)).astype(np.float32)
    # a ragged node count (not a multiple of the tile): cut the edge list
    n = N - 48
    cut = lambda e: e._replace(senders=e.senders[: n * K], receivers=e.receivers[: n * K],
                               mask=e.mask[: n * K])
    jje, tte = cut(je), cut(te)
    jje = jje._replace(senders=jnp.where(jje.senders < n, jje.senders, n),
                       mask=jje.mask & (jje.senders < n))
    tte = tte._replace(senders=torch.where(tte.senders < n, tte.senders, n),
                       mask=tte.mask & (tte.senders < n))
    jg = JGraph.from_radius_edges(jnp.asarray(feats), jt.points[:n], jje, symmetrize=True)
    tg = TGraph.from_radius_edges(feats, tt.points[:n], tte, symmetrize=True)
    return jg, tg


@pytest.mark.parametrize("field", ["senders", "edge_mask", "reverse_slot", "positions"])
def test_symmetrized_graph_matches_jax(graphs, field):
    jg, tg = graphs
    _eq(getattr(jg, field), getattr(tg, field))


def test_rel_positions_match_jax(graphs):
    jg, tg = graphs
    _eq(jax.jit(JGraph.rel_positions)(jg), tg.rel_positions())


@pytest.mark.parametrize("tile", [32, 160])
@pytest.mark.parametrize("field", ["gather_loc", "gather_tab", "gather_rev", "gather_rev_dense",
                                   "gather_rem_pos", "gather_rem_node"])
def test_gather_tables_match_jax(graphs, tile, field):
    jg, tg = graphs
    jt, tt = jg.with_gather_tables(tile=tile), tg.with_gather_tables(tile=tile)
    assert jt.gather_tile == tt.gather_tile == tile
    a, b = getattr(jt, field), getattr(tt, field)
    assert b.dtype == torch.int32
    _eq(a, b)
