"""PyTorch port, the COO path: its ops, graph pieces and data against the
JAX package.

- ``segment_sum``/``segment_mean``/``scatter_sum`` (sorted and unsorted ids,
  padding ids past the last segment) within 1e-6 of max|ref| in fp32 (the
  same fp32 sums, possibly in another order); ``segment_max`` with empty
  segments bit for bit (-inf there, as ``jax.ops.segment_max``); the clipped
  edge gather ``gather_coo`` bit for bit, its gradient and ``segment_sum``'s
  within 1e-6 of max|ref|; ``spmm``/``sddmm`` against JAX and against dense
  products within 1e-5 (``tests/test_gather_scatter.py``'s limits);
- ``batch_same_size``, ``pad_graph``, ``SteerableGraph.rel_positions``, the
  N-body and QM9 generators, ``batch_molecules``, ``load_qm9`` on
  ``tests/fixtures/qm9`` and the rotations bit for bit (the same numpy code);
- ``O3LayerNorm`` within 1e-6 (fp32, the same reductions);
- the segment plans: a graph's ``_replace`` of its topology drops them.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_e3_gnn_tpu.core import rotations as jrot
from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.data import nbody as jnbody
from scalable_e3_gnn_tpu.data import qm9 as jqm9
from scalable_e3_gnn_tpu.graph import batching as jbatch
from scalable_e3_gnn_tpu.ops import gather_scatter as jgs
from scalable_e3_gnn_tpu.ops.linear import O3LayerNorm as JLayerNorm
from scalable_e3_gnn_torch.core import rotations as trot
from scalable_e3_gnn_torch.core.irreps import Irreps
from scalable_e3_gnn_torch.data import nbody as tnbody
from scalable_e3_gnn_torch.data import qm9 as tqm9
from scalable_e3_gnn_torch.graph import batching as tbatch
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph
from scalable_e3_gnn_torch.ops import gather_scatter as tgs
from scalable_e3_gnn_torch.ops.linear import O3LayerNorm
from scalable_e3_gnn_torch.utils.params import params_from_jax

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "qm9")
GRAPH_FIELDS = ("nodes", "positions", "senders", "receivers", "node_graph", "node_mask",
                "edge_mask")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(rng, e, s, sort):
    """Segment ids in [0, s) with padding ids s and s + 3 (dropped) mixed in."""
    ids = rng.integers(0, s, e)
    ids[rng.random(e) < 0.15] = s
    ids[rng.random(e) < 0.05] = s + 3
    return np.sort(ids) if sort else ids


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_segment_sum_mean_match_jax(sort, shape):
    rng = np.random.default_rng(0)
    e, s = 97, 11
    data = rng.standard_normal((e,) + shape).astype(np.float32)
    ids = _ids(rng, e, s, sort)
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    for jf, tf in ((jgs.segment_sum, tgs.segment_sum), (jgs.scatter_sum, tgs.scatter_sum)):
        want = np.asarray(jf(jd, ji, s, indices_are_sorted=sort))
        got = tf(td, ti, s, indices_are_sorted=sort).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    if len(shape) <= 1:  # the JAX mean broadcasts the count over one axis only
        want = np.asarray(jgs.segment_mean(jd, ji, s, indices_are_sorted=sort))
        got = tgs.segment_mean(td, ti, s, indices_are_sorted=sort).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_segment_sum_drops_out_of_range_ids():
    """ids >= num_segments and negative ids add nothing, as in JAX."""
    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    ids = np.array([0, 1, 3, 3, -1, 2])
    want = np.asarray(jgs.segment_sum(jnp.asarray(data), jnp.asarray(ids), 3))
    got = tgs.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sort", [True, False])
def test_segment_max_matches_jax(sort):
    """Empty segments (and segments of padding only) read -inf, as in JAX."""
    rng = np.random.default_rng(1)
    e, s = 40, 16  # some of the 16 segments stay empty
    data = rng.standard_normal((e, 3)).astype(np.float32)
    ids = _ids(rng, e, s, sort)
    want = np.asarray(jgs.segment_max(jnp.asarray(data), jnp.asarray(ids), s,
                                      indices_are_sorted=sort))
    got = tgs.segment_max(torch.from_numpy(data), torch.from_numpy(ids), s,
                          indices_are_sorted=sort).numpy()
    assert np.isneginf(want).any()
    np.testing.assert_array_equal(got, want)
    got1 = tgs.segment_max(torch.from_numpy(data[:, 0]), torch.from_numpy(ids), s,
                           indices_are_sorted=sort).numpy()
    np.testing.assert_array_equal(got1, want[:, 0])


def test_gather_coo_and_grads_match_jax():
    """The clipped edge gather bit for bit (padding ids N and past it clip to
    row N-1, negative ones to row 0); the gradients of a gather feeding a
    segment sum within 1e-6 of max|ref|."""
    rng = np.random.default_rng(2)
    n, e, f = 13, 60, 5
    x = rng.standard_normal((n, f)).astype(np.float32)
    snd = rng.integers(-2, n + 3, e)
    rcv = _ids(rng, e, n, True)
    w = rng.standard_normal((e, f)).astype(np.float32)
    want = np.asarray(jgs.gather(jnp.asarray(x), jnp.asarray(snd)))
    got = tgs.gather_coo(torch.from_numpy(x), torch.from_numpy(snd)).numpy()
    np.testing.assert_array_equal(got, want)

    def jloss(x_, w_):
        m = jgs.gather(x_, jnp.asarray(snd)) * w_
        return jnp.sum(jgs.segment_sum(m, jnp.asarray(rcv), n, indices_are_sorted=True) ** 2)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    m = tgs.gather_coo(tx, torch.from_numpy(snd)) * tw
    torch.sum(tgs.segment_sum(m, torch.from_numpy(rcv), n, indices_are_sorted=True) ** 2).backward()
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_gather_coo_with_plan_matches_without():
    """A precomputed plan (a graph's) gives the same values and gradients."""
    rng = np.random.default_rng(3)
    n, e = 9, 31
    x = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n + 2, e))
    g = torch.from_numpy(rng.standard_normal((e, 4)).astype(np.float32))
    plan = tgs.segment_plan(torch.clamp(idx, 0, n - 1), n)
    grads = []
    for p in (None, plan):
        xx = x.clone().requires_grad_()
        tgs.gather_coo(xx, idx, p).backward(g)
        grads.append(xx.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_matches_jax_and_dense(weighted):
    rng = np.random.default_rng(4)
    n, e, f = 6, 14, 3
    x = rng.standard_normal((n, f)).astype(np.float32)
    s = rng.integers(0, n, e)
    r = np.sort(rng.integers(0, n, e))
    w = rng.standard_normal(e).astype(np.float32) if weighted else None
    dense = np.zeros((n, n), np.float32)
    for k in range(e):
        dense[r[k], s[k]] += 1.0 if w is None else w[k]
    want = np.asarray(jgs.spmm(None if w is None else jnp.asarray(w), jnp.asarray(x),
                               jnp.asarray(s), jnp.asarray(r), n, indices_are_sorted=True))
    got = tgs.spmm(None if w is None else torch.from_numpy(w), torch.from_numpy(x),
                   torch.from_numpy(s), torch.from_numpy(r), n, indices_are_sorted=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, dense @ x, rtol=1e-5, atol=1e-6)


def test_sddmm_matches_jax_and_dense():
    rng = np.random.default_rng(5)
    n, e, f = 5, 9, 4
    a = rng.standard_normal((n, f)).astype(np.float32)
    b = rng.standard_normal((n, f)).astype(np.float32)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    want = np.asarray(jgs.sddmm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s), jnp.asarray(r)))
    got = tgs.sddmm(*(torch.from_numpy(v) for v in (a, b, s, r))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, (a @ b.T)[s, r], rtol=1e-5, atol=1e-6)


def _assert_graph_equal(tg, jg):
    assert tg.n_graphs == jg.n_graphs
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)
        assert getattr(tg, f).numpy().dtype == np.asarray(getattr(jg, f)).dtype, f


def _nbody_graphs(graphs=3, seed=0):
    ds = jnbody.generate_dataset(graphs, num_steps=25, seed=seed)
    feats = np.concatenate([(ds["vel0"] ** 2).sum(-1, keepdims=True),
                            ds["charges"][..., None], ds["vel0"]], -1)
    s, r = jnbody.make_fully_connected_edges(5)
    return (tbatch.batch_same_size(feats, ds["pos0"], s, r, device="cpu"),
            jbatch.batch_same_size(feats, ds["pos0"], s, r))


def test_nbody_data_bitwise():
    for kw in (dict(num_graphs=4, num_steps=40, seed=3), dict(num_graphs=2, seed=7)):
        want, got = jnbody.generate_dataset(**kw), tnbody.generate_dataset(**kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    for n in (2, 5):
        for a, b in zip(tnbody.make_fully_connected_edges(n), jnbody.make_fully_connected_edges(n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad", [(0, 0), (6, 11), (1, 40)])
def test_batch_pad_rel_positions_bitwise(pad):
    tg, jg = _nbody_graphs()
    _assert_graph_equal(tg, jg)
    tp = tbatch.pad_graph(tg, tg.num_nodes + pad[0], tg.num_edges + pad[1])
    jp = jbatch.pad_graph(jg, jg.num_nodes + pad[0], jg.num_edges + pad[1])
    _assert_graph_equal(tp, jp)
    np.testing.assert_array_equal(tp.rel_positions().numpy(), np.asarray(jp.rel_positions()))
    t4 = tbatch.pad_graph(tg, tg.num_nodes + 2, tg.num_edges, num_graphs=4)
    _assert_graph_equal(t4, jbatch.pad_graph(jg, jg.num_nodes + 2, jg.num_edges, num_graphs=4))
    with pytest.raises(ValueError):
        tbatch.pad_graph(tg, tg.num_nodes - 1, tg.num_edges)


def test_molecules_and_batches_bitwise():
    want, got = jqm9.generate_molecules(7, seed=4), tqm9.generate_molecules(7, seed=4)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b) and a["target"] == b["target"]
        np.testing.assert_array_equal(a["species"], b["species"])
        np.testing.assert_array_equal(a["positions"], b["positions"])
    for kw in (dict(), dict(nodes_per_graph=35, radius=1.5, max_neighbors=6)):
        jg, jt = jqm9.batch_molecules(want, **kw)
        tg, tt = tqm9.batch_molecules(got, device="cpu", **kw)
        _assert_graph_equal(tg, jg)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tg.rel_positions().numpy(), np.asarray(jg.rel_positions()))


def test_load_qm9_fixtures_match_jax():
    for target in ("U0", "homo", "mu"):
        want = jqm9.load_qm9(FIXTURES, target=target)
        got = tqm9.load_qm9(FIXTURES, target=target)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a["target"] == b["target"] and a["index"] == b["index"]
            np.testing.assert_array_equal(a["species"], b["species"])
            np.testing.assert_array_equal(a["positions"], b["positions"])
        assert tqm9.target_unit(target) == jqm9.target_unit(target)
    assert len(tqm9.load_qm9(FIXTURES, limit=2, exclude={1})) == 1
    assert tqm9.load_uncharacterized(FIXTURES) == jqm9.load_uncharacterized(FIXTURES)
    mols = jqm9.generate_molecules(40, seed=1)
    for a, b in zip(tqm9.split_qm9(mols, seed=3), jqm9.split_qm9(mols, seed=3)):
        assert [m["target"] for m in a] == [m["target"] for m in b]
    with pytest.raises(ValueError):
        tqm9.load_qm9(FIXTURES, target="nope")
    with pytest.raises(FileNotFoundError):
        tqm9.load_qm9(os.path.join(FIXTURES, "missing"))


def test_rotations_bitwise():
    for seed in (0, 5):
        R = trot.random_rotation(np.random.default_rng(seed))
        np.testing.assert_array_equal(R, jrot.random_rotation(np.random.default_rng(seed)))
        for l in range(4):
            for Rs in (R, -R):
                for p in (1, -1):
                    np.testing.assert_array_equal(trot.irrep_rotation(l, p, Rs),
                                                  jrot.irrep_rotation(l, p, Rs))
            D = trot.wigner_D_from_matrix(l, R)
            np.testing.assert_allclose(D @ D.T, np.eye(2 * l + 1), atol=1e-10)


def test_irreps_randn():
    ir = Irreps("3x0e+2x1o+1x2e")
    g = lambda: torch.Generator().manual_seed(0)
    x = ir.randn(g(), (7,))
    assert tuple(x.shape) == (7, ir.dim) and x.dtype == torch.float32
    xn = ir.randn(g(), (7,), normalization="norm")
    scale = torch.cat([torch.full((mi.dim,), mi.ir.dim ** -0.5) for mi in ir])
    torch.testing.assert_close(xn, x * scale, rtol=1e-6, atol=0)
    assert ir.randn(None, (2, 3), dtype=torch.float64).shape == (2, 3, ir.dim)


def test_o3_layer_norm_matches_jax():
    irreps = "4x0e+3x1o+2x2e+2x0e"
    rng = np.random.default_rng(6)
    x = rng.standard_normal((11, JIrreps(irreps).dim)).astype(np.float32)
    jn = JLayerNorm(JIrreps(irreps))
    params = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
              for k, v in jn.init().items()}
    want = np.asarray(jn(params, jnp.asarray(x)))
    tn = O3LayerNorm(irreps, device="cpu")
    assert set(dict(tn.named_parameters())) == set(params)
    params_from_jax(tn, jax.tree.map(np.asarray, params))
    got = tn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_graph_helpers():
    tg, _ = _nbody_graphs(2)
    gp = tg.with_plans()
    assert gp.plans is not None
    assert gp.replace_nodes(gp.nodes * 2).plans is gp.plans
    assert gp._replace(positions=gp.positions + 1).plans is gp.plans
    assert gp._replace(senders=gp.senders.flip(0)).plans is None
    dense = DenseEdgeGraph(nodes=torch.zeros(4, 2), positions=torch.zeros(4, 3),
                           senders=torch.zeros(4, 3, dtype=torch.int32),
                           edge_mask=torch.ones(4, 3, dtype=torch.bool),
                           node_mask=torch.ones(4, dtype=torch.bool),
                           node_graph=torch.zeros(4, dtype=torch.int32))
    assert dense.num_edges == 12
    assert dense.replace_nodes(torch.ones(4, 2)).nodes.sum() == 8


# ---- the COO model against JAX: forward, gradients, attributes, invariances

IN, HID = "2x0e+1x1o", "8x0e+4x1o"


def _nbody_case(seed=0):
    """A padded N-body batch (pad nodes and trash edges) with velocities,
    one of them zero."""
    tg, jg = _nbody_graphs(3, seed)
    tg = tbatch.pad_graph(tg, tg.num_nodes + 4, tg.num_edges + 7)
    jg = jbatch.pad_graph(jg, jg.num_nodes + 4, jg.num_edges + 7)
    vel = np.zeros((tg.num_nodes, 3), np.float32)
    vel[:15] = tg.nodes[:15, 2:].numpy()
    vel[3] = 0.0
    return tg, jg, vel


def _qm9_case(seed=5):
    """A batch of three padded molecules (masked edges, padding nodes)."""
    mols = jqm9.generate_molecules(3, seed=seed)
    jg, _ = jqm9.batch_molecules(mols, max_neighbors=6)
    tg, _ = tqm9.batch_molecules(mols, max_neighbors=6, device="cpu")
    vel = np.random.default_rng(seed).standard_normal((tg.num_nodes, 3)).astype(np.float32)
    vel[0] = 0.0
    return tg, jg, vel


def _models(task, vel_attr, remat=False, seed=0, ins=None):
    from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
    from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN

    out = "1x1o" if task == "node" else "1x0e"
    ins = ins or (IN if task == "node" else "5x0e")
    jm = JSEGNN(JIrreps(ins), JIrreps(HID), JIrreps(out), num_layers=2, task=task,
                vel_attr=vel_attr, remat=remat)
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(ins, HID, out, num_layers=2, task=task, vel_attr=vel_attr, remat=remat,
                device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("task,vel_attr,remat", [
    ("node", False, False), ("node", True, False), ("graph", False, False),
    ("graph", True, False), ("node", True, True), ("graph", False, True)])
def test_segnn_coo_matches_jax(task, vel_attr, remat):
    """Forward within 1e-5 of max|ref|, each parameter's gradient (of a
    random linear functional of the output) within 1e-4 of its max|ref|."""
    from scalable_e3_gnn_torch.utils.params import params_to_jax

    tg, jg, vel = (_nbody_case if task == "node" else _qm9_case)()
    jm, params, tm = _models(task, vel_attr, remat)
    jv = jnp.asarray(vel)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p: jm(p, jg, jv))(params))
        cot = np.random.default_rng(9).standard_normal(want.shape).astype(np.float32)
        jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm(p, jg, jv) * cot)))(params)
    out = tm(tg, torch.from_numpy(vel))
    got = out.detach().numpy()
    assert got.shape == want.shape == ((tg.num_nodes, 3) if task == "node" else (3, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    torch.sum(out * torch.from_numpy(cot)).backward()
    tgrad = params_to_jax(tm, grad=True)
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrad))[0]
    for path, w in flat_j:
        g = tgrad
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


def test_layer_apply_matches_jax():
    """``SEGNNLayer.apply`` with senders into a wider h_ext (local || halo
    rows), as the JAX ``apply`` takes them, padding edges included."""
    from scalable_e3_gnn_tpu.models.segnn import SEGNNLayer as JLayer
    from scalable_e3_gnn_torch.models.segnn import SEGNNLayer as TLayer

    rng = np.random.default_rng(8)
    n, n_ext, e = 10, 14, 41
    f, a = JIrreps(HID).dim, 4
    jl = JLayer(JIrreps(HID), JIrreps("1x0e+1x1o"), layout="cm")
    params = jl.init(jax.random.key(3))
    tl = TLayer(HID, "1x0e+1x1o", layout="cm", device="cpu")
    params_from_jax(tl, jax.tree.map(np.asarray, params))
    h_ext = rng.standard_normal((n_ext, f)).astype(np.float32)
    snd = rng.integers(0, n_ext + 1, e)
    rcv = np.sort(rng.integers(0, n + 1, e))
    ea = rng.standard_normal((e, a)).astype(np.float32)
    na = rng.standard_normal((n, a)).astype(np.float32)
    d2 = rng.random(e).astype(np.float32)
    em, nm = rcv < n, rng.random(n) > 0.2
    args = (h_ext[:n], h_ext, snd, rcv, ea, na, d2, em, nm)
    want = np.asarray(jl.apply(params, *map(jnp.asarray, args)))
    got = tl.apply(*(torch.from_numpy(np.asarray(x)) for x in args)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_compute_attributes_match_jax():
    """Edge and node attributes (with sh of a zero velocity: exactly
    [1, 0, 0, 0] in both) and squared distances."""
    from scalable_e3_gnn_tpu.core.spherical import spherical_harmonics as jsh
    from scalable_e3_gnn_torch.core.spherical import spherical_harmonics as tsh

    z = np.zeros((2, 3), np.float32)
    np.testing.assert_array_equal(tsh(1, torch.from_numpy(z)).numpy(),
                                  np.asarray(jsh(1, jnp.asarray(z))))
    for case in (_nbody_case, _qm9_case):
        tg, jg, vel = case()
        jm, _, tm = _models("node", True)
        want = jm.compute_attributes(jg, jnp.asarray(vel))
        got = tm.compute_attributes(tg, torch.from_numpy(vel))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
        assert (got[1][:, 0] == 1).all()


def _forward(tm, g, vel):
    with torch.no_grad():
        return tm(g, torch.from_numpy(vel)).numpy()


@pytest.mark.parametrize("improper", [False, True])
def test_coo_e3_equivariance(improper):
    """Rotate (or rotate and reflect) and translate positions, rotate the
    velocities (xyz vectors, by R) and the 1o feature block (by its irrep
    matrix): the 1o outputs co-rotate (atol 2e-4, JAX's own test's limit)."""
    tg, _, vel = _nbody_case()
    _, _, tm = _models("node", True, seed=1)
    rng = np.random.default_rng(5)
    R = trot.random_rotation(rng)
    R = -R if improper else R
    D1 = torch.from_numpy(trot.irrep_rotation(1, -1, R).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    out = torch.from_numpy(_forward(tm, tg, vel))
    feats = torch.cat([tg.nodes[:, :2], tg.nodes[:, 2:] @ D1.T], dim=-1)
    g_rot = tg._replace(positions=tg.positions @ torch.from_numpy(R.astype(np.float32)).T + t,
                        nodes=feats)
    out_rot = _forward(tm, g_rot, vel @ R.T.astype(np.float32))  # xyz vectors rotate by R
    np.testing.assert_allclose(out_rot, (out @ D1.T).numpy(), atol=2e-4)


def test_coo_translation_invariance():
    tg, _, vel = _nbody_case()
    _, _, tm = _models("node", True, seed=2)
    out = _forward(tm, tg, vel)
    shifted = _forward(tm, tg._replace(positions=tg.positions + torch.tensor([10.0, -3.0, 7.0])),
                       vel)
    np.testing.assert_allclose(shifted, out, atol=1e-4)


def test_coo_permutation_equivariance():
    tg, _ = _nbody_graphs(1)
    vel = tg.nodes[:, 2:].numpy().copy()
    _, _, tm = _models("node", True, seed=3)
    out = _forward(tm, tg, vel)
    perm = np.random.default_rng(7).permutation(tg.num_nodes)
    inv = np.argsort(perm)
    s, r = inv[tg.senders.numpy()], inv[tg.receivers.numpy()]
    order = np.argsort(r, kind="stable")
    g2 = tg._replace(nodes=tg.nodes[perm], positions=tg.positions[perm],
                     senders=torch.from_numpy(s[order].astype(np.int32)),
                     receivers=torch.from_numpy(r[order].astype(np.int32)),
                     node_graph=tg.node_graph[perm])
    np.testing.assert_allclose(_forward(tm, g2, vel[perm]), out[perm], atol=1e-4)


def test_coo_padding_invariance_bitwise():
    """Pad nodes and trash edges at several sizes: the real nodes' outputs,
    and the per-graph sums, are the same bits."""
    tg, _ = _nbody_graphs(3)
    vel = tg.nodes[:, 2:].numpy().copy()
    for task in ("node", "graph"):
        _, _, tm = _models(task, True, seed=4, ins=IN)
        ref = _forward(tm, tg, vel)
        for pn, pe in ((1, 1), (6, 11), (17, 64)):
            gp = tbatch.pad_graph(tg, tg.num_nodes + pn, tg.num_edges + pe)
            velp = np.concatenate([vel, np.zeros((pn, 3), np.float32)])
            out = _forward(tm, gp, velp)
            np.testing.assert_array_equal(out[:ref.shape[0]], ref)


def test_qm9_pad_invariance_bitwise():
    """Molecules padded to 29 or to 35 nodes give the same graph outputs."""
    mols = tqm9.generate_molecules(4, seed=1)
    _, _, tm = _models("graph", False, seed=0)
    outs = []
    for npg in (29, 35):
        g, _ = tqm9.batch_molecules(mols, nodes_per_graph=npg, device="cpu")
        with torch.no_grad():
            outs.append(tm(g).numpy())
    assert outs[0].shape == (4, 1)
    np.testing.assert_array_equal(outs[0], outs[1])
