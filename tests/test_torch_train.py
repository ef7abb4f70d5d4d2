"""PyTorch port, training: ``mse_loss``, the Adam mapping and a short train
loop against the JAX package's ``train/pipeline.py`` and ``optax``.

Tolerances, each with its reason: the loss fp32 rtol 1e-6 (one reduction in
another order); Adam parameters atol 1e-6 (one fp32 ulp of an O(1) parameter
is about 1.2e-7, and the two compute the bias correction in another order);
the 3-step loss curve rtol 1e-4 (fp32 gradients through 2 SEGNN layers,
summed in another order, then 3 Adam steps)."""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph as TGraph
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

LO, HI = (-4.0,) * 3, (4.0,) * 3
IRREPS = ("2x0e+1x1o", "16x0e+8x1o", "1x1o")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mask_kind", ["none", "rows", "elements", "empty"])
def test_mse_loss_matches_jax(mask_kind):
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((40, 3)).astype(np.float32)
    target = rng.standard_normal((40, 3)).astype(np.float32)
    mask = {"none": None, "rows": rng.random(40) > 0.3,
            "elements": rng.random((40, 3)) > 0.3, "empty": np.zeros(40, bool)}[mask_kind]
    want = jpipe.mse_loss(jnp.asarray(pred), jnp.asarray(target),
                          None if mask is None else jnp.asarray(mask))
    got = tpipe.mse_loss(torch.from_numpy(pred), torch.from_numpy(target),
                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_adam_mapping_matches_optax():
    """Three updates from the same gradients: torch.optim.Adam(lr=1e-3,
    betas=(0.9, 0.999), eps=1e-8) against optax.adam(1e-3)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (3,), "c": (4, 4)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, init)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    topt = torch.optim.Adam(tp.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)
    assert max(np.abs(tp[k].detach().numpy() - init[k]).max() for k in shapes) > 1e-3


@functools.lru_cache(maxsize=None)
def _graphs(n=128, seed=3, k=8, tile=32):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=k))(tree.points)
    feats = jnp.asarray(rng.standard_normal((n, 5)), jnp.float32)
    jg = JGraph.from_radius_edges(feats, tree.points, e, symmetrize=True)
    jgt = jg.with_gather_tables(tile=tile)
    t = lambda a: torch.from_numpy(np.array(a))
    tg = TGraph(nodes=t(jg.nodes), positions=t(jg.positions), senders=t(jg.senders),
                edge_mask=t(jg.edge_mask), node_mask=t(jg.node_mask),
                node_graph=t(jg.node_graph), n_graphs=1, reverse_slot=t(jg.reverse_slot))
    target = rng.standard_normal((n, 3)).astype(np.float32)
    return jgt, tg.with_gather_tables(tile=tile), target


def test_train_loop_matches_jax():
    """Three steps of make_train_step (MSE, Adam 1e-3) from the same weights on
    a tabled graph: the port's kernel path (its autograd Function) against the
    JAX Pallas kernel in interpret mode.  Losses rtol 1e-4, grad norms rtol
    1e-4, the final parameters atol 1e-6 (3 Adam steps of at most lr each)."""
    jgt, tgt, target = _graphs()
    jm = JSEGNN(*map(JIrreps, IRREPS), num_layers=2, layout="cm", use_pallas=True)
    params = jm.init(jax.random.key(4))
    opt = optax.adam(1e-3)
    loss_fn = lambda p, g, y: jpipe.mse_loss(jm(p, g), y)
    jstep = jpipe.make_train_step(loss_fn, opt, donate=False)
    state = jpipe.make_train_state(params, opt)
    want = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            state, m = jstep(state, jgt, jnp.asarray(target))
            want.append((float(m["loss"]), float(m["grad_norm"])))

    tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = tpipe.make_train_step(
        tm, lambda m, g, y: tpipe.mse_loss(m(g), y), topt)
    got = []
    for _ in range(3):
        m = tstep(tgt, torch.from_numpy(target))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert want[2][0] < want[0][0]  # the loss moves
    final = params_to_jax(tm)
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(state.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_train_loop_untabled_matches_jax(symmetrize):
    """Three steps as test_train_loop_matches_jax on a graph without gather
    tables (n=200: the node axis pads to the km tile 64): the port's untabled
    lmax=1 kernel path (take_dense_symmetric_km or gather_km, the km autograd
    Function) against JAX's Pallas km kernels in interpret mode; the same
    tolerances."""
    n = 200
    rng = np.random.default_rng(40)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=8))(tree.points)
    feats = jnp.asarray(rng.standard_normal((n, 5)), jnp.float32)
    jg = JGraph.from_radius_edges(feats, tree.points, e, symmetrize=symmetrize)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    tg = TGraph(nodes=t(jg.nodes), positions=t(jg.positions), senders=t(jg.senders),
                edge_mask=t(jg.edge_mask), node_mask=t(jg.node_mask),
                node_graph=t(jg.node_graph), n_graphs=1, reverse_slot=t(jg.reverse_slot))
    target = rng.standard_normal((n, 3)).astype(np.float32)
    jm = JSEGNN(*map(JIrreps, IRREPS), num_layers=2, layout="cm", use_pallas=True)
    params = jm.init(jax.random.key(41))
    opt = optax.adam(1e-3)
    jstep = jpipe.make_train_step(lambda p, g, y: jpipe.mse_loss(jm(p, g), y), opt,
                                  donate=False)
    state = jpipe.make_train_state(params, opt)
    want = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            state, m = jstep(state, jg, jnp.asarray(target))
            want.append((float(m["loss"]), float(m["grad_norm"])))

    tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = tpipe.make_train_step(tm, lambda m, g, y: tpipe.mse_loss(m(g), y), topt)
    got = []
    for _ in range(3):
        m = tstep(tg, torch.from_numpy(target))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert want[2][0] < want[0][0]
    final = params_to_jax(tm)
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(state.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def test_bf16_compute_with_fp32_masters():
    """The loss of the config-3 train step in ``chip_smoke.py``: the forward
    runs on bf16 copies of fp32 parameters (``torch.func.functional_call``),
    so the gradients flow back through the casts to fp32; they stay within
    5e-2 * max|ref| of the fp32 gradients (bf16 storage through 2 layers)."""
    _, tgt, target = _graphs()
    tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, device="cpu",
                generator=torch.Generator().manual_seed(5))
    bf = torch.bfloat16
    g_bf = tgt._replace(nodes=tgt.nodes.to(bf))
    attrs = tuple(a.to(bf) for a in tm.compute_attributes_dense(tgt))
    y = torch.from_numpy(target)

    def loss_bf16(model, g, a, t):
        p = {name: w.to(bf) for name, w in model.named_parameters()}
        out = torch.func.functional_call(model, p, (g,), {"attrs": a})
        return tpipe.mse_loss(out.float(), t)

    tm.zero_grad()
    loss_bf16(tm, g_bf, attrs, y).backward()
    got = params_to_jax(tm, grad=True)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tm.parameters())
    tm.zero_grad()
    tpipe.mse_loss(tm(tgt), y).backward()
    ref = params_to_jax(tm, grad=True)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max()
