"""PyTorch port, SEGNN: the full forward, and the MSE loss's gradients, on a
symmetrized graph with gather tables and, through the untabled lmax=1
kernel, on graphs without them (symmetrized, unsymmetrized, and in padded
node blocks under edge_chunks) against the JAX package (Pallas kernels and
their custom VJPs in interpret mode, and its plain jnp path), with the JAX
weights carried over and the gradients compared key by key through
params_to_jax.  fp32 atol 2e-5: the same math, the GEMMs sum in another order.
Also the dispatch rules of the port."""

import contextlib
import functools

import numpy as np
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
from scalable_e3_gnn_tpu.train.pipeline import mse_loss as j_mse
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph as TGraph
from scalable_e3_gnn_torch.kernels import fused_message as tfm
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.train.pipeline import mse_loss as t_mse
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_ops import _assert_trees_close

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


@functools.lru_cache(maxsize=None)
def _graph(n, seed=0, k=8, tile=32, symmetrize=True):
    """JAX graph (symmetrized and tabled unless told otherwise) and the port's
    graph of the same arrays."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=k))(tree.points)
    feats = jnp.asarray(rng.standard_normal((n, 5)), jnp.float32)
    jg = JGraph.from_radius_edges(feats, tree.points, e, symmetrize=symmetrize)
    t = lambda a: torch.from_numpy(np.array(a))
    tg = TGraph(nodes=t(jg.nodes), positions=t(jg.positions), senders=t(jg.senders),
                edge_mask=t(jg.edge_mask), node_mask=t(jg.node_mask),
                node_graph=t(jg.node_graph), n_graphs=1,
                reverse_slot=None if jg.reverse_slot is None else t(jg.reverse_slot))
    if not symmetrize:
        return jg, None, tg, None
    return jg, jg.with_gather_tables(tile=tile), tg, tg.with_gather_tables(tile=tile)


def _models(use_pallas, seed, num_layers=2, task="node", **kw):
    jm = JSEGNN(*map(JIrreps, IRREPS), num_layers=num_layers, layout="cm",
                use_pallas=use_pallas, task=task, **kw)
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*IRREPS, num_layers=num_layers, layout="cm", use_pallas=use_pallas,
                task=task, device="cpu", **kw)
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("n", [128, 200])  # 200: the last table tile is partial
def test_segnn_tabled_forward_matches_jax_pallas(n):
    jg, jgt, tg, tgt = _graph(n)
    jm, params, tm = _models(True, seed=n)
    assert tm.layers[0].use_pallas
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(jm.__call__)(params, jgt))
    with torch.no_grad():
        got = tm(tgt).numpy()
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("n", [128, 200])
def test_segnn_plain_forward_matches_jax_jnp(n):
    jg, jgt, tg, tgt = _graph(n)
    jm, params, tm = _models(False, seed=n + 1)
    ref = np.asarray(jax.jit(jm.__call__)(params, jg))
    with torch.no_grad():
        got = tm(tg).numpy()
        got_tab = tm(tgt).numpy()  # tables are ignored by the plain path
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_array_equal(got_tab, got)


def test_segnn_attributes_and_graph_task_match_jax():
    jg, jgt, tg, tgt = _graph(128)
    jm, params, tm = _models(False, seed=5, num_layers=1, task="graph")
    ref_attrs = jax.jit(jm.compute_attributes_dense)(jg)
    for a, b in zip(ref_attrs, tm.compute_attributes_dense(tg), strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    ref = np.asarray(jax.jit(jm.__call__)(params, jg))
    with torch.no_grad():
        got = tm(tg).numpy()
    assert got.shape == (1, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_kernel_path_equals_plain_path_in_the_port():
    """The two dispatches of the port agree on the CPU (fp32, atol 2e-5)."""
    jg, jgt, tg, tgt = _graph(200)
    _, params, tm_k = _models(True, seed=7)
    tm_p = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=False, device="cpu")
    tm_p.load_state_dict(tm_k.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(tm_k(tgt), tm_p(tg), rtol=0, atol=2e-5)


# graphs without gather tables: the untabled lmax=1 kernel (#3/#5).  n=128
# takes tile 128 unpadded; n=200 pads to 256 (tile 64); edge_chunks=2 at n=200
# gives 100-node blocks, each padded to 128 and checkpointed under remat
UNTABLED_CASES = {
    "symmetrized": (128, True, {}),
    "unsymmetrized": (200, False, {}),
    "edge_chunks": (200, True, dict(edge_chunks=2, remat=True)),
}


@pytest.mark.parametrize("jax_pallas", [True, False])
@pytest.mark.parametrize("case", sorted(UNTABLED_CASES))
def test_segnn_untabled_matches_jax(case, jax_pallas):
    """The port's untabled lmax=1 kernel path (the autograd Function, plain
    versions on the CPU; take_dense_symmetric_km or gather_km for the
    senders) against JAX's Pallas km kernels (interpret mode) and its jnp
    path: the forward at atol 2e-5, the MSE loss at rtol 1e-5, and every
    parameter's gradient as in test_segnn_gradients_match_jax.  Under
    edge_chunks the JAX kernel model runs its blocks without remat (Pallas in
    interpret mode cannot run under jax.checkpoint); remat changes no result."""
    n, sym, kw = UNTABLED_CASES[case]
    jg, _, tg, _ = _graph(n, seed=n + 30, symmetrize=sym)
    assert (tg.reverse_slot is not None) == sym and tg.gather_loc is None
    jkw = {k: v for k, v in kw.items() if not (jax_pallas and k == "remat")}
    jm, params, tm = _models(jax_pallas, seed=n + 31, **jkw)
    tm_k = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, device="cpu", **kw)
    tm_k.load_state_dict(tm.state_dict())
    assert tm_k.layers[0].use_pallas and not tm_k.layers[0].use_pallas_generic
    target = np.random.default_rng(n + 32).standard_normal((n, 3)).astype(np.float32)
    loss = lambda p: j_mse(jm(p, jg), jnp.asarray(target))
    ctx = pltpu.force_tpu_interpret_mode() if jax_pallas else contextlib.nullcontext()
    with ctx:
        ref_out = np.asarray(jax.jit(jm.__call__)(params, jg))
        ref_loss, ref = jax.jit(jax.value_and_grad(loss))(params)
    out = tm_k(tg)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    before = [tfm.KM_FWD.launches, tfm.KM_BWD.launches, tfm.TAB_FWD.launches]
    val = t_mse(out, torch.from_numpy(target))
    val.backward()
    assert [tfm.KM_FWD.launches, tfm.KM_BWD.launches, tfm.TAB_FWD.launches] == before
    assert abs(val.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    got = params_to_jax(tm_k, grad=True)
    _assert_trees_close(got, jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_untabled_dispatch_pads_to_the_km_tile(monkeypatch):
    """The km dispatch's tile (the largest multiple of 16 in [16, 256]
    dividing n, else 64) and its zero padding: the kernel sees [K, Npad, F]
    senders, an [Npad, K*6] geometry whose padded rows are zero (mask 0)."""
    from scalable_e3_gnn_torch.models import segnn as segnn_mod

    assert [segnn_mod.SEGNNLayer._pick_km_tile(n) for n in (128, 200, 100_000, 125_000)] == [
        128, 64, 160, 64]
    jg, _, tg, _ = _graph(200, seed=230, symmetrize=False)
    _, _, tm = _models(True, seed=231, num_layers=1)
    calls = []
    real = segnn_mod.fused_message_aggregate_km
    monkeypatch.setattr(segnn_mod, "fused_message_aggregate_km",
                        lambda *a: calls.append(a) or real(*a))
    with torch.no_grad():
        tm(tg)
    ((cfg, hs3, hr, geo2, *_),) = calls
    assert cfg.tile == 64 and hs3.shape == (8, 256, 40) and hr.shape == (256, 40)
    assert geo2.shape == (256, 48) and not geo2[200:].any() and not hs3[:, 200:].any()


def test_unported_tensor_product_raises():
    """The generic tensor product and its kernels are ported: an lmax=2 model
    builds and runs without tables, and so does a message layer off the
    folded-GEMM path (``mode="sparse"``: the forward #11 and the fallback
    backward #14 on its CG-folded weights), equal to the folded layer's
    result within 1e-5.  A message layer gated by tanh (the concat-form
    gate) runs the kernels too, equal to its plain path within 1e-5; an
    activation outside the kernels' set raises."""
    tm = TSEGNN("2x0e+1x1o", "8x0e+4x1o+2x2e", "1x1o", num_layers=1, lmax_attr=2,
                use_pallas=True, device="cpu")
    assert tm.layers[0].use_pallas_generic
    jg, jgt, tg, tgt = _graph(128)
    with torch.no_grad():
        want = tm(tg)
        assert torch.isfinite(want).all()
    tm.layers[0].message_layers[0].tp.mode = "sparse"
    tm.layers[0]._generic_kernels.clear()
    with torch.no_grad():
        got = tm(tg)
    (kern,) = tm.layers[0]._generic_kernels.values()
    assert not (kern.residual_bwd or kern.replay_bwd)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    other = TSEGNN("2x0e+1x1o", "8x0e+4x1o+2x2e", "1x1o", num_layers=1, lmax_attr=2,
                   act=torch.tanh, use_pallas=True, device="cpu")
    plain = TSEGNN("2x0e+1x1o", "8x0e+4x1o+2x2e", "1x1o", num_layers=1, lmax_attr=2,
                   act=torch.tanh, use_pallas=False, device="cpu")
    plain.load_state_dict(other.state_dict())
    with torch.no_grad():
        got = other(tg)
        assert other.layers[0]._generic_kernels
        torch.testing.assert_close(got, plain(tg), rtol=0, atol=1e-5)
    unknown = TSEGNN("2x0e+1x1o", "8x0e+4x1o+2x2e", "1x1o", num_layers=1, lmax_attr=2,
                     act=torch.sigmoid, use_pallas=True, device="cpu")
    with pytest.raises(ValueError, match="activations silu"):
        with torch.no_grad():
            unknown(tg)


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    """No device= and no GPU: every entry point raises, none runs on the CPU."""
    from scalable_e3_gnn_torch.graph.octree import build_octree as t_octree
    from scalable_e3_gnn_torch.graph.radius import radius_graph_brute as t_brute

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).random((16, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSEGNN(*IRREPS, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_octree(pts, (0.0,) * 3, (1.0,) * 3, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_brute(pts, 0.2, 4)


def test_model_and_graph_devices_must_agree():
    jg, jgt, tg, tgt = _graph(128)
    _, _, tm = _models(True, seed=9)
    meta = tgt._replace(senders=tgt.senders.to("meta"))
    with pytest.raises(ValueError, match="graph is on"):
        tm(meta)


def test_wrapper_launch_count_unchanged_by_cpu_forward():
    jg, jgt, tg, tgt = _graph(128)
    _, _, tm = _models(True, seed=10)
    before = tfm.TAB_FWD.launches
    with torch.no_grad():
        tm(tgt)
    assert tfm.TAB_FWD.launches == before


@pytest.mark.parametrize("port_pallas,jax_pallas", [(True, True), (True, False),
                                                    (False, False)])
def test_segnn_gradients_match_jax(port_pallas, jax_pallas):
    """MSE-loss gradients of every parameter: the port's kernel path (the
    autograd Function, plain backward on the CPU) against JAX's Pallas custom
    VJP and against its jnp path; the port's plain path against jnp."""
    n = 200  # the last table tile is partial
    jg, jgt, tg, tgt = _graph(n)
    jm, params, _ = _models(jax_pallas, seed=21)
    tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=port_pallas, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    target = np.random.default_rng(22).standard_normal((n, 3)).astype(np.float32)
    graph_j = jgt if jax_pallas else jg
    loss = lambda p: j_mse(jm(p, graph_j), jnp.asarray(target))
    if jax_pallas:
        with pltpu.force_tpu_interpret_mode():
            ref_loss, ref = jax.jit(jax.value_and_grad(loss))(params)
    else:
        ref_loss, ref = jax.jit(jax.value_and_grad(loss))(params)
    out = t_mse(tm(tgt if port_pallas else tg), torch.from_numpy(target))
    out.backward()
    assert abs(out.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    got = params_to_jax(tm, grad=True)
    _assert_trees_close(got, jax.tree.map(np.asarray, ref))
    # the mean loss makes the gradients small (1e-5..4e-3), so also hold
    # each parameter's gradient to 1e-4 of its own largest entry
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())
