"""PyTorch port, the lmax=2 path: wigner_3j, the generic TensorProduct (sparse
and folded-GEMM modes, both layouts, fold_params), the fast gate, the tabled
generic message kernel's plain version, and a small lmax=2 SEGNN, each against
the JAX package on the same numpy inputs (the JAX Pallas kernel in interpret
mode).  Tolerances: the 3j tensors exactly equal (the same float64 numpy
code); fp32 outputs atol 2e-5 (the same math, GEMMs summed in another order);
the kernel's plain version in bf16 within 2 bf16 ulps elementwise of the JAX
kernel in bf16 (the same rounding points); the fast gate's tables exactly
equal, its output within 1e-6 of the JAX fast gate and of the concat-form
gate on the unpermuted input."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.core.spherical import spherical_harmonics as jax_sh
from scalable_e3_gnn_tpu.core.wigner import wigner_3j as j_w3j
from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.kernels.fused_message_generic import FusedMessageGeneric as JFMG
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.ops.gate import Gate as JGate
from scalable_e3_gnn_tpu.ops.tensor_product import TensorProduct as JTP
from scalable_e3_gnn_torch import TensorProduct as TTP
from scalable_e3_gnn_torch import wigner_3j as t_w3j
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph as TGraph
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.models.segnn import SEGNNLayer
from scalable_e3_gnn_torch.ops.gate import Gate as TGate
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

ATOL = 2e-5
LO, HI = (-4.0,) * 3, (4.0,) * 3
IRREPS = ("2x0e+1x1o", "4x0e+2x1o+2x2e", "1x1o")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("l1", [0, 1, 2, 3])
def test_wigner_3j_equals_jax(l1):
    for l2 in range(4):
        for l3 in range(4):
            np.testing.assert_array_equal(t_w3j(l1, l2, l3), j_w3j(l1, l2, l3))


SPEC = ("4x0e+2x1o+2x2e", "1x0e+1x1o+1x2e", "3x0e+2x1o+1x2e+1x1e")


@pytest.mark.parametrize("mode,lin,lout", [("auto", "cm", "cm"), ("auto", "cm", "mul"),
                                           ("auto", "mul", "cm"), ("sparse", "cm", "cm"),
                                           ("sparse", "mul", "mul"), ("gemm", "cm", "mul")])
def test_tensor_product_matches_jax(mode, lin, lout):
    jtp = JTP(*SPEC, layout_in1=lin, layout_out=lout, mode=mode)
    ttp = TTP(*SPEC, layout_in1=lin, layout_out=lout, mode=mode, device="cpu")
    assert ttp._gemm_default() == jtp._gemm_default()
    assert ttp.instructions == jtp.instructions
    assert ttp.param_shapes() == dict(jtp._w_shapes)
    params = jtp.init(jax.random.key(0))
    params_from_jax(ttp, _np_tree(params))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, jtp.in1_dim)).astype(np.float32)
    attr = np.array(jax_sh(2, jnp.asarray(rng.standard_normal((40, 3)).astype(np.float32))))
    ref = np.asarray(jax.jit(jtp.__call__)(params, jnp.asarray(x), jnp.asarray(attr)))
    got = ttp(torch.from_numpy(x), torch.from_numpy(attr)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if lin == "cm":  # the folded weight matrix: one fp32 product per entry, so equal
        np.testing.assert_array_equal(ttp.fold_params().detach().numpy(),
                                      np.asarray(jtp.fold_params(params)["w_folded"]))


def test_tensor_product_gradients_match_jax():
    """Gradients of <out, cotangent> in the inputs and the parameters, through
    fold_params (fp32 atol 2e-5)."""
    spec = ("4x0e+2x1o+2x2e", "1x0e+1x1o+1x2e", "4x0e+2x1o+2x2e")
    jtp = JTP(*spec, layout_in1="cm", layout_out="cm")
    ttp = TTP(*spec, layout_in1="cm", layout_out="cm", device="cpu")
    params = jtp.init(jax.random.key(2))
    params_from_jax(ttp, _np_tree(params))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, jtp.in1_dim)).astype(np.float32)
    attr = np.array(jax_sh(2, jnp.asarray(rng.standard_normal((30, 3)).astype(np.float32))))
    ct = rng.standard_normal((30, jtp.out_dim)).astype(np.float32)
    f = lambda p, x_: jnp.sum(jtp(p, x_, jnp.asarray(attr)) * ct)
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ttp(xt, torch.from_numpy(attr)) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL)
    got = params_to_jax(ttp, grad=True)
    for name in got:
        np.testing.assert_allclose(got[name], np.asarray(gp[name]), atol=1e-4)


@pytest.mark.parametrize("scalars,gated", [("24x0e", "12x1o+6x2e"), ("3x0e", "2x1o+1x2e+1x1e")])
def test_gate_fast_tables_and_apply(scalars, gated):
    jg, tg = JGate(scalars, gated, layout="cm"), TGate(scalars, gated, layout="cm")
    for a, b in zip(jg.fast_tables(), tg.fast_tables(), strict=True):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    perm, psel, dk = tg.fast_tables()
    y = np.random.default_rng(4).standard_normal((33, tg.irreps_in.dim)).astype(np.float32)
    # the selection form on permuted y against the concat form on y: silu is
    # x * sigmoid(x) rounded once or twice, so 1e-6 in fp32 and one bf16 step
    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -7)):
        yt = torch.from_numpy(y).to(dt)
        fast, ref_t = tg.fast_apply(yt[:, perm], psel, dk).float(), tg(yt).float()
        assert fast.shape == ref_t.shape == (33, dk)
        assert ((fast - ref_t).abs() <= tol * ref_t.abs().clamp(min=1.0)).all()
    ref = np.asarray(jg.fast_apply(jnp.asarray(y[:, perm]), jnp.asarray(psel), dk))
    got = tg.fast_apply(torch.from_numpy(y[:, perm]), psel, dk).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _graph(n, seed=0, k=8):
    """JAX graph (symmetrized, tables at the generic tile) and the port's
    graph of the same arrays with its own tables."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.9, max_neighbors=k))(tree.points)
    feats = jnp.asarray(rng.standard_normal((n, 5)), jnp.float32)
    jg = JGraph.from_radius_edges(feats, tree.points, e, symmetrize=True)
    tile = SEGNNLayer._pick_generic_tile(n)
    t = lambda a: torch.from_numpy(np.array(a))
    tg = TGraph(nodes=t(jg.nodes), positions=t(jg.positions), senders=t(jg.senders),
                edge_mask=t(jg.edge_mask), node_mask=t(jg.node_mask),
                node_graph=t(jg.node_graph), n_graphs=1, reverse_slot=t(jg.reverse_slot))
    return jg, jg.with_gather_tables(tile=tile), tg, tg.with_gather_tables(tile=tile)


def _models(use_pallas, seed, num_layers=2):
    jm = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=num_layers, layout="cm",
                use_pallas=use_pallas)
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=num_layers, layout="cm",
                use_pallas=use_pallas, device="cpu")
    params_from_jax(tm, _np_tree(params))
    return jm, params, tm


def test_params_round_trip_lmax2():
    """params_from_jax / params_to_jax carry the generic TP's w{io} keys and
    the lmax=2 head unchanged."""
    _, params, tm = _models(True, seed=1)
    back = params_to_jax(tm)
    assert jax.tree.structure(back) == jax.tree.structure(_np_tree(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np_tree(params)), strict=True):
        np.testing.assert_array_equal(a, b)


def _kernel_problem(n, seed):
    """One layer's message inputs on the JAX and the port side: node features,
    the packed geometry with extra masked slots, and the tables."""
    jg, jgt, tg, tgt = _graph(n)
    jm, params, tm = _models(True, seed=seed)
    k = tg.senders.shape[1]
    attrs = tm.compute_attributes_dense(tgt)
    rng = np.random.default_rng(seed + 1)
    geo = attrs[3].numpy().reshape(n, k, -1).copy()
    geo[..., -1] *= rng.random((n, k)) > 0.2  # extra masked slots
    geo2 = geo.reshape(n, -1)
    h = rng.standard_normal((n, tm.hidden_irreps.dim)).astype(np.float32)
    return jgt, tgt, params, tm, k, geo2, h


@pytest.mark.parametrize("n", [96, 240])
def test_generic_plain_matches_jax_geo_call_tab(n):
    """fp32, atol 2e-5: the port's plain version (and its entry through
    FusedMessageGeneric) against the JAX kernel in interpret mode."""
    jgt, tgt, params, tm, k, geo2, h = _kernel_problem(n, seed=n)
    layer = tm.layers[0]
    tile = layer._pick_generic_tile(n)
    assert tgt.gather_tile == tile and layer._tab_eligible(n, tgt)
    jlayer = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm",
                    use_pallas=True).layers[0]
    jk = JFMG(jlayer.message_layers, k, tile=tile)
    lp = params["layer_0"]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.geo_call_tab((lp["msg_0"], lp["msg_1"]), jnp.asarray(h),
                                         jnp.asarray(geo2), jgt.gather_loc, jgt.gather_tab,
                                         jgt.gather_rev_dense, jgt.gather_rem_pos,
                                         jgt.gather_rem_node))
    kern = fmg.FusedMessageGeneric(layer.message_layers, k, tile=tile)
    args = (torch.from_numpy(h), torch.from_numpy(geo2), tgt.gather_loc, tgt.gather_tab)
    rev = (tgt.gather_rev_dense, tgt.gather_rem_pos, tgt.gather_rem_node)
    with torch.no_grad():
        got = kern.geo_call_tab(*args, *rev).numpy()
        cfg = kern.config(geo2.shape[1] // k - 2, tgt.gather_tab.shape[1])
        sels, ws = kern.selections("cpu"), kern.fold(torch.float32)
        plain = fmg.generic_tab_fwd_plain(cfg, *args, ws, sels).numpy()
        # receivers in chunks of 5 (a chunk edge inside a tile) give the same sums
        chunked = fmg.generic_tab_fwd_plain(cfg, *args, ws, sels, chunk_rows=5 * k).numpy()
    assert got.shape == (n, tm.hidden_irreps.dim)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(plain, got)
    np.testing.assert_allclose(chunked, plain, atol=1e-6)


@pytest.mark.parametrize("n", [96, 240])
def test_generic_plain_bf16_matches_jax_geo_call_tab(n):
    """bf16: the plain version rounds where the JAX kernel (interpret mode)
    does.  Elementwise within 2 bf16 ulps of max(|ref|, mean|ref|), and at
    least 99% of the elements equal (fp32 sums in another order may flip a
    rounding step now and then)."""
    jgt, tgt, params, tm, k, geo2, h = _kernel_problem(n, seed=n + 20)
    tile = SEGNNLayer._pick_generic_tile(n)
    jlayer = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm",
                    use_pallas=True).layers[0]
    jk = JFMG(jlayer.message_layers, k, tile=tile)
    lp = params["layer_0"]
    with pltpu.force_tpu_interpret_mode():
        ref = jk.geo_call_tab((lp["msg_0"], lp["msg_1"]), jnp.asarray(h, jnp.bfloat16),
                              jnp.asarray(geo2, jnp.bfloat16), jgt.gather_loc, jgt.gather_tab,
                              jgt.gather_rev_dense, jgt.gather_rem_pos, jgt.gather_rem_node)
    assert ref.dtype == jnp.bfloat16
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=tile)
    bf = torch.bfloat16
    with torch.no_grad():
        got = kern.geo_call_tab(torch.from_numpy(h).to(bf), torch.from_numpy(geo2).to(bf),
                                tgt.gather_loc, tgt.gather_tab, tgt.gather_rev_dense,
                                tgt.gather_rem_pos, tgt.gather_rem_node)
    assert got.dtype == bf and got.shape == ref.shape
    err = (got.float() - ref).abs()
    r = ref.abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp(min=float(r.mean())))) - 7)
    assert float((err / ulp).max()) <= 2
    assert float((err == 0).float().mean()) >= 0.99


def test_generic_plain_bf16_rounding_points():
    """bf16: the plain version rounds where the kernel does; against the same
    function in fp32 from the bf16-rounded inputs it stays within 3e-2 of
    max|ref| (the rounding of y, the gate and the slot messages)."""
    n = 96
    _, tgt, _, tm, k, geo2, h = _kernel_problem(n, seed=3)
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=96)
    cfg = kern.config(geo2.shape[1] // k - 2, tgt.gather_tab.shape[1])
    bf = torch.bfloat16
    hb, gb = torch.from_numpy(h).to(bf), torch.from_numpy(geo2).to(bf)
    with torch.no_grad():
        got = fmg.generic_tab_fwd(cfg, hb, gb, tgt.gather_loc, tgt.gather_tab,
                                  kern.fold(bf), kern.selections("cpu"))
        ref = fmg.generic_tab_fwd(cfg, hb.float(), gb.float(), tgt.gather_loc,
                                  tgt.gather_tab, [w.float() for w in kern.fold(bf)],
                                  kern.selections("cpu"))
    assert got.dtype == bf and torch.isfinite(got).all()
    err = float((got.float() - ref).abs().max())
    assert 0 < err <= 3e-2 * float(ref.abs().max())


@pytest.mark.parametrize("n", [96, 240])
def test_segnn_lmax2_forward_matches_jax_pallas(n):
    """The geo-only attributes (None, node_attr, None, edge_geo), as bench.py
    passes them, through the generic kernel path: fp32 atol 2e-5."""
    jg, jgt, tg, tgt = _graph(n)
    jm, params, tm = _models(True, seed=n + 2)
    assert tm.layers[0].use_pallas_generic and not tm.layers[0].use_pallas
    with pltpu.force_tpu_interpret_mode():
        ja = jax.jit(jm.compute_attributes_dense)(jgt)
        ref = np.asarray(jax.jit(lambda p, g, a: jm(p, g, attrs=a))(
            params, jgt, (None, ja[1], None, ja[3])))
    calls = []
    real = fmg.generic_tab_fwd
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(fmg, "generic_tab_fwd", lambda *a: calls.append(a) or real(*a))
        ta = tm.compute_attributes_dense(tgt)
        got = tm(tgt, attrs=(None, ta[1], None, ta[3])).numpy()
        got_full = tm(tgt).numpy()
    assert len(calls) == 4  # two layers, two forwards: every layer went through the kernel
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(got_full, got)


@pytest.mark.parametrize("n", [96, 240])
def test_segnn_lmax2_plain_matches_jax_jnp(n):
    jg, jgt, tg, tgt = _graph(n)
    jm, params, tm = _models(False, seed=n + 3)
    ref = np.asarray(jax.jit(jm.__call__)(params, jg))
    with torch.no_grad():
        got = tm(tg).numpy()
        ta = tm.compute_attributes_dense(tg)
        geo_only = tm(tg, attrs=(None, ta[1], None, ta[3])).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(geo_only, got)


def test_segnn_lmax2_kernel_path_equals_plain_path_in_the_port():
    jg, jgt, tg, tgt = _graph(240)
    _, _, tm_k = _models(True, seed=7)
    tm_p = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", use_pallas=False,
                  device="cpu")
    tm_p.load_state_dict(tm_k.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(tm_k(tgt), tm_p(tg), rtol=0, atol=ATOL)


def test_segnn_lmax2_serves_clouds_at_two_tiles():
    """One model on clouds whose sizes pick different tiles (96 -> 96,
    240 -> 120), and back: each through the kernel path equals the plain path
    (fp32 atol 2e-5)."""
    _, _, tm_k = _models(True, seed=8)
    tm_p = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", use_pallas=False,
                  device="cpu")
    tm_p.load_state_dict(tm_k.state_dict())
    tiles = []
    with torch.no_grad():
        for n in (96, 240, 96):
            _, _, tg, tgt = _graph(n)
            tiles.append(tgt.gather_tile)
            torch.testing.assert_close(tm_k(tgt), tm_p(tg), rtol=0, atol=ATOL)
    assert tiles == [96, 120, 96]
    # one kernel object per (K, tile, backward tile, residual mode, replay_bwd)
    assert sorted(tm_k.layers[0]._generic_kernels) == [(8, 96, 96, True, True),
                                                        (8, 120, 120, True, True)]


def test_segnn_lmax2_attributes_match_jax():
    jg, jgt, tg, tgt = _graph(96)
    jm, _, tm = _models(False, seed=5)
    ref = jax.jit(jm.compute_attributes_dense)(jg)
    for a, b in zip(ref, tm.compute_attributes_dense(tg), strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_generic_tables_at_another_tile_raise():
    """Tables at another tile than _pick_generic_tile(n), or none: the
    untabled generic kernel (#11, here its plain version) serves the layer
    and agrees with the plain path (fp32 atol 2e-5)."""
    jg, jgt, tg, tgt = _graph(96)
    _, _, tm = _models(True, seed=9)
    tm_p = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", use_pallas=False,
                  device="cpu")
    tm_p.load_state_dict(tm.state_dict())
    calls = []
    real = fmg.generic_fwd
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(fmg, "generic_fwd", lambda *a, **kw: calls.append(a) or real(*a, **kw))
        for graph in (tg, tg.with_gather_tables(tile=32)):
            assert not tm.layers[0]._tab_eligible(96, graph)
            torch.testing.assert_close(tm(graph), tm_p(tg), rtol=0, atol=ATOL)
    assert len(calls) == 4  # two layers, two graphs


def test_generic_flops_count_the_folded_nonzeros():
    """The bound's operation count: 2 x the nonzeros of every layer's folded
    weights (random weights leave none of them zero), below the dense GEMMs."""
    _, _, tm = _models(True, seed=12)
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, 8, tile=96)
    nnz = sum(int(torch.count_nonzero(w)) for w in kern.fold(torch.float32))
    assert kern.flops_per_slot() == 2 * nnz
    assert kern.flops_per_slot() < kern.config(9, 128).dense_flops_per_slot()


def test_tensor_core_weight_layout():
    """The tensor-core engine's weights: [A*C1, D] -> [A, D8, C16],
    transposed per component and zero-padded."""
    a, c1, d = 3, 21, 13
    w = torch.arange(a * c1 * d, dtype=torch.float32).reshape(a * c1, d)
    got = fmg._mma_layout(w, a, c1, d)
    assert got.shape == (a, 16, 32)
    for c in range(a):
        torch.testing.assert_close(got[c, :d, :c1], w[c * c1:(c + 1) * c1].T, rtol=0, atol=0)
    assert (got[:, d:] == 0).all() and (got[:, :, c1:] == 0).all()


def test_generic_wrapper_checks_its_inputs():
    _, tgt, _, tm, k, geo2, h = _kernel_problem(96, seed=11)
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=96)
    cfg = kern.config(geo2.shape[1] // k - 2, tgt.gather_tab.shape[1])
    ht, gt = torch.from_numpy(h), torch.from_numpy(geo2)
    ws, sels = kern.fold(torch.float32), kern.selections("cpu")
    with pytest.raises(ValueError, match="tile"):
        fmg.generic_tab_fwd(cfg, ht[:95], gt[:95], tgt.gather_loc[:95], tgt.gather_tab, ws, sels)
    with pytest.raises(TypeError, match="geo2"):
        fmg.generic_tab_fwd(cfg, ht, gt.double(), tgt.gather_loc, tgt.gather_tab, ws, sels)
    with pytest.raises(ValueError, match="weight 1"):
        fmg.generic_tab_fwd(cfg, ht, gt, tgt.gather_loc, tgt.gather_tab, [ws[0], ws[1][:-1]], sels)
    with pytest.raises(ValueError, match="no kernel for device"):
        fmg.generic_tab_fwd(cfg, ht.to("meta"), gt.to("meta"), tgt.gather_loc.to("meta"),
                            tgt.gather_tab.to("meta"), [w.to("meta") for w in ws],
                            [s.to("meta") for s in sels])
    before = fmg.GENERIC_TAB_FWD.launches
    with torch.no_grad():
        fmg.generic_tab_fwd(cfg, ht, gt, tgt.gather_loc, tgt.gather_tab, ws, sels)
    assert fmg.GENERIC_TAB_FWD.launches == before  # the CPU runs the plain version
