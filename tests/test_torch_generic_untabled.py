"""PyTorch port, the untabled generic message path and the memory ladder,
against the JAX package on the same numpy inputs (its Pallas kernels in
interpret mode, ``colpad`` off): ``take_dense_symmetric_km``, the plain
versions of kernels #11 (with and without its save mode), #12 and #13, the
autograd entries ``geo_call`` and ``geo_call_sym``, the layer's dispatch with
the ``npad != n`` padding, small lmax=2 SEGNNs through each untabled dispatch,
``edge_chunks`` with ``remat_kernel`` and ``remat_layers``,
``compute_attributes_dense_chunked`` and ``radius_graph_cell_segments``.

Tolerances, each with its reason:
- the gathers and the edges: bitwise (the same operations in the same order).
- the chunked attributes: bitwise against the port's whole-graph ones; against
  JAX fp32 atol 1e-6 and the bf16 casts within one rounding step (the port's
  spherical harmonics sum and contract in another order than XLA: up to 6e-7
  apart, as ``test_segnn_lmax2_attributes_match_jax`` allows).
- fp32 against the JAX kernels: 2e-5 * max(1, |ref|) elementwise (the same
  math, GEMMs summed in another order); #12 against #13 within 1e-6.
- bf16 against the JAX kernels: within 32 bf16 ulps of max(|ref|, mean|ref|)
  elementwise.  Interpret mode runs the kernel body through XLA on the CPU,
  which keeps some bf16 intermediates in fp32; the port rounds where the JAX
  code does.
- models: loss and every gradient rtol 1e-4 and 1e-4 * max|ref| per parameter
  (fp32 through 2 layers, sums in another order, the chunked and
  checkpointed forms of the same function); the chunked port against the
  unchunked port: forward 1e-5, gradients 1e-4 * max|ref|.
"""

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
from scalable_e3_gnn_tpu.graph.octree import build_octree as j_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute as j_brute
from scalable_e3_gnn_tpu.graph.radius import radius_graph_cell_segments as j_segments
from scalable_e3_gnn_tpu.graph.radius import suggest_cell_capacity as j_cap
from scalable_e3_gnn_tpu.kernels.fused_message_generic import FusedMessageGeneric as JFMG
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.ops.gather_scatter import take_dense_symmetric_km as j_tdskm
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph as TGraph
from scalable_e3_gnn_torch.graph.octree import build_octree as t_octree
from scalable_e3_gnn_torch.graph.radius import radius_graph_cell as t_cell
from scalable_e3_gnn_torch.graph.radius import radius_graph_cell_segments as t_segments
from scalable_e3_gnn_torch.graph.radius import suggest_cell_capacity as t_cap
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.ops.gather_scatter import take_dense_symmetric_km
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_generic import IRREPS, LO, HI, _graph, _kernel_problem

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _ulps(got, ref):
    """|got - ref| elementwise in bf16 ulps of max(|ref|, mean|ref|)."""
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    r = ref.abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp(min=max(float(r.mean()), 1e-30)))) - 7)
    return (got - ref).abs() / ulp


def _close(got, ref, dtype):
    """The kernel-level limit: fp32 2e-5 * max(1, |ref|), bf16 32 ulps."""
    got, ref = got.float(), _f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if dtype == "float32":
        err = (got - ref).abs()
        assert bool((err <= 2e-5 * ref.abs().clamp(min=1.0)).all()), float(err.max())
    else:
        assert float(_ulps(got, ref).max()) <= 32


def _setup(n, seed, dtype, residual=True):
    """One layer's untabled kernel inputs on both sides: hs = h[senders.T],
    h, the packed geometry (extra masked slots), the folded weights, a
    cotangent; the JAX kernel object (colpad off) and the port's config."""
    jdt, tdt = DTYPES[dtype]
    jgt, tgt, params, tm, k, geo2, h = _kernel_problem(n, seed=seed)
    tile = tm.layers[0]._pick_generic_tile(n)
    jlayer = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm",
                    use_pallas=True).layers[0]
    jk = JFMG(jlayer.message_layers, k, tile=tile, residual_bwd=residual)
    lp = params["layer_0"]
    ptuple = (lp["msg_0"], lp["msg_1"])
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=tile,
                                   residual_bwd=residual)
    cfg = kern.config(geo2.shape[1] // k - 2, 0)
    senders = tgt.senders.numpy()
    hs = h[np.minimum(senders, n - 1).T]  # [K, N, F]
    dagg = np.random.default_rng(seed + 7).standard_normal((n, cfg.out_dim)).astype(np.float32)
    jargs = tuple(jnp.asarray(x, jdt) for x in (hs, h, geo2, dagg))
    targs = (torch.from_numpy(hs).to(tdt), torch.from_numpy(h).to(tdt),
             torch.from_numpy(geo2).to(tdt), kern.fold(tdt), kern.selections("cpu"))
    return dict(jk=jk, ptuple=ptuple, folded=jk._fold(ptuple), jgt=jgt, tgt=tgt, tm=tm,
                kern=kern, cfg=cfg, k=k, n=n, jargs=jargs, targs=targs, h=h, geo2=geo2,
                d_agg=torch.from_numpy(dagg).to(tdt), params=params)


# ---- take_dense_symmetric_km

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_dense_symmetric_km_matches_jax(dtype):
    """The clamped slot-major gather and its reverse-slot gather-sum VJP
    (invalid slots zeroed, the K terms summed): bitwise."""
    jdt, tdt = DTYPES[dtype]
    jg, _, tg, _ = _graph(240)
    n, k = tg.senders.shape
    rng = np.random.default_rng(3)
    h = rng.standard_normal((n, 7)).astype(np.float32)
    ct = (rng.standard_normal((k, n, 7)) * np.exp2(rng.integers(-4, 4, (k, n, 1)))).astype(
        np.float32)
    out, vjp = jax.vjp(lambda x: j_tdskm(x, jg.senders, jg.reverse_slot, jg.edge_mask),
                       jnp.asarray(h, jdt))
    (ref,) = vjp(jnp.asarray(ct, jdt))
    ht = torch.from_numpy(h).to(tdt).requires_grad_()
    got = take_dense_symmetric_km(ht, tg.senders, tg.reverse_slot)
    got.backward(torch.from_numpy(ct).to(tdt))
    assert got.dtype == ht.grad.dtype == tdt
    assert torch.equal(got.detach().float(), _f32(out))
    assert torch.equal(ht.grad.float(), _f32(ref))
    assert int((tg.reverse_slot == n * k).sum()) > 0  # slots without a partner were met


# ---- kernel #11's plain version (and its save mode)

@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [96, 240])
def test_untabled_fwd_plain_matches_jax(n, dtype, save):
    """agg (and both saved ys: [K, N, D] slot-major in JAX, [N*K, D] here)
    against ``_fwd_call``."""
    p = _setup(n, n + 60, dtype)
    hs, h, g2, _ = p["jargs"]
    with pltpu.force_tpu_interpret_mode():
        ref = p["jk"]._fwd_call(p["folded"], hs, h, g2, save=save)
    with torch.no_grad():
        got = fmg.generic_fwd(p["cfg"], *p["targs"], save=save)
    if save:
        (got, ys), (ref, rys) = got, ref
        assert len(ys) == 2
        for y, ry in zip(ys, rys):
            _close(y, jnp.swapaxes(ry, 0, 1).reshape(n * p["k"], -1), dtype)
        assert torch.equal(got, fmg.generic_fwd_plain(p["cfg"], *p["targs"]))
    assert got.dtype == p["targs"][1].dtype
    _close(got, ref, dtype)


# ---- kernels #12 and #13's plain versions

@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untabled_bwd_plain_matches_jax(residual, dtype):
    """d_hs [K, N, F], d_hr and both dW' against ``_bwd_call_res`` (#12, from
    the saved ys) and ``_bwd_call_rep`` (#13, replay)."""
    p = _setup(240, 71, dtype, residual=residual)
    jk, (hs, h, g2, dj) = p["jk"], p["jargs"]
    with pltpu.force_tpu_interpret_mode():
        if residual:
            _, ys = jk._fwd_call(p["folded"], hs, h, g2, save=True)
            dp, dhs, dhr = jk._bwd_call_res(p["folded"], hs, h, g2, ys, dj)
        else:
            dp, dhs, dhr = jk._bwd_call_rep(p["folded"], hs, h, g2, dj)
    with torch.no_grad():
        tys = fmg.generic_fwd(p["cfg"], *p["targs"], save=True)[1] if residual else None
        d_hs, d_hr, dws = fmg.generic_bwd(p["cfg"], *p["targs"], p["d_agg"], ys=tys)
    assert d_hs.dtype == d_hr.dtype == p["targs"][1].dtype
    assert all(dw.dtype == torch.float32 for dw in dws)
    for got, ref in [(d_hs, dhs), (d_hr, dhr)] + [(dw, d["w_folded"]) for dw, d in zip(dws, dp)]:
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untabled_bwd_residual_equals_replay(dtype):
    """#12's plain version (saved ys) against #13's (replay): fp32 within
    1e-6, bf16 bitwise (both round y where the forward does); chunks of 7
    receivers give the same d_hs."""
    p = _setup(240, 73, dtype)
    cfg, args, d_agg = p["cfg"], p["targs"], p["d_agg"]
    with torch.no_grad():
        _, ys = fmg.generic_fwd_plain(cfg, *args, save=True)
        res = fmg.generic_bwd_plain(cfg, *args, d_agg, ys=ys)
        rep = fmg.generic_bwd_plain(cfg, *args, d_agg)
        ch = fmg.generic_bwd_plain(cfg, *args, d_agg, chunk_rows=7 * p["k"])
    pairs = [(res[0], rep[0]), (res[1], rep[1])] + list(zip(res[2], rep[2]))
    for a, b in pairs:
        if dtype == "float32":
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        else:
            assert torch.equal(a, b)
    assert torch.equal(ch[0], rep[0]) and torch.equal(ch[1], rep[1])


# ---- the autograd entries

def _got_ys(args, kw):
    """Whether a ``generic_bwd`` call got the saved ys (its 8th argument)."""
    return (args[7] if len(args) > 7 else kw.get("ys")) is not None


def _entry_grads(p, mode):
    """Output and gradients (h, then every message parameter) of <agg, ct>
    through the port's entry and through the JAX one."""
    jk, n, k = p["jk"], p["n"], p["k"]
    ct = np.random.default_rng(9).standard_normal((n, p["cfg"].out_dim)).astype(np.float32)
    jg = p["jgt"]
    g2 = jnp.asarray(p["geo2"])
    hsj = lambda hh: jnp.take(hh, jg.senders.T, axis=0, mode="clip")
    if mode == "sym":
        jf = lambda pt, hh: jk.geo_call_sym(pt, hh, g2, jg.senders, jg.reverse_slot)
    else:
        jf = lambda pt, hh: jk.geo_call(pt, hsj(hh), hh, g2)
    with pltpu.force_tpu_interpret_mode():
        ref_out = np.asarray(jf(p["ptuple"], jnp.asarray(p["h"])))
        gp, gh = jax.grad(lambda a: jnp.sum(jf(*a) * ct))((p["ptuple"], jnp.asarray(p["h"])))
    tm, tg = p["tm"], p["tgt"]
    tm.zero_grad()
    h = torch.from_numpy(p["h"]).requires_grad_()
    g2t = torch.from_numpy(p["geo2"])
    if mode == "sym":
        out = p["kern"].geo_call_sym(h, g2t, tg.senders, tg.reverse_slot)
    else:
        out = p["kern"].geo_call(h[torch.clamp(tg.senders.t(), max=n - 1).long()], h, g2t)
    (out * torch.from_numpy(ct)).sum().backward()
    pairs = [(h.grad, _f32(gh))]
    grads = params_to_jax(tm, grad=True)["layer_0"]
    for i, jp in enumerate(gp):
        for name, ref in jp.items():
            pairs.append((torch.from_numpy(grads[f"msg_{i}"][name]), _f32(ref)))
    return out.detach(), ref_out, pairs


@pytest.mark.parametrize("mode", ["residual", "replay", "sym"])
def test_geo_call_gradients_match_jax(mode):
    """``geo_call`` in residual (#11 save + #12) and replay (#11 + #13) mode,
    and ``geo_call_sym`` (the gather inside, #13, the reverse-slot
    gather-sum), against the JAX entries under ``jax.grad``: the forward
    within 2e-5, every gradient 1e-4 * max|ref|."""
    p = _setup(240, 75, "float32", residual=mode == "residual")
    calls = []
    real = fmg.generic_bwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fmg, "generic_bwd", lambda *a, **kw: calls.append(_got_ys(a, kw)) or
                   real(*a, **kw))
        out, ref_out, pairs = _entry_grads(p, mode)
    assert calls == [mode == "residual"]
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5)
    assert len(pairs) > 3
    for got, ref in pairs:
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("n", [100, 240])
def test_layer_dispatch_pads_to_the_tile(n):
    """The layer's untabled dispatch (take_dense_symmetric_km + geo_call,
    residual) against the JAX ``_fused_messages_generic`` on a graph without
    tables; n=100 has no multiple of 8 in [48, 224] as a divisor, so both pad
    to tile 64 (npad 128): output and gradients as the model tests."""
    jg, _, tg, _ = _graph(n)
    jm = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm", use_pallas=True)
    params = jm.init(jax.random.key(n))
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=True, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    jl, tl = jm.layers[0], tm.layers[0]
    assert (tl._pick_generic_tile(n) == 64) == (n == 100)
    rng = np.random.default_rng(n + 1)
    h = rng.standard_normal((n, tm.hidden_irreps.dim)).astype(np.float32)
    geo = tm.compute_attributes_dense(tg)[3].numpy()
    ct = rng.standard_normal((n, tm.hidden_irreps.dim)).astype(np.float32)

    def jf(lp, hh):
        return jl._fused_messages_generic(lp, hh, hh, jg.senders, None, None, jg.edge_mask,
                                          reverse_slot=jg.reverse_slot,
                                          edge_geo=jnp.asarray(geo))

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jf(params["layer_0"], jnp.asarray(h)))
        gp, gh = jax.grad(lambda a: jnp.sum(jf(*a) * ct))((params["layer_0"], jnp.asarray(h)))
    ht = torch.from_numpy(h).requires_grad_()
    out = tl._fused_messages_generic(ht, ht, tg.senders, None, None, tg.edge_mask,
                                     reverse_slot=tg.reverse_slot,
                                     edge_geo=torch.from_numpy(geo))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5)
    (out * torch.from_numpy(ct)).sum().backward()
    grads = params_to_jax(tm, grad=True)["layer_0"]
    pairs = [(ht.grad, _f32(gh))] + [(torch.from_numpy(grads[m][nm]), _f32(v))
                                     for m in ("msg_0", "msg_1") for nm, v in gp[m].items()]
    for got, want in pairs:
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_untabled_wrapper_checks_its_inputs():
    p = _setup(96, 77, "float32")
    cfg, (hs, h, g2, ws, sels), d_agg = p["cfg"], p["targs"], p["d_agg"]
    with pytest.raises(ValueError, match="hs has shape"):
        fmg.generic_fwd(cfg, hs[:, :-1], h, g2, ws, sels)
    with pytest.raises(TypeError, match="hs is"):
        fmg.generic_fwd(cfg, hs.double(), h, g2, ws, sels)
    with pytest.raises(ValueError, match="d_agg"):
        fmg.generic_bwd(cfg, hs, h, g2, ws, sels, d_agg[:, :-1])
    with pytest.raises(ValueError, match="no kernel for device"):
        fmg.generic_bwd_kernels(cfg, hs.to("meta"), h.to("meta"), g2.to("meta"),
                                [w.to("meta") for w in ws], [s.to("meta") for s in sels],
                                d_agg.to("meta"))
    before = [kern.launches for kern in fmg.KERNELS]
    with torch.no_grad():
        _, ys = fmg.generic_fwd(cfg, hs, h, g2, ws, sels, save=True)
        fmg.generic_bwd(cfg, hs, h, g2, ws, sels, d_agg, ys=ys)
    assert [kern.launches for kern in fmg.KERNELS] == before  # the CPU runs the plain versions


# ---- the model through each untabled dispatch

@functools.lru_cache(maxsize=None)
def _plain_graph(n, seed=0, k=8):
    """A graph without symmetrization (no reverse slots) on both sides."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda q: j_octree(q, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda q: j_brute(q, 0.9, max_neighbors=k))(tree.points)
    feats = jnp.asarray(rng.standard_normal((n, 5)), jnp.float32)
    jg = JGraph.from_radius_edges(feats, tree.points, e, symmetrize=False)
    t = lambda a: torch.from_numpy(np.array(a))
    tg = TGraph(nodes=t(jg.nodes), positions=t(jg.positions), senders=t(jg.senders),
                edge_mask=t(jg.edge_mask), node_mask=t(jg.node_mask),
                node_graph=t(jg.node_graph), n_graphs=1)
    return jg, tg


def _pair(seed, jkw, tkw=None, num_layers=2):
    jm = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=num_layers, layout="cm", **jkw)
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=num_layers, layout="cm", device="cpu",
                **(jkw if tkw is None else tkw))
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _assert_grads(loss_t, loss_j, tm, ref):
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    got = params_to_jax(tm, grad=True)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


MODEL_PATHS = {  # dispatch -> (model settings, symmetrized graph, backward gets ys)
    "gather": (dict(use_pallas=True), False, True),
    "take_dense_symmetric_km": (dict(use_pallas=True), True, True),
    "sym_regather": (dict(use_pallas=True, remat=True, remat_kernel=True), True, False),
}


@pytest.mark.parametrize("path", sorted(MODEL_PATHS))
def test_segnn_untabled_gradients_match_jax(monkeypatch, path):
    """The MSE loss and every gradient of a 2-layer lmax=2 SEGNN without
    gather tables, through the plain gather (no reverse slots), through
    ``take_dense_symmetric_km`` (residual) and through the sym-regather
    entry (``remat_kernel``), against ``jax.grad`` of the JAX model."""
    kw, sym, residual = MODEL_PATHS[path]
    n = 96
    if sym:
        jgraph, _, tgraph, _ = _graph(n)
    else:
        jgraph, tgraph = _plain_graph(n)
    jm, params, tm = _pair(31, kw)
    y = np.random.default_rng(32).standard_normal((n, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        loss_j, ref = jax.jit(jax.value_and_grad(
            lambda p: jpipe.mse_loss(jm(p, jgraph), jnp.asarray(y))))(params)
    calls, sym_calls = [], []
    real, real_sym = fmg.generic_bwd, fmg.FusedMessageGeneric.geo_call_sym
    monkeypatch.setattr(fmg, "generic_bwd",
                        lambda *a, **kw_: calls.append(_got_ys(a, kw_)) or real(*a, **kw_))
    monkeypatch.setattr(fmg.FusedMessageGeneric, "geo_call_sym",
                        lambda *a: sym_calls.append(1) or real_sym(*a))
    loss_t = tpipe.mse_loss(tm(tgraph), torch.from_numpy(y))
    loss_t.backward()
    assert calls == [residual] * 2
    assert len(sym_calls) == (2 if path == "sym_regather" else 0)
    _assert_grads(loss_t.item(), float(loss_j), tm, ref)


# ---- the memory ladder: edge_chunks, remat_kernel, remat_layers

LADDER = dict(use_pallas=True, remat=True, remat_kernel=True)


@pytest.mark.parametrize("remat_layers", [0, 2])
@pytest.mark.parametrize("edge_chunks", [2, 4])
def test_chunked_model_matches_jax(edge_chunks, remat_layers):
    """The port with ``edge_chunks``, ``remat_kernel`` and ``remat_layers``
    (kernel path, blocks of 48 or 24 nodes padded to tile 64) against the
    JAX model with ``use_pallas=False`` and the same chunking (Pallas in
    interpret mode cannot run under ``jax.checkpoint``), and against the
    unchunked JAX kernel model without ``remat_kernel``: loss and every
    gradient."""
    n = 96
    jg, _, tg, _ = _graph(n)
    ladder = dict(edge_chunks=edge_chunks, remat_layers=remat_layers, remat=True)
    jm, params, tm = _pair(33, dict(use_pallas=False, remat_kernel=True, **ladder),
                           dict(LADDER, **ladder))
    y = np.random.default_rng(34).standard_normal((n, 3)).astype(np.float32)
    loss_fn = lambda m: lambda p: jpipe.mse_loss(m(p, jg), jnp.asarray(y))
    loss_j, ref = jax.jit(jax.value_and_grad(loss_fn(jm)))(params)
    jk = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=2, layout="cm", use_pallas=True)
    with pltpu.force_tpu_interpret_mode():
        loss_k, ref_k = jax.jit(jax.value_and_grad(loss_fn(jk)))(params)
    calls = []
    real = fmg.generic_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fmg, "generic_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
        loss_t = tpipe.mse_loss(tm(tg), torch.from_numpy(y))
        loss_t.backward()
    assert calls  # the blocks went through the untabled kernel
    _assert_grads(loss_t.item(), float(loss_j), tm, ref)
    _assert_grads(loss_t.item(), float(loss_k), tm, ref_k)


def test_chunked_equals_unchunked_in_the_port():
    """edge_chunks=4 (with remat_layers=2) against edge_chunks=1 in the port,
    same weights: forward within 1e-5, gradients 1e-4 * max|ref|."""
    n = 96
    _, _, tg, _ = _graph(n)
    y = torch.from_numpy(np.random.default_rng(36).standard_normal((n, 3)).astype(np.float32))
    one = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", device="cpu",
                 generator=torch.Generator().manual_seed(37), **LADDER)
    four = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", device="cpu",
                  edge_chunks=4, remat_layers=2, **LADDER)
    four.load_state_dict(one.state_dict())
    outs = []
    for m in (one, four):
        out = m(tg)
        tpipe.mse_loss(out, y).backward()
        outs.append(out.detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)
    for a, b in zip(four.parameters(), one.parameters(), strict=True):
        assert float((a.grad - b.grad).abs().max()) <= 1e-4 * float(b.grad.abs().max())


@pytest.mark.parametrize("remat_layers", [0, 2])
def test_chunked_launch_counts(monkeypatch, remat_layers):
    """Per train step of L layers in C node blocks under ``remat_kernel``:
    the replay backward (#13) once per layer and block; the forward kernel
    (#11) once per layer and block in the forward, once more in the block
    checkpoint's recompute and, with ``remat_layers``, once more in the
    layer group's recompute (the nested checkpoints run every block again):
    2 L C or 3 L C.  ``chip_smoke.py`` asserts 3 x 4 x 25 = 300 at config 5."""
    n, layers, chunks = 96, 2, 4
    _, _, tg, _ = _graph(n)
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=layers, layout="cm", device="cpu",
                edge_chunks=chunks, remat_layers=remat_layers, **LADDER)
    fwd, bwd = [], []
    real_f, real_b = fmg.generic_fwd, fmg.generic_bwd
    monkeypatch.setattr(fmg, "generic_fwd", lambda *a, **kw: fwd.append(1) or real_f(*a, **kw))
    monkeypatch.setattr(fmg, "generic_bwd",
                        lambda *a, **kw: bwd.append(_got_ys(a, kw)) or real_b(*a, **kw))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    step = tpipe.make_train_step(tm, lambda m, g: tpipe.mse_loss(m(g), torch.zeros((n, 3))), opt)
    step(tg)
    assert len(fwd) == (3 if remat_layers else 2) * layers * chunks
    assert bwd == [False] * (layers * chunks)


def test_chunked_loss_curve_matches_jax():
    """Three steps of make_train_step (MSE, Adam 1e-3) with edge_chunks=2 and
    remat_layers=2 from the same weights, against the JAX loop on the
    chunked plain path (optax Adam 1e-3): losses and gradient norms rtol
    1e-4, the final parameters atol 1e-6."""
    n = 96
    jg, _, tg, _ = _graph(n)
    ladder = dict(edge_chunks=2, remat_layers=2, remat=True)
    jm, params, tm = _pair(38, dict(use_pallas=False, remat_kernel=True, **ladder),
                           dict(LADDER, **ladder))
    y = np.random.default_rng(39).standard_normal((n, 3)).astype(np.float32)
    opt = optax.adam(1e-3)
    jstep = jpipe.make_train_step(lambda p, g, t: jpipe.mse_loss(jm(p, g), t), opt, donate=False)
    state = jpipe.make_train_state(params, opt)
    want = []
    for _ in range(3):
        state, m = jstep(state, jg, jnp.asarray(y))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = tpipe.make_train_step(tm, lambda m_, g, t: tpipe.mse_loss(m_(g), t), topt)
    got = [tuple(v.item() for v in tstep(tg, torch.from_numpy(y)).values()) for _ in range(3)]
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert want[2][0] < want[0][0]
    for a, b in zip(jax.tree.leaves(params_to_jax(tm)), jax.tree.leaves(state.params),
                    strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


# ---- compute_attributes_dense_chunked

@pytest.mark.parametrize("nchunk", [None, 4])
def test_attributes_chunked_match_jax(nchunk):
    """The geo-only streams against JAX: fp32 atol 1e-6, the bf16 casts
    within one bf16 rounding step of each element and 99% equal; the fp32
    streams bitwise equal to the port's whole-graph
    ``compute_attributes_dense``."""
    jg, tg = _plain_graph(96)
    jm, _, tm = _pair(40, dict(use_pallas=False))
    args_j = (jg.positions, jg.senders, jg.edge_mask)
    args_t = (tg.positions, tg.senders, tg.edge_mask)
    for name, (jdt, tdt) in DTYPES.items():
        ref = jm.compute_attributes_dense_chunked(*args_j, nchunk=nchunk, dtype=jdt)
        got = tm.compute_attributes_dense_chunked(*args_t, nchunk=nchunk, dtype=tdt)
        assert got[0] is None and got[2] is None
        for i in (1, 3):
            a, b = got[i].float(), _f32(ref[i])
            assert got[i].dtype == tdt and a.shape == b.shape
            if name == "float32":
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
            else:
                step = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30))) - 7)
                assert bool(((a - b).abs() <= step).all())
                assert float((a == b).float().mean()) >= 0.99
    whole = tm.compute_attributes_dense(tg)
    got = tm.compute_attributes_dense_chunked(*args_t, nchunk=nchunk, dtype=torch.float32)
    assert torch.equal(got[1], whole[1]) and torch.equal(got[3], whole[3])


# ---- radius_graph_cell_segments

@functools.lru_cache(maxsize=None)
def _trees():
    """The cloud of ``test_torch_graph.py``, on which the port's and the JAX
    cell builders agree bitwise."""
    pts = np.random.default_rng(0).random((2048, 3)).astype(np.float32)
    jt = jax.jit(lambda p: j_octree(p, (0.0,) * 3, (1.0,) * 3, num_levels=5))(jnp.asarray(pts))
    tt = t_octree(pts, (0.0,) * 3, (1.0,) * 3, num_levels=5, device="cpu")
    return jt, tt


@pytest.mark.parametrize("num_segments", [1, 3, 8])
def test_radius_graph_cell_segments_match(num_segments):
    """The segmented entry: the same edges as the port's
    ``radius_graph_cell`` and as the JAX ``radius_graph_cell_segments`` at
    any segment count (bitwise: on this cloud the two cell builders agree
    bitwise)."""
    jt, tt = _trees()
    box = ((0.0,) * 3, (1.0,) * 3)
    r, k = 0.1, 16
    cap = t_cap(tt, r, *box)
    assert cap == j_cap(jt, r, *box)
    got = t_segments(tt, r, *box, max_neighbors=k, cell_capacity=cap,
                     num_segments=num_segments)
    whole = t_cell(tt, r, *box, max_neighbors=k, cell_capacity=cap)
    ref = j_segments(jt, r, *box, max_neighbors=k, cell_capacity=cap,
                     num_segments=num_segments)
    for field in ("senders", "receivers", "mask", "num_edges"):
        assert torch.equal(getattr(got, field), getattr(whole, field))
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))
    assert int(got.num_edges) > 0


def test_radius_graph_cell_segments_approx_raises():
    """The selections that raised before the large-graph builders landed run
    now: "approx" gives JAX's segmented edges (bitwise on this cloud) and
    "approx2" the whole cell build's at any segment count (their parity with
    JAX on a larger cloud: ``test_torch_radius_approx.py``); an unknown
    selection still raises."""
    jt, tt = _trees()
    box = ((0.0,) * 3, (1.0,) * 3)
    kw = dict(max_neighbors=16, cell_capacity=t_cap(tt, 0.1, *box))
    got = t_segments(tt, 0.1, *box, num_segments=3, selection="approx", **kw)
    ref = j_segments(jt, 0.1, *box, num_segments=3, selection="approx", **kw)
    for field in ("senders", "receivers", "mask", "num_edges"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))
    got2 = t_segments(tt, 0.1, *box, num_segments=3, selection="approx2", **kw)
    whole2 = t_cell(tt, 0.1, *box, selection="approx2", **kw)
    for field in ("senders", "receivers", "mask", "num_edges"):
        assert torch.equal(getattr(got2, field), getattr(whole2, field))
    with pytest.raises(ValueError, match="unknown selection"):
        t_segments(tt, 0.1, *box, selection="bogus", **kw)


def test_radius_graph_cell_segments_needs_a_segment():
    _, tt = _trees()
    with pytest.raises(ValueError, match="num_segments"):
        t_segments(tt, 0.1, (0.0,) * 3, (1.0,) * 3, max_neighbors=16, num_segments=0)
