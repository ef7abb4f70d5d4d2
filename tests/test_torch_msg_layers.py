"""PyTorch port, the generic message kernels #8-#14 at other counts of message
layers than two (``SEGNNLayer(num_message_layers=L)``, L = 1 and 3), against
the JAX package on the same numpy inputs (its Pallas kernels in interpret
mode, ``colpad`` off): the plain version of every CUDA route (the tabled
forward with its save mode, the residual and the replay backward, the
untabled forward and both its backwards, the sym-regather entry, the
fallback backward #14 at two backward tiles, three non-foldable
``lmax_attr=5`` layers through #11 and #14), a one-layer SEGNN's forward and
every parameter's gradient; and the kernels' host-side arguments (weight
streams, chunk tables, the per-layer descriptor table) at L = 1, 2, 3, the
two-layer stream order and packed weights as before.

Tolerances, each with its reason:
- fp32 against the JAX kernels: agg, the saved ys, d_hu, d_hs and d_hr
  atol 2e-5 (the same math, GEMMs summed in another order, as the two-layer
  parity tests of ``test_torch_generic_bwd.py``); dW' 1e-5 * max|ref| (sums
  over every slot in another order).
- the autograd entries and the model: the output atol 2e-5, every gradient
  1e-4 * max|ref| per leaf (fp32 through the layer's message layers and
  update, sums in another order, as ``test_geo_call_tab_gradients_match_jax``).
- the host-side arguments: exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.kernels.fused_message_generic import FusedMessageGeneric as JFMG
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.models.segnn import SEGNNLayer as JSEGNNLayer
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.models.segnn import SEGNNLayer
from scalable_e3_gnn_torch.utils.params import params_to_jax
from tests.test_torch_generic import _graph

ATOL = 2e-5
HIDDEN = "8x0e+4x1o+2x2e"
N = 128  # one table tile of 128 receivers, K = 8
MSG_LAYERS = [1, 3]
VJP_TILES = (64, 32)


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


def _models(n_msg, lmax_attr=2, hidden=HIDDEN, seed=0):
    """A one-layer SEGNN on each side whose layer runs ``n_msg`` gated
    message layers, built as a user would (the layer replaced by a
    ``SEGNNLayer(num_message_layers=n_msg)``); the port's seeded parameters
    in both (``params_to_jax``: JAX's initialisation, eager, takes seconds
    a model)."""
    ir = ("2x0e+1x1o", hidden, "1x1o")
    jm = JSEGNN(*map(JIrreps, ir), lmax_attr=lmax_attr, num_layers=0, layout="cm",
                use_pallas=True)
    jm.layers = [JSEGNNLayer(jm.hidden_irreps, jm.attr_irreps, num_message_layers=n_msg,
                             layout="cm", use_pallas=True)]
    gen = torch.Generator().manual_seed(seed)
    tm = TSEGNN(*ir, lmax_attr=lmax_attr, num_layers=0, layout="cm", use_pallas=True,
                device="cpu", generator=gen)
    tm.layers = torch.nn.ModuleList([SEGNNLayer(tm.hidden_irreps, tm.attr_irreps,
                                                num_message_layers=n_msg, layout="cm",
                                                use_pallas=True, device="cpu", generator=gen)])
    params = jax.tree.map(jnp.asarray, params_to_jax(tm))
    assert jax.tree.structure(params) == jax.tree.structure(jax.eval_shape(
        jm.init, jax.random.key(0)))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _problem(n_msg, lmax_attr=2, hidden=HIDDEN, seed=0):
    """One layer's message inputs on both sides (node features, the packed
    geometry with extra masked slots, hs = h[senders.T], a cotangent), the
    JAX kernel object with its folded weights and the port's configs."""
    jg, jgt, tg, tgt = _graph(N)
    jm, params, tm = _models(n_msg, lmax_attr, hidden, seed)
    k = tg.senders.shape[1]
    tile = SEGNNLayer._pick_generic_tile(N)
    rng = np.random.default_rng(seed + 1)
    geo = tm.compute_attributes_dense(tgt)[3].numpy().reshape(N, k, -1).copy()
    geo[..., -1] *= rng.random((N, k)) > 0.2  # extra masked slots
    geo2 = geo.reshape(N, -1)
    h = rng.standard_normal((N, tm.hidden_irreps.dim)).astype(np.float32)
    hs = h[np.minimum(tg.senders.numpy(), N - 1).T]  # [K, N, F]
    jk = JFMG(jm.layers[0].message_layers, k, tile=tile)
    ptuple = tuple(params["layer_0"][f"msg_{i}"] for i in range(n_msg))
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=tile)
    a = geo2.shape[1] // k - 2
    dagg = rng.standard_normal((N, kern.out_dim)).astype(np.float32)
    ws, sels = kern.fold(torch.float32), kern.selections("cpu")
    t = torch.from_numpy
    return dict(jg=jg, jgt=jgt, tg=tg, tgt=tgt, jm=jm, params=params, tm=tm, k=k, tile=tile,
                jk=jk, ptuple=ptuple, folded=jax.jit(jk._fold)(ptuple), kern=kern, h=h, hs=hs,
                geo2=geo2,
                cfg_t=kern.config(a, tgt.gather_tab.shape[1]), cfg_u=kern.config(a, 0),
                jh=jnp.asarray(h), jhs=jnp.asarray(hs), jgeo=jnp.asarray(geo2),
                jd=jnp.asarray(dagg), targs_t=(t(h), t(geo2), tgt.gather_loc, tgt.gather_tab,
                                               ws, sels),
                targs_u=(t(hs), t(h), t(geo2), ws, sels), d_agg=t(dagg))


@functools.lru_cache(maxsize=None)
def _jax_routes(n_msg, hidden=HIDDEN):
    """The JAX kernels' results for every route of ``_problem(n_msg,
    hidden=hidden)``, from one compiled call in interpret mode: the tabled
    forward with save and its two backwards, the untabled forward with save
    and its two backwards, and ``_bwd_call`` (#14) at backward tiles 64 and
    32."""
    p = _problem(n_msg, hidden=hidden)
    jk, loc = p["jk"], p["jgt"].gather_loc
    vjp = {bt: JFMG(p["jm"].layers[0].message_layers, p["k"], tile=p["tile"], bwd_tile=bt)
           for bt in VJP_TILES}

    def routes(folded, hj, hs, gj, dj):
        hu = jnp.take(hj, p["jgt"].gather_tab.reshape(-1), axis=0, mode="clip")
        out_t, ys_t = jk._fwd_call_tab(folded, hu, hj, gj, loc, save=True)
        out_u, ys_u = jk._fwd_call(folded, hs, hj, gj, save=True)
        return dict(
            tab=(out_t, ys_t), tab_res=jk._bwd_call_res_tab(folded, hu, hj, gj, loc, ys_t, dj),
            tab_rep=jk._bwd_call_rep_tab(folded, hu, hj, gj, loc, dj),
            untab=(out_u, ys_u), untab_res=jk._bwd_call_res(folded, hs, hj, gj, ys_u, dj),
            untab_rep=jk._bwd_call_rep(folded, hs, hj, gj, dj),
            **{f"vjp_{bt}": vjp[bt]._bwd_call(folded, hs, hj, gj, dj) for bt in VJP_TILES})

    with pltpu.force_tpu_interpret_mode():
        return _compiled(routes, p["folded"], p["jh"], p["jhs"], p["jgeo"], p["jd"])


def _compiled(f, *args):
    """``jax.jit(f)(*args)``, compiled at XLA's lowest backend optimization
    level (the interpret-mode kernels compile a third faster)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _slot_major(y, n, k):
    return jnp.swapaxes(y, 0, 1).reshape(n * k, -1)


def _check(pairs, dws=()):
    """(port, JAX) pairs atol 2e-5; the dW' pairs ``dws`` 1e-5 max|ref|."""
    for i, (got, ref) in enumerate([*pairs, *dws]):
        ref = _f32(ref)
        assert got.shape == ref.shape, (i, got.shape, ref.shape)
        err = float((got.float() - ref).abs().max())
        assert err <= (ATOL if i < len(pairs) else 1e-5 * float(ref.abs().max())), (i, err)


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
def test_tabled_routes_plain_match_jax(n_msg):
    """#8 with its save mode (agg and every layer's y), #9 from the saved ys
    and #10 by replay: the port's plain versions against ``_fwd_call_tab``,
    ``_bwd_call_res_tab`` and ``_bwd_call_rep_tab``."""
    p, r = _problem(n_msg), _jax_routes(n_msg)
    (out, ys), res, rep = r["tab"], r["tab_res"], r["tab_rep"]
    cfg, args = p["cfg_t"], p["targs_t"]
    with torch.no_grad():
        agg, tys = fmg.generic_tab_fwd(cfg, *args, save=True)
        got_res = fmg.generic_tab_bwd(cfg, *args, p["d_agg"], ys=tys)
        got_rep = fmg.generic_tab_bwd(cfg, *args, p["d_agg"])
    assert len(tys) == len(ys) == n_msg
    _check([(agg, out)] + [(y, _slot_major(yj, N, p["k"])) for y, yj in zip(tys, ys)])
    for got, (dp, dhu, dhr) in ((got_res, res), (got_rep, rep)):
        assert len(got[2]) == len(dp) == n_msg
        _check([(got[0], dhu), (got[1], dhr)], [(dw, d["w_folded"]) for dw, d in zip(got[2], dp)])


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
def test_untabled_routes_plain_match_jax(n_msg):
    """#11 with its save mode, #12 from the saved ys and #13 by replay: the
    port's plain versions against ``_fwd_call``, ``_bwd_call_res`` and
    ``_bwd_call_rep``."""
    p, r = _problem(n_msg), _jax_routes(n_msg)
    (out, ys), res, rep = r["untab"], r["untab_res"], r["untab_rep"]
    cfg, args = p["cfg_u"], p["targs_u"]
    with torch.no_grad():
        agg, tys = fmg.generic_fwd(cfg, *args, save=True)
        got_res = fmg.generic_bwd(cfg, *args, p["d_agg"], ys=tys)
        got_rep = fmg.generic_bwd(cfg, *args, p["d_agg"])
    _check([(agg, out)] + [(y, _slot_major(yj, N, p["k"])) for y, yj in zip(tys, ys)])
    for got, (dp, dhs, dhr) in ((got_res, res), (got_rep, rep)):
        assert len(got[2]) == len(dp) == n_msg
        _check([(got[0], dhs), (got[1], dhr)], [(dw, d["w_folded"]) for dw, d in zip(got[2], dp)])


@pytest.mark.parametrize("bwd_tile", VJP_TILES)
@pytest.mark.parametrize("n_msg", MSG_LAYERS)
def test_vjp_route_plain_matches_jax(n_msg, bwd_tile):
    """#14's plain version against ``_bwd_call`` (the in-kernel ``jax.vjp``)
    at two backward tiles."""
    p = _problem(n_msg)
    dp, dhs, dhr = _jax_routes(n_msg)[f"vjp_{bwd_tile}"]
    with torch.no_grad():
        got = fmg.generic_bwd_vjp(p["cfg_u"], *p["targs_u"], p["d_agg"], bwd_tile)
    assert len(got[2]) == len(dp) == n_msg
    _check([(got[0], dhs), (got[1], dhr)], [(dw, d["w_folded"]) for dw, d in zip(got[2], dp)])


def _grads_match(tm, jmsg_grads, got_h, ref_h):
    """h's gradient and every message-layer parameter's against JAX's: 1e-4
    max|ref| each."""
    pairs = [(got_h, _f32(ref_h))]
    grads = params_to_jax(tm, grad=True)["layer_0"]
    for i, jp in enumerate(jmsg_grads):
        for name, ref in jp.items():
            pairs.append((torch.from_numpy(grads[f"msg_{i}"][name]), _f32(ref)))
    assert len(pairs) > len(jmsg_grads)
    for got, ref in pairs:
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


def test_sym_regather_entry_matches_jax():
    """``geo_call_sym`` at three message layers (the gather inside the
    autograd Function, #11 then #13's plain versions, sender gradients by the
    reverse-slot gather-sum): the output and the gradients of h and of every
    message-layer parameter against ``jax.grad`` of the JAX
    ``geo_call_sym``."""
    p = _problem(3)
    jk, jg = p["jk"], p["jg"]
    ct = np.random.default_rng(9).standard_normal((N, p["kern"].out_dim)).astype(np.float32)
    f = lambda pt, hh: jk.geo_call_sym(pt, hh, p["jgeo"], jg.senders, jg.reverse_slot)
    def loss(pt, hh):
        out = f(pt, hh)
        return jnp.sum(out * ct), out

    with pltpu.force_tpu_interpret_mode():
        (gp, gh), ref = _compiled(jax.grad(loss, argnums=(0, 1), has_aux=True), p["ptuple"],
                                  p["jh"])
    tm, tg = p["tm"], p["tg"]
    tm.zero_grad()
    h = torch.from_numpy(p["h"]).requires_grad_()
    out = p["kern"].geo_call_sym(h, torch.from_numpy(p["geo2"]), tg.senders, tg.reverse_slot)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    (out * torch.from_numpy(ct)).sum().backward()
    _grads_match(tm, gp, h.grad, gh)


def test_attr36_routes_plain_match_jax():
    """Three non-foldable message layers (``lmax_attr=5``: A=36, few irreps;
    JAX's sparse TP compiles slowly past them): #11 and #14 on their folded
    weights and the selection gate against JAX's component-wise layers with
    the concat gate (``_fwd_call``, ``_bwd_call``)."""
    p = _problem(3, lmax_attr=5, hidden="2x0e+1x1o", seed=3)
    cfg = p["cfg_u"]
    assert cfg.a == 36 and len(cfg.widths) == 3
    assert not (p["kern"].residual_bwd or p["kern"].replay_bwd)
    jk = JFMG(p["jm"].layers[0].message_layers, p["k"], tile=p["tile"], bwd_tile=64)
    with pltpu.force_tpu_interpret_mode():
        out, (_, dhs, dhr) = _compiled(lambda *a: (jk._fwd_call(*a[:4]), jk._bwd_call(*a)),
                                       p["folded"], p["jhs"], p["jh"], p["jgeo"], p["jd"])
    with torch.no_grad():
        agg = fmg.generic_fwd(cfg, *p["targs_u"])
        d_hs, d_hr, _ = fmg.generic_bwd_vjp(cfg, *p["targs_u"], p["d_agg"], 64)
    _check([(agg, out), (d_hs, dhs), (d_hr, dhr)])


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
def test_one_layer_model_matches_jax(n_msg):
    """The one-layer SEGNN (hidden 8x0e+4x1o+2x2e, lmax_attr=2, 128 points,
    K=8, geo-only attributes as bench.py passes them, the tabled dispatch)
    with ``n_msg`` message layers: its output and every parameter's MSE
    gradient against the JAX model through its kernels."""
    p = _problem(n_msg)
    jm, params, tm, jgt, tgt = p["jm"], p["params"], p["tm"], p["jgt"], p["tgt"]
    target = np.random.default_rng(11).standard_normal((N, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ja = jax.jit(jm.compute_attributes_dense)(jgt)
        jat = (None, ja[1], None, ja[3])
        def loss(pr):
            out = jm(pr, jgt, attrs=jat)
            return jnp.mean((out - target) ** 2), out

        jgrad, ref = _compiled(jax.grad(loss, has_aux=True), params)
    tm.zero_grad()
    ta = tm.compute_attributes_dense(tgt)
    assert tm.layers[0]._tab_eligible(N, tgt)
    out = tm(tgt, attrs=(None, ta[1], None, ta[3]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    got = params_to_jax(tm, grad=True)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jgrad)))
    assert len(flat_got) == len(flat_ref)
    for path, g in flat_got:
        r = flat_ref[path]
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), (path, np.abs(g - r).max())


# ---- the host-side arguments: streams, chunk tables, the layer table

@functools.lru_cache(maxsize=None)
def _lmax2_kern(n_msg):
    """The lmax=2 config's widths (24x0e+12x1o+6x2e, A=9) at ``n_msg``
    message layers, with their tile plan."""
    layer = SEGNNLayer("24x0e+12x1o+6x2e", "1x0e+1x1o+1x2e", num_message_layers=n_msg,
                       layout="cm", use_pallas=True, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    kern = fmg.FusedMessageGeneric(layer.message_layers, 16, 200)
    return kern, kern.config(9, 640)


@pytest.mark.parametrize("n_msg", [1, 2, 3])
def test_streams_chunks_and_layer_table(n_msg):
    """The forward kernel takes one stream per layer, the chain every
    layer's forward stream (replay) then every layer's dm stream, last layer
    first; the device chunk array is each stream's first chunk, then the
    chunk table; the layer table's fields are the prefix sums the kernels
    read (``csrc/generic_mma.cuh`` LayerField)."""
    kern, cfg = _lmax2_kern(n_msg)
    plan = cfg.plan
    widths = [(181, 108, 90)] + [(90, 108, 90)] * (n_msg - 1)
    assert cfg.widths == tuple(widths) and plan.widths == tuple((c, d) for c, d, _ in widths)
    fwd = tuple(("fwd", i, False) for i in range(n_msg))
    assert fmg._fwd_streams(cfg) == fwd
    for vjp in (False, True):
        dm = tuple(("dm", i, vjp) for i in range(n_msg - 1, -1, -1))
        assert fmg._chain_streams(cfg, True, vjp) == fwd + dm
        assert fmg._chain_streams(cfg, False, vjp) == dm
    ws = kern.fold(torch.bfloat16)
    for streams in (fwd, fmg._chain_streams(cfg, True), fmg._chain_streams(cfg, False, True)):
        wpk, masks, chunks, per = plan.args(ws, streams)
        table, per_t = plan.chunk_table(streams)
        assert per == per_t and len(per) == len(streams)
        s = len(streams)
        assert chunks.tolist() == [0, *np.cumsum(per).tolist()] + table.tolist()
        assert chunks[s] == sum(per) <= masks.numel()  # no more chunks than masks
        assert wpk.numel() == 128 * sum(len(plan.index([st])) // 128 for st in streams)
    got = fmg.layer_table(cfg)
    assert got.shape == (n_msg, len(fmg._LAYER_FIELDS)) and got.dtype == np.int32
    ks = [-(-c1 // 16) for c1, _, _ in widths]
    ds = [-(-d // 16) for _, d, _ in widths]
    for i, (c1, d, dk) in enumerate(widths):
        row = dict(zip(fmg._LAYER_FIELDS, got[i].tolist()))
        assert (row["c1"], row["d"], row["dk"]) == (c1, d, dk)
        assert row["mask_fwd"] == 9 * sum(ks[:i])
        assert row["mask_dm"] == 9 * (sum(ks) + sum(ds[:i]))
        assert row["w_off"] == sum(9 * c * dd for c, dd, _ in widths[:i])
        assert row["sel_off"] == sum(w[2] for w in widths[:i])
        assert row["y_off"] == sum(w[1] for w in widths[:i])
        assert row["dy_off"] == sum(-(-w[1] // 8) * 8 for w in widths[:i])
        assert row["m_off"] == sum(-(-w[0] // 16) * 16 for w in widths[1:i])
        assert row["gate_off"] == sum(2 * w[2] + w[1] + 1 for w in widths[:i])
    assert cfg.nw == sum(9 * c * d for c, d, _ in widths)
    nl, host, dev_table = fmg._layers(cfg, "cpu")
    assert nl == n_msg and list(host) == [v for w in widths for v in w]
    assert torch.equal(dev_table, torch.from_numpy(got))
    # the selections: views of one buffer in layer order, as the kernels read them
    sels = kern.selections("cpu")
    assert len(sels) == n_msg and fmg._flat(sels).data_ptr() == sels[0].data_ptr()


def test_two_layers_keep_the_fixed_stream_layout():
    """At two message layers the chain's streams are the former fixed order
    (forward layer 0, forward layer 1, dm layer 1, dm layer 0) and the packed
    weights are those streams' tiles one after the other, as the two-layer
    kernels took them."""
    kern, cfg = _lmax2_kern(2)
    plan = cfg.plan
    old = (("fwd", 0, False), ("fwd", 1, False), ("dm", 1, False), ("dm", 0, False))
    assert fmg._chain_streams(cfg, True) == old
    assert fmg._chain_streams(cfg, False) == old[2:]
    assert fmg._fwd_streams(cfg) == old[:2]
    ws = kern.fold(torch.bfloat16)
    for streams in (old, old[:2], old[2:]):
        wpk, _, chunks, per = plan.args(ws, streams)
        assert torch.equal(wpk, torch.cat([plan.pack(ws, [s]) for s in streams]))
        table, _ = plan.chunk_table(streams)
        assert chunks[len(streams) + 1:].tolist() == table.tolist()
    # the masks: both layers' forward masks, then both layers' dm masks
    flat = np.concatenate([plan.block_masks[(kind, i)].reshape(-1)
                           for kind in ("fwd", "dm") for i in range(2)])
    assert plan.masks("cpu").numpy().tolist() == flat.view(np.int32).tolist()
    assert plan.counts("fwd") == (483, 228) and plan.counts("dm") == (456, 219)
    w3 = [181, 108, 90, 90, 108, 90]
    assert list(fmg._layers(cfg, "cpu")[1]) == w3


def test_flat_reads_consecutive_views_in_place():
    """``_flat`` hands the kernels a buffer that already holds the tensors
    one after the other in place (no copy), and copies otherwise."""
    buf = torch.arange(20.0)
    views = fmg._views(buf, [(2, 3), (7,), (1, 7)])
    assert [tuple(v.shape) for v in views] == [(2, 3), (7,), (1, 7)]
    flat = fmg._flat(views)
    assert flat.data_ptr() == buf.data_ptr() and torch.equal(flat, buf)
    apart = [torch.arange(3.0), torch.arange(4.0)]
    assert torch.equal(fmg._flat(apart), torch.cat(apart))
    assert fmg._flat([buf[10:], buf[:10]]).data_ptr() != buf.data_ptr()


def _c_entries(source: str) -> dict:
    """The ``extern "C"`` functions of ``csrc/<source>.cu``: name -> the C
    type of each parameter, mapped to its ctypes class."""
    import re
    from pathlib import Path

    import ctypes

    text = (Path(fmg.__file__).resolve().parents[1] / "csrc" / f"{source}.cu").read_text()
    text = text[text.index('extern "C" {'):]
    kinds = {"int": ctypes.c_int, "long": ctypes.c_long, "void*": ctypes.c_void_p,
             "constvoid*": ctypes.c_void_p, "constint*": ctypes.POINTER(ctypes.c_int),
             "unsignedlonglong*": None}
    out = {}
    for m in re.finditer(r"^(int|long) (\w+)\(([^)]*)\)\s*\{", text, re.M):
        params = [re.sub(r"\s+", "", p.rsplit(" ", 1)[0] + ("*" if "*" in p else ""))
                  .replace("**", "*") for p in m.group(3).split(",") if p.strip()]
        out[m.group(2)] = ({"int": ctypes.c_int, "long": ctypes.c_long}[m.group(1)],
                           [kinds[p] for p in params])
    return out


@pytest.mark.parametrize("source,sigs", [("fused_message_generic_tab_fwd", "_FWD_SIGS"),
                                         ("fused_message_generic_tab_bwd", "_BWD_SIGS")])
def test_ctypes_signatures_match_the_c_entries(source, sigs):
    """Every entry point the wrapper binds has, in the CUDA source, the
    return type and the parameters (count, and int / long / pointer / host
    int array) that its ctypes signature declares."""
    entries = _c_entries(source)
    for name, (restype, argtypes) in getattr(fmg, sigs).items():
        assert name in entries, name
        assert entries[name] == (restype, argtypes), (name, entries[name], (restype, argtypes))
