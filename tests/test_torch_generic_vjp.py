"""PyTorch port, the generic fallback backward (TPU kernel #14,
``FusedMessageGeneric._bwd_call``: an in-kernel ``jax.vjp`` of the tile
forward), against the JAX package on the same numpy inputs (its Pallas kernels
in interpret mode, ``colpad`` off): the plain #14 at two backward tiles, the
autograd entry ``geo_call`` with ``replay_bwd=False``, a small SEGNN with
``replay_bwd=False`` (forward, gradients, a 3-step bf16 loss curve) and the
dispatch rules.  ``test_torch_generic_sparse.py`` holds the non-foldable
message layers (``lmax_attr=5``), which also run #14.

Tolerances, each with its reason (those of ``test_torch_generic_untabled.py``
for the same comparisons):
- fp32 against the JAX kernels: 2e-5 * max(1, |ref|) elementwise (the same
  math, sums in another order); #14 against #13 in the port 1e-5.
- bf16 against the JAX kernels: within 32 bf16 ulps of max(|ref|, mean|ref|)
  elementwise.  Interpret mode runs the kernel body through XLA on the CPU,
  which keeps some bf16 intermediates in fp32; the port rounds where JAX's
  AD does.
- models: loss and every gradient rtol 1e-4 and 1e-4 * max|ref| per parameter
  (fp32 through 2 layers).  The bf16 3-step loss curve: gradient norms rtol
  1.5e-2, as the packed model's in ``test_torch_pack.py``; losses rtol 3e-4
  (``LOSS_RTOL``), where the packed lmax=1 model's curve holds 1e-4: on this
  lmax=2 model the first loss, before any update, already reads 7.4e-5 apart
  (the bf16 forward of two frameworks), and the curve 1.4e-4.  At
  ``lmax_attr=5`` (``test_torch_generic_sparse.py``) 5e-3: there the losses
  read 2.3e-3, 1.8e-3 and 2.9e-3 apart from the first on, the port's folded
  and JAX's sparse bf16 forwards each 5e-3 to 8e-3 (relative RMS) from the
  fp32 one (``test_lmax_attr5_bf16_forward_error_is_rounding``;
  ``ROADMAP.md``, "Not faults").
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.kernels.fused_message_generic import FusedMessageGeneric as JFMG
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_generic import IRREPS, _graph
from tests.test_torch_generic_untabled import DTYPES, _close, _f32

SPARSE_IRREPS = ("2x0e+1x1o", "2x0e+1x2e", "3x0e")  # with lmax_attr=5: (2, 4, 2) paths


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread.  The bitwise checks of this file are
    about the port's order of sums (per tile, tiles folded in order); the
    plain versions' CPU GEMMs block their sums by the thread count, so two
    GEMMs of one product can differ in their last bit between thread counts
    and the checks would depend on the machine rather than on the order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n, seed, dtype, lmax_attr=2, bwd_tile=0, irreps=IRREPS):
    """One layer's untabled kernel inputs on both sides (hs = h[senders.T],
    the packed geometry with extra masked slots, a cotangent), the JAX kernel
    with ``residual_bwd=False, replay_bwd=False`` (#14) and the port's."""
    jdt, tdt = DTYPES[dtype]
    _, _, tg, _ = _graph(n)
    jm = JSEGNN(*map(JIrreps, irreps), lmax_attr=lmax_attr, num_layers=1, layout="cm",
                use_pallas=True)
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*irreps, lmax_attr=lmax_attr, num_layers=1, layout="cm", use_pallas=True,
                device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    k = tg.senders.shape[1]
    rng = np.random.default_rng(seed + 1)
    geo = tm.compute_attributes_dense(tg)[3].numpy().reshape(n, k, -1).copy()
    geo[..., -1] *= rng.random((n, k)) > 0.2  # extra masked slots
    geo2 = geo.reshape(n, -1)
    h = rng.standard_normal((n, tm.hidden_irreps.dim)).astype(np.float32)
    hs = h[np.minimum(tg.senders.numpy(), n - 1).T]  # [K, N, F]
    tile = tm.layers[0]._pick_generic_tile(n)
    jk = JFMG(jm.layers[0].message_layers, k, tile=tile, bwd_tile=bwd_tile, residual_bwd=False,
              replay_bwd=False)
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=tile, bwd_tile=bwd_tile,
                                   residual_bwd=False, replay_bwd=False)
    cfg = kern.config(geo2.shape[1] // k - 2, 0)
    dagg = rng.standard_normal((n, cfg.out_dim)).astype(np.float32)
    lp = params["layer_0"]
    return dict(jk=jk, kern=kern, cfg=cfg, k=k, n=n, tm=tm, ptuple=(lp["msg_0"], lp["msg_1"]),
                jargs=tuple(jnp.asarray(x, jdt) for x in (hs, h, geo2, dagg)),
                targs=tuple(torch.from_numpy(x).to(tdt) for x in (hs, h, geo2)),
                d_agg=torch.from_numpy(dagg).to(tdt), tdt=tdt)


def _plain_vjp(p, bwd_tile):
    """The port's plain #14 on the problem's inputs (CPU: the wrapper's path)."""
    kern, tdt = p["kern"], p["tdt"]
    with torch.no_grad():
        return fmg.generic_bwd_vjp(p["cfg"], *p["targs"], kern.fold(tdt), kern.selections("cpu"),
                                   p["d_agg"], bwd_tile)


# ---- the plain #14 against _bwd_call

@pytest.mark.parametrize("bwd_tile", [40, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_plain_matches_jax_bwd_call(dtype, bwd_tile):
    """d_hs [K, N, F], d_hr and both dW' against ``_bwd_call`` at the same
    backward tile (3 and 6 tiles of 240 receivers)."""
    p = _problem(240, 71, dtype, bwd_tile=bwd_tile)
    jk = p["jk"]
    assert not jk.residual_bwd and not jk.replay_bwd and jk.bwd_tile == bwd_tile
    with pltpu.force_tpu_interpret_mode():
        dp, dhs, dhr = jk._bwd_call(jk._fold(p["ptuple"]), *p["jargs"])
    d_hs, d_hr, dws = _plain_vjp(p, bwd_tile)
    assert d_hs.dtype == d_hr.dtype == p["tdt"] and all(dw.dtype == torch.float32 for dw in dws)
    for got, ref in [(d_hs, dhs), (d_hr, dhr)] + [(dw, d["w_folded"]) for dw, d in zip(dws, dp)]:
        _close(got, ref, dtype)


def test_vjp_weight_gradient_depends_on_the_backward_tile():
    """In bf16 each tile's dW' is rounded before the fp32 sum over tiles, in
    JAX and in the port: the weight gradients at backward tiles 40 and 120
    differ (d_hs and d_hr do not), each is nearer JAX's at its own tile than
    at the other (mean |error|, both layers), and in fp32 the two tiles agree
    within 1e-5 * max|ref|."""
    ref, got = {}, {}
    for bt in (40, 120):
        p = _problem(240, 71, "bfloat16", bwd_tile=bt)
        with pltpu.force_tpu_interpret_mode():
            dp, _, _ = p["jk"]._bwd_call(p["jk"]._fold(p["ptuple"]), *p["jargs"])
        ref[bt] = [_f32(d["w_folded"]) for d in dp]
        got[bt] = _plain_vjp(p, bt)
    assert torch.equal(got[40][0], got[120][0]) and torch.equal(got[40][1], got[120][1])
    for i in range(2):
        assert not torch.equal(got[40][2][i], got[120][2][i])
        assert not torch.equal(ref[40][i], ref[120][i])
        for bt, other in ((40, 120), (120, 40)):
            own = float((got[bt][2][i] - ref[bt][i]).abs().mean())
            cross = float((got[bt][2][i] - ref[other][i]).abs().mean())
            assert own < cross, (i, bt, own, cross)
    p = _problem(240, 71, "float32")
    a, b = _plain_vjp(p, 40)[2], _plain_vjp(p, 120)[2]
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_plain_against_replay_and_chunks(dtype):
    """#14's plain version against #13's (replay): fp32 within 1e-5 (every
    rounding is the identity; sums in another order), bf16 not bitwise (the
    dm sum and dW' round at other points); chunks of one tile give the same
    result bitwise."""
    p = _problem(240, 73, dtype)
    cfg, args, kern, d_agg = p["cfg"], p["targs"], p["kern"], p["d_agg"]
    ws, sels = kern.fold(p["tdt"]), kern.selections("cpu")
    with torch.no_grad():
        vjp = fmg.generic_bwd_vjp_plain(cfg, *args, ws, sels, d_agg, 40)
        rep = fmg.generic_bwd_plain(cfg, *args, ws, sels, d_agg)
        one = fmg.generic_bwd_vjp_plain(cfg, *args, ws, sels, d_agg, 40, chunk_rows=1)
    pairs = [(vjp[0], rep[0]), (vjp[1], rep[1])] + list(zip(vjp[2], rep[2]))
    if dtype == "float32":
        for a, b in pairs:
            assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))
    else:
        assert not all(torch.equal(a, b) for a, b in pairs)
    for a, b in [(vjp[0], one[0]), (vjp[1], one[1])] + list(zip(vjp[2], one[2])):
        assert torch.equal(a, b)


def test_vjp_wgrad_plain_is_the_per_tile_sum():
    """The per-tile weight-gradient kernel's plain version on the chain's rows
    (m and dy per slot row, zero-padded as the chain writes them), folded in
    tile order, gives the plain #14's dW' bitwise; the last tile may be short."""
    p = _problem(240, 75, "bfloat16")
    cfg, (hs, h, geo2), kern = p["cfg"], p["targs"], p["kern"]
    ws, sels = [w.float() for w in kern.fold(torch.bfloat16)], kern.selections("cpu")
    sels_l = [s.long() for s in sels]
    k, bt = p["k"], 40
    m0, attr, mask = fmg._slot_rows_km(cfg, hs, h, geo2, 0, p["n"])
    ms, ys = fmg._rows_fwd(cfg, m0, attr, ws, sels_l, last_gate=False)
    dm = (p["d_agg"].float().repeat_interleave(k, 0) * mask.float()).to(torch.bfloat16)
    dys = [None, None]
    for i in (1, 0):
        dys[i] = fmg._gate_vjp(ys[i], dm, sels_l[i], cfg.widths[i][2])
        dm = fmg._layer_vjp(dys[i], attr, ws[i], ms[i], cfg.widths[i][0], cfg.a, bt * k)[0]
    pad = lambda x, w: torch.nn.functional.pad(x, (0, w - x.shape[1]))
    (c1a, da, _), (c1b, db, _) = cfg.widths
    rows = (pad(ms[0], -(-c1a // 16) * 16), pad(ms[1], -(-c1b // 16) * 16),
            pad(dys[0], -(-da // 8) * 8), pad(dys[1], -(-db // 8) * 8))
    parts = fmg.generic_bwd_vjp_wgrad(cfg, geo2, rows[:2], rows[2:], bt * k, 0, 6)
    acc = torch.zeros(parts.shape[1])
    for row in parts:
        acc += row
    want = _plain_vjp(p, bt)[2]
    n1 = cfg.a * c1a * da
    assert torch.equal(acc[:n1].view_as(want[0]), want[0])
    assert torch.equal(acc[n1:].view_as(want[1]), want[1])
    short = fmg.generic_bwd_vjp_wgrad(cfg, geo2, rows[:2], rows[2:], 7 * bt * k // 8, 7, 2)
    assert short.shape[0] == 2 and torch.isfinite(short).all()


# ---- the autograd entry

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_geo_call_matches_jax(dtype):
    """``geo_call`` with ``replay_bwd=False``: the forward (#11) and the
    gradients of every input (the message-layer parameters through the fold,
    hs and h) against ``jax.grad`` through the JAX ``custom_vjp`` (#14)."""
    p = _problem(240, 77, dtype, bwd_tile=40)
    jk, kern, tm = p["jk"], p["kern"], p["tm"]
    hs, h, geo2, dagg = p["jargs"]

    def jloss(args):
        out = jk.geo_call(args[0], args[1], args[2], geo2)
        return (out.astype(jnp.float32) * dagg.astype(jnp.float32)).sum(), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)((p["ptuple"], hs, h))
    ths, th = (x.clone().requires_grad_() for x in p["targs"][:2])
    out = kern.geo_call(ths, th, p["targs"][2])
    (out.float() * p["d_agg"].float()).sum().backward()
    _close(out.detach(), jout, dtype)
    _close(ths.grad, jgrads[1], dtype)
    _close(th.grad, jgrads[2], dtype)
    for layer, jg in zip(tm.layers[0].message_layers, jgrads[0]):
        for name, w in layer.tp.named_parameters():
            _close(w.grad, jg[name], dtype)


# ---- models

N = 128
MODELS = {  # 2 layers at lmax_attr=2; 1 at lmax_attr=5, whose JAX sparse TPs trace slowly
    "replay_off": dict(irreps=IRREPS, lmax_attr=2, layers=2,
                       kw=dict(remat=True, residual_bwd=False, replay_bwd=False)),
    "lmax_attr5": dict(irreps=SPARSE_IRREPS, lmax_attr=5, layers=1, kw={})}


# the bf16 3-step loss curves' loss tolerance (the module docstring says why)
LOSS_RTOL = {"replay_off": 3e-4, "lmax_attr5": 5e-3}


def _pair(name, seed):
    spec = MODELS[name]
    jm = JSEGNN(*map(JIrreps, spec["irreps"]), lmax_attr=spec["lmax_attr"],
                num_layers=spec["layers"], layout="cm", use_pallas=True, **spec["kw"])
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*spec["irreps"], lmax_attr=spec["lmax_attr"], num_layers=spec["layers"],
                layout="cm", use_pallas=True, device="cpu", **spec["kw"])
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _spy(monkeypatch):
    """Count the plain backwards the generic kernels run: #14 and the others."""
    calls = {"vjp": 0, "other": 0}
    real_vjp, real = fmg.generic_bwd_vjp, fmg.generic_bwd

    def vjp(*a, **kw):
        calls["vjp"] += 1
        return real_vjp(*a, **kw)

    def other(*a, **kw):
        calls["other"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(fmg, "generic_bwd_vjp", vjp)
    monkeypatch.setattr(fmg, "generic_bwd", other)
    monkeypatch.setattr(fmg, "generic_tab_bwd", other)
    return calls


@pytest.mark.parametrize("name", ["replay_off"])
def test_segnn_vjp_gradients_match_jax(monkeypatch, name):
    """The forward and the MSE gradients of every parameter of a small SEGNN
    whose message backward is #14 (``replay_bwd=False`` under ``remat``, and
    ``lmax_attr=5``) on a graph with tables (which #14 bypasses), against
    jax.grad of the JAX model; two #14 backwards and no other."""
    _, jgt, _, tgt = _graph(N)
    jm, params, tm = _pair(name, seed=91)
    y = np.random.default_rng(92).standard_normal((N, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jout = jax.jit(jm)(params, jgt)
        ref = jax.jit(jax.grad(lambda q: jpipe.mse_loss(jm(q, jgt), jnp.asarray(y))))(params)
    calls = _spy(monkeypatch)
    out = tm(tgt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jout).max()))
    tpipe.mse_loss(out, torch.from_numpy(y)).backward()
    assert calls == {"vjp": MODELS[name]["layers"], "other": 0}
    got = params_to_jax(tm, grad=True)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("name", ["replay_off"])
def test_segnn_vjp_bf16_loss_curve_matches_jax(name):
    """Three bf16 train steps (bf16 copies of fp32 master weights, bf16 nodes
    and attributes, MSE, Adam 1e-3) through #11 and #14 on a graph without
    tables, against the JAX loop: losses within ``LOSS_RTOL`` and gradient
    norms rtol 1.5e-2 (the module docstring says why)."""
    jg, _, tg, _ = _graph(N)
    jm, params, tm = _pair(name, seed=93)
    target = np.random.default_rng(94).standard_normal((N, 3)).astype(np.float32)
    jattrs = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
                          jax.jit(jm.compute_attributes_dense)(jg))
    jg_bf = jg._replace(nodes=jg.nodes.astype(jnp.bfloat16))

    def jloss(q, g, a, t):
        q = jax.tree.map(lambda x: x.astype(jnp.bfloat16), q)
        return jpipe.mse_loss(jm(q, g, attrs=a).astype(jnp.float32), t)

    opt = optax.adam(1e-3)
    jstep = jpipe.make_train_step(jloss, opt, donate=False)
    state = jpipe.make_train_state(params, opt)
    want = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            state, m = jstep(state, jg_bf, jattrs, jnp.asarray(target))
            want.append((float(m["loss"]), float(m["grad_norm"])))
    bf = torch.bfloat16
    tattrs = tuple(None if a is None else a.to(bf) for a in tm.compute_attributes_dense(tg))
    tg_bf = tg._replace(nodes=tg.nodes.to(bf))

    def tloss(model, g, a, t):
        q = {nm: w.to(bf) for nm, w in model.named_parameters()}
        return tpipe.mse_loss(torch.func.functional_call(model, q, (g,), {"attrs": a}).float(), t)

    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = tpipe.make_train_step(tm, tloss, topt)
    got = []
    for _ in range(3):
        m = tstep(tg_bf, tattrs, torch.from_numpy(target))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL[name])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1.5e-2)
    assert want[2, 0] < want[0, 0]  # the loss moves


# ---- dispatch

def test_dispatch_skips_the_tabled_and_sym_entries_without_a_hand_backward(monkeypatch):
    """``replay_bwd=False`` under ``remat_kernel`` on a symmetrized graph with
    tables: JAX skips the tabled entry (no hand-structured backward) and the
    sym-regather entry (it needs ``replay_bwd``), and so does the port:
    ``geo_call`` runs, with the backward tile the remat_kernel pick gives."""
    _, _, _, tgt = _graph(N)
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=True,
                remat=True, remat_kernel=True, residual_bwd=False, replay_bwd=False,
                device="cpu")
    layer = tm.layers[0]
    assert layer._tab_eligible(N, tgt) and not layer._sym_regather_eligible(N, True)
    entries = []
    for name in ("geo_call", "geo_call_tab", "geo_call_sym"):
        real = getattr(fmg.FusedMessageGeneric, name)
        monkeypatch.setattr(fmg.FusedMessageGeneric, name,
                            lambda self, *a, _r=real, _n=name: entries.append(_n) or _r(self, *a))
    calls = _spy(monkeypatch)
    tpipe.mse_loss(tm(tgt), torch.zeros(N, 3)).backward()
    assert entries == ["geo_call"] and calls == {"vjp": 1, "other": 0}
    (kern,) = layer._generic_kernels.values()
    assert (kern.tile, kern.bwd_tile, kern.residual_bwd, kern.replay_bwd) == (128, 64, False, False)


@pytest.mark.parametrize("n, remat_kernel, want", [
    (250_000, False, 200), (250_000, True, 80), (1_000_000, True, 80), (240, True, 80),
    (96, True, 48), (112, True, 16), (128, True, 64), (1040, True, 80), (448, True, 64),
    (2000, False, 200)])
def test_backward_tile_pick_matches_jax(n, remat_kernel, want):
    """The backward tile: the dispatch tile, except under ``remat_kernel``
    with a tile above 80, the largest of 80, 64, 48, 32, 16, 8 that divides
    the padded row count: the port's pick against the JAX kernel the JAX
    dispatch builds."""
    kw = dict(remat=True, remat_kernel=remat_kernel, residual_bwd=False)
    layer = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=True,
                   device="cpu", **kw).layers[0]
    assert layer._pick_bwd_tile(n) == want
    jlayer = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm",
                    use_pallas=True, **kw).layers[0]
    tile = jlayer._pick_generic_tile(n)
    jlayer._generic_kernels.clear()
    k, f = 2, jlayer.hidden_irreps.dim
    # the dispatch builds (and caches) its kernel before it touches the data
    with pytest.raises(Exception):
        jlayer._fused_messages_generic(None, jnp.zeros((n, f)), None, jnp.zeros((n, k), jnp.int32),
                                       None, None, None, edge_geo=jnp.zeros((1,)))
    (jk,) = jlayer._generic_kernels.values()
    assert (jk.tile, jk.bwd_tile) == (tile, want)
