"""PyTorch port, the lmax=2 backward at the kernel level: the generic tabled
kernel's save mode, its plain backward in residual and replay mode, the fast
gate's VJP, the sender epilogue and the autograd entry
``FusedMessageGeneric.geo_call_tab``, each against the JAX package on the same
numpy inputs (its Pallas kernels in interpret mode, ``colpad`` off).

Tolerances, each with its reason:
- fp32 against the JAX kernels: d_hu, d_hr, ys and agg atol 2e-5 (the same
  math, GEMMs summed in another order); dW' 1e-5 * max|ref| (sums over every
  slot in another order); autograd gradients 1e-4 * max|ref| per leaf.
- bf16 forward and save mode: within 2 bf16 ulps of max(|ref|, mean|ref|)
  elementwise, at least 99% of the elements equal (the same rounding points).
- bf16 backward against the JAX kernels in interpret mode: within 32 bf16
  ulps elementwise and 2e-2 * max|ref|.  Interpret mode runs the kernel body
  through XLA on the CPU, which may keep a bf16 intermediate in fp32 (XLA's
  excess precision under jit); the port rounds every intermediate where the
  JAX code does, as eager JAX does (``test_gate_vjp_matches_jax_ad``: bitwise).
- the plain residual and replay backwards: bitwise equal (both round y where
  the forward does).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.kernels.fused_message_generic import FusedMessageGeneric as JFMG
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.ops.gate import Gate as JGate
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.utils.params import params_to_jax
from tests.test_torch_generic import IRREPS, _kernel_problem

ATOL = 2e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(got, ref):
    """|got - ref| elementwise in bf16 ulps of max(|ref|, mean|ref|)."""
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    r = ref.abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp(min=max(float(r.mean()), 1e-30)))) - 7)
    return (got - ref).abs() / ulp


def _f32(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _setup(n, seed, dtype_name, residual=True):
    """The JAX kernel (colpad off) with its folded weights and the port's
    kernel with its config, on one layer's inputs, plus a cotangent."""
    jdt, tdt = DTYPES[dtype_name]
    jgt, tgt, params, tm, k, geo2, h = _kernel_problem(n, seed=seed)
    tile = tm.layers[0]._pick_generic_tile(n)
    jlayer = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm",
                    use_pallas=True).layers[0]
    jk = JFMG(jlayer.message_layers, k, tile=tile, residual_bwd=residual)
    lp = params["layer_0"]
    ptuple = (lp["msg_0"], lp["msg_1"])
    kern = fmg.FusedMessageGeneric(tm.layers[0].message_layers, k, tile=tile,
                                   residual_bwd=residual)
    cfg = kern.config(geo2.shape[1] // k - 2, tgt.gather_tab.shape[1])
    dagg = np.random.default_rng(seed + 7).standard_normal((n, cfg.out_dim)).astype(np.float32)
    jargs = (jnp.asarray(h, jdt), jnp.asarray(geo2, jdt), jnp.asarray(dagg, jdt))
    targs = (torch.from_numpy(h).to(tdt), torch.from_numpy(geo2).to(tdt), tgt.gather_loc,
             tgt.gather_tab, kern.fold(tdt), kern.selections("cpu"))
    return dict(jk=jk, ptuple=ptuple, jgt=jgt, tgt=tgt, tm=tm, kern=kern, cfg=cfg, k=k, n=n,
                jargs=jargs, targs=targs, d_agg=torch.from_numpy(dagg).to(tdt), h=h, geo2=geo2)


def _jax_fwd_save(p):
    jk, (hj, gj, _) = p["jk"], p["jargs"]
    folded = jk._fold(p["ptuple"])
    hu = jnp.take(hj, p["jgt"].gather_tab.reshape(-1), axis=0, mode="clip")
    with pltpu.force_tpu_interpret_mode():
        out, ys = jk._fwd_call_tab(folded, hu, hj, gj, p["jgt"].gather_loc, save=True)
    return folded, hu, out, ys


@pytest.mark.parametrize("n", [96, 240])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generic_fwd_save_matches_jax(n, dtype):
    """agg and both saved ys ([K, N, D] slot-major in JAX, [N*K, D] here)."""
    p = _setup(n, n + 30, dtype)
    _, _, out, ys = _jax_fwd_save(p)
    with torch.no_grad():
        agg, tys = fmg.generic_tab_fwd(p["cfg"], *p["targs"], save=True)
        plain_agg = fmg.generic_tab_fwd(p["cfg"], *p["targs"])
    assert len(tys) == 2 and torch.equal(agg, plain_agg)
    pairs = [(agg, _f32(out))] + [
        (y, _f32(jnp.swapaxes(yj, 0, 1).reshape(n * p["k"], -1))) for y, yj in zip(tys, ys)]
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == p["targs"][0].dtype
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
        else:
            u = _ulps(got, ref)
            assert float(u.max()) <= 2 and float((u == 0).float().mean()) >= 0.99


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generic_bwd_plain_matches_jax(residual, dtype):
    """d_hu, d_hr and both dW' against ``_bwd_call_res_tab`` (residual) or
    ``_bwd_call_rep_tab`` (replay), at 240 points (two table tiles)."""
    p = _setup(240, 41, dtype, residual=residual)
    folded, hu, _, ys = _jax_fwd_save(p)
    jk, (hj, gj, dj), loc = p["jk"], p["jargs"], p["jgt"].gather_loc
    with pltpu.force_tpu_interpret_mode():
        if residual:
            dp, dhu, dhr = jk._bwd_call_res_tab(folded, hu, hj, gj, loc, ys, dj)
        else:
            dp, dhu, dhr = jk._bwd_call_rep_tab(folded, hu, hj, gj, loc, dj)
    with torch.no_grad():
        tys = fmg.generic_tab_fwd_plain(p["cfg"], *p["targs"], save=True)[1] if residual else None
        d_hu, d_hr, dws = fmg.generic_tab_bwd(p["cfg"], *p["targs"], p["d_agg"], ys=tys)
    assert d_hu.dtype == d_hr.dtype == p["targs"][0].dtype
    assert all(dw.dtype == torch.float32 for dw in dws)
    pairs = [(d_hu, _f32(dhu)), (d_hr, _f32(dhr))] + [
        (dw, _f32(d["w_folded"])) for dw, d in zip(dws, dp)]
    for i, (got, ref) in enumerate(pairs):
        assert got.shape == ref.shape
        scale = float(ref.abs().max())
        err = float((got.float() - ref).abs().max())
        if dtype == "float32":
            assert err <= (ATOL if i < 2 else 1e-5 * scale), (i, err)
        else:
            assert err <= 2e-2 * scale and float(_ulps(got, ref).max()) <= 32, (i, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generic_bwd_residual_equals_replay(dtype):
    """The plain backward from the saved ys and by replay: bitwise equal."""
    p = _setup(240, 43, dtype)
    _, ys = fmg.generic_tab_fwd_plain(p["cfg"], *p["targs"], save=True)
    res = fmg.generic_tab_bwd_plain(p["cfg"], *p["targs"], p["d_agg"], ys=ys)
    rep = fmg.generic_tab_bwd_plain(p["cfg"], *p["targs"], p["d_agg"])
    assert torch.equal(res[0], rep[0]) and torch.equal(res[1], rep[1])
    assert all(torch.equal(a, b) for a, b in zip(res[2], rep[2], strict=True))
    # chunks of 7 receivers (a chunk edge inside a tile) give the same sums
    ch = fmg.generic_tab_bwd_plain(p["cfg"], *p["targs"], p["d_agg"], chunk_rows=7 * p["k"])
    torch.testing.assert_close(ch[0].float(), rep[0].float(), rtol=0, atol=0)
    for a, b in zip(ch[2], rep[2]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_vjp_matches_jax_ad(dtype):
    """The fast gate's VJP against eager ``jax.vjp`` of ``Gate.fast_apply``:
    bitwise in bf16 (every rounding point of JAX's AD), atol 1e-6 in fp32
    (the sigmoid and the fp32 sums of two implementations)."""
    jdt, tdt = DTYPES[dtype]
    jg = JGate("24x0e", "12x1o+6x2e", layout="cm")
    _, psel, dk = jg.fast_tables()
    rng = np.random.default_rng(6)
    y = (rng.standard_normal((500, psel.shape[0])) * 3).astype(np.float32)
    d = rng.standard_normal((500, dk)).astype(np.float32)
    _, vjp = jax.vjp(lambda z: jg.fast_apply(z, jnp.asarray(psel), dk), jnp.asarray(y, jdt))
    ref = _f32(vjp(jnp.asarray(d, jdt))[0])
    sel = torch.as_tensor(np.asarray(psel)).argmax(dim=0)
    got = fmg._gate_vjp(torch.from_numpy(y).to(tdt), torch.from_numpy(d).to(tdt), sel, dk)
    assert got.dtype == tdt and got.shape == ref.shape
    if dtype == "bfloat16":
        assert torch.equal(got.float(), ref)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def _jax_epilogue(d_hu, d_hr, revd, remp, remn):
    """The sender epilogue of the JAX ``call_tab_bwd``, line for line, eager."""
    n, total = d_hr.shape[0], d_hu.shape[0]
    acc = None
    for q in range(revd.shape[1]):
        idx = revd[:, q]
        v = (idx < total).astype(d_hu.dtype)
        pq = jnp.take(d_hu, idx, axis=0, mode="clip") * v[:, None]
        acc = pq if acc is None else acc + pq
    rem = jnp.take(d_hu, remp, axis=0, mode="clip")
    acc = acc + jax.ops.segment_sum(rem, remn, num_segments=revd.shape[0],
                                    indices_are_sorted=True)
    return (acc[:n] + d_hr).astype(d_hr.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generic_sender_epilogue_matches_jax_order(dtype):
    """Dense reverse gathers (with pads), then a node-sorted remainder of up
    to 4 rows per node (with pads), then d_hr: bitwise equal in bf16, where
    each add rounds; atol 1e-6 in fp32."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    n, nrow, f = 50, 120, 7
    d_hu = (rng.standard_normal((nrow, f)) * np.exp2(rng.integers(-6, 6, (nrow, 1)))).astype(
        np.float32)
    d_hr = rng.standard_normal((n, f)).astype(np.float32)
    revd = rng.integers(0, nrow, (n, 2)).astype(np.int32)
    revd[rng.random((n, 2)) < 0.2] = nrow  # pads
    remn = np.sort(np.concatenate([rng.integers(0, n, 60), np.arange(0, n, 3).repeat(4)]))
    remn = np.concatenate([remn, [n, n]]).astype(np.int32)  # pad node: dropped
    remp = rng.integers(0, nrow, remn.shape[0]).astype(np.int32)
    want = _f32(_jax_epilogue(*(jnp.asarray(x, jdt) for x in (d_hu, d_hr)),
                              *map(jnp.asarray, (revd, remp, remn))))
    t = torch.from_numpy
    got = fmg.generic_sender_epilogue(t(d_hr).to(tdt), t(d_hu).to(tdt), t(revd), t(remp),
                                      t(remn))
    assert got.dtype == tdt
    if dtype == "bfloat16":
        assert torch.equal(got.float(), want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("residual", [True, False])
def test_geo_call_tab_gradients_match_jax(residual):
    """Gradients of <agg, ct> in h and in every message-layer parameter,
    through the port's autograd entry (its plain backward on the CPU) and
    through ``jax.grad`` of the JAX ``geo_call_tab`` (its kernels in
    interpret mode), in residual and replay mode; fp32, 1e-4 * max|ref| per
    leaf, and the forward atol 2e-5."""
    p = _setup(240, 45, "float32", residual=residual)
    jk, jgt, n = p["jk"], p["jgt"], p["n"]
    assert jk.residual_bwd == residual and p["kern"].residual_bwd == residual
    ct = np.random.default_rng(9).standard_normal((n, p["cfg"].out_dim)).astype(np.float32)
    tabs = (jgt.gather_loc, jgt.gather_tab, jgt.gather_rev_dense, jgt.gather_rem_pos,
            jgt.gather_rem_node)
    g2 = jnp.asarray(p["geo2"])

    def loss(args):
        pt, hh = args
        return jnp.sum(jk.geo_call_tab(pt, hh, g2, *tabs) * ct)

    with pltpu.force_tpu_interpret_mode():
        ref_out = np.asarray(jk.geo_call_tab(p["ptuple"], jnp.asarray(p["h"]), g2, *tabs))
        gp, gh = jax.grad(loss)((p["ptuple"], jnp.asarray(p["h"])))
    tm, tgt = p["tm"], p["tgt"]
    tm.zero_grad()
    h = torch.from_numpy(p["h"]).requires_grad_()
    out = p["kern"].geo_call_tab(h, torch.from_numpy(p["geo2"]), tgt.gather_loc, tgt.gather_tab,
                                 tgt.gather_rev_dense, tgt.gather_rem_pos, tgt.gather_rem_node)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=ATOL)
    (out * torch.from_numpy(ct)).sum().backward()
    pairs = [(h.grad, _f32(gh))]
    grads = params_to_jax(tm, grad=True)["layer_0"]
    for i, jp in enumerate(gp):
        for name, ref in jp.items():
            pairs.append((torch.from_numpy(grads[f"msg_{i}"][name]), _f32(ref)))
    assert len(pairs) > 3
    for got, ref in pairs:
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


def test_generic_bwd_wrapper_checks_its_inputs():
    p = _setup(96, 47, "float32")
    cfg, args, d_agg = p["cfg"], p["targs"], p["d_agg"]
    with pytest.raises(ValueError, match="d_agg"):
        fmg.generic_tab_bwd(cfg, *args, d_agg[:, :-1])
    _, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
    with pytest.raises(ValueError, match="saved y 1"):
        fmg.generic_tab_bwd(cfg, *args, d_agg, ys=[ys[0], ys[1][:-1]])
    with pytest.raises(ValueError, match="no kernel for device"):
        fmg.generic_tab_bwd_kernels(cfg, *(a.to("meta") for a in args[:4]),
                                    [w.to("meta") for w in args[4]],
                                    [s.to("meta") for s in args[5]], d_agg.to("meta"))
    before = [kern.launches for kern in fmg.KERNELS]
    fmg.generic_tab_bwd(cfg, *args, d_agg, ys=ys)
    assert [kern.launches for kern in fmg.KERNELS] == before  # the CPU runs the plain version


@pytest.mark.parametrize("a, sms, rows, want", [
    (9, 132, 4_000_000, 22),  # the lmax=2 configs on 132 SMs: 396 blocks, three waves
    (4, 132, 4_000_000, 33),  # 264 blocks, two waves
    (9, 114, 4_000_000, 19),  # 342 blocks, three waves
    (9, 132, 5_000, 4),  # at most one range per 1024 slot rows
])
def test_wgrad_splits_fill_whole_waves(a, sms, rows, want):
    cfg = fmg.GenericConfig(k=16, tile=200, u=640, a=a, widths=((181, 108, 90), (90, 108, 90)))
    splits = fmg._wgrad_splits(cfg, rows, sms)
    assert splits == want and rows // splits >= 1024
    if splits < rows // 1024:
        assert 2 * a * splits % sms == 0


def _chain_outputs(cfg, h, geo2, loc, gtab, ws, sels, d_agg):
    """The chain kernel's outputs (d_hs, d_hr, dy_1, dy_2, m_0, m_1; unpadded)
    written out with the module's plain pieces."""
    dt, n, f = h.dtype, h.shape[0], h.shape[1]
    m0, attr, mask, _ = fmg._slot_rows(cfg, h, geo2, loc, gtab, 0, n)
    wts, sl = [w.float() for w in ws], [s.long() for s in sels]
    y1 = fmg._layer_y(m0, wts[0], attr, cfg.widths[0][0], cfg.a)
    m1 = fmg._gate(y1, sl[0], cfg.widths[0][2])
    y2 = fmg._layer_y(m1, wts[1], attr, cfg.widths[1][0], cfg.a)
    dm = (d_agg.float().repeat_interleave(cfg.k, 0) * mask.float()).to(dt)
    dys = [None, None]
    for i, y in ((1, y2), (0, y1)):
        c1, _, dk = cfg.widths[i]
        dys[i] = fmg._gate_vjp(y, dm, sl[i], dk)
        dm = sum((dys[i] * attr[:, c:c + 1].to(dt)).float() @ wts[i][c * c1:(c + 1) * c1].T
                 for c in range(cfg.a)).to(dt)
    return dm[:, :f], dm[:, f:2 * f].reshape(n, cfg.k, f).float().sum(1).to(dt), *dys, m0, m1


@pytest.mark.parametrize("splits", [1, 3])
def test_wgrad_and_table_plain_versions_match_the_plain_backward(splits):
    """The weight-gradient and table-sum kernels' plain versions, fed the
    chain's outputs, give the plain backward's dW' (summed over the ranges;
    fp32 1e-5 * max|ref|, sums in another order) and d_hu (bitwise: the same
    rounded terms added in the same order)."""
    p = _setup(240, 51, "float32")
    cfg, args, d_agg = p["cfg"], p["targs"], p["d_agg"]
    with torch.no_grad():
        d_hu, d_hr, dws = fmg.generic_tab_bwd_plain(cfg, *args, d_agg)
        d_hs, c_hr, dy1, dy2, m0, m1 = _chain_outputs(cfg, *args, d_agg)
        part = fmg.generic_tab_bwd_wgrad(cfg, args[1], m0, m1, dy1, dy2, splits)
        table = fmg.generic_tab_bwd_table(cfg, d_hs, args[2])
    assert torch.equal(c_hr, d_hr) and torch.equal(table, d_hu)
    assert part.shape == (splits, sum(w.numel() for w in dws))
    dw = part.sum(0)
    n1 = dws[0].numel()
    for got, ref in ((dw[:n1].view_as(dws[0]), dws[0]), (dw[n1:].view_as(dws[1]), dws[1])):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
