"""PyTorch port: the arithmetic of the lmax=1 tensor-core engine
(``scalable_e3_gnn_torch/csrc/lmax1_mma.cuh``, kernels #1-#7 in bf16), on
the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).  What
makes their tensor-core form exact is plain arithmetic and is tested here:

- the split: a product of two bf16 values has at most 16 significant bits,
  so hi = bf16(p), lo = bf16(p - hi) give hi + lo == p bitwise in fp32
  (the weight gradients' s d_o0 and s d_o1 operands); three bf16 parts
  hold an fp32 value (the weight gradients' dot lanes);
- an emulation of the engine's factored layers in PyTorch: bf16 operands,
  fp32 products and sums, the sh factors on the fp32 accumulators
  (``s (xs W)``, ``sum_c v_c (xv_c W0v)`` for the dot lanes), the weight
  gradients from split operands, against the plain versions the card
  checks the kernels with (``fused_message_aggregate_tabled_plain``,
  ``tab_bwd_plain``, the km2 forms) at the three widths of
  ``tests/test_torch_cuda.py`` (K = 8, 13, 24);
- the two forms of the dot lanes against an fp64 reference.

Tolerances are in bf16 ulps of max(|ref|, mean|ref|) (as ``chip_smoke.
bf16_ulps``): the km forward is held to the card's limit (4 ulps, at most
1e-3 of the elements over 1 ulp); the tabled forward and the backward's
rows to the rounding flips the emulation shows (at most 1 ulp, no element
over it), the weight gradients to 2e-4 of max|ref| (the flips of bf16
cotangents move them up to 8e-5), far inside the card's 3e-2 and 5e-2 of
max|ref|.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scalable_e3_gnn_torch.kernels import fused_message as fm

CG = 1.0 / math.sqrt(3.0)
BF = torch.bfloat16

# (hs, hv, K, receivers, tile): the widths of tests/test_torch_cuda.py::WIDTHS
WIDTHS = [(16, 8, 8, 96, 32), (8, 12, 13, 128, 64), (32, 16, 24, 160, 160)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(x):
    return x.to(BF).float()


def split2(p):
    hi = rnd(p)
    return hi, rnd(p - hi)


def split3(x):
    a = rnd(x)
    b = rnd(x - a)
    return a, b, rnd(x - a - b)


def ulps(got, ref):
    """(max ulps, share of elements over 1 ulp) of got against ref."""
    r = ref.float().abs()
    scale = torch.clamp(r, min=max(float(r.mean()), 1e-30))
    d = (got.float() - ref.float()).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(d.max()), float((d > 1).float().mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_product_split_is_exact(seed):
    rng = np.random.default_rng(seed)
    n = 200_000
    # two bf16 factors over a wide range of exponents, away from underflow
    a = torch.from_numpy(rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)).float().to(BF)
    b = torch.from_numpy(rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)).float().to(BF)
    p = a.float() * b.float()
    hi, lo = split2(p)
    assert torch.equal(hi + lo, p)
    # the parts are bf16 values, and lo is below half an ulp of hi
    assert torch.equal(rnd(hi), hi) and torch.equal(rnd(lo), lo)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_three_part_split_holds_an_fp32_value(seed):
    """The dot lanes' split: hi + mid + lo equals the fp32 value but for its
    last bit (a carry of the first rounding can leave 17 bits past hi)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(200_000) * 2.0 ** rng.integers(-30, 30, 200_000))
    x = x.float()
    a, b, c = split3(x)
    for part in (a, b, c):
        assert torch.equal(rnd(part), part)
    err = ((a.double() + b.double() + c.double()) - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -24).all())
    assert float((err == 0).double().mean()) > 0.99


def _problem(hs, hv, k, n, tile, seed=0):
    """Tabled inputs in bf16 from a seed: h, geometry (sh of unit vectors,
    random d2, masks), a per-tile compact table with empty slots, the folded
    weights."""
    rng = np.random.default_rng(seed)
    cfg0 = fm.MessageConfig(hs=hs, hv=hv, k=k, tile=tile)
    f = cfg0.f
    ntiles = n // tile
    u = min(tile * k, 3 * tile)
    cfg = fm.MessageConfig(hs=hs, hv=hv, k=k, tile=tile, u=u)
    e = n * k
    h = torch.from_numpy(rng.standard_normal((n, f))).float().to(BF)
    vec = rng.standard_normal((e, 3))
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    attr = torch.from_numpy(np.concatenate([np.ones((e, 1)), math.sqrt(3) * vec], 1)).float()
    d2 = torch.from_numpy(rng.random((e, 1)) * 0.05).float()
    maskf = torch.from_numpy((rng.random((e, 1)) > 0.15).astype(np.float32))
    loc = torch.from_numpy(rng.integers(0, u + 1, (e, 1))).int()  # u: no sender
    gtab = torch.from_numpy(rng.integers(0, n, (ntiles, u))).int()
    shapes = cfg.weight_shapes()
    w = [torch.from_numpy(rng.standard_normal(s) / math.sqrt(s[0])).float().to(BF)
         for s in shapes]
    ref_w = (w[0], torch.cat([w[1], w[2]]), w[3], torch.cat([w[4], w[5]]))
    return cfg, (h, d2.to(BF), attr.to(BF), maskf.to(BF), loc, gtab), ref_w


# ---- the engine's arithmetic, emulated: products of bf16 values summed in
# fp32 (torch's fp32 matmul), the factors on the accumulators

def _eng_layer(xs, d2, xv, s, v, w0, w1s, w1v, hs, km):
    """One layer as the engine computes it.  xs [R, S] (layer 1: without the
    d2 lane; d2 [R, 1] or None), xv [R, 3, V]; w0 [S (+1) + V, C0] etc.  km:
    w0's vector rows already CG-scaled and rounded, A and the sigmoid
    rounded.  Returns m0, m1 (fp32, unrounded), o0 and o1."""
    ns = xs.shape[1]
    acc = xs @ w0[:ns]
    oa = xs @ w1s[:ns]
    if d2 is not None:
        acc = acc + d2 * w0[ns]
        oa = oa + d2 * w1s[ns]
        ns += 1
    o0 = s * acc
    cgd = 1.0 if km else CG
    for c in range(3):
        o0 = o0 + (cgd * v[:, c:c + 1]) * (xv[:, c] @ w0[ns:])
    ob = torch.stack([s * (xv[:, c] @ w1v) for c in range(3)], 1)
    a = rnd(oa) if km else oa
    o1 = CG * (v[:, :, None] * a[:, None, :] + ob)
    g = torch.sigmoid(o0[:, hs:])
    m0 = F.silu(o0[:, :hs])
    m1 = o1 * (rnd(g) if km else g)[:, None, :]
    return m0, m1, o0, o1


def _eng_forward(cfg, xs1, xv1, s, v, mask, ws, km):
    """agg rows per slot [E, F] (masked messages, rounded) by the engine."""
    hs, hv = cfg.hs, cfg.hv
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.float() for w in ws)
    m0, m1, _, _ = _eng_layer(xs1[:, :2 * hs], xs1[:, 2 * hs:], xv1, s, v, w0a, w1sa, w1va, hs, km)
    m0, m1, _, _ = _eng_layer(rnd(m0), None, rnd(m1), s, v, w0b, w1sb, w1vb, hs, km)
    e = xs1.shape[0]
    msg = torch.cat([m0, m1.reshape(e, 3 * hv)], -1)
    return rnd(msg * mask)


def _gate_vjp(o0, o1, d_m0, d_m1, v, hs):
    g = torch.sigmoid(o0[:, hs:])
    d_o1 = rnd(d_m1 * g[:, None, :])
    d_g = (d_m1 * o1).sum(1)
    sg = torch.sigmoid(o0[:, :hs])
    d_o0 = rnd(torch.cat([d_m0 * (sg * (1 + o0[:, :hs] * (1 - sg))), d_g * g * (1 - g)], -1))
    d_a = rnd(CG * (d_o1 * v[:, :, None]).sum(1))
    return d_o0, d_a, d_o1


def _eng_wgrad(x, x_dot, s, v, d_o0, d_a, d_o1, d2=None):
    """dW0, dW1S, dW1V of one layer from exact operands: x [R, S] the scalar
    inputs (raw), x_dot [R, 3, V] the vector inputs; s d_o0 and s d_o1 split
    hi + lo, the dot split into three parts."""
    hi, lo = split2(s * d_o0)
    dw0_s = x.T @ hi + x.T @ lo
    dot = (x_dot * v[:, :, None]).sum(1)
    dw0_v = CG * sum(p.T @ d_o0 for p in split3(dot))
    dw1s = x.T @ d_a
    dw1v = 0
    for c in range(3):
        hi, lo = split2(s * d_o1[:, c])
        dw1v = dw1v + x_dot[:, c].T @ hi + x_dot[:, c].T @ lo
    dw1v = CG * dw1v
    if d2 is not None:  # the d2 lane: rows of dW0 and dW1S in fp32
        dw0_s = torch.cat([dw0_s, ((d2 * s) * d_o0).sum(0, keepdim=True)])
        dw1s = torch.cat([dw1s, (d2 * d_a).sum(0, keepdim=True)])
    return torch.cat([dw0_s, dw0_v]), dw1s, dw1v


def _eng_backward(cfg, xs1, xv1, s, v, mask, ws, d_rows):
    """(d_hs rows, d_hr rows [E, F], six weight gradients) by the engine."""
    hs, hv = cfg.hs, cfg.hv
    e = xs1.shape[0]
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.float() for w in ws)
    xs, d2 = xs1[:, :2 * hs], xs1[:, 2 * hs:]
    m0a, m1a, o0a, o1a = _eng_layer(xs, d2, xv1, s, v, w0a, w1sa, w1va, hs, False)
    m0, m1 = rnd(m0a), rnd(m1a)
    _, _, o0b, o1b = _eng_layer(m0, None, m1, s, v, w0b, w1sb, w1vb, hs, False)
    d_m = rnd(d_rows * mask)
    d_o0, d_a, d_o1 = _gate_vjp(o0b, o1b, d_m[:, :hs], d_m[:, hs:].reshape(e, 3, hv), v, hs)
    dw0b, dw1sb, dw1vb = _eng_wgrad(m0, m1, s, v, d_o0, d_a, d_o1)
    df = rnd(d_o0 @ w0b.T)
    d_m0 = rnd(d_a @ w1sb.T + df[:, :hs] * s)
    d_m1 = rnd(torch.stack([rnd(CG * (d_o1[:, c] @ w1vb.T)) for c in range(3)], 1) * s[:, :, None]
               + (CG * df[:, hs:])[:, None, :] * v[:, :, None])
    d_o0, d_a, d_o1 = _gate_vjp(o0a, o1a, d_m0, d_m1, v, hs)
    dw0a, dw1sa, dw1va = _eng_wgrad(xs, xv1, s, v, d_o0, d_a, d_o1, d2)
    df = rnd(d_o0 @ w0a.T)
    n_s = 2 * hs + 1
    d_xs = rnd(d_a @ w1sa[:2 * hs].T + df[:, :2 * hs] * s)
    d_xv = rnd(torch.stack([rnd(CG * (d_o1[:, c] @ w1va.T)) for c in range(3)], 1) * s[:, :, None]
               + (CG * df[:, n_s:])[:, None, :] * v[:, :, None])
    d_hs = torch.cat([d_xs[:, :hs], d_xv[:, :, :hv].reshape(e, 3 * hv)], -1)
    d_hr = torch.cat([d_xs[:, hs:], d_xv[:, :, hv:].reshape(e, 3 * hv)], -1)
    return d_hs, d_hr, (dw0a, dw1sa, dw1va, dw0b, dw1sb, dw1vb)


def _ksum(rows, n, k):
    acc = rows.reshape(n, k, -1)[:, 0]
    for j in range(1, k):
        acc = acc + rows.reshape(n, k, -1)[:, j]
    return acc


@pytest.mark.parametrize("hs,hv,k,n,tile", WIDTHS)
def test_engine_forward_matches_plain(hs, hv, k, n, tile):
    cfg, (h, d2, attr, maskf, loc, gtab), rw = _problem(hs, hv, k, n, tile)
    ref = fm.fused_message_aggregate_tabled_plain(cfg, h, d2, attr, maskf, loc, gtab, *rw)
    ws = fm.split_weights(cfg, *rw)
    xs, xv, s, v, _ = fm._slot_inputs(cfg, h, d2, attr, loc, gtab)
    got = _ksum(_eng_forward(cfg, xs, xv, s, v, maskf.float(), ws, km=False), n, k).to(BF)
    worst, over = ulps(got, ref)
    assert worst <= 1 and over == 0, (worst, over)


@pytest.mark.parametrize("hs,hv,k,n,tile", WIDTHS)
def test_engine_km_forward_matches_km2_plain(hs, hv, k, n, tile):
    """The km2 form (#3): W0's vector rows CG-scaled and rounded when the
    weights are staged, the dot lanes unscaled, A and the sigmoid rounded."""
    cfg, (h, d2, attr, maskf, loc, gtab), rw = _problem(hs, hv, k, n, tile, seed=1)
    xs, xv, s, v, _ = fm._slot_inputs(cfg, h, d2, attr, loc, gtab)
    hrow = torch.cat([xs[:, :hs], xv[:, :, :hv].reshape(-1, 3 * hv)], -1).to(BF)
    hs3 = hrow.reshape(n, k, -1).transpose(0, 1).contiguous()
    geo2 = torch.cat([attr, d2, maskf], -1).reshape(n, k * 6)
    kcfg = fm.MessageConfig(hs=hs, hv=hv, k=k, tile=tile)
    ref = fm.fused_message_aggregate_km_plain(kcfg, hs3, h, geo2, *rw)
    ws = list(fm.split_weights(kcfg, *rw))
    ws[0], ws[3] = fm._fold_cg(ws[0], kcfg.s1), fm._fold_cg(ws[3], hs)
    # slot-major rows as the plain km form orders them
    xs_k, xv_k, s_k, v_k, m_k = fm._km_slot_inputs(kcfg, hs3, h, geo2)
    msg = _eng_forward(kcfg, xs_k, xv_k, s_k, v_k, m_k, ws, km=True)
    got = msg.reshape(k, n, -1).sum(0).to(BF)
    worst, over = ulps(got, ref)
    assert worst <= 4 and over <= 1e-3, (worst, over)


@pytest.mark.parametrize("hs,hv,k,n,tile", WIDTHS)
def test_engine_backward_matches_plain(hs, hv, k, n, tile):
    """d_hr, the sender rows and the six weight gradients against
    ``tab_bwd_plain`` (whose sender rows the kernel folds into d_hu; the
    rows are compared here, the fold is a sum of them)."""
    cfg, (h, d2, attr, maskf, loc, gtab), rw = _problem(hs, hv, k, n, tile, seed=2)
    rng = np.random.default_rng(7)
    d_agg = torch.from_numpy(rng.standard_normal(h.shape)).float().to(BF)
    ws = fm.split_weights(cfg, *rw)
    xs, xv, s, v, slot_tab = fm._slot_inputs(cfg, h, d2, attr, loc, gtab)
    d_rows = d_agg.float().repeat_interleave(k, dim=0)
    r_hs, r_hrr, r_dws = fm._rows_bwd(cfg, xs, xv, s, v, maskf, ws, d_rows, BF)
    g_hs, g_hrr, g_dws = _eng_backward(cfg, xs, xv, s, v, maskf.float(), ws, d_rows)
    for got, ref in ((g_hs, r_hs), (_ksum(g_hrr, n, k), _ksum(r_hrr, n, k))):
        worst, over = ulps(got.to(BF), ref.to(BF))
        assert worst <= 1 and over == 0, (worst, over)
    _, r_hr, _ = fm.tab_bwd_plain(cfg, h, d2, attr, maskf, loc, gtab, ws, d_agg)
    worst, over = ulps(_ksum(g_hrr, n, k).to(BF), r_hr)
    assert worst <= 1 and over == 0, (worst, over)
    for got, ref in zip(g_dws, r_dws, strict=True):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max())


def test_dot_forms_against_fp64():
    """The two forms of the dot lanes (sum_c v_c (xv_c W), and the fp32 dot
    split into three bf16 parts times W) against fp64 on one layer's
    shapes: both within a few fp32 ulps of the result, no bf16 rounding."""
    rng = np.random.default_rng(3)
    r, vdim, c0 = 4096, 32, 48
    xv = torch.from_numpy(rng.standard_normal((r, 3, vdim))).float().to(BF).float()
    v = torch.from_numpy(rng.standard_normal((r, 3))).float().to(BF).float()
    w = torch.from_numpy(rng.standard_normal((vdim, c0)) / 6).float().to(BF).float()
    exact = sum(v[:, c:c + 1].double() * (xv[:, c].double() @ w.double()) for c in range(3))
    form_a = sum(v[:, c:c + 1] * (xv[:, c] @ w) for c in range(3))
    dot = (xv * v[:, :, None]).sum(1)
    form_b = sum(p @ w for p in split3(dot))
    scale = float(exact.abs().max())
    for form in (form_a, form_b):
        assert float((form.double() - exact).abs().max()) <= 2.0 ** -20 * scale
