"""PyTorch port, the generic kernels #8-#14 under SEGNN's other gate
activations (tanh, gelu in JAX's default tanh form, relu, softplus), against
the JAX package on the same numpy inputs (its Pallas kernels in interpret
mode, ``colpad`` off): the activations and their cotangents, the plain gate
and its VJP against JAX's concat-form ``Gate`` and ``jax.vjp``, every route
(#8/#9, #10, #11/#12, #13 through ``geo_call_sym``, #14) under tanh, #8/#9
under gelu, relu and softplus on #8/#9 against the port's own plain path,
each activation's 1-layer ``SEGNN`` at hidden 8x0e+4x1o+2x2e through the
kernel path, a 1-layer ``SEGNN(act=tanh)`` against JAX's Pallas model, and
the raises.

Column order: JAX evaluates a non-silu gate on the TP's own columns
(``scalars || gates || gated``); the port keeps its folded weights permuted
to ``scalars || gated || gates`` for every activation, so its saved ys and
dW' are JAX's with the columns permuted (``Gate.fast_tables``' perm), and
every other output is the same tensor.

Tolerances, each with its reason:
- activations, fp32 on a grid with 0 and +-30: values 1e-6 * max(1, |ref|)
  (torch's and XLA's tanh, exp and log1p differ by up to 2.4e-7 there);
  cotangents 1e-6 * max(1, |ref|), gelu's 5e-6: XLA's tanh returns exactly
  -1 for arguments below about -7.9 (x below about -4.9), where gelu' is
  about 1e-5 and JAX's cotangent reads 0; the port's is the nearer to fp64.
- the gate and its VJP in fp32: 2e-6 * max(1, |ref|) elementwise, gelu's
  1e-5 (tanh's derivative (1 - t)(1 + t) cancels near |t| = 1, amplifying
  the 1-2 ulp gap between torch's and XLA's tanh; gelu as above).  In bf16
  the gated lanes and the gate columns bitwise (the same bf16 roundings of
  the products and of the copy sums, the same sigmoid bits at these
  inputs); the scalar lanes within 1 bf16 ulp of max(|ref|, mean|ref|):
  where |y| > 4 or so the two tanh (or gelu) implementations' fp32 values
  differ in their last bits and the cancellation in the derivative turns
  that into other bf16 values, all far below the tensor's scale (at most
  0.06 ulp at this test's inputs, 1.1% of the elements).
- the routes and the model in fp32: forwards 2e-5 * max(1, |ref|)
  elementwise and every gradient 2e-5 * max(1, max|ref|) per leaf (the same
  math, GEMMs summed in another order).
- #8/#9 in bf16: the forward and the saved ys within 2 bf16 ulps of
  max(|ref|, mean|ref|) with at least 99% of the elements equal, the
  backward within 32 ulps and 2e-2 * max|ref|: the limits of
  ``test_torch_generic_bwd.py`` for the silu gate (interpret mode runs the
  kernel body through XLA on the CPU, which keeps some bf16 intermediates
  in fp32).
- the kernel path against the port's own plain path (relu, softplus): the
  forward 2e-5, gradients 1e-4 * max|ref| per parameter (fp32, two forms
  of one function, as ``test_torch_generic.py`` holds silu's).
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
from scalable_e3_gnn_tpu.ops.gate import Gate as JGate
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.ops.gate import ACTIVATIONS, Gate as TGate, activation
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_generic import IRREPS, _graph
from tests.test_torch_generic_untabled import DTYPES, _f32, _ulps

ACTS = {act.name: act for act in ACTIVATIONS[1:]}
JACTS = {"tanh": jnp.tanh, "gelu_tanh": jax.nn.gelu, "relu": jax.nn.relu,
         "softplus": jax.nn.softplus}
N = 96  # one table tile (the generic tile of 96 points)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    rng = np.random.default_rng(0)
    edges = np.array([0.0, -0.0, 30.0, -30.0, 1e-30, -1e-30, 20.0, -20.0, 5.0, -5.0], np.float32)
    return np.concatenate([edges, np.linspace(-30, 30, 1201, dtype=np.float32),
                           (rng.standard_normal(2000) * 3).astype(np.float32)])


@pytest.mark.parametrize("name", list(ACTS))
def test_activation_matches_jax(name):
    """Each activation of the table against its JAX function, and its
    cotangent (``Activation.vjp`` at g = 1) against ``jax.grad``, in fp32."""
    act, jf = ACTS[name], JACTS[name]
    x = _grid()
    ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    dref = np.asarray(jax.jit(jax.vmap(jax.grad(jf)))(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = act.fn(xt).numpy()
    dgot = act.vjp(xt, torch.ones_like(xt)).numpy()
    assert np.isfinite(got).all() and np.isfinite(dgot).all()
    assert np.all(np.abs(got - ref) <= 1e-6 * np.maximum(1.0, np.abs(ref)))
    dtol = 5e-6 if name == "gelu_tanh" else 1e-6
    assert np.all(np.abs(dgot - dref) <= dtol * np.maximum(1.0, np.abs(dref)))
    assert dgot[0] == dref[0]  # at 0: relu's 0 (JAX's custom JVP), the others' exact value
    assert activation(act.fn) is act


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(ACTS))
def test_gate_matches_jax_concat_gate(name, dtype):
    """The port's plain gate and gate VJP on the permuted columns against
    JAX's concat-form ``Gate.__call__`` and its ``jax.vjp`` (jitted, as the
    kernels run it) on the TP's own columns."""
    jdt, tdt = DTYPES[dtype]
    act = ACTS[name]
    jg = JGate("24x0e", "12x1o+6x2e", act_scalars=JACTS[name], layout="cm")
    tg = TGate("24x0e", "12x1o+6x2e", act_scalars=act.fn, layout="cm")
    perm, psel, dk = tg.fast_tables()
    rng = np.random.default_rng(6)
    y = (rng.standard_normal((500, psel.shape[0])) * 3).astype(np.float32)
    d = rng.standard_normal((500, dk)).astype(np.float32)
    out, vjp = jax.vjp(jax.jit(jg.__call__), jnp.asarray(y, jdt))
    ref_out = _f32(out)
    ref_dy = _f32(jax.jit(vjp)(jnp.asarray(d, jdt))[0])[:, perm]
    sel = tg.fast_select(psel)
    yp = torch.from_numpy(y[:, perm]).to(tdt)
    got_out = fmg._gate(yp, sel, dk, act.code)
    got_dy = fmg._gate_vjp(yp, torch.from_numpy(d).to(tdt), sel, dk, act.code)
    assert got_out.dtype == got_dy.dtype == tdt
    tol = 1e-5 if name == "gelu_tanh" else 2e-6
    for got, ref in ((got_out, ref_out), (got_dy, ref_dy)):
        got = got.float()
        assert got.shape == ref.shape
        if dtype == "float32":
            assert bool(((got - ref).abs() <= tol * ref.abs().clamp(min=1.0)).all())
        else:
            # the scalar lanes within 1 ulp; the gated lanes, the gates' copy
            # sums and s (1 - s) bitwise (the same bf16 roundings, and the
            # same sigmoid bits at these inputs)
            assert float(_ulps(got[:, :24], ref[:, :24]).max()) <= 1
            assert torch.equal(got[:, 24:], ref[:, 24:])


@functools.lru_cache(maxsize=None)
def _problem(name, seed=5):
    """One 1-layer lmax=2 model under the activation on both sides (the JAX
    weights carried over), its tabled graph of N points, the packed
    geometry with extra masked slots, node features and a cotangent."""
    jg, jgt, tg, tgt = _graph(N)
    jm = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=1, layout="cm",
                use_pallas=True, act=JACTS[name])
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=True,
                act=ACTS[name].fn, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    k = tg.senders.shape[1]
    rng = np.random.default_rng(seed + 1)
    geo = tm.compute_attributes_dense(tgt)[3].numpy().reshape(N, k, -1).copy()
    geo[..., -1] *= rng.random((N, k)) > 0.2  # extra masked slots
    h = rng.standard_normal((N, tm.hidden_irreps.dim)).astype(np.float32)
    ct = rng.standard_normal((N, tm.hidden_irreps.dim)).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, jgt=jgt, tgt=tgt, k=k, geo2=geo.reshape(N, -1),
                h=h, ct=ct, tile=tm.layers[0]._pick_generic_tile(N))


# route -> (entry, the kernels' flags, the port's backward wrapper and
# whether it reads saved ys)
ROUTES = {
    "8/9": ("tab", dict(residual_bwd=True), ("generic_tab_bwd", True)),
    "10": ("tab", dict(residual_bwd=False), ("generic_tab_bwd", False)),
    "11/12": ("km", dict(residual_bwd=True), ("generic_bwd", True)),
    "13": ("sym", dict(residual_bwd=False), ("generic_bwd", False)),
    "14": ("km", dict(residual_bwd=False, replay_bwd=False), ("generic_bwd_vjp", False)),
}


def _kernels(p, flags):
    jk = JFMG(p["jm"].layers[0].message_layers, p["k"], tile=p["tile"], **flags)
    kern = fmg.FusedMessageGeneric(p["tm"].layers[0].message_layers, p["k"], tile=p["tile"],
                                   **flags)
    return jk, kern


@functools.lru_cache(maxsize=None)
def _jax_entry(name, route):
    """Output and gradients (the message parameters, then h) of <agg, ct>
    through the JAX entry of the route, in interpret mode."""
    p = _problem(name)
    entry, flags, _ = ROUTES[route]
    jk, _ = _kernels(p, flags)
    assert jk._gate_fast == [None, None]  # the concat-form gate
    jg, g2 = p["jgt"], jnp.asarray(p["geo2"])
    if entry == "tab":
        f = lambda pt, hh: jk.geo_call_tab(pt, hh, g2, jg.gather_loc, jg.gather_tab,
                                           jg.gather_rev_dense, jg.gather_rem_pos,
                                           jg.gather_rem_node)
    elif entry == "sym":
        f = lambda pt, hh: jk.geo_call_sym(pt, hh, g2, jg.senders, jg.reverse_slot)
    else:
        f = lambda pt, hh: jk.geo_call(pt, jnp.take(hh, jg.senders.T, axis=0, mode="clip"),
                                       hh, g2)
    lp = p["params"]["layer_0"]
    args = ((lp["msg_0"], lp["msg_1"]), jnp.asarray(p["h"]))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(f(*args))
        gp, gh = jax.grad(lambda a: jnp.sum(f(*a) * p["ct"]))(args)
    return out, [np.asarray(gh)] + [np.asarray(v) for g in gp for _, v in sorted(g.items())]


def _port_entry(name, route, monkeypatch):
    """The same through the port's entry (its plain versions on the CPU),
    recording which backward ran."""
    p = _problem(name)
    entry, flags, (bwd, _) = ROUTES[route]
    _, kern = _kernels(p, flags)
    tm, tg, n = p["tm"], p["tgt"], N
    calls = []
    real = getattr(fmg, bwd)
    monkeypatch.setattr(fmg, bwd, lambda *a, **kw: calls.append(
        (a[8] if bwd == "generic_tab_bwd" and len(a) > 8 else
         a[7] if bwd == "generic_bwd" and len(a) > 7 else kw.get("ys")) is not None)
        or real(*a, **kw))
    tm.zero_grad()
    h = torch.from_numpy(p["h"]).requires_grad_()
    g2 = torch.from_numpy(p["geo2"])
    if entry == "tab":
        out = kern.geo_call_tab(h, g2, tg.gather_loc, tg.gather_tab, tg.gather_rev_dense,
                                tg.gather_rem_pos, tg.gather_rem_node)
    elif entry == "sym":
        out = kern.geo_call_sym(h, g2, tg.senders, tg.reverse_slot)
    else:
        out = kern.geo_call(h[torch.clamp(tg.senders.t(), max=n - 1).long()], h, g2)
    (out * torch.from_numpy(p["ct"])).sum().backward()
    grads = params_to_jax(tm, grad=True)["layer_0"]
    leaves = [h.grad.numpy()] + [v for i in range(2) for _, v in sorted(grads[f"msg_{i}"].items())]
    return out.detach().numpy(), leaves, calls


def _assert_entry(name, route, monkeypatch):
    ref_out, ref_grads = _jax_entry(name, route)
    out, grads, calls = _port_entry(name, route, monkeypatch)
    assert calls == [ROUTES[route][2][1]]
    assert np.all(np.abs(out - ref_out) <= 2e-5 * np.maximum(1.0, np.abs(ref_out)))
    assert len(grads) == len(ref_grads) > 3
    for got, ref in zip(grads, ref_grads):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("route", list(ROUTES))
def test_tanh_routes_match_jax(route, monkeypatch):
    """Under tanh, each route's forward and its gradients in h and the
    message parameters against the JAX entry: #8/#9 (tabled, residual), #10
    (tabled, replay), #11/#12 (untabled, residual), #13 (``geo_call_sym``),
    #14 (``replay_bwd=False``), fp32."""
    _assert_entry("tanh", route, monkeypatch)


def test_gelu_tabled_residual_matches_jax(monkeypatch):
    """Under gelu (JAX's default tanh form), #8/#9 against the JAX entry."""
    _assert_entry("gelu_tanh", "8/9", monkeypatch)


@functools.lru_cache(maxsize=None)
def _jax_tab_bf16(name):
    """#8 in save mode and #9 of the JAX kernel in bf16 (interpret mode)."""
    p = _problem(name)
    jk, _ = _kernels(p, dict(residual_bwd=True))
    bf = jnp.bfloat16
    lp = p["params"]["layer_0"]
    folded = jk._fold((lp["msg_0"], lp["msg_1"]))
    hj, gj, dj = (jnp.asarray(x, bf) for x in (p["h"], p["geo2"], p["ct"]))
    hu = jnp.take(hj, p["jgt"].gather_tab.reshape(-1), axis=0, mode="clip")
    loc = p["jgt"].gather_loc
    with pltpu.force_tpu_interpret_mode():
        out, ys = jk._fwd_call_tab(folded, hu, hj, gj, loc, save=True)
        dp, dhu, dhr = jk._bwd_call_res_tab(folded, hu, hj, gj, loc, ys, dj)
    return _f32(out), [_f32(y) for y in ys], [_f32(x) for x in (dhu, dhr)] + [
        _f32(d["w_folded"]) for d in dp]


@pytest.mark.parametrize("name", ["tanh", "gelu_tanh"])
def test_tabled_bf16_matches_jax(name):
    """#8 (save mode) and #9 in bf16 against the JAX kernels: agg and the
    saved ys, then d_hu, d_hr and both dW' (the port's columns permuted back
    to JAX's)."""
    p = _problem(name)
    _, kern = _kernels(p, dict(residual_bwd=True))
    bf = torch.bfloat16
    cfg = kern.config(p["geo2"].shape[1] // p["k"] - 2, p["tgt"].gather_tab.shape[1])
    args = (torch.from_numpy(p["h"]).to(bf), torch.from_numpy(p["geo2"]).to(bf),
            p["tgt"].gather_loc, p["tgt"].gather_tab, kern.fold(bf), kern.selections("cpu"))
    with torch.no_grad():
        agg, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
        bwd = fmg.generic_tab_bwd(cfg, *args, torch.from_numpy(p["ct"]).to(bf), ys=ys)
    ref_agg, ref_ys, ref_bwd = _jax_tab_bf16(name)
    inv = [torch.as_tensor(np.argsort(perm)) for perm, _, _ in kern._gate_fast]
    k = p["k"]
    fwd_pairs = [(agg, ref_agg)] + [
        (y[:, iv], ry.transpose(0, 1).reshape(N * k, -1)) for y, iv, ry in zip(ys, inv, ref_ys)]
    for got, ref in fwd_pairs:
        assert got.dtype == bf and got.shape == ref.shape
        u = _ulps(got, ref)
        assert float(u.max()) <= 2 and float((u == 0).float().mean()) >= 0.99
    d_hu, d_hr, dws = bwd
    for got, ref in zip([d_hu, d_hr] + [dw[:, iv] for dw, iv in zip(dws, inv)], ref_bwd):
        assert got.shape == ref.shape
        assert float((got.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
        assert float(_ulps(got, ref).max()) <= 32


@pytest.mark.parametrize("name", ["relu", "softplus"])
def test_kernel_path_equals_plain_path(name):
    """relu and softplus: a 1-layer model through the tabled kernel path
    (#8/#9's plain versions) against the same model's plain path
    (``use_pallas=False``), forward and MSE gradients, fp32."""
    p = _problem(name)
    tm_k = p["tm"]
    tm_p = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=False,
                  act=ACTS[name].fn, device="cpu")
    tm_p.load_state_dict(tm_k.state_dict())
    y = torch.from_numpy(np.random.default_rng(3).standard_normal((N, 3)).astype(np.float32))
    calls = []
    real = fmg.generic_tab_bwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fmg, "generic_tab_bwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
        outs = []
        for tm, graph in ((tm_k, p["tgt"]), (tm_p, _graph(N)[2])):
            tm.zero_grad()
            out = tm(graph)
            tpipe.mse_loss(out, y).backward()
            outs.append(out.detach())
    assert calls == [1]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=2e-5)
    for (nk, a), (npl, b) in zip(tm_k.named_parameters(), tm_p.named_parameters(), strict=True):
        assert nk == npl
        assert float((a.grad - b.grad).abs().max()) <= 1e-4 * float(b.grad.abs().max()), nk


@pytest.mark.parametrize("name", list(ACTS))
def test_segnn_runs_under_each_activation(name):
    """``SEGNN(hidden "8x0e+4x1o+2x2e", lmax_attr=2, act=..., use_pallas=True)``
    builds and runs on the CPU under each activation, through the generic
    kernels' plain versions (one tabled forward per layer), forward and MSE
    gradients finite, the forward within 2e-5 of the plain path's."""
    _, _, tg, tgt = _graph(N)
    kw = dict(lmax_attr=2, num_layers=1, layout="cm", act=ACTS[name].fn, device="cpu")
    tm = TSEGNN("2x0e+1x1o", "8x0e+4x1o+2x2e", "1x1o", use_pallas=True, **kw)
    plain = TSEGNN("2x0e+1x1o", "8x0e+4x1o+2x2e", "1x1o", use_pallas=False, **kw)
    plain.load_state_dict(tm.state_dict())
    assert tm.layers[0].use_pallas_generic
    calls = []
    real = fmg.generic_tab_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fmg, "generic_tab_fwd", lambda cfg, *a, **kw_: calls.append(cfg.act) or
                   real(cfg, *a, **kw_))
        out = tm(tgt)
    tpipe.mse_loss(out, torch.zeros_like(out)).backward()
    assert calls == [ACTS[name].code]
    assert bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(p_.grad).all()) for p_ in tm.parameters())
    with torch.no_grad():
        torch.testing.assert_close(out.detach(), plain(tg), rtol=0, atol=2e-5)


def test_segnn_tanh_matches_jax_pallas():
    """A 1-layer lmax=2 ``SEGNN(act=tanh)`` on the tabled graph: the forward
    and every parameter's MSE gradient against JAX's model with its Pallas
    kernels (interpret mode), fp32."""
    p = _problem("tanh")
    jm, params, tm = p["jm"], p["params"], p["tm"]
    y = np.random.default_rng(4).standard_normal((N, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        f = jax.jit(lambda q: jpipe.mse_loss(jm(q, p["jgt"]), jnp.asarray(y)))
        ref_out = np.asarray(jax.jit(jm.__call__)(params, p["jgt"]))
        ref = jax.grad(f)(params)
    assert tm.layers[0].use_pallas_generic and jm.layers[0].use_pallas_generic
    tm.zero_grad()
    out = tm(p["tgt"])
    tpipe.mse_loss(out, torch.from_numpy(y)).backward()
    got_out = out.detach().numpy()
    assert np.all(np.abs(got_out - ref_out) <= 2e-5 * np.maximum(1.0, np.abs(ref_out)))
    got = params_to_jax(tm, grad=True)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 2e-5 * max(1.0, np.abs(b).max())


def test_vjp_plain_reads_saved_ys():
    """The plain #14 reading the forward's saved ys (how the card checks hold
    relu's kernel at its own y) equals its replay bitwise, in bf16."""
    p = _problem("relu")
    _, kern = _kernels(p, dict(residual_bwd=False, replay_bwd=False))
    bf = torch.bfloat16
    cfg = kern.config(p["geo2"].shape[1] // p["k"] - 2, 0)
    senders = p["tgt"].senders
    h = torch.from_numpy(p["h"]).to(bf)
    args = (h[torch.clamp(senders.t(), max=N - 1).long()], h,
            torch.from_numpy(p["geo2"]).to(bf), kern.fold(bf), kern.selections("cpu"))
    d_agg = torch.from_numpy(p["ct"]).to(bf)
    with torch.no_grad():
        ys = fmg.generic_fwd_plain(cfg, *args, save=True)[1]
        rep = fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 48)
        got = fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 48, ys=ys)
    for a, b in zip([got[0], got[1], *got[2]], [rep[0], rep[1], *rep[2]], strict=True):
        assert torch.equal(a, b)


def test_activations_outside_the_set_raise():
    """An activation outside the table, or gates squashed by anything but
    sigmoid, raise ``ValueError`` naming the set, before any kernel runs."""
    _, _, tg, tgt = _graph(N)
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=True,
                act=torch.sigmoid, device="cpu")
    assert tm.layers[0].use_pallas_generic
    with pytest.raises(ValueError, match="silu .*tanh .*gelu_tanh .*relu .*softplus"):
        with torch.no_grad():
            tm(tgt)
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=1, layout="cm", use_pallas=True,
                act=torch.tanh, device="cpu")
    for m in tm.layers[0].message_layers:
        m.gate.act_gates = torch.tanh
    with pytest.raises(ValueError, match="sigmoid"):
        fmg.FusedMessageGeneric(tm.layers[0].message_layers, 8, tile=96)
    with pytest.raises(ValueError, match="tanh"):
        activation(lambda x: torch.tanh(x))
