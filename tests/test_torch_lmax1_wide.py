"""PyTorch port, the lmax=1 message kernels (#1-#7) past 32x0e+16x1o: the
plain PyTorch versions (the CPU's path and the card's yardstick for the
Wide kernels) and a wide SEGNN against the JAX package, whose lmax=1 Pallas
kernels take any ``Hs x0e + Hv x1o`` and run here in interpret mode.

Widths 40x0e+20x1o (neither multiplicity a multiple of the engine's
padding, 32 and 16) and 64x0e+32x1o (twice config 3's width in both), K=8,
on small problems (96 live receivers of NPAD=128 nodes' slot rows for the
untabled forms; a 96-point radius graph, with gather tables at tile 32 or
without them).
Every JAX call is jitted once per width and form and cached.

Tolerances are the bench-width files', unchanged:
- fp32 forward atol 2e-5 (``test_torch_fused_message.py``); fp32 backward
  1e-5 * max(1, max|ref|) (``test_torch_fused_message_km.py``; at these
  widths the weight gradients exceed 1, so the tabled file's absolute 2e-5
  does not scale);
- bf16 forward: against km2 1 ulp, against the stacked-lane km form 8 ulps
  (``test_torch_fused_message_km.py``), the packed form 8 ulps
  (``test_torch_pack.py``), in bf16 ulps of max(|ref|, mean|ref|); the
  tabled form 3e-2 * max|ref| (``test_torch_fused_message.py``);
- bf16 backward 2e-2 * max|ref| per output (the JAX stacked-lane backward
  rounds products the port does not);
- the model: forward atol 2e-5, loss rtol 1e-5, every gradient 1e-4 * its
  max|ref|; the bf16 3-step curve: losses rtol 1e-4, gradient norms rtol
  1.5e-2 (``test_torch_pack.py``).
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
from scalable_e3_gnn_tpu.graph.octree import build_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_brute
from scalable_e3_gnn_tpu.kernels import fused_message as jfm
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.models.segnn import SEGNNLayer as JLayer
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph as TGraph
from scalable_e3_gnn_torch.kernels import fused_message as tfm
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

WIDTHS = [(40, 20), (64, 32)]
K, TILE, NPAD, NLIVE = 8, 64, 128, 96
N_GRAPH = 96
LO, HI = (-4.0,) * 3, (4.0,) * 3
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _cheap_compiles():
    """XLA's least optimizing compiles for this file's JAX programs, each of
    which runs once or a few times on small shapes; after the file the
    setting is restored and the programs compiled under it are dropped."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(arrays, dtype):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, JDT[dtype]) for a in arrays]


def _ulps(got, ref):
    """|got - ref| in bf16 ulps of max(|ref|, mean|ref|)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    r = np.abs(ref)
    return np.abs(got - ref) / np.exp2(np.floor(np.log2(np.maximum(r, max(r.mean(), 1e-30)))) - 7)


def _weights(hs, hv, seed):
    layer = JLayer(JIrreps(f"{hs}x0e+{hv}x1o"), JIrreps.spherical_harmonics(1), layout="cm",
                   use_pallas=True)
    fold = jax.jit(lambda key: layer._folded_weights(layer.init(key), jnp.float32))
    return [np.asarray(w) for w in fold(jax.random.key(seed))]


# ---- the untabled forms: node-major slot rows, as km and packed views

@functools.lru_cache(maxsize=None)
def _slots(hs, hv, seed=0):
    """numpy slot rows i*K + k of which the first NLIVE receivers' are live:
    hs [E, F], hr [NPAD, F], d2 [E] >= 0, attr [E, 4], maskf [E]; the folded
    weights of a JAX layer; a cotangent."""
    rng = np.random.default_rng(seed)
    f, e = hs + 3 * hv, NPAD * K
    rows = rng.standard_normal((e, f)).astype(np.float32)
    hr = rng.standard_normal((NPAD, f)).astype(np.float32)
    d2 = rng.random(e).astype(np.float32)
    attr = rng.standard_normal((e, 4)).astype(np.float32)
    maskf = (rng.random(e) > 0.2).astype(np.float32)
    for x in (rows, d2, attr, maskf):
        x[NLIVE * K:] = 0.0
    hr[NLIVE:] = 0.0
    d_agg = rng.standard_normal((NPAD, f)).astype(np.float32)
    return (rows, hr, d2, attr, maskf), _weights(hs, hv, seed), d_agg


def _km(arrays):
    """hs3 [K, NPAD, F] and geo2 [NPAD, K*6] of the slot rows."""
    rows, hr, d2, attr, maskf = arrays
    f = rows.shape[1]
    hs3 = np.ascontiguousarray(rows.reshape(NPAD, K, f).transpose(1, 0, 2))
    geo2 = np.concatenate([attr, d2[:, None], maskf[:, None]], 1).reshape(NPAD, K * 6)
    return [hs3, hr, geo2]


def _packed(arrays, p=2):
    rows, hr, d2, attr, maskf = arrays
    r = NPAD * K // p
    return [rows.reshape(r, -1), hr, d2.reshape(r, p), attr.reshape(r, 4 * p),
            maskf.reshape(r, p)]


def _jcfg(hs, hv, **kw):
    return jfm.MessageConfig(hs=hs, hv=hv, k=K, tile=TILE, bwd_tile=TILE, **kw)


@functools.lru_cache(maxsize=None)
def _jax_untabled(hs, hv, dtype, form):
    """JAX's untabled forward and jax.vjp of it in hs, hr and the four
    weights (one jitted call; the stacked-lane km form: the forward alone,
    grads None), as numpy fp32; form: km2 / km for the forward's two GEMM
    forms (km2 with the backward's stacked-lane body), km_bwd2 for the
    backward's GEMM body, packed at p = 2."""
    arrays, ws, d_agg = _slots(hs, hv)
    if form == "packed":
        cfg = _jcfg(hs, hv, pack=2)
        hs_, hr_, *geo = _jax(_packed(arrays), dtype)
        call = lambda a, b, *w: jfm.fused_message_aggregate(cfg, a, b, *geo, *w)
    else:
        cfg = _jcfg(hs, hv, gemm_form=form != "km", gemm_form_bwd=form == "km_bwd2")
        hs_, hr_, geo2 = _jax(_km(arrays), dtype)
        call = lambda a, b, *w: jfm.fused_message_aggregate_km(cfg, a, b, geo2, *w)

    def out_and_grads(d, *a):
        out, vjp = jax.vjp(call, *a)
        return out, vjp(d)

    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        if form == "km":
            return f32(jax.jit(call)(hs_, hr_, *_jax(ws, dtype))), None
        out, grads = jax.jit(out_and_grads)(jnp.asarray(d_agg, JDT[dtype]), hs_, hr_,
                                            *_jax(ws, dtype))
    return f32(out), [f32(g) for g in grads]


def _check_fwd(got, ref, dtype, limit):
    got = got.float().numpy()
    assert np.abs(ref).max() > 0.1 and not got[NLIVE:].any()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-5)
    else:
        assert _ulps(got[:NLIVE], ref[:NLIVE]).max() <= limit


def _check_bwd(got, ref, dtype):
    for i, (x, want) in enumerate(zip(got, ref, strict=True)):
        x = x.float().numpy().reshape(want.shape)
        assert np.abs(want).max() > 0.01, i
        scale = max(1.0, np.abs(want).max()) * 1e-5 if dtype == torch.float32 else \
            2e-2 * np.abs(want).max()
        assert np.abs(x - want).max() <= scale, (i, np.abs(x - want).max(), scale)


@pytest.mark.parametrize("hs,hv", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form,limit", [("km2", 1.0), ("km", 8.0)])
def test_km_plain_matches_pallas(hs, hv, dtype, form, limit):
    """#3 (km2) and #4 (stacked lanes): the port's one plain forward (the
    km2 rounding points) against both JAX forms."""
    arrays, ws, _ = _slots(hs, hv)
    ref, _ = _jax_untabled(hs, hv, dtype, form)
    cfg = tfm.MessageConfig(hs=hs, hv=hv, k=K, tile=TILE)
    got = tfm.fused_message_aggregate_km_plain(cfg, *_torch(_km(arrays), dtype),
                                               *_torch(ws, dtype))
    _check_fwd(got, ref, dtype, limit)


@pytest.mark.parametrize("hs,hv", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["km2", "km_bwd2"])
def test_km_bwd_plain_matches_pallas_vjp(hs, hv, dtype, form):
    """#5 (the plain backward: d_hs, d_hr, the four weight gradients)
    against jax.vjp of the km kernel under both backward bodies."""
    arrays, ws, d_agg = _slots(hs, hv)
    _, ref = _jax_untabled(hs, hv, dtype, form)
    cfg = tfm.MessageConfig(hs=hs, hv=hv, k=K, tile=TILE)
    got = tfm.fused_message_aggregate_km_bwd_plain(
        cfg, *_torch(_km(arrays), dtype), *_torch(ws, dtype), *_torch([d_agg], dtype))
    _check_bwd(got, ref, dtype)


@pytest.mark.parametrize("hs,hv", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_plain_matches_pallas(hs, hv, dtype):
    """#6 and #7 at p = 2: the plain forward and backward against JAX's
    ``fused_message_aggregate`` and its VJP."""
    arrays, ws, d_agg = _slots(hs, hv)
    ref, ref_grads = _jax_untabled(hs, hv, dtype, "packed")
    cfg = tfm.MessageConfig(hs=hs, hv=hv, k=K, tile=TILE, pack=2)
    args = _torch(_packed(arrays), dtype)
    _check_fwd(tfm.fused_message_aggregate_plain(cfg, *args, *_torch(ws, dtype)), ref, dtype, 8.0)
    got = tfm.fused_message_aggregate_bwd_plain(cfg, *args, *_torch(ws, dtype),
                                                *_torch([d_agg], dtype))
    _check_bwd(got, ref_grads, dtype)


# ---- the tabled form: a radius graph with gather tables

@functools.lru_cache(maxsize=None)
def _graph(tables=True, n=N_GRAPH, seed=3):
    """A symmetrized JAX radius graph and the port's graph of the same
    arrays, with gather tables at tile 32 or without them; a regression
    target."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=K))(tree.points)
    feats = jnp.asarray(rng.standard_normal((n, 5)), jnp.float32)
    jg = JGraph.from_radius_edges(feats, tree.points, e, symmetrize=True)
    t = lambda a: torch.from_numpy(np.array(a))
    tg = TGraph(nodes=t(jg.nodes), positions=t(jg.positions), senders=t(jg.senders),
                edge_mask=t(jg.edge_mask), node_mask=t(jg.node_mask),
                node_graph=t(jg.node_graph), n_graphs=1, reverse_slot=t(jg.reverse_slot))
    if tables:
        jg, tg = jg.with_gather_tables(tile=32), tg.with_gather_tables(tile=32)
    target = rng.standard_normal((n, 3)).astype(np.float32)
    return jg, tg, target


@functools.lru_cache(maxsize=None)
def _tabled(hs, hv, dtype):
    """The tabled kernel's inputs on the graph (masked slots, slots without
    a sender), JAX's forward and jax.vjp in h and the weights (numpy fp32)."""
    jg, _, _ = _graph()
    rng = np.random.default_rng(hs)
    npad, f = jg.gather_loc.shape[0], hs + 3 * hv
    mask = np.zeros((npad, K), np.float32)
    mask[:N_GRAPH] = np.asarray(jg.edge_mask) & (rng.random((N_GRAPH, K)) > 0.2)
    a = dict(h=rng.standard_normal((npad, f)).astype(np.float32),
             d2=rng.random((npad * K, 1)).astype(np.float32),
             attr=rng.standard_normal((npad * K, 4)).astype(np.float32),
             maskf=mask.reshape(npad * K, 1),
             loc=np.asarray(jg.gather_loc).reshape(npad * K, 1), gtab=np.asarray(jg.gather_tab))
    a["h"][N_GRAPH:] = 0.0
    ws = _weights(hs, hv, hs + 1)
    d_agg = rng.standard_normal((npad, f)).astype(np.float32)
    cfg = jfm.MessageConfig(hs=hs, hv=hv, k=K, tile=32, u=a["gtab"].shape[1])
    geo = [jnp.asarray(a[k], JDT[dtype]) if k in ("d2", "attr", "maskf") else jnp.asarray(a[k])
           for k in ("d2", "attr", "maskf", "loc", "gtab")]
    tabs = (jg.gather_rev_dense, jg.gather_rem_pos, jg.gather_rem_node)
    call = lambda h, *w: jfm.fused_message_aggregate_tabled(cfg, h, *geo, *tabs, *w)

    def out_and_grads(d, *hw):
        out, vjp = jax.vjp(call, *hw)
        return out, vjp(d)

    with pltpu.force_tpu_interpret_mode():
        out, grads = jax.jit(out_and_grads)(jnp.asarray(d_agg, JDT[dtype]),
                                            *_jax([a["h"], *ws], dtype))
    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    return a, ws, d_agg, f32(out), [f32(g) for g in grads]


@pytest.mark.parametrize("hs,hv", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tabled_plain_matches_pallas(hs, hv, dtype):
    """#1 and #2 (the plain forward; the plain backward with its epilogue,
    through the autograd Function on the CPU) against the JAX tabled kernel
    and its VJP: fp32 2e-5 forward, 1e-5 * max(1, max|ref|) backward; bf16
    3e-2 * max|ref| forward (``test_torch_fused_message.py``'s bf16 limit;
    XLA on the CPU keeps some of the stacked-lane form's bf16 intermediates
    in fp32, 10 ulps apart here), 2e-2 * max|ref| backward."""
    a, ws, d_agg, ref, ref_grads = _tabled(hs, hv, dtype)
    jg, tg, _ = _graph()
    cfg = tfm.MessageConfig(hs=hs, hv=hv, k=K, tile=32, u=a["gtab"].shape[1])
    geo = [torch.from_numpy(np.array(a[k])) for k in ("d2", "attr", "maskf", "loc", "gtab")]
    geo = [x.to(dtype) if x.is_floating_point() else x for x in geo]
    h, *tws = _torch([a["h"], *ws], dtype)
    tabs = (tg.gather_rev_dense, tg.gather_rem_pos, tg.gather_rem_node)
    leaves = [x.requires_grad_(True) for x in (h, *tws)]
    out = tfm.fused_message_aggregate_tabled(cfg, leaves[0], *geo, *tabs, *leaves[1:])
    got = out.detach().float().numpy()
    assert np.abs(ref).max() > 0.1
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-5)
    else:
        assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()
    out.backward(torch.from_numpy(d_agg).to(dtype))
    for i, (x, want) in enumerate(zip(leaves, ref_grads, strict=True)):
        err = np.abs(x.grad.float().numpy() - want).max()
        scale = 1e-5 * max(1.0, np.abs(want).max()) if dtype == torch.float32 else \
            2e-2 * np.abs(want).max()
        assert err <= scale, (i, err, scale)


# ---- a 2-layer wide SEGNN: with tables, without them, and at pack = 2

MODEL = ("2x0e+1x1o", "40x0e+20x1o", "1x1o")
# (model settings, gather tables)
ROUTES = {"tabled": (dict(), True), "untabled": (dict(), False), "pack2": (dict(pack=2), False)}


def _route_graph(route):
    return _graph(tables=ROUTES[route][1])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_wide_segnn_matches_jax(route):
    """The forward, the MSE loss and every parameter's gradient of the wide
    model (the port's autograd Functions, plain versions on the CPU) against
    JAX's with its Pallas kernels in interpret mode."""
    kw = ROUTES[route][0]
    jg, tg, target = _route_graph(route)
    jm = JSEGNN(*map(JIrreps, MODEL), num_layers=2, layout="cm", use_pallas=True, **kw)
    params = jm.init(jax.random.key(7))
    tm = TSEGNN(*MODEL, num_layers=2, layout="cm", use_pallas=True, device="cpu", **kw)
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    def loss(q):
        out = jm(q, jg)
        return jpipe.mse_loss(out, jnp.asarray(target)), out

    with pltpu.force_tpu_interpret_mode():
        (ref_loss, ref_out), ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref_out = np.asarray(ref_out)
    before = [kern.launches for kern in tfm.KERNELS]
    out = tm(tg)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    val = tpipe.mse_loss(out, torch.from_numpy(target))
    val.backward()
    assert [kern.launches for kern in tfm.KERNELS] == before  # plain versions on the CPU
    assert abs(val.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    got = params_to_jax(tm, grad=True)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        y = np.asarray(y)
        assert np.abs(y).max() > 0
        np.testing.assert_allclose(x, y, atol=1e-4 * np.abs(y).max())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_wide_train_loop_bf16_matches_jax(route):
    """Three bf16 train steps of the wide model (bf16 copies of fp32 master
    weights, bf16 nodes and attributes, MSE, Adam 1e-3) against JAX's:
    losses rtol 1e-4, gradient norms rtol 1.5e-2; the loss falls."""
    kw = ROUTES[route][0]
    jg, tg, target = _route_graph(route)
    bf = torch.bfloat16
    jm = JSEGNN(*map(JIrreps, MODEL), num_layers=2, layout="cm", use_pallas=True, **kw)
    params = jm.init(jax.random.key(8))
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

    tm = TSEGNN(*MODEL, num_layers=2, layout="cm", use_pallas=True, device="cpu", **kw)
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    tattrs = tuple(None if a is None else a.to(bf) for a in tm.compute_attributes_dense(tg))
    tg_bf = tg._replace(nodes=tg.nodes.to(bf))

    def tloss(model, g, a, t):
        q = {name: w.to(bf) for name, w in model.named_parameters()}
        return tpipe.mse_loss(torch.func.functional_call(model, q, (g,), {"attrs": a}).float(), t)

    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = tpipe.make_train_step(tm, tloss, topt)
    got = []
    for _ in range(3):
        m = tstep(tg_bf, tattrs, torch.from_numpy(target))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1.5e-2)
    assert want[2, 0] < want[0, 0]
