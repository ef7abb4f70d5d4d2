"""PyTorch port, the packed t-major lmax=1 fused message (#6 forward, #7
backward) and ``SEGNN(pack=p)``: the plain PyTorch versions against the JAX
Pallas kernel ``fused_message_aggregate`` and its custom VJP in interpret
mode at p = 1, 2, 3, 4; the node-major gathers ``take_dense_symmetric`` and
``gather`` against JAX; ``SEGNN(pack=p)`` against JAX ``SEGNN(pack=p)`` on
symmetrized and unsymmetrized graphs and under ``edge_chunks``; a 3-step bf16
loss curve; the dispatch rules of ``pack``.

Kernel shapes: K=12, hidden 16x0e+8x1o, tile 16, 48 rows of which 40 are
live (the last 8 padded with zero rows and mask 0, the way the model pads),
about a fifth of the slots masked.  Every slot has its own sender row and
geometry, so a mix-up of the node-major rows (i*K + k) shows.

Tolerances, each with its reason:
- fp32 kernels: 2e-5 * max(1, |ref|) elementwise (the same math, the GEMMs
  summed in another order); the weight gradients 2e-5 * max|ref| (sums over
  every slot).
- bf16 forward: 8 bf16 ulps of max(|ref|, mean|ref|) elementwise over the
  live receivers (measured 4.0, 4.0, 2.5 and 6.0 at p = 1, 2, 3, 4, with
  4-7% of the elements over 1 ulp); the padded ones must be exact zeros.  The
  JAX stacked-lane kernel also rounds x*s, the dot and f0 of each layer in
  bf16 where the port (and its CUDA kernel) keeps fp32, as the km form does
  (8 ulps in ``tests/test_torch_fused_message_km.py``).
- bf16 backward: d_hs, d_hr and each weight gradient within 2e-2 *
  max|ref| (measured at most 8.9e-3): the JAX stacked-lane backward rounds
  products such as d_Xvs * s in bf16 where the port rounds only at the named
  points, as ``tests/test_torch_fused_message_km.py`` states for #5.
- the gathers: bitwise; the clamped ``gather``'s gradient (an indexed
  scatter-add) fp32 1e-6 * max(1, |ref|), bf16 2 ulps of the element, as
  ``gather_km``'s.
- the model: forward atol 2e-5, loss rtol 1e-5, every gradient 1e-4 *
  max|ref| per parameter (fp32 through 2 layers, sums in another order).
- the bf16 loss curve: losses rtol 1e-4 (measured at most 2.1e-5 at p = 2
  and 4), gradient norms rtol 1.5e-2 (measured at most 6.0e-3): bf16 storage
  through 2 layers and their backward in two frameworks that round
  intermediates at other points.  The same curve at p = 1 (the km kernels)
  reads 3.3e-5 and 4.6e-3, and in fp32 at p = 2 3e-7: the spread is bf16's,
  not the packing's.
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
from scalable_e3_gnn_tpu.kernels import fused_message as jfm
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.models.segnn import SEGNNLayer as JLayer
from scalable_e3_gnn_tpu.ops.gather_scatter import take_dense_symmetric as j_tds
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.kernels import fused_message as tfm
from scalable_e3_gnn_torch.models import segnn as segnn_mod
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.ops.gather_scatter import gather, take_dense_symmetric
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_ops import _assert_trees_close
from tests.test_torch_segnn import IRREPS, _graph

HS, HV, K, TILE = 16, 8, 12, 16
F = HS + 3 * HV
NPAD, NLIVE = 48, 40
PACKS = [1, 2, 3, 4]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _problem(seed):
    """numpy arrays, node-major [NPAD*K, .] slot rows of which the first
    NLIVE receivers' are live: hs [E, F], hr [NPAD, F], d2 [E] >= 0, attr
    [E, 4], maskf [E] (0/1); the folded weights of a JAX layer; a cotangent."""
    rng = np.random.default_rng(seed)
    e = NPAD * K
    hs = rng.standard_normal((e, F)).astype(np.float32)
    hr = rng.standard_normal((NPAD, F)).astype(np.float32)
    d2 = rng.random(e).astype(np.float32)
    attr = rng.standard_normal((e, 4)).astype(np.float32)
    maskf = (rng.random(e) > 0.2).astype(np.float32)
    for x in (hs, d2, attr, maskf):
        x[NLIVE * K:] = 0.0
    hr[NLIVE:] = 0.0
    layer = JLayer(JIrreps(f"{HS}x0e+{HV}x1o"), JIrreps.spherical_harmonics(1), layout="cm",
                   use_pallas=True)
    ws = [np.asarray(w) for w in layer._folded_weights(layer.init(jax.random.key(seed)),
                                                       jnp.float32)]
    d_agg = rng.standard_normal((NPAD, F)).astype(np.float32)
    return (hs, hr, d2, attr, maskf), ws, d_agg


def _packed(arrays, p):
    """The JAX operand shapes at pack p: contiguous views of the flat rows."""
    hs, hr, d2, attr, maskf = arrays
    r = NPAD * K // p
    return [hs.reshape(r, p * F), hr, d2.reshape(r, p), attr.reshape(r, 4 * p),
            maskf.reshape(r, p)]


def _tcfg(p):
    return tfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, pack=p)


def _jcfg(p):
    return jfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, bwd_tile=TILE, pack=p)


def _torch(arrays, dtype):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, JDT[dtype]) for a in arrays]


def _ulps(got, ref, floor=None):
    """|got - ref| in bf16 ulps (8 significant bits) of max(|ref|, floor),
    the floor mean|ref| unless given."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    r = np.abs(ref)
    floor = max(float(r.mean()), 1e-30) if floor is None else floor
    return np.abs(got - ref) / np.exp2(np.floor(np.log2(np.maximum(r, floor))) - 7)


def _jax_fwd(p, dtype, arrays, ws):
    fn = jax.jit(functools.partial(jfm.fused_message_aggregate, _jcfg(p)))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*_jax(_packed(arrays, p), dtype), *_jax(ws, dtype))
                          .astype(jnp.float32))


def _jax_vjp(p, dtype, arrays, ws, d_agg):
    """jax.vjp of the Pallas kernel in hs, hr and the four weights."""
    hs, hr, d2, attr, maskf = _jax(_packed(arrays, p), dtype)

    def fn(hs_, hr_, *w):
        return jfm.fused_message_aggregate(_jcfg(p), hs_, hr_, d2, attr, maskf, *w)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, hs, hr, *_jax(ws, dtype))
        grads = jax.jit(vjp)(jnp.asarray(d_agg, JDT[dtype]))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", PACKS)
def test_flat_plain_matches_pallas(p, dtype):
    """agg of the plain #6 against the Pallas kernel at pack p."""
    arrays, ws, _ = _problem(p)
    ref = _jax_fwd(p, dtype, arrays, ws)
    got = tfm.fused_message_aggregate_plain(_tcfg(p), *_torch(_packed(arrays, p), dtype),
                                            *_torch(ws, dtype))
    assert got.dtype == dtype and got.shape == (NPAD, F)
    got = got.float().numpy()
    assert not got[NLIVE:].any() and not ref[NLIVE:].any()
    assert np.abs(ref).max() > 0.1
    if dtype == torch.float32:
        err = np.abs(got - ref)
        assert (err <= 2e-5 * np.maximum(np.abs(ref), 1.0)).all(), err.max()
    else:
        u = _ulps(got[:NLIVE], ref[:NLIVE])
        assert u.max() <= 8.0, u.max()


@pytest.mark.parametrize("p", PACKS)
def test_flat_bwd_plain_matches_pallas_vjp(p):
    """The port's autograd Function (the plain #7 on the CPU) against
    ``jax.vjp`` of the Pallas kernel, fp32: d_hs, d_hr and the four weights;
    masked slots and padded rows get exact zeros."""
    arrays, ws, d_agg = _problem(p + 10)
    ref = _jax_vjp(p, torch.float32, arrays, ws, d_agg)
    hs, hr, d2, attr, maskf = _torch(_packed(arrays, p), torch.float32)
    ws_t = _torch(ws, torch.float32)
    leaves = [x.requires_grad_(True) for x in (hs, hr, *ws_t)]
    out = tfm.fused_message_aggregate(_tcfg(p), hs, hr, d2, attr, maskf, *ws_t)
    out.backward(torch.from_numpy(d_agg))
    for i, (want, x) in enumerate(zip(ref, leaves, strict=True)):
        assert x.grad.shape == want.shape
        got = x.grad.numpy()
        scale = np.maximum(np.abs(want), 1.0) if i < 2 else np.abs(want).max()
        assert (np.abs(got - want) <= 2e-5 * scale).all(), (i, np.abs(got - want).max())
        assert np.abs(want).max() > 0.01
    dead = maskf.reshape(-1) == 0
    assert not hs.grad.reshape(NPAD * K, F)[dead].any() and not hr.grad[NLIVE:].any()


@pytest.mark.parametrize("p", PACKS)
def test_flat_bwd_plain_matches_pallas_vjp_bf16(p):
    arrays, ws, d_agg = _problem(p + 20)
    ref = _jax_vjp(p, torch.bfloat16, arrays, ws, d_agg)
    args = _torch(_packed(arrays, p), torch.bfloat16)
    got = tfm.fused_message_aggregate_bwd_plain(_tcfg(p), *args, *_torch(ws, torch.bfloat16),
                                                torch.from_numpy(d_agg).to(torch.bfloat16))
    for i, (x, want) in enumerate(zip(got, ref, strict=True)):
        assert x.dtype == torch.bfloat16 and x.shape == want.shape
        err = np.abs(x.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), (i, err, np.abs(want).max())


@pytest.mark.parametrize("p", [1, 3])
def test_flat_bwd_plain_matches_autograd_of_plain_forward(p):
    """A second oracle for the hand VJP: PyTorch autograd through the plain
    forward, fp32; 1e-5 * max(1, max|ref|) per gradient."""
    arrays, ws, d_agg = _problem(p + 30)
    hs, hr, d2, attr, maskf = _torch(_packed(arrays, p), torch.float32)
    ws_t = _torch(ws, torch.float32)
    leaves = [x.clone().requires_grad_(True) for x in (hs, hr, *ws_t)]
    out = tfm.fused_message_aggregate_plain(_tcfg(p), leaves[0], leaves[1], d2, attr, maskf,
                                            *leaves[2:])
    ref = torch.autograd.grad(out, leaves, torch.from_numpy(d_agg))
    got = tfm.fused_message_aggregate_bwd_plain(_tcfg(p), hs, hr, d2, attr, maskf, *ws_t,
                                                torch.from_numpy(d_agg))
    for want, have in zip(ref, got, strict=True):
        torch.testing.assert_close(have, want, rtol=0,
                                   atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_wrappers_on_cpu_run_the_plain_versions(dtype):
    """On CPU tensors the wrappers and the autograd Function give the plain
    versions' results bitwise, and no kernel counter moves."""
    p = 4
    arrays, ws, d_agg = _problem(7)
    args = _torch(_packed(arrays, p), dtype)
    ws_t = _torch(ws, dtype)
    d = torch.from_numpy(d_agg).to(dtype)
    cfg = _tcfg(p)
    before = [kern.launches for kern in tfm.KERNELS]
    fwd = tfm.fused_message_aggregate_fwd(cfg, *args, *ws_t)
    bwd = tfm.fused_message_aggregate_bwd(cfg, *args, *ws_t, d)
    leaves = [x.clone().requires_grad_(True) for x in (args[0], args[1], *ws_t)]
    out = tfm.fused_message_aggregate(cfg, leaves[0], leaves[1], *args[2:], *leaves[2:])
    out.backward(d)
    assert [kern.launches for kern in tfm.KERNELS] == before
    torch.testing.assert_close(fwd, tfm.fused_message_aggregate_plain(cfg, *args, *ws_t),
                               rtol=0, atol=0)
    torch.testing.assert_close(out.detach(), fwd, rtol=0, atol=0)
    want = tfm.fused_message_aggregate_bwd_plain(cfg, *args, *ws_t, d)
    for x, y, leaf in zip(bwd, want, leaves, strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(leaf.grad, y, rtol=0, atol=0)


def test_flat_shape_and_dtype_checks():
    p = 2
    arrays, ws, d_agg = _problem(9)
    args = _torch(_packed(arrays, p), torch.float32)
    ws_t = _torch(ws, torch.float32)
    cfg = _tcfg(p)
    plain = functools.partial(tfm.fused_message_aggregate_plain, cfg)
    with pytest.raises(ValueError, match="hs"):  # the [N*K, F] rows, not packed
        plain(args[0].reshape(NPAD * K, F), *args[1:], *ws_t)
    with pytest.raises(ValueError, match="attr"):
        plain(*args[:3], args[3].reshape(NPAD * K, 4), args[4], *ws_t)
    with pytest.raises(ValueError, match="tile"):
        plain(args[0][:NLIVE * K // p], args[1][:NLIVE], *(a[:NLIVE * K // p] for a in args[2:]),
              *ws_t)
    with pytest.raises(ValueError, match="weight block"):
        plain(*args, ws_t[0][:-1], *ws_t[1:])
    with pytest.raises(TypeError):
        plain(*args[:4], args[4].to(torch.bfloat16), *ws_t)
    with pytest.raises(ValueError, match="d_agg"):
        tfm.fused_message_aggregate_bwd(cfg, *args, *ws_t, torch.zeros((NPAD - 1, F)))
    with pytest.raises(ValueError, match="does not divide"):
        tfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, pack=5)


def test_flat_kernel_path_rejects_what_it_does_not_take():
    """The kernel entry raises on anything but CUDA tensors: a CPU tensor that
    reaches it (not through the wrappers' CPU branch) is refused, and the
    counters do not move."""
    p = 2
    arrays, ws, d_agg = _problem(9)
    args = _torch(_packed(arrays, p), torch.float32)
    ws6 = tfm.split_weights(_tcfg(p), *_torch(ws, torch.float32))
    before = [kern.launches for kern in tfm.KERNELS]
    with pytest.raises(ValueError, match="no kernel for device"):
        tfm.flat_bwd_kernel(_tcfg(p), *args, ws6, torch.from_numpy(d_agg))
    assert [kern.launches for kern in tfm.KERNELS] == before


# ---- the node-major gathers

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_dense_symmetric_matches_jax(dtype):
    """The clamped node-major gather and its reverse-slot gather-sum VJP
    (invalid slots zeroed, the K terms summed in fp32 and rounded once, as
    XLA sums the JAX VJP's bf16 ``.sum(axis=1)``): bitwise."""
    jg, _, tg, _ = _graph(200)
    n, k = tg.senders.shape
    rng = np.random.default_rng(3)
    h = rng.standard_normal((n, 7)).astype(np.float32)
    ct = (rng.standard_normal((n, k, 7)) * np.exp2(rng.integers(-4, 4, (n, k, 1)))).astype(
        np.float32)
    out, vjp = jax.vjp(lambda x: j_tds(x, jg.senders, jg.reverse_slot, jg.edge_mask),
                       jnp.asarray(h, JDT[dtype]))
    (ref,) = vjp(jnp.asarray(ct, JDT[dtype]))
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    got = take_dense_symmetric(ht, tg.senders, tg.reverse_slot)
    got.backward(torch.from_numpy(ct).to(dtype))
    assert got.dtype == ht.grad.dtype == dtype and got.shape == (n, k, 7)
    assert np.array_equal(got.detach().float().numpy(), np.asarray(out.astype(jnp.float32)))
    assert np.array_equal(ht.grad.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert int((tg.reverse_slot == n * k).sum()) > 0  # slots without a partner were met


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_gradient_matches_jnp_take(dtype):
    """The unsymmetrized node-major gather: autograd of ``gather`` (indexing,
    its gradient an indexed scatter-add) against the VJP of JAX's
    ``jnp.take(h, senders, axis=0, mode="clip")``; invalid slots (sender
    index n) clip to the last row, in both."""
    rng = np.random.default_rng(11)
    n, f = 64, 40
    h = rng.standard_normal((n, f)).astype(np.float32)
    senders = rng.integers(0, n, (n, K)).astype(np.int32)
    senders[rng.random((n, K)) < 0.2] = n
    g = rng.standard_normal((n, K, f)).astype(np.float32)
    jt = lambda x: jnp.take(x, jnp.asarray(senders), axis=0, mode="clip")
    fwd_j, vjp = jax.vjp(jt, jnp.asarray(h, JDT[dtype]))
    (ref,) = vjp(jnp.asarray(g, JDT[dtype]))
    ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
    out = gather(ht, torch.from_numpy(senders))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(fwd_j.astype(jnp.float32)))
    out.backward(torch.from_numpy(g).to(dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    got = ht.grad.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, np.abs(ref).max()))
    else:
        assert _ulps(got, ref, floor=1e-30).max() <= 2


# ---- SEGNN(pack=p)

# n=120 pads to 128 (tile 64); edge_chunks=2 gives 60-node blocks, each
# padded to 64 and checkpointed under remat.  K = 8: p = 2 and 4 divide it.
GRAPH_CASES = {
    "symmetrized": (120, True, {}),
    "unsymmetrized": (120, False, {}),
    "edge_chunks": (120, True, dict(edge_chunks=2, remat=True)),
}


def _spy(monkeypatch):
    """Count the model's calls of the packed and the km entries."""
    calls = {"flat": 0, "km": 0}
    for key, name in (("flat", "fused_message_aggregate"), ("km", "fused_message_aggregate_km")):
        real = getattr(segnn_mod, name)

        def wrapped(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)

        monkeypatch.setattr(segnn_mod, name, wrapped)
    return calls


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_segnn_pack_matches_jax(case, p, monkeypatch):
    """The port's ``SEGNN(pack=p)`` (the packed autograd Function, plain
    versions on the CPU; take_dense_symmetric or gather for the senders)
    against JAX ``SEGNN(pack=p)`` with its Pallas kernels in interpret mode:
    the forward, the MSE loss and every parameter's gradient.  Under
    edge_chunks the JAX model runs its blocks without remat (Pallas in
    interpret mode cannot run under jax.checkpoint); remat changes no
    result."""
    n, sym, kw = GRAPH_CASES[case]
    jg, _, tg, _ = _graph(n, seed=n + 50, symmetrize=sym)
    assert (tg.reverse_slot is not None) == sym and tg.gather_loc is None
    assert tg.senders.shape[1] % p == 0
    jkw = {k: v for k, v in kw.items() if k != "remat"}
    jm = JSEGNN(*map(JIrreps, IRREPS), num_layers=2, layout="cm", use_pallas=True, pack=p,
                **jkw)
    params = jm.init(jax.random.key(n + p))
    tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, pack=p, device="cpu", **kw)
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    assert all(layer.pack == p for layer in tm.layers)
    target = np.random.default_rng(n + 52).standard_normal((n, 3)).astype(np.float32)
    loss = lambda q: jpipe.mse_loss(jm(q, jg), jnp.asarray(target))
    with pltpu.force_tpu_interpret_mode():
        ref_out = np.asarray(jax.jit(jm.__call__)(params, jg))
        ref_loss, ref = jax.jit(jax.value_and_grad(loss))(params)
    calls = _spy(monkeypatch)
    out = tm(tg)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    val = tpipe.mse_loss(out, torch.from_numpy(target))
    val.backward()
    chunks = kw.get("edge_chunks", 1)
    # one call per layer and block, and once more per block's recompute
    assert calls == {"flat": 2 * chunks * (1 + (chunks > 1)), "km": 0}, calls
    assert abs(val.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    got = params_to_jax(tm, grad=True)
    _assert_trees_close(got, jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_train_loop_pack_bf16_matches_jax():
    """Three bf16 train steps at pack 2 (bf16 copies of fp32 master weights,
    bf16 nodes and attributes, MSE, Adam 1e-3), as ``bench.py`` runs its
    step: the port's packed kernel path against JAX's Pallas kernels in
    interpret mode on an unsymmetrized graph without tables.  Losses rtol
    1e-4, gradient norms rtol 1.5e-2 (the module docstring says why)."""
    n, p = 200, 2
    jg, _, tg, _ = _graph(n, seed=260, symmetrize=False)
    bf = torch.bfloat16
    jm = JSEGNN(*map(JIrreps, IRREPS), num_layers=2, layout="cm", use_pallas=True, pack=p)
    params = jm.init(jax.random.key(61))
    target = np.random.default_rng(62).standard_normal((n, 3)).astype(np.float32)
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

    tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, pack=p, device="cpu")
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
    assert want[2, 0] < want[0, 0]  # the loss moves


def test_pack_not_dividing_k_runs_the_km_kernel(monkeypatch):
    """K=8 with pack=3: the dispatch runs the km path (no packed call), and
    gives pack 1's result bitwise."""
    jg, _, tg, _ = _graph(128, symmetrize=False)
    tm3 = TSEGNN(*IRREPS, num_layers=1, layout="cm", use_pallas=True, pack=3, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    tm1 = TSEGNN(*IRREPS, num_layers=1, layout="cm", use_pallas=True, device="cpu")
    tm1.load_state_dict(tm3.state_dict())
    calls = _spy(monkeypatch)
    with torch.no_grad():
        out = tm3(tg)
        assert calls == {"flat": 0, "km": 1}
        torch.testing.assert_close(out, tm1(tg), rtol=0, atol=0)


def test_pack_is_ignored_where_tables_serve(monkeypatch):
    """On a graph with gather tables the tabled kernel serves whatever pack
    is, as in JAX: the result equals pack 1's bitwise."""
    _, _, _, tgt = _graph(200)
    tm4 = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, pack=4, device="cpu",
                 generator=torch.Generator().manual_seed(4))
    tm1 = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, device="cpu")
    tm1.load_state_dict(tm4.state_dict())
    calls = _spy(monkeypatch)
    with torch.no_grad():
        out = tm4(tgt)
        assert calls == {"flat": 0, "km": 0}
        torch.testing.assert_close(out, tm1(tgt), rtol=0, atol=0)


def test_params_from_jax_is_the_same_for_every_pack():
    """pack adds no parameter: the same JAX tree loads into the same state
    dict for every p."""
    jm = JSEGNN(*map(JIrreps, IRREPS), num_layers=2, layout="cm", use_pallas=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(70)))
    dicts = []
    for p in (1, 2, 3, 4):
        tm = TSEGNN(*IRREPS, num_layers=2, layout="cm", use_pallas=True, pack=p, device="cpu")
        params_from_jax(tm, params)
        dicts.append(tm.state_dict())
    for d in dicts[1:]:
        assert list(d) == list(dicts[0])
        assert all(torch.equal(d[key], dicts[0][key]) for key in d)
