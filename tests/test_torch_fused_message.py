"""PyTorch port, tabled lmax=1 fused message kernel: the plain PyTorch versions
of the forward and of the backward (with its epilogue) against the JAX Pallas
kernel and its custom VJP run in interpret mode, fp32 atol 2e-5 (same math;
the GEMMs sum in another order).  N=128 and N=200 (a ragged tail tile), K=8,
hidden 16x0e+8x1o, tile 32, with masked slots and slots without a sender
(loc == U)."""

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
from scalable_e3_gnn_tpu.kernels import fused_message as jfm
from scalable_e3_gnn_tpu.models.segnn import SEGNNLayer as JLayer
from scalable_e3_gnn_torch.kernels import fused_message as tfm

LO, HI = (-4.0,) * 3, (4.0,) * 3
HS, HV, K, TILE = 16, 8, 8, 32


@functools.lru_cache(maxsize=None)
def _problem(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    tree = jax.jit(lambda p: build_octree(p, LO, HI, num_levels=4))(jnp.asarray(pts))
    e = jax.jit(lambda p: radius_graph_brute(p, 0.7, max_neighbors=K))(tree.points)
    g = JGraph.from_radius_edges(jnp.zeros((n, 5)), tree.points, e, symmetrize=True)
    g = g.with_gather_tables(tile=TILE)
    npad = g.gather_loc.shape[0]
    f = HS + 3 * HV
    mask = np.zeros((npad, K), np.float32)
    mask[:n] = np.asarray(g.edge_mask) & (rng.random((n, K)) > 0.2)
    arrays = dict(
        h=rng.standard_normal((npad, f)).astype(np.float32),  # callers copy before use
        d2=rng.random((npad * K, 1)).astype(np.float32),
        attr=rng.standard_normal((npad * K, 4)).astype(np.float32),
        maskf=mask.reshape(npad * K, 1),
        loc=np.asarray(g.gather_loc).reshape(npad * K, 1),
        gtab=np.asarray(g.gather_tab),
    )
    arrays["h"][n:] = 0.0
    layer = JLayer(JIrreps(f"{HS}x0e+{HV}x1o"), JIrreps.spherical_harmonics(1), layout="cm",
                   use_pallas=True)
    ws = [np.asarray(w) for w in layer._folded_weights(layer.init(jax.random.key(seed)),
                                                       jnp.float32)]
    return g, arrays, ws


def _jax_ref(g, a, ws):
    cfg = jfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, u=a["gtab"].shape[1])
    args = [jnp.asarray(a[k]) for k in ("h", "d2", "attr", "maskf", "loc", "gtab")]
    fn = jax.jit(functools.partial(jfm.fused_message_aggregate_tabled, cfg))
    with pltpu.force_tpu_interpret_mode():
        out = fn(*args, g.gather_rev_dense, g.gather_rem_pos, g.gather_rem_node,
                 *map(jnp.asarray, ws))
    return np.asarray(out)


def _torch_args(a, ws):
    cfg = tfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, u=a["gtab"].shape[1])
    args = [torch.from_numpy(np.array(a[k])) for k in ("h", "d2", "attr", "maskf", "loc",
                                                          "gtab")]
    return cfg, args, [torch.from_numpy(w.copy()) for w in ws]


@pytest.mark.parametrize("n", [128, 200])
def test_tabled_plain_matches_pallas(n):
    g, a, ws = _problem(n, seed=n)
    ref = _jax_ref(g, a, ws)
    cfg, args, tws = _torch_args(a, ws)
    got = tfm.fused_message_aggregate_tabled_plain(cfg, *args, *tws).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert np.abs(ref).max() > 0.1  # the comparison is not of zeros


def _tables(g):
    return [torch.from_numpy(np.array(x)) for x in (g.gather_rev_dense, g.gather_rem_pos,
                                                     g.gather_rem_node)]


def test_wrapper_on_cpu_runs_the_plain_version():
    g, a, ws = _problem(128, seed=128)
    cfg, args, tws = _torch_args(a, ws)
    before = [kern.launches for kern in tfm.KERNELS]
    got = tfm.fused_message_aggregate_tabled(cfg, *args, *_tables(g), *tws)
    want = tfm.fused_message_aggregate_tabled_plain(cfg, *args, *tws)
    assert [kern.launches for kern in tfm.KERNELS] == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_masked_and_tableless_slots_contribute_nothing():
    g, a, ws = _problem(128, seed=128)
    cfg, args, tws = _torch_args(a, ws)
    base = tfm.fused_message_aggregate_tabled_plain(cfg, *args, *tws)
    # point masked slots at no sender and give them garbage geometry
    maskf = args[3].reshape(-1)
    dead = maskf == 0
    args[4] = torch.where(dead[:, None], torch.tensor(cfg.u, dtype=torch.int32), args[4])
    args[1] = torch.where(dead[:, None], torch.tensor(7.0), args[1])
    again = tfm.fused_message_aggregate_tabled_plain(cfg, *args, *tws)
    torch.testing.assert_close(again, base, rtol=0, atol=0)


def test_bf16_plain_tracks_fp32():
    """bf16 storage: within 3e-2 * max|ref| of the fp32 result (bf16 keeps 8
    bits of mantissa; the layer-1 outputs and each slot message round)."""
    g, a, ws = _problem(200, seed=200)
    cfg, args, tws = _torch_args(a, ws)
    ref = tfm.fused_message_aggregate_tabled_plain(cfg, *args, *tws)
    bf = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in args]
    got = tfm.fused_message_aggregate_tabled_plain(cfg, *bf, *(w.to(torch.bfloat16) for w in tws))
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max() <= 3e-2 * ref.abs().max()


def test_shape_and_dtype_checks():
    g, a, ws = _problem(128, seed=128)
    cfg, args, tws = _torch_args(a, ws)
    with pytest.raises(ValueError):
        tfm.fused_message_aggregate_tabled_plain(cfg, args[0][:-1], *args[1:], *tws)
    with pytest.raises(TypeError):
        bad = args[:4] + [args[4].long()] + args[5:]
        tfm.fused_message_aggregate_tabled_plain(cfg, *bad, *tws)


def _cotangent(a, seed):
    d = np.random.default_rng(seed).standard_normal(a["h"].shape).astype(np.float32)
    return d


def _jax_vjp(g, a, ws, d_agg):
    cfg = jfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, u=a["gtab"].shape[1])
    geo = [jnp.asarray(a[k]) for k in ("d2", "attr", "maskf", "loc", "gtab")]
    tabs = (g.gather_rev_dense, g.gather_rem_pos, g.gather_rem_node)

    def fn(h, *w):
        return jfm.fused_message_aggregate_tabled(cfg, h, *geo, *tabs, *w)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, jnp.asarray(a["h"]), *map(jnp.asarray, ws))
        grads = jax.jit(vjp)(jnp.asarray(d_agg))
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("n", [128, 200])
def test_tabled_vjp_matches_pallas(n):
    """The port's autograd Function (plain backward on the CPU) against
    ``jax.vjp`` of the Pallas kernel: d_h and the four weight gradients."""
    g, a, ws = _problem(n, seed=n)
    assert (a["loc"] == a["gtab"].shape[1]).any() and (a["maskf"] == 0).any()
    d_agg = _cotangent(a, n + 1)
    ref = _jax_vjp(g, a, ws, d_agg)
    cfg, args, tws = _torch_args(a, ws)
    h = args[0].requires_grad_(True)
    wr = [w.requires_grad_(True) for w in tws]
    out = tfm.fused_message_aggregate_tabled(cfg, h, *args[1:], *_tables(g), *wr)
    out.backward(torch.from_numpy(d_agg))
    for want, got in zip(ref, [h.grad, *(w.grad for w in wr)], strict=True):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("n", [128, 200])
def test_bwd_plain_matches_autograd_of_plain_forward(n):
    """A second oracle for the hand VJP: PyTorch autograd through the plain
    forward, fp32; atol 1e-5 * max(1, max|ref|) per gradient (the same math
    summed in another order)."""
    g, a, ws = _problem(n, seed=n)
    cfg, args, tws = _torch_args(a, ws)
    d_agg = torch.from_numpy(_cotangent(a, n + 2))
    h = args[0].clone().requires_grad_(True)
    wr = [w.clone().requires_grad_(True) for w in tws]
    out = tfm.fused_message_aggregate_tabled_plain(cfg, h, *args[1:], *wr)
    ref = torch.autograd.grad(out, [h, *wr], d_agg)
    got = tfm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, *_tables(g), *tws, d_agg)
    for want, have in zip(ref, got, strict=True):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(have, want, rtol=0, atol=1e-5 * scale)


def test_sender_epilogue_equals_scatter_of_the_table():
    """The split reverse-table gather-sum equals scattering every table row
    back to its node (pad rows dropped): exact on small integers."""
    g, a, ws = _problem(200, seed=200)
    gtab = torch.from_numpy(np.array(a["gtab"])).long().reshape(-1)
    npad, f = a["h"].shape
    rng = np.random.default_rng(3)
    d_hu = torch.from_numpy(rng.integers(-8, 8, (gtab.numel(), f)).astype(np.float32))
    d_hr = torch.from_numpy(rng.integers(-8, 8, (npad, f)).astype(np.float32))
    got = tfm.sender_epilogue(d_hr, d_hu, *_tables(g))
    keep = gtab < npad
    want = d_hr.clone().index_add_(0, gtab[keep], d_hu[keep])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _tables(g)[1].numel() > 0  # the remainder path is exercised


def test_bwd_wrapper_on_cpu_runs_the_plain_version():
    g, a, ws = _problem(128, seed=128)
    cfg, args, tws = _torch_args(a, ws)
    d_agg = torch.from_numpy(_cotangent(a, 9))
    before = [kern.launches for kern in tfm.KERNELS]
    got = tfm.fused_message_aggregate_tabled_bwd(cfg, *args, *_tables(g), *tws, d_agg)
    want = tfm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, *_tables(g), *tws, d_agg)
    assert [kern.launches for kern in tfm.KERNELS] == before
    for x, y in zip(got, want, strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_bwd_bf16_plain_tracks_fp32():
    """bf16 storage: each gradient within 3e-2 * max|ref| of fp32 (the
    cotangent intermediates round to bf16); dtypes follow h and the weights."""
    g, a, ws = _problem(200, seed=200)
    cfg, args, tws = _torch_args(a, ws)
    d_agg = torch.from_numpy(_cotangent(a, 11))
    ref = tfm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, *_tables(g), *tws, d_agg)
    bf = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in args]
    got = tfm.fused_message_aggregate_tabled_bwd_plain(
        cfg, *bf, *_tables(g), *(w.to(torch.bfloat16) for w in tws), d_agg.to(torch.bfloat16))
    for x, y in zip(got, ref, strict=True):
        assert x.dtype == torch.bfloat16
        assert (x.float() - y).abs().max() <= 3e-2 * y.abs().max()


def test_bwd_checks_its_tables():
    g, a, ws = _problem(128, seed=128)
    cfg, args, tws = _torch_args(a, ws)
    revd, remp, remn = _tables(g)
    d_agg = torch.zeros_like(args[0])
    with pytest.raises(TypeError):
        tfm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, revd.long(), remp, remn,
                                                     *tws, d_agg)
    with pytest.raises(ValueError):
        tfm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, revd, remp, remn, *tws,
                                                     d_agg[:-1])
