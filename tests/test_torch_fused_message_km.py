"""PyTorch port, untabled slot-major lmax=1 fused message kernel (#3/#4
forward, #5 backward): the plain PyTorch versions against the JAX Pallas
kernels run in interpret mode, ``fused_message_aggregate_km`` with
``gemm_form`` True (km2, #3) and False (stacked lanes, #4) and its custom VJP
with ``gemm_form_bwd`` False and True (#5's two bodies).

Shapes as ``tests/test_fused_message.py``'s km test: K=8, tile 64, hidden
32x0e+16x1o (config 3's width); n=256, and n=200 padded with zero rows to 256
the way the model pads (mask 0 on the padded receivers).  Every slot has its
own sender row, geometry and mask, so a mix-up of the slot-major hs3 rows
(k*N + i) and the node-major geo2 rows (i*K + k) shows.

Tolerances, each with its reason:
- fp32 forward atol 2e-5: the same math, the GEMMs sum in another order.
- fp32 backward 1e-5 * max(1, max|ref|) per output: the same, summed over
  every slot for the weight gradients.
- bf16 forward against km2: 1 bf16 ulp of max(|ref|, mean|ref|) elementwise
  over the live receivers (the padded ones must be exact zeros); the plain
  version rounds where km2 does (the CG110-scaled W0 vector rows, A, the
  gate's sigmoid, each layer's output): measured 1.0 (n=256) and 0.5 (n=200)
  ulp, and 4.5 ulps without the first three of those rounding points.
- bf16 forward against km (stacked lanes, which also rounds x*s, the dot and
  f0 in bf16): 8 ulps; measured 6 and 5.
- bf16 backward, each output within 2e-2 * max|ref| (measured at most
  9.6e-3): the stacked-lane JAX backward rounds products such as d_Xvs * s
  in bf16 where the port rounds only at the named points, so an element
  that cancels can differ by tens of its own ulps (59 measured).
- gather_km's gradient (an indexed scatter-add) against the VJP of JAX's
  ``jnp.take``: fp32 1e-6 * max(1, |ref|), bf16 2 ulps of the element.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.kernels import fused_message as jfm
from scalable_e3_gnn_tpu.models.segnn import SEGNNLayer as JLayer
from scalable_e3_gnn_torch.kernels import fused_message as tfm
from scalable_e3_gnn_torch.ops.gather_scatter import gather_km

HS, HV, K, TILE = 32, 16, 8, 64
F = HS + 3 * HV
NPAD = 256


@functools.lru_cache(maxsize=None)
def _problem(n, seed):
    """numpy arrays at NPAD rows, of which n are live: hs3 [K, NPAD, F], hr,
    geo2 [NPAD, K*6] (sh 4, d2 >= 0, mask), the folded weights of a JAX
    layer, a cotangent."""
    rng = np.random.default_rng(seed)
    hs3 = rng.standard_normal((K, NPAD, F)).astype(np.float32)
    hr = rng.standard_normal((NPAD, F)).astype(np.float32)
    geo = rng.standard_normal((NPAD, K, 6)).astype(np.float32)
    geo[..., 4] = rng.random((NPAD, K))
    geo[..., 5] = rng.random((NPAD, K)) > 0.2
    hs3[:, n:] = 0.0
    hr[n:] = 0.0
    geo[n:] = 0.0
    layer = JLayer(JIrreps(f"{HS}x0e+{HV}x1o"), JIrreps.spherical_harmonics(1), layout="cm",
                   use_pallas=True)
    ws = [np.asarray(w) for w in layer._folded_weights(layer.init(jax.random.key(seed)),
                                                       jnp.float32)]
    d_agg = rng.standard_normal((NPAD, F)).astype(np.float32)
    return hs3, hr, geo.reshape(NPAD, K * 6), ws, d_agg


def _jcfg(**kw):
    return jfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE, bwd_tile=TILE, **kw)


TCFG = tfm.MessageConfig(hs=HS, hv=HV, k=K, tile=TILE)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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


def _jax_fwd(cfg, hs3, hr, geo2, ws):
    fn = jax.jit(functools.partial(jfm.fused_message_aggregate_km, cfg))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(hs3, hr, geo2, *ws).astype(jnp.float32))


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("gemm_form", [True, False])
def test_km_plain_matches_pallas_fp32(n, gemm_form):
    hs3, hr, geo2, ws, _ = _problem(n, seed=n)
    ref = _jax_fwd(_jcfg(gemm_form=gemm_form), *_jax([hs3, hr, geo2], torch.float32),
                   _jax(ws, torch.float32))
    got = tfm.fused_message_aggregate_km_plain(TCFG, *_torch([hs3, hr, geo2, *ws],
                                                             torch.float32)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert np.abs(ref).max() > 0.1  # the comparison is not of zeros
    assert not got[n:].any()  # padded receivers: no valid slot, an exact zero


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("gemm_form,limit", [(True, 1.0), (False, 8.0)])
def test_km_plain_matches_pallas_bf16(n, gemm_form, limit):
    """bf16 inputs and weights: in bf16 ulps against km2 (the same rounding
    points) and against the stacked-lane km form."""
    hs3, hr, geo2, ws, _ = _problem(n, seed=n)
    ref = _jax_fwd(_jcfg(gemm_form=gemm_form), *_jax([hs3, hr, geo2], torch.bfloat16),
                   _jax(ws, torch.bfloat16))
    got = tfm.fused_message_aggregate_km_plain(TCFG, *_torch([hs3, hr, geo2, *ws],
                                                             torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert not got[n:].any() and not ref[n:].any()
    u = _ulps(got[:n], ref[:n])
    assert u.max() <= limit, u.max()


def _jax_vjp(cfg, dtype, hs3, hr, geo2, ws, d_agg):
    geo = jnp.asarray(geo2, JDT[dtype])

    def fn(hs_, hr_, *w):
        return jfm.fused_message_aggregate_km(cfg, hs_, hr_, geo, *w)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *_jax([hs3, hr, *ws], dtype))
        grads = jax.jit(vjp)(jnp.asarray(d_agg, JDT[dtype]))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("gemm_form_bwd", [False, True])
def test_km_bwd_plain_matches_pallas_vjp(n, gemm_form_bwd):
    """The port's autograd Function (the plain backward on the CPU) against
    ``jax.vjp`` of the Pallas kernel: d_hs, d_hr and the four weights."""
    hs3, hr, geo2, ws, d_agg = _problem(n, seed=n)
    ref = _jax_vjp(_jcfg(gemm_form_bwd=gemm_form_bwd), torch.float32, hs3, hr, geo2, ws,
                   d_agg)
    hs3_t, hr_t, geo_t, *ws_t = _torch([hs3, hr, geo2, *ws], torch.float32)
    leaves = [x.requires_grad_(True) for x in (hs3_t, hr_t, *ws_t)]
    out = tfm.fused_message_aggregate_km(TCFG, hs3_t, hr_t, geo_t, *ws_t)
    out.backward(torch.from_numpy(d_agg))
    for want, x in zip(ref, leaves, strict=True):
        assert x.grad.shape == want.shape
        np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()))
        assert np.abs(want).max() > 0.1
    assert not hs3_t.grad[:, n:].any() and not hr_t.grad[n:].any()


@pytest.mark.parametrize("gemm_form_bwd", [False, True])
def test_km_bwd_plain_matches_pallas_vjp_bf16(gemm_form_bwd):
    hs3, hr, geo2, ws, d_agg = _problem(200, seed=200)
    ref = _jax_vjp(_jcfg(gemm_form_bwd=gemm_form_bwd), torch.bfloat16, hs3, hr, geo2, ws,
                   d_agg)
    args = _torch([hs3, hr, geo2, *ws, d_agg], torch.bfloat16)
    got = tfm.fused_message_aggregate_km_bwd_plain(TCFG, *args)
    for i, (x, want) in enumerate(zip(got, ref, strict=True)):
        assert x.dtype == torch.bfloat16
        err = np.abs(x.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), (i, err, np.abs(want).max())


@pytest.mark.parametrize("n", [256, 200])
def test_km_bwd_plain_matches_autograd_of_plain_forward(n):
    """A second oracle for the hand VJP: PyTorch autograd through the plain
    forward, fp32; 1e-5 * max(1, max|ref|) per gradient."""
    hs3, hr, geo2, ws, d_agg = _problem(n, seed=n + 1)
    args = _torch([hs3, hr, geo2, *ws], torch.float32)
    leaves = [x.clone().requires_grad_(True) for x in (args[0], args[1], *args[3:])]
    out = tfm.fused_message_aggregate_km_plain(TCFG, leaves[0], leaves[1], args[2], *leaves[2:])
    ref = torch.autograd.grad(out, leaves, torch.from_numpy(d_agg))
    got = tfm.fused_message_aggregate_km_bwd_plain(TCFG, *args, torch.from_numpy(d_agg))
    for want, have in zip(ref, got, strict=True):
        torch.testing.assert_close(have, want, rtol=0,
                                   atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_km_bwd_plain_exact_sums(dtype):
    """``km_bwd_plain(acc=float64)``, the exact-sum reference of the card's
    d_hs check: the same rounding points as with fp32 sums, so in bf16 the
    two agree bit for bit but where an fp32 sum lands on the other side of
    a rounding step (at most 1e-3 of the elements, within 8 ulps), and in
    fp32 within 1e-6 * max(1, |ref|); d_hs keeps the data dtype."""
    hs3, hr, geo2, ws, d_agg = _problem(200, seed=7)
    hs3_t, hr_t, geo_t, *ws_t, d_t = _torch([hs3, hr, geo2, *ws, d_agg], dtype)
    ws6 = tfm.split_weights(TCFG, *ws_t)
    fp32 = tfm.km_bwd_plain(TCFG, hs3_t, hr_t, geo_t, ws6, d_t)[0]
    exact = tfm.km_bwd_plain(TCFG, hs3_t, hr_t, geo_t, ws6, d_t, acc=torch.float64)[0]
    assert exact.dtype == dtype and exact.shape == fp32.shape == (K, NPAD, F)
    a, b = fp32.float().numpy(), exact.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(1.0, np.abs(b).max()))
    else:
        u = _ulps(a, b)
        assert (a != b).mean() <= 1e-3 and u.max() <= 8
    assert np.abs(b).max() > 0.1 and not b[:, 200:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_km_wrappers_on_cpu_run_the_plain_versions(dtype):
    """On CPU tensors the wrappers and the autograd Function give the plain
    versions' results bitwise, and no kernel counter moves."""
    hs3, hr, geo2, ws, d_agg = _problem(200, seed=7)
    args = _torch([hs3, hr, geo2, *ws], dtype)
    d = torch.from_numpy(d_agg).to(dtype)
    before = [kern.launches for kern in tfm.KERNELS]
    fwd = tfm.fused_message_aggregate_km_fwd(TCFG, *args)
    bwd = tfm.fused_message_aggregate_km_bwd(TCFG, *args, d)
    leaves = [x.clone().requires_grad_(True) for x in (args[0], args[1], *args[3:])]
    out = tfm.fused_message_aggregate_km(TCFG, leaves[0], leaves[1], args[2], *leaves[2:])
    out.backward(d)
    assert [kern.launches for kern in tfm.KERNELS] == before
    torch.testing.assert_close(fwd, tfm.fused_message_aggregate_km_plain(TCFG, *args),
                               rtol=0, atol=0)
    torch.testing.assert_close(out.detach(), fwd, rtol=0, atol=0)
    want = tfm.fused_message_aggregate_km_bwd_plain(TCFG, *args, d)
    for x, y, leaf in zip(bwd, want, leaves, strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(leaf.grad, y, rtol=0, atol=0)


def test_km_shape_and_dtype_checks():
    hs3, hr, geo2, ws, d_agg = _problem(256, seed=256)
    hs3_t, hr_t, geo_t, *ws_t = _torch([hs3, hr, geo2, *ws], torch.float32)
    plain = functools.partial(tfm.fused_message_aggregate_km_plain, TCFG)
    with pytest.raises(ValueError, match="hs3"):  # node-major senders
        plain(hs3_t.transpose(0, 1).contiguous(), hr_t, geo_t, *ws_t)
    with pytest.raises(ValueError, match="geo2"):
        plain(hs3_t, hr_t, geo_t.reshape(NPAD * K, 6), *ws_t)
    with pytest.raises(ValueError, match="tile"):
        plain(hs3_t[:, :200], hr_t[:200], geo_t[:200], *ws_t)
    with pytest.raises(ValueError, match="weight block"):
        plain(hs3_t, hr_t, geo_t, ws_t[0][:-1], *ws_t[1:])
    with pytest.raises(TypeError):
        plain(hs3_t, hr_t, geo_t.to(torch.bfloat16), *ws_t)
    with pytest.raises(ValueError, match="d_agg"):
        tfm.fused_message_aggregate_km_bwd(TCFG, hs3_t, hr_t, geo_t, *ws_t,
                                           torch.zeros((NPAD - 1, F)))


def test_km_kernel_path_rejects_what_it_does_not_take():
    """The kernel entries raise on anything but CUDA tensors: a CPU tensor that
    reaches them (not through the wrappers' CPU branch) is refused, and the
    counters do not move."""
    hs3, hr, geo2, ws, d_agg = _problem(256, seed=256)
    args = _torch([hs3, hr, geo2], torch.float32)
    ws6 = tfm.split_weights(TCFG, *_torch(ws, torch.float32))
    before = [kern.launches for kern in tfm.KERNELS]
    with pytest.raises(ValueError, match="no kernel for device"):
        tfm.km_bwd_kernel(TCFG, *args, ws6, torch.from_numpy(d_agg))
    assert [kern.launches for kern in tfm.KERNELS] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_km_gradient_matches_jnp_take(dtype):
    """The unsymmetrized sender gather: autograd of ``gather_km`` (indexing,
    its gradient an indexed scatter-add) against the VJP of JAX's
    ``jnp.take(h, senders.T, axis=0, mode="clip")``; invalid slots (sender
    index n) clip to the last row, in both."""
    rng = np.random.default_rng(11)
    n, f = 64, 40
    h = rng.standard_normal((n, f)).astype(np.float32)
    senders = rng.integers(0, n, (n, K)).astype(np.int32)
    senders[rng.random((n, K)) < 0.2] = n
    g = rng.standard_normal((K, n, f)).astype(np.float32)
    jt = lambda x: jnp.take(x, jnp.asarray(senders).T, axis=0, mode="clip")
    fwd_j, vjp = jax.vjp(jt, jnp.asarray(h, JDT[dtype]))
    (ref,) = vjp(jnp.asarray(g, JDT[dtype]))
    ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
    out = gather_km(ht, torch.from_numpy(senders))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(fwd_j.astype(jnp.float32)))
    out.backward(torch.from_numpy(g).to(dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    got = ht.grad.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, np.abs(ref).max()))
    else:
        assert _ulps(got, ref, floor=1e-30).max() <= 2
