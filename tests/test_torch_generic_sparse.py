"""PyTorch port, non-foldable generic message layers (``lmax_attr=5``: the
attributes 36 wide, past the folded-GEMM path's 32) against the JAX package.
JAX turns both hand-structured backwards off for them and runs the layer
component-wise (its sparse TP) with the concat gate inside the forward #11 and
the fallback backward #14; the port runs the same two kernels on the layers'
CG-folded weights with the selection gate: the same function.  Here: one
layer's forward and every gradient through ``geo_call``, a small
``lmax_attr=5`` SEGNN (forward, gradients, a 3-step bf16 loss curve) and the
``remat_kernel`` quirk on symmetrized graphs, which both packages share.

Tolerances as in ``test_torch_generic_vjp.py`` (its docstring gives the
reasons): fp32 2e-5 * max(1, |ref|) for the layer, 1e-4 for the model; bf16
32 ulps for the layer; the bf16 loss curve's losses rtol 5e-3.  The bf16 gap
between the folded and the sparse evaluation is recorded in ``ROADMAP.md``
("Not faults").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.kernels.fused_message_generic import FusedMessageGeneric as JFMG
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from tests.test_torch_generic import _graph
from tests.test_torch_generic_untabled import _close
from tests import test_torch_generic_vjp as vjp_tests
from tests.test_torch_generic_vjp import N, SPARSE_IRREPS, _problem


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonfoldable_layer_matches_jax_sparse_body(dtype):
    """A non-foldable layer (attributes 36 wide): JAX turns both hand
    backwards off and runs the sparse TP with the concat gate in #11 and #14;
    the port runs the same kernels on the CG-folded weights.  Forward and
    every gradient through ``geo_call``; ``replay_bwd=True`` asked for, as the
    model does, and turned off by foldability on both sides."""
    p = _problem(96, 81, dtype, lmax_attr=5, irreps=SPARSE_IRREPS)
    jk = JFMG(p["jk"].layers, p["k"], tile=p["jk"].tile)
    kern = fmg.FusedMessageGeneric(p["kern"].layers, p["k"], tile=p["kern"].tile)
    assert p["cfg"].a == 36 and kern.bwd_tile == jk.bwd_tile == 48
    assert not (jk.residual_bwd or jk.replay_bwd or kern.residual_bwd or kern.replay_bwd)
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
    for layer, jg in zip(p["tm"].layers[0].message_layers, jgrads[0]):
        for name, w in layer.tp.named_parameters():
            _close(w.grad, jg[name], dtype)


def test_segnn_lmax_attr5_gradients_match_jax(monkeypatch):
    """The forward and every MSE gradient of a 1-layer ``lmax_attr=5`` SEGNN
    (its message backward #14) against the JAX model, as the
    ``replay_bwd=False`` model in ``test_torch_generic_vjp.py``."""
    vjp_tests.test_segnn_vjp_gradients_match_jax(monkeypatch, "lmax_attr5")


def test_lmax_attr5_bf16_forward_error_is_rounding():
    """The bf16 gap between the two evaluations is bf16 rounding on both
    sides: the 1-layer ``lmax_attr=5`` model's bf16 forward (bf16 weights,
    nodes and attributes) against the fp32 forward of the same weights, in
    relative RMS over the outputs.  Measured: JAX's sparse body 5.3e-3, the
    port's folded kernels 7.6e-3, the two bf16 forwards 5.1e-3 apart.  The
    port's error is held within 2x JAX's, and the two within 1e-2."""
    jg, _, tg, _ = _graph(N)
    jm, params, tm = vjp_tests._pair("lmax_attr5", seed=93)
    bf = torch.bfloat16
    ja = jax.jit(jm.compute_attributes_dense)(jg)
    jab = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, ja)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(jm)(params, jg, attrs=ja))
        jb = np.asarray(jax.jit(jm)(jax.tree.map(lambda x: x.astype(jnp.bfloat16), params),
                                    jg._replace(nodes=jg.nodes.astype(jnp.bfloat16)),
                                    attrs=jab).astype(jnp.float32))
    with torch.no_grad():
        ta = tuple(a.to(bf) for a in tm.compute_attributes_dense(tg))
        q = {nm: w.to(bf) for nm, w in tm.named_parameters()}
        tb = torch.func.functional_call(tm, q, (tg._replace(nodes=tg.nodes.to(bf)),),
                                        {"attrs": ta}).float().numpy()
    rms = lambda x: float(np.sqrt((x ** 2).mean()))
    jax_err, port_err, apart = (rms(x) / rms(ref) for x in (jb - ref, tb - ref, tb - jb))
    assert jax_err > 0 and port_err <= 2 * jax_err, (port_err, jax_err)
    assert apart <= 1e-2, apart


def test_segnn_lmax_attr5_bf16_loss_curve_matches_jax():
    """Three bf16 train steps of the ``lmax_attr=5`` model against JAX's."""
    vjp_tests.test_segnn_vjp_bf16_loss_curve_matches_jax("lmax_attr5")


def test_remat_kernel_nonfoldable_on_symmetrized_graph_raises_in_both():
    """A non-foldable model under ``remat_kernel`` on a symmetrized graph takes
    the sym-regather entry (the layer's ``replay_bwd`` is True) and fails
    there, since the kernel has no replay backward: JAX's assert, the port's
    ValueError."""
    jg, _, tg, _ = _graph(N)
    kw = dict(remat=True, remat_kernel=True, residual_bwd=False)
    jm = JSEGNN(*map(JIrreps, SPARSE_IRREPS), lmax_attr=5, num_layers=1, layout="cm",
                use_pallas=True, **kw)
    params = jm.init(jax.random.key(95))
    with pytest.raises(AssertionError, match="replay backward"):
        with pltpu.force_tpu_interpret_mode():
            jm(params, jg)
    tm = TSEGNN(*SPARSE_IRREPS, lmax_attr=5, num_layers=1, layout="cm", use_pallas=True,
                device="cpu", **kw)
    assert tm.layers[0]._sym_regather_eligible(N, True)
    with pytest.raises(ValueError, match="replay backward"):
        with torch.no_grad():
            tm(tg)
