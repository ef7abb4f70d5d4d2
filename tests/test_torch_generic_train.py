"""PyTorch port, lmax=2 training at the model level: a small lmax=2 SEGNN (2
layers, hidden 4x0e+2x1o+2x2e, 128 points, tables at the generic tile) in
the bench's two training configurations, residual (kernel #9's function)
and ``remat=True, remat_kernel=True`` (kernel #10's), against the JAX package
on the same weights (its Pallas kernels in interpret mode), and the port's
``remat`` against no remat.

Tolerances, each with its reason: gradients 1e-4 * max|ref| per parameter
(fp32 through 2 layers, sums in another order); the 3-step loss curve and
gradient norms rtol 1e-4 and the final parameters atol 1e-6 (3 Adam steps of
at most lr each), as the lmax=1 loop in ``test_torch_train.py``; remat
against no remat bitwise (the recompute repeats the same operations).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.models.segnn import SEGNN as TSEGNN
from scalable_e3_gnn_torch.train import pipeline as tpipe
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_generic import IRREPS, _graph

N = 128
MODES = {"residual": {}, "remat_kernel": dict(remat=True, remat_kernel=True, residual_bwd=False)}


def _pair(mode, use_pallas, seed):
    jm = JSEGNN(*map(JIrreps, IRREPS), lmax_attr=2, num_layers=2, layout="cm",
                use_pallas=use_pallas, **MODES[mode])
    params = jm.init(jax.random.key(seed))
    tm = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", use_pallas=use_pallas,
                device="cpu", **MODES[mode])
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _target(seed):
    return np.random.default_rng(seed).standard_normal((N, 3)).astype(np.float32)


def _count_backwards(monkeypatch):
    """Record, per call of the generic backward, whether it got saved ys."""
    calls = []
    real = fmg.generic_tab_bwd
    monkeypatch.setattr(fmg, "generic_tab_bwd",
                        lambda *a, **kw: calls.append(a[-1] is not None) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mode", ["residual", "remat_kernel"])
def test_segnn_lmax2_gradients_match_jax(monkeypatch, mode, use_pallas):
    """MSE gradients of every parameter, carried back by params_to_jax,
    against jax.grad of the JAX model with the same settings."""
    jg, jgt, tg, tgt = _graph(N)
    jm, params, tm = _pair(mode, use_pallas, seed=21)
    y = _target(22)
    jgraph, tgraph = (jgt, tgt) if use_pallas else (jg, tg)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jax.grad(lambda p: jpipe.mse_loss(jm(p, jgraph), jnp.asarray(y))))(params)
    calls = _count_backwards(monkeypatch)
    tpipe.mse_loss(tm(tgraph), torch.from_numpy(y)).backward()
    # two layers through the kernel's backward: from the saved ys in residual
    # mode, by replay under remat_kernel; none on the plain path
    assert calls == ([mode == "residual"] * 2 if use_pallas else [])
    got = params_to_jax(tm, grad=True)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("mode", ["residual", "remat_kernel"])
def test_lmax2_train_loop_matches_jax(mode):
    """Three steps of make_train_step (MSE, Adam 1e-3) from the same weights
    through the kernel path, against the JAX loop (optax Adam 1e-3)."""
    _, jgt, _, tgt = _graph(N)
    jm, params, tm = _pair(mode, True, seed=23)
    y = _target(24)
    opt = optax.adam(1e-3)
    jstep = jpipe.make_train_step(lambda p, g, t: jpipe.mse_loss(jm(p, g), t), opt, donate=False)
    state = jpipe.make_train_state(params, opt)
    want = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            state, m = jstep(state, jgt, jnp.asarray(y))
            want.append((float(m["loss"]), float(m["grad_norm"])))
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = tpipe.make_train_step(tm, lambda m_, g, t: tpipe.mse_loss(m_(g), t), topt)
    got = []
    for _ in range(3):
        m = tstep(tgt, torch.from_numpy(y))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert want[2][0] < want[0][0]  # the loss moves
    for a, b in zip(jax.tree.leaves(params_to_jax(tm)), jax.tree.leaves(state.params),
                    strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def _grads(model, loss):
    model.zero_grad()
    loss(model).backward()
    return [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("compute", ["float32", "bf16_copies"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_remat_gives_the_same_gradients(use_pallas, compute):
    """remat=True (the plain messages and the generic update checkpointed)
    against remat=False, same weights: bitwise equal gradients, in fp32 and
    with chip_smoke.py's bf16-compute loss (torch.func.functional_call on
    bf16 copies of the fp32 masters, which the update's recompute must see)."""
    _, _, tg, tgt = _graph(N)
    graph = tgt if use_pallas else tg
    y = torch.from_numpy(_target(25))
    base = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", use_pallas=use_pallas,
                  device="cpu", generator=torch.Generator().manual_seed(26))
    remat = TSEGNN(*IRREPS, lmax_attr=2, num_layers=2, layout="cm", use_pallas=use_pallas,
                   remat=True, device="cpu")
    remat.load_state_dict(base.state_dict())
    if compute == "float32":
        loss = lambda m: tpipe.mse_loss(m(graph), y)
    else:
        bf = torch.bfloat16
        g_bf = graph._replace(nodes=graph.nodes.to(bf))
        attrs = tuple(a.to(bf) for a in base.compute_attributes_dense(graph))

        def loss(m):
            p = {nm: w.to(bf) for nm, w in m.named_parameters()}
            out = torch.func.functional_call(m, p, (g_bf,), {"attrs": attrs})
            return tpipe.mse_loss(out.float(), y)

    for a, b in zip(_grads(remat, loss), _grads(base, loss), strict=True):
        assert torch.equal(a, b)
