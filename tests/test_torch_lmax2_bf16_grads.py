"""PyTorch port, the lmax=2 bf16 gap after the first Adam step, held by a
comparison that does not depend on the order of fp32 sums.

``run_pointcloud`` at config ``cloud1m`` (lmax=2, bf16 compute on fp32
masters) at 2,000 points, from JAX's initial weights, stopped at its first
step: its model, loss, bf16 graph, bf16 attributes and target.  On those
inputs, the first step's parameter gradients of
- the port (its runner's own loss),
- the JAX package (its runner's loss: the bf16 cast of the parameters, the
  model, ``mse_loss``), and
- an fp64 evaluation of the same step: the same bf16-rounded parameters and
  inputs in float64, no rounding after them (the port's model in float64),
so both packages are measured against one reference that neither one's sum
order shapes.  Held:
- the port's distance to fp64 is within the JAX package's own, by a factor
  of 1.1 in rms and 1.25 at the maximum (measured 1.04 and 1.14 on the
  runner's own inputs; the two distances are bf16 roundings at the same
  places, summed in different orders);
- the two packages lie closer to each other than either lies to fp64;
- every entry whose gradient sign differs between the packages lies within
  that noise (its fp64 gradient no larger than either package's distance
  to fp64 there): Adam's first update, ``lr * g / (|g| + eps)``, about
  ``lr * sign(g)``, turns exactly these entries into a gap of 2 lr;
- after one Adam step from each package's gradients, the port's bf16 loss
  moves by more than 3.3e-5 between the two parameter sets (1.56e-3
  measured), and by less than that (2.3e-6) once the entries whose two
  updates differ by more than 1e-3 lr (2,752 of 64,866; under 5% held) take
  the JAX package's update; every one of those entries is near zero, its
  fp64 gradient within that noise or under 1000 eps, where Adam's eps moves
  ``lr * g / (|g| + eps)`` by more than 1e-3 of ``lr * sign(g)``: the
  near-zero entries alone make the curve's gap.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.train.pipeline import mse_loss as j_mse
from scalable_e3_gnn_torch.train import runners as trunners
from scalable_e3_gnn_torch.utils.params import params_from_jax
from tests.test_torch_entry import (TOL_BF16, _configs, _jax_init, _jax_model,
                                    _load_jax_weights)

POINTS = 2000
RMS_FACTOR, MAX_FACTOR = 1.1, 1.25  # the port's distance to fp64 over JAX's (module docstring)
ADAM_EPS = 1e-8  # torch.optim.Adam's and optax.adam's default


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FirstStep(Exception):
    pass


@pytest.fixture(scope="module")
def first_step():
    """The port runner's first step (model, loss, graph, attributes,
    target) and the gradients of the port, of JAX and in fp64."""
    jcfg, tcfg = _configs("cloud1m", True)
    params = _jax_init(jcfg)
    mp = pytest.MonkeyPatch()
    seen = {}

    def make_step(model, loss_fn, opt):
        def step(g, a, t):
            seen.update(model=model, loss_fn=loss_fn, g=g, a=a, t=t, lr=opt.defaults["lr"])
            raise _FirstStep
        return step

    try:
        _load_jax_weights(mp, params)
        mp.setattr(trunners, "make_train_step", make_step)
        with pytest.raises(_FirstStep):
            trunners.run_pointcloud(tcfg, points=POINTS, steps=1, device="cpu")
    finally:
        mp.undo()
    model, loss_fn, g, a, t = (seen[k] for k in ("model", "loss_fn", "g", "a", "t"))
    names = [nm for nm, _ in model.named_parameters()]

    model.zero_grad()
    loss_fn(model, g, a, t).backward()
    port = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}

    # JAX: its runner's loss on the same inputs
    jm = _jax_model(jcfg)
    jnp_of = lambda x: jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32) \
        if x.is_floating_point() else jnp.asarray(x.numpy())
    jg = JGraph(nodes=jnp_of(g.nodes), positions=jnp_of(g.positions),
                senders=jnp_of(g.senders), edge_mask=jnp_of(g.edge_mask),
                node_mask=jnp_of(g.node_mask), node_graph=jnp_of(g.node_graph),
                n_graphs=g.n_graphs, reverse_slot=jnp_of(g.reverse_slot))
    ja = tuple(jnp_of(x) for x in a)

    def jloss(p):
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
        return j_mse(jm(p, jg, attrs=ja).astype(jnp.float32), jnp.asarray(t.numpy()))

    jgrad = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, params))
    holder = params_from_jax(copy.deepcopy(model), jax.tree.map(np.asarray, jgrad))
    jaxg = {nm: p.detach().clone() for nm, p in holder.named_parameters()}

    # fp64: the bf16-rounded parameters and inputs, nothing rounded after them
    m64 = copy.deepcopy(model).double()
    p64 = {nm: w.detach().to(torch.bfloat16).double().requires_grad_(True)
           for nm, w in model.named_parameters()}
    g64 = g._replace(nodes=g.nodes.double(), positions=g.positions.double())
    out = torch.func.functional_call(m64, p64, (g64,), {"attrs": tuple(x.double() for x in a)})
    ref = dict(zip(names, torch.autograd.grad(((out - t.double()) ** 2).mean(),
                                              list(p64.values()))))
    flat = lambda d: torch.cat([d[nm].reshape(-1).double() for nm in names])
    return dict(seen=seen, names=names, port=flat(port), jax=flat(jaxg), ref=flat(ref),
                port_by_name=port, jax_by_name=jaxg, ref_by_name=ref)


def _rms(x):
    return float((x ** 2).mean().sqrt())


def test_port_gradients_lie_as_close_to_fp64_as_jax(first_step):
    port, jax_, ref = first_step["port"], first_step["jax"], first_step["ref"]
    d_port, d_jax = port - ref, jax_ - ref
    assert _rms(d_port) <= RMS_FACTOR * _rms(d_jax), (_rms(d_port), _rms(d_jax))
    assert float(d_port.abs().max()) <= MAX_FACTOR * float(d_jax.abs().max())
    # each package's own bf16 rounding dominates: they agree with each other
    # more closely than either with fp64
    assert _rms(port - jax_) < 0.25 * min(_rms(d_port), _rms(d_jax))


def test_sign_flips_lie_within_the_noise(first_step):
    port, jax_, ref = first_step["port"], first_step["jax"], first_step["ref"]
    flip = torch.sign(port) != torch.sign(jax_)
    noise = torch.maximum((port - ref).abs(), (jax_ - ref).abs())
    assert int(flip.sum()) > 0  # the gap exists: some entries do flip
    assert int(flip.sum()) < 1e-2 * port.numel()
    assert bool((ref.abs()[flip] <= noise[flip]).all())


def _adam_once(model, grads, lr):
    """The parameters after torch's Adam's first step on ``grads``."""
    m = copy.deepcopy(model)
    opt = torch.optim.Adam(m.parameters(), lr=lr)
    for (nm, p) in m.named_parameters():
        p.grad = grads[nm].clone()
    opt.step()
    return m


def test_the_near_zero_entries_alone_make_the_gap_after_the_first_step(first_step):
    seen = first_step["seen"]
    model, loss_fn, lr = seen["model"], seen["loss_fn"], seen["lr"]
    g, a, t = seen["g"], seen["a"], seen["t"]
    gp, gj, g64 = (first_step[k] for k in ("port_by_name", "jax_by_name", "ref_by_name"))
    after_port, after_jax = _adam_once(model, gp, lr), _adam_once(model, gj, lr)
    # the port's step, but where the two first updates differ by more than
    # 1e-3 lr the entry takes JAX's; each such entry must be near zero: its
    # fp64 gradient within the packages' noise, or under 1000 eps, where
    # Adam's eps moves lr * g / (|g| + eps) by over 1e-3 of lr * sign(g)
    fixed = copy.deepcopy(after_port)
    differ, far = 0, []
    with torch.no_grad():
        for (nm, p), pj in zip(fixed.named_parameters(), after_jax.parameters()):
            ref = g64[nm].float()
            noise = torch.maximum((gp[nm] - ref).abs(), (gj[nm] - ref).abs())
            apart = (p - pj).abs() > 1e-3 * lr
            differ += int(apart.sum())
            if not bool((ref.abs()[apart] <= noise[apart] + 1000 * ADAM_EPS).all()):
                far.append(nm)
            p[apart] = pj[apart]
        loss = {k: float(loss_fn(m, g, a, t)) for k, m in
                (("port", after_port), ("jax", after_jax), ("fixed", fixed))}
    assert not far, far
    assert 0 < differ < 5e-2 * first_step["port"].numel()
    gap = abs(loss["port"] - loss["jax"]) / loss["jax"]
    left = abs(loss["fixed"] - loss["jax"]) / loss["jax"]
    assert gap > TOL_BF16, loss
    assert left < TOL_BF16, loss
