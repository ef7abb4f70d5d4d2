"""PyTorch port, the accuracy gates of configs 1 and 2 on the CPU, from the
JAX package's initial weights, as ``tests/test_accuracy_gate.py`` sets them
(no threshold changed):

- N-body: 400 steps of Adam 5e-3 on 64 graphs; train loss < 0.009, held-out
  MSE (16 graphs, the next seed) < 0.011 and < 0.2x predict-zero;
- QM9 stand-in: 250 steps of Adam 3e-3 on 48 molecules (16x0e+8x1o, 2
  layers, graph task); loss < 0.16.

The initial weights are also kept in ``tests/fixtures/gate_init.npz``, so
that ``chip_smoke.py`` runs the same gates on the GPU without JAX;
``test_gate_init_file_is_jax_init`` holds the file to JAX's ``init`` bit
for bit.  ``python tests/test_torch_coo_gates.py`` writes it anew;
``... sweep`` prints the N-body gate's numbers over several initial weights
(the port's own seeds 0-3, JAX's keys 0-2).
"""

import os

import numpy as np
import pytest
import torch

import jax

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_torch.data.nbody import generate_dataset, make_fully_connected_edges
from scalable_e3_gnn_torch.data.qm9 import batch_molecules, generate_molecules
from scalable_e3_gnn_torch.graph.batching import batch_same_size
from scalable_e3_gnn_torch.models.segnn import SEGNN
from scalable_e3_gnn_torch.train.pipeline import make_train_step, mse_loss
from scalable_e3_gnn_torch.utils.params import params_from_jax

GATE_INIT = os.path.join(os.path.dirname(__file__), "fixtures", "gate_init.npz")
# (input, hidden, output irreps, SEGNN keywords, init key) of each gate's model
GATE_MODELS = {
    "nbody": ("2x0e+1x1o", "16x0e+8x1o", "1x1o", dict(num_layers=3, vel_attr=True), 0),
    "qm9": ("5x0e", "16x0e+8x1o", "1x0e", dict(num_layers=2, task="graph"), 1),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers on the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(which):
    ins, hid, out, kw, key = GATE_MODELS[which]
    jm = JSEGNN(JIrreps(ins), JIrreps(hid), JIrreps(out), **kw)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(key)))


def _flat(which, tree):
    return {f"{which}/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _model(which):
    ins, hid, out, kw, _ = GATE_MODELS[which]
    return params_from_jax(SEGNN(ins, hid, out, device="cpu", **kw), _jax_init(which))


@pytest.mark.parametrize("which", sorted(GATE_MODELS))
def test_gate_init_file_is_jax_init(which):
    want = _flat(which, _jax_init(which))
    with np.load(GATE_INIT) as data:
        assert {k for k in data.files if k.startswith(which + "/")} == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(data[k], v, err_msg=k)


def _nbody_batch(graphs, seed):
    ds = generate_dataset(graphs, num_steps=500, seed=seed)
    feats = np.concatenate([(ds["vel0"] ** 2).sum(-1, keepdims=True), ds["charges"][..., None],
                            ds["vel0"]], -1)
    s, r = make_fully_connected_edges(5)
    g = batch_same_size(feats, ds["pos0"], s, r, device="cpu").with_plans()
    t = lambda a: torch.from_numpy(a.reshape(-1, 3))
    return g, t(ds["vel0"]), t(ds["disp"])


def _nbody_gate(model):
    """(train loss, held-out MSE, predict-zero MSE) after the N-body gate's
    400 steps."""
    graph, vel, target = _nbody_batch(64, 0)
    step = make_train_step(model, lambda m, g, v, t: mse_loss(m(g, v), t),
                           torch.optim.Adam(model.parameters(), lr=5e-3))
    for _ in range(400):
        m = step(graph, vel, target)
    graph_e, vel_e, target_e = _nbody_batch(16, 1)
    with torch.no_grad():
        eval_mse = torch.mean((model(graph_e, vel_e) - target_e) ** 2).item()
    return m["loss"].item(), eval_mse, torch.mean(target_e ** 2).item()


def test_nbody_accuracy_gate():
    final, eval_mse, base = _nbody_gate(_model("nbody"))
    assert final < 0.009, f"N-body train loss: {final} (gate 0.009)"
    assert eval_mse < 0.011, f"N-body held-out MSE: {eval_mse} (gate 0.011)"
    assert eval_mse < 0.2 * base, (eval_mse, base)


def test_qm9_accuracy_gate():
    model = _model("qm9")
    g, targets = batch_molecules(generate_molecules(48, seed=2), device="cpu")
    g = g.with_plans()
    step = make_train_step(model, lambda m, g_, t: torch.mean((m(g_)[:, 0] - t) ** 2),
                           torch.optim.Adam(model.parameters(), lr=3e-3))
    for _ in range(250):
        m = step(g, targets)
    final = m["loss"].item()
    assert final < 0.16, f"QM9 loss: {final} (gate 0.16, var {targets.var(unbiased=False)})"


def _sweep():
    """The N-body gate's numbers over initial weights: the port's own from
    torch seeds 0-3, and JAX's keys 0-2 loaded into the port."""
    ins, hid, out, kw, _ = GATE_MODELS["nbody"]
    for seed in range(4):
        m = SEGNN(ins, hid, out, device="cpu", generator=torch.Generator().manual_seed(seed), **kw)
        print(f"own seed {seed}: train, held-out, predict-zero = {_nbody_gate(m)}", flush=True)
    for key in range(3):
        jm = JSEGNN(JIrreps(ins), JIrreps(hid), JIrreps(out), **kw)
        m = params_from_jax(SEGNN(ins, hid, out, device="cpu", **kw),
                            jax.tree.map(np.asarray, jm.init(jax.random.key(key))))
        print(f"JAX key {key}: train, held-out, predict-zero = {_nbody_gate(m)}", flush=True)


if __name__ == "__main__":
    # python tests/test_torch_coo_gates.py        writes the gate weights file
    # python tests/test_torch_coo_gates.py sweep  the N-body gate over inits
    import sys

    if sys.argv[1:] == ["sweep"]:
        _sweep()
    else:
        arrays = {}
        for name in GATE_MODELS:
            arrays.update(_flat(name, _jax_init(name)))
        np.savez(GATE_INIT, **arrays)
        print(f"wrote {len(arrays)} arrays to {GATE_INIT}")
