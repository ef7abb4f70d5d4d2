"""PyTorch port, ``run_pointcloud``'s branch above 1M/2M points (config
``cloud10m``) against JAX, at 8,000 points with the runner's size
thresholds lowered (the helpers and the other configs:
``test_torch_entry.py``).

The segmented "approx" build (4 segments), no symmetrize, 4 node blocks,
``remat_kernel``, ``remat_layers=2``, chunked bf16 attributes, no held-out
cloud.  JAX's segmented "approx" edges of the same cloud equal the port's as
sets except in at most 0.1% of the receivers, where the differing senders
sit at the row's K-th distance or at the radius within the fp32 rounding of
d^2 (``test_torch_radius_approx.py``: near-equal keys trade places, and d^2
rounds at r); the first 3 losses against a JAX ``SEGNN`` with the same ladder on the
port's graph within 3.3e-5 relative (bf16, the limit of
``test_torch_entry.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scalable_e3_gnn_tpu.graph.container import DenseEdgeGraph as JGraph
from scalable_e3_gnn_tpu.graph.octree import build_octree as j_octree
from scalable_e3_gnn_tpu.graph.radius import radius_graph_cell_segments as j_segments
from scalable_e3_gnn_tpu.graph.radius import search_level_for_radius as j_level
from scalable_e3_gnn_tpu.graph.radius import suggest_cell_capacity as j_cap
from scalable_e3_gnn_tpu.train import pipeline as jpipe
from scalable_e3_gnn_torch.train import runners as trunners
from tests.test_torch_radius_approx import D2_ATOL
from tests.test_torch_entry import (TOL_BF16, _configs, _jax_init, _jax_model, _load_jax_weights,
                                    _losses)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LARGE = dict(_SEGMENT_POINTS=2_000, _LARGE_POINTS=4_000, _BLOCK_POINTS=2_000,
             _REMAT_KERNEL_POINTS=2_000, _EVAL_POINTS=2_000)


def test_run_pointcloud_large_branch(tmp_path, monkeypatch):
    """``cloud10m``'s branch at 8,000 points with the thresholds lowered."""
    n, steps = 8_000, 3
    for k, v in LARGE.items():
        monkeypatch.setattr(trunners, k, v)
    jcfg, tcfg = _configs("cloud10m", True)
    params = _jax_init(jcfg)
    seen, graphs = [], []
    _load_jax_weights(monkeypatch, params, seen)
    build = trunners._cloud_graph
    monkeypatch.setattr(trunners, "_cloud_graph",
                        lambda *a, **kw: graphs.append(build(*a, **kw)) or graphs[-1])
    tlog = str(tmp_path / "torch.jsonl")
    got = trunners.run_pointcloud(tcfg, points=n, steps=steps, log=tlog, device="cpu")
    assert list(got) == ["final_loss", "steps", "edges"]  # no held-out cloud
    assert seen == [dict(use_pallas=False, edge_chunks=4, remat_kernel=True, remat_layers=2)]
    assert len(graphs) == 1
    graph, target, cap = graphs[0]
    assert graph.reverse_slot is None and got["edges"] == int(graph.edge_mask.sum())

    # JAX's segmented "approx" build of the same cloud: the same edges as sets
    radius = 0.04 * (100_000 / n) ** (1 / 3)
    lo, hi = (0.0,) * 3, (1.0,) * 3
    rng = np.random.default_rng(0)
    pts = rng.random((n, 3)).astype(np.float32)
    rng.random((n, 1))
    levels = max(4, j_level(radius, lo, hi) + 1)
    jt = jax.jit(lambda p: j_octree(p, lo, hi, num_levels=levels))(jnp.asarray(pts))
    assert j_cap(jt, radius, lo, hi) == cap
    je = j_segments(jt, radius, lo, hi, max_neighbors=16, cell_capacity=cap, num_segments=4,
                    selection="approx")
    k = graph.senders.shape[1]
    js, jm = np.asarray(je.senders).reshape(n, k), np.asarray(je.mask).reshape(n, k)
    ts, tm = graph.senders.numpy(), graph.edge_mask.numpy()
    differ = [i for i in range(n) if set(js[i][jm[i]]) != set(ts[i][tm[i]])]
    assert len(differ) <= 1e-3 * n, differ
    pos64 = graph.positions.numpy().astype(np.float64)
    for i in differ:  # only senders at the row's K-th distance or at the radius
        d2 = lambda s_: ((pos64[s_] - pos64[i]) ** 2).sum(-1)
        kth = d2(js[i][jm[i]]).max()
        for s_ in set(js[i][jm[i]]) ^ set(ts[i][tm[i]]):
            assert min(abs(d2(s_) - kth), abs(d2(s_) - radius ** 2)) <= D2_ATOL, (i, s_)

    # a JAX SEGNN with the same ladder on the port's graph, bf16 as the runner
    jm_ = _jax_model(jcfg, edge_chunks=4, remat_kernel=True, remat_layers=2)
    pos = jnp.asarray(graph.positions.numpy())
    snd, msk = jnp.asarray(ts), jnp.asarray(tm)
    jg = JGraph(nodes=jnp.asarray(graph.nodes.numpy()).astype(jnp.bfloat16), positions=pos,
                senders=snd, edge_mask=msk, node_mask=jnp.ones((n,), bool),
                node_graph=jnp.zeros((n,), jnp.int32), n_graphs=1)
    attrs = jax.jit(lambda p, s, m: jm_.compute_attributes_dense_chunked(
        p, s, m, dtype=jnp.bfloat16))(pos, snd, msk)
    tgt = jnp.asarray(target.numpy())

    def loss_fn(p, g, a, t):
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
        return jpipe.mse_loss(jm_(p, g, attrs=a).astype(jnp.float32), t)

    opt = optax.adam(tcfg.train.learning_rate)
    step = jpipe.make_train_step(loss_fn, opt, donate=False)
    state = jpipe.make_train_state(jax.tree.map(jnp.asarray, params), opt)
    want = []
    for _ in range(steps):
        state, m = step(state, jg, attrs, tgt)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(_losses(tlog), want, rtol=TOL_BF16, atol=0)
