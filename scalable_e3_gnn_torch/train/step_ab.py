"""Before/after A/B of the config-3 train step, for two checkouts of the port
on one card.

    python scalable_e3_gnn_torch/train/step_ab.py [--repo DIR] [--tag NAME]
        [--legs product,plain] [--cloud10m-peak]

Imports ``scalable_e3_gnn_torch`` from DIR (default: the checkout holding
this file) and builds config 3 as ``chip_smoke.py`` does: 100k uniform
points from seed 0, r = 0.04, K = 24, octree 6 levels, symmetrized, gather
tables at tile 160; SEGNN 2x0e+1x1o -> 32x0e+16x1o -> 1x1o, 4 layers, the
message kernels, weights from seed 0; bf16 compute on fp32 masters
(``functional_call`` on bf16 copies), MSE on a seeded target, Adam(1e-3).
Prints one JSON line: for each leg, CUDA-event ms of the bf16 forward and
of the train step, in rounds after a warm-up, and the card's name and power
limit.

Legs: ``product`` runs the checkout as it is; ``plain`` first replaces the
update layers' fp32 product (``ops.tensor_product._matmul_f32``, also bound
in ``ops.linear``) by ``torch.matmul(f.float(), w.float())``, whose autograd
keeps fp32 copies of bf16 operands.  ``--cloud10m-peak`` also runs ``train
--config cloud10m`` for one step with each leg's product and reports
``torch.cuda.max_memory_allocated``.  Compare two checkouts only within one
call, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N_POINTS = 100_000
RADIUS = 0.04
K = 24
TILE = 160
LEVELS = 6
HIDDEN = "32x0e+16x1o"
LAYERS = 4
SEED = 0
LO, HI = (0.0,) * 3, (1.0,) * 3
ROUNDS, ITERS = 3, 10


def _events(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _plain_product(f, w):
    return torch.matmul(f.float(), w.float())


def _use_product(leg: str, saved: dict) -> None:
    """Bind the update layers' fp32 product of ``leg`` (``saved`` holds the
    checkout's own)."""
    from scalable_e3_gnn_torch.ops import linear, tensor_product

    for mod in (tensor_product, linear):
        if hasattr(mod, "_matmul_f32"):
            saved.setdefault(mod, mod._matmul_f32)
            mod._matmul_f32 = _plain_product if leg == "plain" else saved[mod]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--legs", default="product")
    ap.add_argument("--cloud10m-peak", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import scalable_e3_gnn_torch as port
    from scalable_e3_gnn_torch.train.pipeline import make_train_step, mse_loss

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    pts = np.random.default_rng(SEED).random((N_POINTS, 3)).astype(np.float32)
    tree = port.build_octree(pts, LO, HI, num_levels=LEVELS, device=dev)
    cap = port.suggest_cell_capacity(tree, RADIUS, LO, HI)
    edges = port.radius_graph_cell(tree, RADIUS, LO, HI, max_neighbors=K, cell_capacity=cap)
    feats = np.random.default_rng(SEED + 1).standard_normal((N_POINTS, 5)).astype(np.float32)
    graph = port.DenseEdgeGraph.from_radius_edges(feats, tree.points, edges, symmetrize=True)
    graph = graph.with_gather_tables(tile=TILE)
    model = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=LAYERS, layout="cm",
                       use_pallas=True, device=dev, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        attrs = tuple(a.to(bf) for a in model.compute_attributes_dense(graph))
    graph = graph._replace(nodes=graph.nodes.to(bf))
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (N_POINTS, 3)).astype(np.float32)).to(dev)
    model_bf = copy.deepcopy(model).to(bf)

    def loss_fn(m, g, a, t):
        p = {nm: w.to(bf) for nm, w in m.named_parameters()}
        return mse_loss(torch.func.functional_call(m, p, (g,), {"attrs": a}).float(), t)

    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, loss_fn, opt)
    saved, out = {}, dict(tag=args.tag, card=card, torch=torch.__version__)
    for leg in args.legs.split(","):
        _use_product(leg, saved)
        with torch.no_grad():
            fwd = [_events(lambda: model_bf(graph, attrs=attrs), ITERS) for _ in range(ROUNDS)]
        steps = [_events(lambda: step(graph, attrs, target), ITERS, warmup=2)
                 for _ in range(ROUNDS)]
        out[leg] = dict(forward_ms=fwd, step_ms=steps)
    if args.cloud10m_peak:
        from scalable_e3_gnn_torch.train import runners
        from scalable_e3_gnn_torch.utils.config import cloud10m_config

        del model, model_bf, opt, step, graph, attrs, target
        for leg in args.legs.split(","):
            _use_product(leg, saved)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res = runners.run_pointcloud(cloud10m_config(), points=10_000_000, steps=1, device=dev)
            out[leg]["cloud10m_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out[leg]["cloud10m_loss"] = res["final_loss"]
    _use_product("product", saved)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
