"""Train SEGNN on a large point cloud (evaluation configs 3-4).

    python -m scalable_e3_gnn_torch.examples.train_pointcloud --points 100000
    python -m scalable_e3_gnn_torch.examples.train_pointcloud --points 1000000 --lmax 2

Pipeline: octree build -> cell radius graph -> dense fixed-K graph -> bf16
train step.  On the GPU the messages run through the hand-written kernels
at both lmax values (the untabled lmax=1 kernels, or the generic ones at
lmax=2); ``--device cpu`` takes the plain message path.  The synthetic
target is the local mass-dipole direction, an equivariant quantity a
correct model can learn.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lmax", type=int, default=1)
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--neighbors", type=int, default=24)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=0,
                    help="cell capacity; 0 = auto (measured max occupancy)")
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the current GPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..graph.container import DenseEdgeGraph
    from ..graph.octree import build_octree
    from ..graph.radius import (radius_graph_cell, radius_graph_cell_segments,
                                suggest_cell_capacity)
    from ..models.segnn import SEGNN
    from ..train.metrics import MetricsLogger
    from ..train.pipeline import make_train_step, mse_loss
    from ..utils.device import resolve_device
    from ..utils.profiling import StepTimer

    dev = resolve_device(args.device)
    n = args.points
    radius = args.radius or (0.04 * (100_000 / n) ** (1 / 3))
    lo, hi = (0.0,) * 3, (1.0,) * 3
    rng = np.random.default_rng(0)
    pts = rng.random((n, 3)).astype(np.float32)
    masses = rng.random((n, 1)).astype(np.float32)

    levels = min(8, max(4, int(np.log2(1.0 / radius))))
    tree = build_octree(pts, lo, hi, num_levels=levels, device=dev)
    capacity = args.capacity or suggest_cell_capacity(tree, radius, lo, hi)
    seg = 1_000_000
    if n <= seg:
        edges = radius_graph_cell(tree, radius, lo, hi, max_neighbors=args.neighbors,
                                  cell_capacity=capacity)
    else:
        edges = radius_graph_cell_segments(tree, radius, lo, hi, max_neighbors=args.neighbors,
                                           cell_capacity=capacity,
                                           num_segments=max(2, n // seg))
    print(f"N={n} edges={int(edges.num_edges)} radius={radius:.4f} levels={levels}")

    ms = torch.from_numpy(masses).to(dev)[tree.order.long()]
    feats = torch.cat([ms, torch.ones_like(ms), torch.zeros((n, 3), device=dev)], dim=-1)
    graph = DenseEdgeGraph.from_radius_edges(feats, tree.points, edges)

    # equivariant synthetic target: local mass dipole sum_j m_j (x_j - x_i)
    rel = graph.rel_positions()
    mj = ms[:, 0][torch.clamp(graph.senders, max=n - 1).long()]
    target = (rel * torch.where(graph.edge_mask, mj, 0.0)[..., None]).sum(dim=1)

    hidden = "32x0e+16x1o" if args.lmax == 1 else "24x0e+12x1o+6x2e"
    chunks = args.chunks or max(1, n // 125_000)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", lmax_attr=args.lmax, num_layers=4, remat=True,
                  layout="cm", use_pallas=dev.type == "cuda", edge_chunks=chunks, device=dev,
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        attrs = model.compute_attributes_dense(graph)
    if args.bf16:
        graph = graph._replace(nodes=graph.nodes.to(torch.bfloat16))
        attrs = tuple(a.to(torch.bfloat16) for a in attrs)

    def loss_fn(m, g, a, t):
        if args.bf16:
            p = {nm: w.to(torch.bfloat16) for nm, w in m.named_parameters()}
            return mse_loss(torch.func.functional_call(m, p, (g,), {"attrs": a}).float(), t)
        return mse_loss(m(g, attrs=a).float(), t)

    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, loss_fn, opt)
    logger = MetricsLogger(args.log, stdout_every=1)
    timer = StepTimer()
    n_edges = int(edges.num_edges)
    m = {"loss": float("inf")}
    for i in range(args.steps):
        m = step(graph, attrs, target)
        timer.tick(m["loss"])
        logger.log(i, {"loss": m["loss"]}, edges=n_edges)
    logger.close()
    print(f"final loss {float(m['loss']):.6f}")


if __name__ == "__main__":
    main()
