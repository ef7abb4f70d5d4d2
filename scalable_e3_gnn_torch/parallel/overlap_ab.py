"""A/B of the halo exchange overlapped with the interior block against the
serialized exchange, in the multi-process dense dp world on one card.

    python -m scalable_e3_gnn_torch.parallel.overlap_ab [--pairs 3]
        [--points 100000] [--device cpu]

Builds two config-3 clouds as ``chip_smoke.py``'s ``dp_dense`` phase does
(uniform points from seeds 0 and 1, features from seed 1, r = 0.04 at 100k
points and scaled by (100000 / points)^(1/3) below, K = 24, octree 6
levels, symmetrized;
SEGNN 2x0e+1x1o -> 32x0e+16x1o x4 -> 1x1o with the message kernels,
``remat``, weights from seed 0; bf16 compute on fp32 masters, Adam 1e-3,
seeded targets), then runs ``dense_worker.run_world`` with 4 ranks (2 dp
rows x 2 graph ranks, P=4, a warm-up and 5 timed steps) in ABBA order,
``--pairs`` times: overlapped, serialized, serialized, overlapped, ...  Each
world prints one JSON line (per rank: the mean CUDA-event ms of the timed
steps and the mean host ms in collectives a step); the last line sums up
each mode (the medians over the worlds of the mean over ranks, and every
world's value) with the card's name and power limit, and whether every
world ended on the same parameters (the modes give the same bits).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..graph.container import DenseEdgeGraph
from ..graph.octree import build_octree
from ..graph.radius import radius_graph_cell, suggest_cell_capacity
from ..kernels import fused_message as fm
from ..kernels.build import build_libraries
from ..models.segnn import SEGNN
from ..utils.device import resolve_device
from . import dense_worker

RADIUS, FULL_POINTS, K, LEVELS = 0.04, 100_000, 24, 6
LO, HI = (0.0,) * 3, (1.0,) * 3
CLOUDS, PARTS, WORLD, STEPS = 2, 4, 4, 6
MODEL = dict(input_irreps="2x0e+1x1o", hidden_irreps="32x0e+16x1o", output_irreps="1x1o",
             num_layers=4, layout="cm", use_pallas=True, remat=True)


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _cloud(seed: int, points: int, dev):
    """(positions, features, senders, edge_mask) of one cloud, host numpy."""
    radius = RADIUS * (FULL_POINTS / points) ** (1 / 3)
    pts = np.random.default_rng(seed).random((points, 3)).astype(np.float32)
    tree = build_octree(pts, LO, HI, num_levels=LEVELS, device=dev)
    cap = suggest_cell_capacity(tree, radius, LO, HI)
    edges = radius_graph_cell(tree, radius, LO, HI, max_neighbors=K, cell_capacity=cap)
    feats = np.random.default_rng(1).standard_normal((points, 5)).astype(np.float32)
    g = DenseEdgeGraph.from_radius_edges(feats, tree.points, edges, symmetrize=True)
    return [x.cpu().numpy() for x in (g.positions, g.nodes, g.senders, g.edge_mask)]


def _world(in_dir: Path, out_dir: Path, device) -> dict:
    report, res = dense_worker.run_world(in_dir, out_dir, WORLD, device=device,
                                         startup_timeout_s=240.0, wall_timeout_s=420.0,
                                         max_restarts=0)
    if not (report.ok and sorted(res) == list(range(WORLD))):
        logs = "\n".join(p.read_text()[-1500:] for p in sorted(out_dir.glob("log_*.txt")))
        raise RuntimeError(f"{out_dir.name}: {report}\n{logs}")
    mean = lambda xs: sum(xs) / len(xs)
    return dict(step_ms={r: mean(res[r]["step_ms"][1:]) for r in res},
                comm_ms={r: mean(res[r]["comm_ms"][1:]) for r in res},
                state_sha=sorted({res[r]["state_sha"] for r in res}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--points", type=int, default=FULL_POINTS)
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # once here, not in every worker's first step
        build_libraries(sorted({kern.source_name for kern in fm.KERNELS}))
    clouds = [_cloud(seed, args.points, dev) for seed in range(CLOUDS)]
    gen = np.random.default_rng(2)
    target = np.stack([gen.standard_normal((args.points, 3)).astype(np.float32)
                       for _ in range(CLOUDS)])
    model = SEGNN(**MODEL, device=dev, generator=torch.Generator().manual_seed(0))
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    order = [m for _ in range(args.pairs) for m in (False, True, True, False)]
    worlds = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for serialize in (False, True):
            dense_worker.write_inputs(
                tmp / f"in_{serialize}", *(np.stack([c[i] for c in clouds]) for i in range(4)),
                target, MODEL, weights, num_parts=PARTS, steps=STEPS, lr=1e-3,
                compute_dtype="bfloat16", num_clouds=CLOUDS, serialize_exchange=serialize)
        for i, serialize in enumerate(order):
            w = _world(tmp / f"in_{serialize}", tmp / f"run{i}", args.device)
            w.update(run=i, mode="serialized" if serialize else "overlapped")
            print(json.dumps(w), flush=True)
            worlds.append(w)
    summary = {}
    for mode in ("overlapped", "serialized"):
        ws = [w for w in worlds if w["mode"] == mode]
        step = [statistics.mean(w["step_ms"].values()) for w in ws]
        comm = [statistics.mean(w["comm_ms"].values()) for w in ws]
        summary[mode] = dict(step_ms=step, comm_ms=comm, step_ms_median=statistics.median(step),
                             comm_ms_median=statistics.median(comm))
    same = len({sha for w in worlds for sha in w["state_sha"]}) == 1
    print(json.dumps({"card": _card(dev), "points": args.points, "pairs": args.pairs,
                      "order": ["serialized" if s else "overlapped" for s in order],
                      "same_parameters_every_world": same, **summary}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
