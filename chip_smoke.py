#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- require CUDA; print the card's name and power limit
             (``nvidia-smi --query-gpu=name,power.limit``); TF32 off.
2. build   -- compile every CUDA source of the package with nvcc, all at once.
3. graph   -- the config-3 main path up to the model: 100k uniform points,
             octree (6 levels), radius graph (r=0.04, K=24), symmetrized,
             gather tables (tile 160), sh attributes; timed; checked against
             the brute-force radius graph on the same card.
4. kernel  -- every kernel's wrapper against its plain PyTorch version on the
             card, at the main path's shapes, in fp32 and bf16, with a partial
             tail tile and extra masked slots.
5. forward -- the config-3 SEGNN forward (4 layers, bf16 storage, weights from
             a seed) with launch counts zeroed before and read after; output
             finite and of shape [100000, 3]; held against the plain path in
             fp32 on the card.
6. times   -- CUDA-event times of the forward, each kernel and its plain
             version, and the graph build.

Then the ``kernels`` line, the card line and, last, the result line.  Any
failed check raises: the script exits non-zero and prints no result.  It
exits non-zero as well without a GPU or without the package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import scalable_e3_gnn_torch as port
from scalable_e3_gnn_torch.graph.radius import radius_graph_brute
from scalable_e3_gnn_torch.kernels import fused_message as fm
from scalable_e3_gnn_torch.kernels.build import build_libraries

# config 3 (bench.py of the JAX package)
N_POINTS = 100_000
RADIUS = 0.04
MAX_NEIGHBORS = 24
LO, HI = (0.0,) * 3, (1.0,) * 3
HIDDEN = "32x0e+16x1o"
NUM_LAYERS = 4
TILE = 160
OCTREE_LEVELS = 6
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances, each with its reason
TOL_KERNEL_FP32 = 1e-4  # x max(1, |ref|): the same fp32 math summed in another order
TOL_KERNEL_BF16 = 3e-2  # x max|ref|: bf16 rounding of layer-1 outputs and slot messages
TOL_FORWARD_FP32 = 1e-4  # x max(1, |ref|): kernel vs plain path, both fp32, 4 layers
TOL_FORWARD_BF16 = 5e-2  # x max|ref|: bf16 storage through 4 layers vs fp32 plain path
TOL_RADIUS_AGREE = 0.9999  # share of identical (receiver, sender) pairs; d^2 rounding at r


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_graph(pts):
    """The config-3 graph on the card; returns (graph with tables, timings, raw edges)."""
    dev = torch.device(DEVICE)
    times = {}
    tree, times["octree_ms"] = sync_time(
        lambda: port.build_octree(pts, LO, HI, num_levels=OCTREE_LEVELS, device=dev))
    cap = port.suggest_cell_capacity(tree, RADIUS, LO, HI)
    edges, times["radius_graph_ms"] = sync_time(
        lambda: port.radius_graph_cell(tree, RADIUS, LO, HI, max_neighbors=MAX_NEIGHBORS,
                                       cell_capacity=cap))
    feats = np.random.default_rng(SEED + 1).standard_normal((N_POINTS, 5)).astype(np.float32)
    graph, times["symmetrize_ms"] = sync_time(
        lambda: port.DenseEdgeGraph.from_radius_edges(feats, tree.points, edges,
                                                      symmetrize=True))
    graph_t, times["tables_ms"] = sync_time(lambda: graph.with_gather_tables(tile=TILE))
    return tree, cap, edges, graph_t, times


def edge_agreement(a, b, n):
    """|A & B| / |A | B| over the valid (receiver, sender) pairs of two edge lists."""
    ka = (a.receivers.long() * n + a.senders.long())[a.mask]
    kb = (b.receivers.long() * n + b.senders.long())[b.mask]
    both = torch.isin(ka, kb).sum().item()
    return both / max(ka.numel() + kb.numel() - both, 1)


def messages_per_slot(cfg) -> int:
    """Multiply-adds of the two message layers for one slot."""
    s1, v1, hs, hv = cfg.s1, cfg.v1, cfg.hs, cfg.hv
    c0 = hs + hv
    return ((s1 + v1) * c0 + s1 * hv + 3 * v1 * hv) + (c0 * c0 + hs * hv + 3 * hv * hv)


def kernel_inputs(graph, attrs, layer, dtype, gen):
    """The tabled kernel's arguments at the main path's shapes: the real
    tables, geometry and (folded) weights of a layer, random features, a partial tail tile
    (the last 37 receivers padded the way the model pads) and extra masked
    slots."""
    edge_attr, _, dist2 = attrs[:3]
    n, k = graph.edge_mask.shape
    npad = graph.gather_loc.shape[0]
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=graph.gather_tile,
                           u=graph.gather_tab.shape[1])
    dev = graph.device
    mask = graph.edge_mask & (torch.rand((n, k), generator=gen, device=dev) > 0.1)
    cut = 37
    mask[n - cut:] = False
    loc = graph.gather_loc.clone()
    loc[n - cut:] = cfg.u
    h = torch.randn((npad, cfg.f), generator=gen, device=dev)
    h[n - cut:] = 0.0
    pad = lambda x: torch.cat([x, x.new_zeros((npad - n,) + x.shape[1:])])
    args = (h, pad(dist2).reshape(npad * k, 1), pad(edge_attr).reshape(npad * k, 4),
            pad(mask.float()).reshape(npad * k, 1), loc.reshape(npad * k, 1),
            graph.gather_tab)
    args = [a.to(dtype).contiguous() if a.is_floating_point() else a.contiguous() for a in args]
    return cfg, args, layer._folded_weights(dtype), int(mask.sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # ---- 2. build every kernel source
    t0 = time.perf_counter()
    built = build_libraries([fm.TAB_FWD.name])
    ptxas = [ln.strip() for b in built.values() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_source={k: round(v["seconds"], 3) for k, v in built.items()}, ptxas=ptxas)

    # ---- 3. the config-3 graph
    pts = np.random.default_rng(SEED).random((N_POINTS, 3)).astype(np.float32)
    build_graph(pts)  # warm-up: allocator, sort and search kernels
    tree, cap, edges, graph, gtimes = build_graph(pts)
    n_edges = int(graph.edge_mask.sum())
    brute, brute_ms = sync_time(
        lambda: radius_graph_brute(tree.points, RADIUS, MAX_NEIGHBORS, device=dev))
    agree = edge_agreement(edges, brute, N_POINTS)
    emit("graph", points=N_POINTS, cell_capacity=cap, edges_cell=int(edges.num_edges),
         edges_brute=int(brute.num_edges), edges_symmetrized=n_edges,
         table_size=graph.gather_tab.shape[1], brute_ms=round(brute_ms, 3),
         radius_agreement=agree, tolerance=TOL_RADIUS_AGREE, card=card,
         **{k: round(v, 3) for k, v in gtimes.items()})
    check(agree >= TOL_RADIUS_AGREE, f"radius graph agreement {agree} < {TOL_RADIUS_AGREE}")
    del brute

    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                       use_pallas=True, device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    attrs32 = model.compute_attributes_dense(graph)

    # ---- 4. kernel vs plain at the main path's shapes
    kres = {}
    for dtype, tol in ((torch.float32, TOL_KERNEL_FP32), (torch.bfloat16, TOL_KERNEL_BF16)):
        cfg, args, ws, n_valid = kernel_inputs(graph, attrs32, model.layers[0], dtype, gen)
        got = fm.fused_message_aggregate_tabled(cfg, *args, *ws).float()
        torch.cuda.synchronize()
        ref = fm.fused_message_aggregate_tabled_plain(cfg, *args, *ws).float()
        err = (got - ref).abs()
        if dtype == torch.float32:
            bad = int((err > tol * torch.clamp(ref.abs(), min=1.0)).sum())
            limit = f"{tol} * max(1, |ref|) elementwise; fp32 sums in another order"
        else:
            bad = int((err > tol * ref.abs().max()).sum())
            limit = f"{tol} * max|ref|; bf16 rounding of layer-1 outputs and slot messages"
        max_err = float(err.max())
        kres[str(dtype)] = dict(cfg=cfg, args=args, ws=ws, n_valid=n_valid, max_abs_err=max_err)
        emit("kernel", kernel=fm.TAB_FWD.name, dtype=str(dtype).replace("torch.", ""),
             rows=args[0].shape[0], k=cfg.k, tile=cfg.tile, u=cfg.u, valid_slots=n_valid,
             max_abs_err=max_err, max_rel_err=max_err / max(float(ref.abs().max()), 1e-30),
             max_abs_ref=float(ref.abs().max()), elements_over_tolerance=bad, tolerance=limit,
             finite=bool(torch.isfinite(got).all()))
        check(bad == 0 and bool(torch.isfinite(got).all()),
              f"kernel vs plain in {dtype}: {bad} elements over tolerance")

    # ---- 5. the config-3 forward through the kernel (bf16), counted
    bf = torch.bfloat16
    model_bf = model.to(bf)
    attrs_bf = tuple(a.to(bf) for a in attrs32)
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    fwd = lambda: model_bf(graph_bf, attrs=attrs_bf)
    fm.TAB_FWD.launches = 0
    out = fwd()
    torch.cuda.synchronize()
    launches = {fm.TAB_FWD.name: fm.TAB_FWD.launches}
    check(launches[fm.TAB_FWD.name] == NUM_LAYERS,
          f"{launches} kernel launches in one forward, expected {NUM_LAYERS}")
    check(tuple(out.shape) == (N_POINTS, 3), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")

    # the same weights in fp32: through the kernel and through the plain path
    model32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                         use_pallas=True, device=dev)
    model32.load_state_dict({k: v.float() for k, v in model_bf.state_dict().items()})
    plain32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                         use_pallas=False, device=dev)
    plain32.load_state_dict(model32.state_dict())
    ref = plain32(graph, attrs=attrs32)
    k32 = model32(graph, attrs=attrs32)
    scale = float(ref.abs().max())
    err32 = float((k32 - ref).abs().max())
    errbf = float((out.float() - ref).abs().max())
    emit("forward", points=N_POINTS, layers=NUM_LAYERS, dtype="bfloat16",
         shape=list(out.shape), launches=launches, max_abs_ref=scale,
         fp32_kernel_vs_plain_max_abs_err=err32,
         fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
         bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
         bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
    check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
          f"fp32 forward: kernel vs plain max abs err {err32}")
    check(errbf <= TOL_FORWARD_BF16 * scale, f"bf16 forward vs fp32 plain: {errbf}")
    del ref, k32, model32

    # the same bf16 forward through the plain message path, for the times
    plain_bf = plain32.to(bf)
    fwd_plain = lambda: plain_bf(graph_bf, attrs=attrs_bf)
    del plain32

    # ---- 6. times (CUDA events after warm-up)
    fwd_ms = event_ms(fwd, iters=10)
    fwd_plain_ms = event_ms(fwd_plain, iters=3, warmup=1)
    kb = kres[str(bf)]
    cfg, args, ws = kb["cfg"], kb["args"], kb["ws"]
    kern_ms = event_ms(lambda: fm.fused_message_aggregate_tabled(cfg, *args, *ws), iters=20)
    plain_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_plain(cfg, *args, *ws),
                        iters=5, warmup=1)
    # bound: each input read once, the output written once; the products of
    # the valid slots at the bf16 tensor-core peak
    nbytes = sum(a.numel() * a.element_size() for a in (*args, *ws)) + \
        args[0].numel() * args[0].element_size()
    flops = 2 * messages_per_slot(cfg) * kb["n_valid"]
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit("times", card=card, forward_ms=fwd_ms, forward_plain_path_ms=fwd_plain_ms,
         kernel_ms_per_launch=kern_ms, kernel_ms_per_forward=kern_ms * NUM_LAYERS,
         plain_ms_per_call=plain_ms, bound_ms=bound_ms, bound_bytes_ms=bytes_ms,
         bound_ops_ms=ops_ms, kernel_gflop=flops / 1e9, kernel_mbytes=nbytes / 1e6,
         kernel_fp32_fma_bound_ms=flops / PEAK_FP32_FMA_FLOPS * 1e3,
         graph_build_ms=sum(gtimes.values()), **{k: gtimes[k] for k in gtimes})

    print(json.dumps({"kernels": [{
        "name": fm.TAB_FWD.name,
        "route": "cuda",
        "source": str(fm.TAB_FWD.source.relative_to(Path(__file__).resolve().parent)),
        "replaces": "scalable_e3_gnn_tpu/kernels/fused_message.py:401",
        "launches": launches[fm.TAB_FWD.name],
        "max_abs_err": kb["max_abs_err"],
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
