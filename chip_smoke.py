#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device     -- require CUDA; print the card's name and power limit
                 (``nvidia-smi --query-gpu=name,power.limit``); TF32 off.
2. build      -- compile every CUDA source of the package with nvcc, all at once.
3. graph      -- the config-3 main path up to the model: 100k uniform points,
                 octree (6 levels), radius graph (r=0.04, K=24), symmetrized,
                 gather tables (tile 160), sh attributes; timed; checked
                 against the brute-force radius graph on the same card.
4. kernel     -- the forward kernel's wrapper against its plain PyTorch
                 version on the card, at the main path's shapes, in fp32 and
                 bf16, with a partial tail tile and extra masked slots.
5. kernel_bwd -- the backward kernels (main kernel and the weight-gradient
                 reduction) and the full backward with its epilogue against
                 their plain versions on the same inputs and a random
                 cotangent, in fp32 and bf16; two runs bit-identical.
6. forward    -- the config-3 SEGNN forward (4 layers, bf16 storage, weights
                 from a seed) with launch counts zeroed before and read after;
                 output finite and of shape [100000, 3]; held against the
                 plain path in fp32 on the card.
7. train      -- the config-3 train step (fp32 master weights, bf16 compute,
                 MSE against a seeded target, Adam 1e-3), 5 steps with launch
                 counts zeroed before and read after: every loss and gradient
                 norm finite, exactly 4 forward and 4 backward launches per step.
8. grad_check -- fp32 gradients of every parameter through the kernels
                 against PyTorch autograd through the plain message path, from
                 the same weights and graph, on a 20k-point cloud of the same
                 density (the plain path's autograd at 100k would need tens of GB).
9. times      -- CUDA-event times of the forward, the forward kernel and its
                 plain version, and the graph build.
10. train_times -- CUDA-event times of the train step, each backward kernel,
                 its plain version and the epilogue, with the bounds.
11. profile   -- two train steps traced with ``torch.profiler``: device time
                 per kernel and the device's busy share of the wall time.
12. graph_lmax2 -- the lmax=2 config-4 proxy of bench.py:223-259: 250k uniform
                 points, octree (7 levels), radius graph (r = 0.04 *
                 (100000/250000)^(1/3), K=16, cell capacity 64), symmetrized,
                 gather tables at the generic tile (200); timed.
13. kernel_lmax2 -- the generic kernel (#8) against its plain version on the
                 card at that path's shapes (real tables, geometry and folded
                 layer-0 weights, random features, a masked tail and extra
                 masked slots), in fp32 and in bf16 (elementwise in bf16 ulps:
                 both round at the same points).
14. forward_lmax2 -- the lmax=2 SEGNN forward (24x0e+12x1o+6x2e, 4 layers, bf16,
                 geo-only attributes as bench.py passes them) with launch
                 counts zeroed before and read after: exactly 4 launches of
                 #8; output finite, [250000, 3]; the fp32 kernel path and the
                 bf16 forward held against the fp32 plain path.
15. times_lmax2 -- CUDA-event times of that forward, of #8 (bf16 and fp32) and
                 its plain version, with #8's bound.

Then the ``kernels`` line, the card line and, last, the result line.  Any
failed check raises: the script exits non-zero and prints no result.  It
exits non-zero as well without a GPU or without the package beside it.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import scalable_e3_gnn_torch as port
from scalable_e3_gnn_torch.graph.radius import radius_graph_brute
from scalable_e3_gnn_torch.kernels import fused_message as fm
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.kernels.build import build_libraries
from scalable_e3_gnn_torch.models.segnn import SEGNNLayer
from scalable_e3_gnn_torch.train.pipeline import make_train_step, mse_loss

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
TRAIN_STEPS = 5
LEARNING_RATE = 1e-3  # optax.adam(1e-3) of bench.py
# the gradient check's cloud: 5x fewer points in the same cube, the radius
# grown by 5^(1/3) so the neighbourhoods stay as full as at 100k
GC_POINTS = 20_000
GC_RADIUS = RADIUS * 5 ** (1 / 3)
# the lmax=2 config-4 proxy (bench.py:223-259): not cut
L2_POINTS = 250_000
L2_RADIUS = RADIUS * (N_POINTS / L2_POINTS) ** (1 / 3)
L2_NEIGHBORS = 16
L2_CELL_CAPACITY = 64
L2_OCTREE_LEVELS = 7
L2_HIDDEN = "24x0e+12x1o+6x2e"

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances, each with its reason
TOL_KERNEL_FP32 = 1e-4  # x max(1, |ref|): the same fp32 math summed in another order
TOL_KERNEL_BF16 = 3e-2  # x max|ref|: bf16 rounding of layer-1 outputs and slot messages
# kernel #8 vs its plain version, both bf16 with the same rounding points:
# elementwise in bf16 ulps of max(|ref|, mean|ref|); they differ only where an
# fp32 sum in another order lands on the other side of a bf16 rounding step
TOL_GENERIC_BF16_ULPS = 4
TOL_GENERIC_BF16_OVER_1ULP = 1e-3  # share of elements more than 1 ulp apart
TOL_BWD_FP32 = 1e-4  # d_h: x max(1, |ref|); weight blocks: x max|ref| (sums over 2.4M slots)
TOL_BWD_BF16 = 5e-2  # x max|ref|: bf16 rounding of the cotangent intermediates
TOL_REDUCE = 1e-5  # x max|ref|: fp32 sums over the blocks in another order
TOL_FORWARD_FP32 = 1e-4  # x max(1, |ref|): kernel vs plain path, both fp32, 4 layers
TOL_FORWARD_BF16 = 5e-2  # x max|ref|: bf16 storage through 4 layers vs fp32 plain path
TOL_GRAD_FP32 = 1e-4  # x max|ref| per parameter: fp32 sums in another order, 4 layers
TOL_RADIUS_AGREE = 0.9999  # share of identical (receiver, sender) pairs; d^2 rounding at r

TPU_FILE = "scalable_e3_gnn_tpu/kernels/fused_message.py"
GENERIC_TPU_FILE = "scalable_e3_gnn_tpu/kernels/fused_message_generic.py"
ALL_KERNELS = fm.KERNELS + fmg.KERNELS


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


def build_graph(pts, radius=None, levels=None, k=None, cap=None, tile=None):
    """The config-3 graph of ``pts`` on the card (radius, octree levels, K,
    cell capacity and table tile as given, config 3's otherwise); returns
    (tree, cell capacity, raw edges, graph with tables, timings)."""
    radius = RADIUS if radius is None else radius
    dev = torch.device(DEVICE)
    times = {}
    tree, times["octree_ms"] = sync_time(
        lambda: port.build_octree(pts, LO, HI, num_levels=levels or OCTREE_LEVELS, device=dev))
    cap = cap or port.suggest_cell_capacity(tree, radius, LO, HI)
    edges, times["radius_graph_ms"] = sync_time(
        lambda: port.radius_graph_cell(tree, radius, LO, HI, max_neighbors=k or MAX_NEIGHBORS,
                                       cell_capacity=cap))
    feats = np.random.default_rng(SEED + 1).standard_normal((len(pts), 5)).astype(np.float32)
    graph, times["symmetrize_ms"] = sync_time(
        lambda: port.DenseEdgeGraph.from_radius_edges(feats, tree.points, edges,
                                                      symmetrize=True))
    graph_t, times["tables_ms"] = sync_time(lambda: graph.with_gather_tables(tile=tile or TILE))
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, peak_flops=PEAK_BF16_FLOPS):
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms)."""
    b_ms, o_ms = n_bytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms > o_ms else "operations"), b_ms, o_ms


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


def compare(got, ref, scale, tol):
    """(max abs err, elements over tol * scale, max |ref|) of two tensors."""
    err = (got.float() - ref.float()).abs()
    return float(err.max()), int((err > tol * scale).sum()), float(ref.float().abs().max())


def bf16_ulps(got, ref):
    """|got - ref| elementwise in bf16 ulps (8 significant bits) of
    max(|ref|, mean|ref|): the floor keeps elements near zero, which are sums
    of larger slot messages, from counting their own tiny ulps."""
    r = ref.float().abs()
    scale = torch.clamp(r, min=max(float(r.mean()), 1e-30))
    return (got.float() - ref.float()).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


def reset_launches() -> None:
    for kern in ALL_KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.name: kern.launches for kern in ALL_KERNELS}


def profile_steps(step, batch, steps: int = 2, top: int = 14) -> dict:
    """Device time per kernel over ``steps`` train steps (torch.profiler),
    per step, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels' time
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total / 1e3 / steps, ev.count / steps, ev.key[:90]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps, device_ms_per_step=busy,
                device_busy_share=busy * steps / wall_ms if wall_ms else 0.0,
                top=[dict(name=n, ms_per_step=ms, calls_per_step=c) for ms, c, n in rows[:top]])


def generic_kernel_inputs(kern, graph, edge_geo, dtype, gen):
    """Kernel #8's arguments at the lmax=2 path's shapes: the real tables,
    geometry and folded (column-permuted) layer-0 weights, random features, a
    masked tail (the last 37 receivers without senders or valid slots) and
    extra masked slots.  Returns (cfg, args, valid slots)."""
    n, k = graph.edge_mask.shape
    dev = graph.device
    a = edge_geo.shape[1] // k - 2
    cfg = kern.config(a, graph.gather_tab.shape[1])
    geo = edge_geo.reshape(n, k, a + 2).clone()
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).to(geo.dtype)
    cut = 37
    geo[n - cut:, :, a + 1] = 0.0
    loc = graph.gather_loc.clone()
    loc[n - cut:] = cfg.u
    h = torch.randn((n, cfg.f), generator=gen, device=dev)
    h[n - cut:] = 0.0
    n_valid = int((geo[..., a + 1] > 0).sum())
    args = (h.to(dtype), geo.reshape(n, -1).to(dtype).contiguous(), loc.contiguous(),
            graph.gather_tab.contiguous(), [w.contiguous() for w in kern.fold(dtype)],
            kern.selections(dev))
    return cfg, args, n_valid


def lmax2_phases(card: str) -> dict:
    """Phases 12-15 (the lmax=2 config-4 proxy); returns kernel #8's numbers
    for the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    # ---- 12. the graph
    pts = np.random.default_rng(SEED + 5).random((L2_POINTS, 3)).astype(np.float32)
    tile = SEGNNLayer._pick_generic_tile(L2_POINTS)
    kw = dict(radius=L2_RADIUS, levels=L2_OCTREE_LEVELS, k=L2_NEIGHBORS,
              cap=L2_CELL_CAPACITY, tile=tile)
    build_graph(pts, **kw)  # warm-up
    _, cap, edges, graph, gtimes = build_graph(pts, **kw)
    emit("graph_lmax2", points=L2_POINTS, radius=L2_RADIUS, k=L2_NEIGHBORS, cell_capacity=cap,
         octree_levels=L2_OCTREE_LEVELS, edges_cell=int(edges.num_edges),
         edges_symmetrized=int(graph.edge_mask.sum()), tile=tile,
         table_size=graph.gather_tab.shape[1], card=card, graph_build_ms=sum(gtimes.values()),
         **gtimes)
    check(graph.gather_loc.shape[0] == L2_POINTS and graph.gather_tile == tile,
          f"tables at tile {graph.gather_tile} for {graph.gather_loc.shape[0]} rows")
    check(int(graph.edge_mask.sum()) > 0, "no edges")
    del edges

    model = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                       layout="cm", use_pallas=True, device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    check(all(layer.use_pallas_generic and layer._tab_eligible(L2_POINTS, graph)
              for layer in model.layers), "the lmax=2 layers do not take the tabled kernel")
    with torch.no_grad():
        attrs32 = model.compute_attributes_dense(graph)

    # ---- 13. kernel #8 vs its plain version at this path's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile)
    kres = {}
    with torch.no_grad():
        for dtype, tol in ((torch.float32, TOL_KERNEL_FP32), (bf, TOL_KERNEL_BF16)):
            cfg, args, n_valid = generic_kernel_inputs(kern, graph, attrs32[3], dtype, gen)
            got = fmg.generic_tab_fwd(cfg, *args).float()
            torch.cuda.synchronize()
            ref = fmg.generic_tab_fwd_plain(cfg, *args).float()
            err = (got - ref).abs()
            ulps = {}
            if dtype == torch.float32:
                bad = int((err > tol * torch.clamp(ref.abs(), min=1.0)).sum())
                limit = f"{tol} * max(1, |ref|) elementwise; fp32 sums in another order"
            else:
                # the same rounding points: elementwise in bf16 ulps, and the
                # loose whole-tensor limit beside it
                u = bf16_ulps(got, ref)
                ulps = dict(max_ulps=float(u.max()), share_over_1ulp=float((u > 1).float().mean()),
                            share_equal=float((err == 0).float().mean()))
                bad = int((err > tol * ref.abs().max()).sum()) + int(
                    (u > TOL_GENERIC_BF16_ULPS).sum())
                limit = (f"{TOL_GENERIC_BF16_ULPS} bf16 ulps of max(|ref|, mean|ref|) elementwise "
                         f"and at most {TOL_GENERIC_BF16_OVER_1ULP} of the elements over 1 ulp "
                         "(the plain version rounds where the kernel does; fp32 sums in "
                         f"another order flip a rounding now and then); and {tol} * max|ref|")
                if ulps["share_over_1ulp"] > TOL_GENERIC_BF16_OVER_1ULP:
                    bad += 1
            max_err = float(err.max())
            kres[dtype] = dict(cfg=cfg, args=args, n_valid=n_valid, max_abs_err=max_err)
            emit("kernel_lmax2", kernel=fmg.GENERIC_TAB_FWD.name,
                 dtype=str(dtype).replace("torch.", ""), rows=args[0].shape[0], k=cfg.k,
                 tile=cfg.tile, u=cfg.u, a=cfg.a, widths=cfg.widths, valid_slots=n_valid,
                 max_abs_err=max_err, max_rel_err=max_err / max(float(ref.abs().max()), 1e-30),
                 max_abs_ref=float(ref.abs().max()), mean_abs_ref=float(ref.abs().mean()),
                 **ulps, elements_over_tolerance=bad, tolerance=limit,
                 finite=bool(torch.isfinite(got).all()))
            check(bad == 0 and bool(torch.isfinite(got).all()),
                  f"kernel #8 vs plain in {dtype}: {bad} elements over tolerance {ulps}")
        del got, ref, err

    # ---- 14. the bf16 forward through kernel #8, counted (geo-only attributes)
    model_bf = copy.deepcopy(model).to(bf)
    attrs_bf = (None, attrs32[1].to(bf), None, attrs32[3].to(bf))
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    fwd = lambda: model_bf(graph_bf, attrs=attrs_bf)
    with torch.no_grad():
        reset_launches()
        out = fwd()
        torch.cuda.synchronize()
        launches = launch_counts()
        want = {fm.TAB_FWD.name: 0, fm.TAB_BWD.name: 0, fm.TAB_BWD_REDUCE.name: 0,
                fmg.GENERIC_TAB_FWD.name: NUM_LAYERS}
        check(launches == want, f"{launches} kernel launches in one forward, expected {want}")
        check(tuple(out.shape) == (L2_POINTS, 3), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite output")
        # the same (bf16) weights in fp32: through the kernel and the plain path
        state32 = {k: v.float() for k, v in model_bf.state_dict().items()}
        attrs_32 = (None, attrs32[1], None, attrs32[3])
        plain32 = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                             layout="cm", use_pallas=False, device=dev)
        plain32.load_state_dict(state32)
        ref = plain32(graph, attrs=attrs_32)
        del plain32
        model32 = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                             layout="cm", use_pallas=True, device=dev)
        model32.load_state_dict(state32)
        k32 = model32(graph, attrs=attrs_32)
        del model32
        scale = float(ref.abs().max())
        err32 = float((k32 - ref).abs().max())
        errbf = float((out.float() - ref).abs().max())
        emit("forward_lmax2", points=L2_POINTS, layers=NUM_LAYERS, hidden=L2_HIDDEN,
             dtype="bfloat16", shape=list(out.shape), launches=launches, max_abs_ref=scale,
             fp32_kernel_vs_plain_max_abs_err=err32,
             fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
             bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
             bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
        check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
              f"lmax=2 fp32 forward: kernel vs plain max abs err {err32}")
        check(errbf <= TOL_FORWARD_BF16 * scale, f"lmax=2 bf16 forward vs fp32 plain: {errbf}")
        del ref, k32, out

    # ---- 15. times (CUDA events after warm-up) and kernel #8's bound
    kb = kres[bf]
    cfg, args = kb["cfg"], kb["args"]
    plain_bf = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                          layout="cm", use_pallas=False, device=dev).to(bf)
    plain_bf.load_state_dict(model_bf.state_dict())
    with torch.no_grad():
        fwd_ms = event_ms(fwd, iters=3, warmup=1)
        fwd_plain_ms = event_ms(lambda: plain_bf(graph_bf, attrs=attrs_bf), iters=2, warmup=1)
        kern_ms = event_ms(lambda: fmg.generic_tab_fwd(cfg, *args), iters=5, warmup=1)
        plain_ms = event_ms(lambda: fmg.generic_tab_fwd_plain(cfg, *args), iters=2, warmup=1)
        k32 = kres[torch.float32]
        kern_fp32_ms = event_ms(lambda: fmg.generic_tab_fwd(k32["cfg"], *k32["args"]),
                                iters=2, warmup=1)
        out8 = fmg.generic_tab_fwd(cfg, *args)
    # bound: each input read once, the output written once; the multiply-adds
    # the valid slots need (the nonzeros of the folded weights) at the bf16
    # tensor-core peak and, beside it, at the fp32 FMA peak; the dense folded
    # GEMMs the kernel runs are reported beside them
    h, geo2, loc, gtab, ws, sels = args
    flops = kern.flops_per_slot() * kb["n_valid"]
    dense_flops = cfg.dense_flops_per_slot() * kb["n_valid"]
    n_bytes = nbytes(h, geo2, loc, gtab, *ws, *sels, out8)
    b_ms, by, bytes_ms, ops_ms = bound(n_bytes, flops)
    emit("times_lmax2", card=card, points=L2_POINTS, forward_ms=fwd_ms,
         forward_plain_path_ms=fwd_plain_ms, kernel_ms_per_launch=kern_ms,
         kernel_ms_per_forward=kern_ms * NUM_LAYERS, plain_ms_per_call=plain_ms,
         kernel_fp32_ms_per_launch=kern_fp32_ms,
         bound_ms=b_ms, bound_by=by, bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms,
         kernel_gflop=flops / 1e9, kernel_mbytes=n_bytes / 1e6, valid_slots=kb["n_valid"],
         flops_per_slot=kern.flops_per_slot(), dense_flops_per_slot=cfg.dense_flops_per_slot(),
         kernel_fp32_fma_bound_ms=flops / PEAK_FP32_FMA_FLOPS * 1e3,
         dense_gemm_gflop=dense_flops / 1e9,
         dense_gemm_bf16_ms=dense_flops / PEAK_BF16_FLOPS * 1e3,
         graph_build_ms=sum(gtimes.values()))
    return dict(launches=launches[fmg.GENERIC_TAB_FWD.name], max_abs_err=kb["max_abs_err"],
                ms=kern_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # ---- 2. build every kernel source
    t0 = time.perf_counter()
    built = build_libraries(sorted({kern.source_name for kern in ALL_KERNELS}))
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
    with torch.no_grad():
        attrs32 = model.compute_attributes_dense(graph)
    tabs = (graph.gather_rev_dense, graph.gather_rem_pos, graph.gather_rem_node)
    bf = torch.bfloat16

    # ---- 4. forward kernel vs plain at the main path's shapes
    kres = {}
    with torch.no_grad():
        for dtype, tol in ((torch.float32, TOL_KERNEL_FP32), (bf, TOL_KERNEL_BF16)):
            cfg, args, ws, n_valid = kernel_inputs(graph, attrs32, model.layers[0], dtype, gen)
            got = fm.fused_message_aggregate_tabled_fwd(cfg, *args, *ws).float()
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
            kres[dtype] = dict(cfg=cfg, args=args, ws=ws, n_valid=n_valid, max_abs_err=max_err)
            emit("kernel", kernel=fm.TAB_FWD.name, dtype=str(dtype).replace("torch.", ""),
                 rows=args[0].shape[0], k=cfg.k, tile=cfg.tile, u=cfg.u, valid_slots=n_valid,
                 max_abs_err=max_err, max_rel_err=max_err / max(float(ref.abs().max()), 1e-30),
                 max_abs_ref=float(ref.abs().max()), elements_over_tolerance=bad,
                 tolerance=limit, finite=bool(torch.isfinite(got).all()))
            check(bad == 0 and bool(torch.isfinite(got).all()),
                  f"kernel vs plain in {dtype}: {bad} elements over tolerance")
        del got, ref, err

    # ---- 5. backward kernels vs plain, same inputs and a random cotangent
    names = ("d_h", "d_w0e1", "d_w1o1", "d_w0e2", "d_w1o2")
    part_names = ("d_hu", "d_hr", "dW0a", "dW1Sa", "dW1Va", "dW0b", "dW1Sb", "dW1Vb")
    with torch.no_grad():
        for dtype in (torch.float32, bf):
            kr = kres[dtype]
            cfg, args, ws = kr["cfg"], kr["args"], kr["ws"]
            ws6 = fm.split_weights(cfg, *ws)
            d_agg = torch.randn(args[0].shape, generator=gen, device=dev).to(dtype)
            kr["d_agg"] = d_agg
            fp32 = dtype == torch.float32
            # the kernels' own outputs: d_hu, d_hr and the reduced weight blocks
            d_hu, d_hr, partials = fm.tab_bwd_kernel(cfg, *args, ws6, d_agg)
            dw = fm.tab_bwd_reduce(partials)
            torch.cuda.synchronize()
            dw_ref = fm.tab_bwd_reduce_plain(partials)
            red = compare(dw, dw_ref, float(dw_ref.abs().max()), TOL_REDUCE)
            check(red[1] == 0, f"weight-gradient reduction vs plain: {red}")
            pieces, off = [], 0
            for a, b in cfg.weight_shapes():
                pieces.append(dw[off:off + a * b].view(a, b))
                off += a * b
            ref_parts = fm.tab_bwd_plain(cfg, *args, ws6, d_agg)
            ref_parts = list(ref_parts[:2]) + list(ref_parts[2])
            parts = {}
            for nm, x, y in zip(part_names, [d_hu, d_hr, *pieces], ref_parts, strict=True):
                ym = float(y.float().abs().max())
                scale = (torch.clamp(y.float().abs(), min=1.0) if fp32 and nm in ("d_hu", "d_hr")
                         else ym)
                parts[nm] = compare(x, y, scale, TOL_BWD_FP32 if fp32 else TOL_BWD_BF16)
            # the full backward: kernels + epilogue against the plain backward
            got = fm.fused_message_aggregate_tabled_bwd(cfg, *args, *tabs, *ws, d_agg)
            again = fm.fused_message_aggregate_tabled_bwd(cfg, *args, *tabs, *ws, d_agg)
            torch.cuda.synchronize()
            identical = all(torch.equal(x, y) for x, y in zip(got, again))
            ref = fm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, *tabs, *ws, d_agg)
            full = {}
            for nm, x, y in zip(names, got, ref, strict=True):
                ym = float(y.float().abs().max())
                scale = torch.clamp(y.float().abs(), min=1.0) if fp32 and nm == "d_h" else ym
                full[nm] = compare(x, y, scale, TOL_BWD_FP32 if fp32 else TOL_BWD_BF16)
            finite = all(bool(torch.isfinite(x).all()) for x in (*got, d_hu, d_hr, dw))
            kr["bwd_max_abs_err"] = max(v[0] for v in parts.values())
            kr["reduce_max_abs_err"] = red[0]
            kr["bwd_parts"] = (d_hu, d_hr, partials)
            emit("kernel_bwd", kernels=[fm.TAB_BWD.name, fm.TAB_BWD_REDUCE.name],
                 dtype=str(dtype).replace("torch.", ""), rows=args[0].shape[0],
                 valid_slots=kr["n_valid"], blocks=partials.shape[0],
                 kernel_outputs={k: dict(max_abs_err=v[0], over_tolerance=v[1], max_abs_ref=v[2])
                                 for k, v in parts.items()},
                 reduction=dict(max_abs_err=red[0], over_tolerance=red[1], max_abs_ref=red[2],
                                tolerance=f"{TOL_REDUCE} * max|ref|; fp32 sums over the "
                                          "blocks in another order"),
                 with_epilogue={k: dict(max_abs_err=v[0], over_tolerance=v[1], max_abs_ref=v[2])
                                for k, v in full.items()},
                 tolerance=(f"d_h, d_hu, d_hr: {TOL_BWD_FP32} * max(1, |ref|) elementwise; "
                            f"weights: {TOL_BWD_FP32} * max|ref| (fp32 sums over 2.4M slots "
                            "in another order)") if fp32 else
                 f"{TOL_BWD_BF16} * max|ref|; bf16 rounding of the cotangent intermediates",
                 bit_identical_reruns=identical, finite=finite)
            bad = {k: v[1] for k, v in {**parts, **full}.items() if v[1]}
            check(not bad and finite, f"backward kernels vs plain in {dtype}: {bad}")
            check(identical, f"two backward runs differ in {dtype}")
            del got, again, ref, ref_parts

    # ---- 6. the config-3 forward through the kernel (bf16), counted
    model_bf = copy.deepcopy(model).to(bf)
    attrs_bf = tuple(a.to(bf) for a in attrs32)
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    fwd = lambda: model_bf(graph_bf, attrs=attrs_bf)
    with torch.no_grad():
        reset_launches()
        out = fwd()
        torch.cuda.synchronize()
        fwd_launches = launch_counts()
        check(fwd_launches == {fm.TAB_FWD.name: NUM_LAYERS, fm.TAB_BWD.name: 0,
                               fm.TAB_BWD_REDUCE.name: 0, fmg.GENERIC_TAB_FWD.name: 0},
              f"{fwd_launches} kernel launches in one forward, expected {NUM_LAYERS} forward")
        check(tuple(out.shape) == (N_POINTS, 3), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite output")

        # the same (bf16) weights in fp32: through the kernel and through the plain path
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
             shape=list(out.shape), launches=fwd_launches, max_abs_ref=scale,
             fp32_kernel_vs_plain_max_abs_err=err32,
             fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
             bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
             bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
        check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
              f"fp32 forward: kernel vs plain max abs err {err32}")
        check(errbf <= TOL_FORWARD_BF16 * scale, f"bf16 forward vs fp32 plain: {errbf}")
        del ref, k32, out, model32
        # the same bf16 forward through the plain message path, for the times
        plain_bf = plain32.to(bf)
        fwd_plain = lambda: plain_bf(graph_bf, attrs=attrs_bf)
        del plain32

    # ---- 7. the config-3 train step: fp32 masters, bf16 compute, MSE, Adam
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (N_POINTS, 3)).astype(np.float32)).to(dev)

    def loss_fn(m, g, a, t):
        # bench.py's loss: the forward under bf16 copies of the fp32 masters,
        # so the gradients flow back through the casts to fp32
        p = {nm: w.to(bf) for nm, w in m.named_parameters()}
        return mse_loss(torch.func.functional_call(m, p, (g,), {"attrs": a}).float(), t)

    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, loss_fn, opt)
    losses, norms, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        m = step(graph_bf, attrs_bf, target)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = launch_counts()
    want = {fm.TAB_FWD.name: NUM_LAYERS, fm.TAB_BWD.name: NUM_LAYERS,
            fm.TAB_BWD_REDUCE.name: NUM_LAYERS, fmg.GENERIC_TAB_FWD.name: 0}
    masters = all(p.dtype == torch.float32 for p in model.parameters())
    emit("train", points=N_POINTS, layers=NUM_LAYERS, steps=TRAIN_STEPS,
         compute_dtype="bfloat16", master_dtype="float32" if masters else "mixed",
         optimizer=f"Adam(lr={LEARNING_RATE}, betas=(0.9, 0.999), eps=1e-8)", losses=losses,
         grad_norms=norms, launches=train_launches, launches_per_step=per_step,
         seconds_incl_first_step=train_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    check(all(math.isfinite(x) for x in losses + norms), f"non-finite loss or norm: {losses} {norms}")
    check(all(s == want for s in per_step), f"launches per step {per_step}, expected {want}")
    check(masters, "master weights are not all fp32")

    # ---- 8. fp32 gradients: kernels vs autograd through the plain path
    pts_gc = np.random.default_rng(SEED + 3).random((GC_POINTS, 3)).astype(np.float32)
    _, _, _, graph_gc, _ = build_graph(pts_gc, GC_RADIUS)
    m_k = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                     use_pallas=True, device=dev, generator=torch.Generator().manual_seed(SEED))
    m_p = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                     use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    with torch.no_grad():
        attrs_gc = m_k.compute_attributes_dense(graph_gc)
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (GC_POINTS, 3)).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    loss_k = mse_loss(m_k(graph_gc, attrs=attrs_gc), t_gc)
    loss_k.backward()
    loss_p = mse_loss(m_p(graph_gc, attrs=attrs_gc), t_gc)
    loss_p.backward()
    worst, worst_name = 0.0, ""
    for (nm, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        rel = float((a.grad - b.grad).abs().max()) / max(float(b.grad.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, nm
    emit("grad_check", points=GC_POINTS, radius=GC_RADIUS, k=MAX_NEIGHBORS, tile=TILE,
         layers=NUM_LAYERS, dtype="float32",
         edges_symmetrized=int(graph_gc.edge_mask.sum()), loss_kernel=loss_k.item(),
         loss_plain=loss_p.item(), worst_param=worst_name, worst_rel_err=worst,
         tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order",
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(worst <= TOL_GRAD_FP32, f"fp32 gradients: {worst_name} off by {worst} of max|ref|")
    check(abs(loss_k.item() - loss_p.item()) <= 1e-5 * loss_p.item(), "losses differ")
    del m_k, m_p, graph_gc, attrs_gc, loss_k, loss_p

    # ---- 9. forward times (CUDA events after warm-up)
    kb = kres[bf]
    cfg, args, ws = kb["cfg"], kb["args"], kb["ws"]
    with torch.no_grad():
        fwd_ms = event_ms(fwd, iters=10)
        fwd_plain_ms = event_ms(fwd_plain, iters=3, warmup=1)
        kern_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_fwd(cfg, *args, *ws),
                           iters=20)
        plain_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_plain(cfg, *args, *ws),
                            iters=5, warmup=1)
    del fwd_plain, plain_bf
    # bound: each input read once, the output written once; the products of
    # the valid slots at the bf16 tensor-core peak
    fwd_flops = 2 * messages_per_slot(cfg) * kb["n_valid"]
    fwd_bytes = nbytes(*args, *ws) + nbytes(args[0])
    fwd_bound, fwd_by, fwd_b_ms, fwd_o_ms = bound(fwd_bytes, fwd_flops)
    emit("times", card=card, forward_ms=fwd_ms, forward_plain_path_ms=fwd_plain_ms,
         kernel_ms_per_launch=kern_ms, kernel_ms_per_forward=kern_ms * NUM_LAYERS,
         plain_ms_per_call=plain_ms, bound_ms=fwd_bound, bound_bytes_ms=fwd_b_ms,
         bound_ops_ms=fwd_o_ms, kernel_gflop=fwd_flops / 1e9, kernel_mbytes=fwd_bytes / 1e6,
         kernel_fp32_fma_bound_ms=fwd_flops / PEAK_FP32_FMA_FLOPS * 1e3,
         graph_build_ms=sum(gtimes.values()), **{k: gtimes[k] for k in gtimes})

    # ---- 10. train-step and backward times (CUDA events after warm-up)
    step_ms = event_ms(lambda: step(graph_bf, attrs_bf, target), iters=5, warmup=1)
    ws6 = fm.split_weights(cfg, *ws)
    d_agg = kb["d_agg"]
    d_hu, d_hr, partials = kb["bwd_parts"]
    with torch.no_grad():
        bwd_ms = event_ms(lambda: fm.tab_bwd_kernel(cfg, *args, ws6, d_agg), iters=5, warmup=1)
        red_ms = event_ms(lambda: fm.tab_bwd_reduce(partials), iters=20)
        # the plain version is one PyTorch call (torch.sum over the blocks):
        # its time is also the library time
        red_plain_ms = event_ms(lambda: fm.tab_bwd_reduce_plain(partials), iters=20)
        bwd_plain_ms = event_ms(lambda: fm.tab_bwd_plain(cfg, *args, ws6, d_agg),
                                iters=2, warmup=1)
        bwd_full_plain_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_bwd_plain(
            cfg, *args, *tabs, *ws, d_agg), iters=2, warmup=1)
        epi_ms = event_ms(lambda: fm.sender_epilogue(d_hr, d_hu, *tabs), iters=10)
        bwd_full_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_bwd(
            cfg, *args, *tabs, *ws, d_agg), iters=5, warmup=1)
    # bound of the main backward kernel: its inputs read once, d_hu, d_hr and
    # the weight gradients written once; the recompute (1x) and the VJP (2x)
    # products of the valid slots at the bf16 tensor-core peak
    nw = partials.shape[1]
    bwd_flops = 2 * 3 * messages_per_slot(cfg) * kb["n_valid"]
    bwd_bytes = nbytes(*args, *ws6, d_agg, d_hu, d_hr) + 4 * nw
    bwd_bound, bwd_by, bwd_b_ms, bwd_o_ms = bound(bwd_bytes, bwd_flops)
    # the reduction: the partials read once, the sums written once; one fp32
    # add per partial on the non-tensor units
    red_bound, red_by, _, _ = bound(nbytes(partials) + 4 * nw, partials.numel(),
                                    PEAK_FP32_FMA_FLOPS)
    emit("train_times", card=card, points=N_POINTS, step_ms=step_ms,
         bwd_kernel_ms_per_launch=bwd_ms, bwd_kernel_ms_per_step=bwd_ms * NUM_LAYERS,
         bwd_plain_ms_per_call=bwd_plain_ms, reduce_kernel_ms=red_ms,
         reduce_plain_ms=red_plain_ms,
         epilogue_ms=epi_ms, bwd_with_epilogue_ms=bwd_full_ms,
         bwd_with_epilogue_plain_ms=bwd_full_plain_ms, bwd_bound_ms=bwd_bound,
         bwd_bound_bytes_ms=bwd_b_ms, bwd_bound_ops_ms=bwd_o_ms,
         bwd_gflop=bwd_flops / 1e9, bwd_mbytes=bwd_bytes / 1e6,
         bwd_fp32_fma_bound_ms=bwd_flops / PEAK_FP32_FMA_FLOPS * 1e3,
         reduce_bound_ms=red_bound, reduce_blocks=partials.shape[0],
         valid_slots=kb["n_valid"])

    # ---- 11. where a train step's device time goes
    prof = profile_steps(step, (graph_bf, attrs_bf, target))
    emit("profile", card=card, points=N_POINTS, **prof)
    check(prof["device_ms_per_step"] > 0, "the profiler saw no device time")

    # ---- 12-15. the lmax=2 config-4 proxy: graph, kernel #8, forward, times
    l2 = lmax2_phases(card)

    src = lambda kern: str(kern.source.relative_to(Path(__file__).resolve().parent))
    print(json.dumps({"kernels": [
        {"name": fm.TAB_FWD.name, "route": "cuda", "source": src(fm.TAB_FWD),
         "replaces": f"{TPU_FILE}:401", "launches": train_launches[fm.TAB_FWD.name],
         "max_abs_err": kb["max_abs_err"], "ms": kern_ms, "plain_ms": plain_ms,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None},
        {"name": fm.TAB_BWD.name, "route": "cuda", "source": src(fm.TAB_BWD),
         "replaces": f"{TPU_FILE}:513", "launches": train_launches[fm.TAB_BWD.name],
         "max_abs_err": kb["bwd_max_abs_err"], "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None},
        {"name": fm.TAB_BWD_REDUCE.name, "route": "cuda", "source": src(fm.TAB_BWD_REDUCE),
         "replaces": f"{TPU_FILE}:485", "launches": train_launches[fm.TAB_BWD_REDUCE.name],
         "max_abs_err": kb["reduce_max_abs_err"], "ms": red_ms, "plain_ms": red_plain_ms,
         "bound_ms": red_bound, "bound_by": red_by, "library_ms": red_plain_ms},
        {"name": fmg.GENERIC_TAB_FWD.name, "route": "cuda", "source": src(fmg.GENERIC_TAB_FWD),
         "replaces": f"{GENERIC_TPU_FILE}:937", "launches": l2["launches"],
         "max_abs_err": l2["max_abs_err"], "ms": l2["ms"], "plain_ms": l2["plain_ms"],
         "bound_ms": l2["bound_ms"], "bound_by": l2["bound_by"], "library_ms": None},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
