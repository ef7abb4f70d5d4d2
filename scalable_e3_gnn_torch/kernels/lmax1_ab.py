"""Before/after A/B of the lmax=1 message kernels at config 3, for two
checkouts of the port on one card.

    python scalable_e3_gnn_torch/kernels/lmax1_ab.py [--repo DIR] [--tag NAME]
        [--hidden IRREPS] [--wide] [--clocks DIR]

Imports ``scalable_e3_gnn_torch`` from DIR (default: the checkout holding
this file), builds config 3's graph on the card (100k uniform points from
seed 0, r = 0.04, K = 24, octree 6 levels, symmetrized, gather tables at
tile 160), takes layer 0 of a SEGNN at ``--hidden`` (default config 3's
32x0e+16x1o; weights from seed 0) and makes bf16 inputs as ``chip_smoke.py``
does (random features, extra masked slots, the last 37 receivers without a
valid slot), then runs the tabled forward #1 and backward #2 (main kernel,
the reduction, the whole backward with its epilogue), the untabled #3 and
#5 on the same graph without its tables, and the packed #6 and #7 at pack =
2, and prints one JSON line: device ms per launch of every kernel by
torch.profiler, CUDA-event ms per call, the kernels' bf16 ulps against
their plain versions (max, and the share of elements over 1 ulp, of
max(|ref|, mean|ref|)), a SHA-256 of every output (each forward's agg; each
backward's sender and receiver cotangents and its per-block weight-gradient
partials), #2's partials shape, and the card's name and power limit.
Compare two checkouts only within one call, in turns (parent, change,
change, parent); equal digests are bit-identical outputs.  ``--wide``
(this checkout only) sends the bf16 launches to the Wide kernels at every
width, as past 32x0e+16x1o (``fused_message.BENCH_HS`` set to 0 in this
process): at the Bench widths their digests equal the Bench kernels'.

Where the wrappers pick the Wide kernels (past 32x0e+16x1o, or ``--wide``)
the line also gives each Wide kernel's launch (``occupancy``: its instance,
warps a block, blocks an SM by the occupancy query, warps an SM, shared
memory a block), where the checkout has ``fused_message.wide_occupancy``
(null otherwise).  ``reduce`` times the reduction's two kernels (the column
kernel and the strips) at #2's partials shape, device ms by torch.profiler.
``--reduce-shapes NBxNW,...`` (this checkout only) times them instead on
random partials of each shape, beside ``torch.sum`` and the plan's choice,
and prints only that.

``--clocks DIR`` (this checkout's sources only) builds the backward source
once more with ``LMAX1_BWD_CLOCKS`` into DIR (with the Wide instance's
defines where the wrappers pick the Wide kernels at this width) and prints #2's cycles
per round in each phase, read by ``clock64`` on thread 0 of every block:
the gather, layer 1, layer 2 with its gates' VJP, layer 2's input
cotangents, layer 1 again with its gates' VJP, layer 1's input cotangents,
the K-sum, the wait at the round's first barrier, warp 0's weight
gradients, the wait at the second barrier, and the table sums after the
rounds (spread per round; the Wide kernel's also write its weight-gradient
accumulators).  The Wide kernel runs layer 2's weight gradients after its
input cotangents: the wait before them, warp 0's jobs of layer 2 and the
wait after them are three more phases (its ``wgrad`` is then layer 1's
jobs); and thread 0's waits on the weight ring's mbarriers, inside the
phases, are given apart (``ring_wait``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
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
SEED = 0
LO, HI = (0.0,) * 3, (1.0,) * 3


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


def _device(fn, iters: int) -> dict:
    """Per CUDA kernel name: device ms per launch and launches per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            out[ev.key[:60]] = dict(ms=ev.self_device_time_total / 1e3 / ev.count,
                                    per_call=ev.count / iters)
    return out


def _digest(x) -> str:
    """SHA-256 of a tensor's bytes (bf16 read as int16)."""
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()


def _ulps(got, ref) -> dict:
    """|got - ref| in bf16 ulps of max(|ref|, mean|ref|): the max and the
    share of elements over 1 ulp (``chip_smoke.bf16_ulps``)."""
    r = ref.float().abs()
    scale = torch.clamp(r, min=max(float(r.mean()), 1e-30))
    d = (got.float() - ref.float()).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return dict(max=round(float(d.max()), 4), over1=float((d > 1).float().mean()))


def bwd_clocks(fm, ta, ws, d_agg, out_dir: Path) -> dict:
    """#2's cycles per round in each phase, from the profiling build of the
    library the wrappers pick at this width."""
    from scalable_e3_gnn_torch.kernels import build

    cfg, h = ta[0], ta[1]
    variant = fm._variant(h, cfg)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"libfused_message_tab_bwd-clocks{'-wide' if variant else ''}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in variant),
                    "-DLMAX1_BWD_CLOCKS", "-o", str(path),
                    str(build.CSRC / "fused_message_tab_bwd.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in fm.TAB_BWD.signatures.items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    lib.lmax1_bwd_phase_cycles.restype = ctypes.c_int
    lib.lmax1_bwd_phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    npad, f = h.shape
    dims = (cfg.hs, cfg.hv, cfg.k, cfg.tile, cfg.u)
    grid = lib.fused_message_tab_bwd_grid(1, *dims, npad // cfg.tile)
    d_hu = torch.empty((npad // cfg.tile * cfg.u, f), dtype=h.dtype, device=h.device)
    d_hr = torch.empty_like(h)
    scratch = torch.empty((npad * cfg.k, f), dtype=h.dtype, device=h.device)
    part = fm._partials(lib, cfg, 1, grid, h.device)
    args = (*ta[1:], *ws, d_agg)
    call = lambda: lib.fused_message_tab_bwd(
        1, *(x.data_ptr() for x in args), d_hu.data_ptr(), d_hr.data_ptr(), scratch.data_ptr(),
        part.data_ptr(), npad, *dims, grid, torch.cuda.current_stream().cuda_stream)
    cyc = (ctypes.c_ulonglong * 16)()
    assert call() == 0
    torch.cuda.synchronize()
    lib.lmax1_bwd_phase_cycles(cyc)  # drop the warm-up
    iters = 3
    for _ in range(iters):
        assert call() == 0
    torch.cuda.synchronize()
    assert lib.lmax1_bwd_phase_cycles(cyc) == 0
    rounds = cyc[11]
    names = ("gather", "layer1", "layer2_vjp", "layer2_cotangents", "layer1_again_vjp",
             "layer1_cotangents", "ksum", "barrier1", "wgrad", "barrier2", "table_sum")
    if variant:
        names += (None, "barrier_l2", "wgrad_l2", "barrier_l2_after")
    per_round = {nm: cyc[i] / rounds for i, nm in enumerate(names) if nm}
    out = dict(library="wide" if variant else "bench", cycles_per_round=per_round,
               total=sum(per_round.values()), rounds_per_block=rounds / iters / grid,
               blocks=grid)
    if variant:
        out["ring_wait_per_round"] = cyc[15] / rounds
    return out


def reduce_shapes(fm, shapes: str) -> list:
    """``reduce_times`` on random fp32 partials of each shape ("NBxNW,...")."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for shape in shapes.split(","):
        nb, nw = (int(x) for x in shape.split("x"))
        out.append(reduce_times(fm, torch.randn((nb, nw), generator=gen, device="cuda")))
    return out


def reduce_times(fm, part) -> dict:
    """Device ms of the reduction's column kernel and strip kernel at the
    partials' shape (the column kernel only where nw % 4 == 0), and of
    torch.sum, by torch.profiler; both kernels fold each column in block
    order, so their outputs are bitwise equal."""
    nblocks, nw = part.shape
    lib = fm.TAB_BWD_REDUCE.lib()
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for cols in ((0, 1) if nw % 4 == 0 else (0,)):
        o = torch.empty((nw,), dtype=torch.float32, device=part.device)
        call = lambda: lib.fused_message_tab_bwd_reduce(part.data_ptr(), o.data_ptr(), nblocks,
                                                        nw, cols, stream)
        dev = _device(call, 20)
        out["cols" if cols else "strips"] = sum(v["ms"] * v["per_call"] for v in dev.values())
        out[f"{'cols' if cols else 'strips'}_digest"] = _digest(o)
    dev = _device(lambda: part.sum(dim=0), 20)
    out["torch_sum"] = sum(v["ms"] * v["per_call"] for v in dev.values())
    sms = torch.cuda.get_device_properties(part.device).multi_processor_count
    out["plan_cols"] = bool(fm.reduce_plan(nblocks, nw, (part.data_ptr(), 0), sms)["cols"])
    out["shape"] = [nblocks, nw]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--clocks", default="", help="scratch directory for the profiling build")
    ap.add_argument("--hidden", default=HIDDEN, help="the layer's hidden irreps")
    ap.add_argument("--wide", action="store_true", help="the Wide kernels at every width")
    ap.add_argument("--reduce-shapes", default="", help="time the reduction alone at NBxNW,...")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import scalable_e3_gnn_torch
    from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph
    from scalable_e3_gnn_torch.graph.octree import build_octree
    from scalable_e3_gnn_torch.graph.radius import radius_graph_cell, suggest_cell_capacity
    from scalable_e3_gnn_torch.kernels import fused_message as fm
    from scalable_e3_gnn_torch.models.segnn import SEGNN

    if args.wide:
        fm.BENCH_HS = 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    if args.reduce_shapes:
        print(json.dumps(dict(tag=args.tag, card=card, reduce=reduce_shapes(fm, args.reduce_shapes))),
              flush=True)
        return 0
    pts = np.random.default_rng(SEED).random((N_POINTS, 3)).astype(np.float32)
    tree = build_octree(pts, LO, HI, num_levels=LEVELS, device=dev)
    cap = suggest_cell_capacity(tree, RADIUS, LO, HI)
    edges = radius_graph_cell(tree, RADIUS, LO, HI, max_neighbors=K, cell_capacity=cap)
    feats = np.random.default_rng(SEED + 1).standard_normal((N_POINTS, 5)).astype(np.float32)
    graph = DenseEdgeGraph.from_radius_edges(feats, tree.points, edges, symmetrize=True)
    graph = graph.with_gather_tables(tile=TILE)
    model = SEGNN("2x0e+1x1o", args.hidden, "1x1o", num_layers=4, layout="cm", use_pallas=True,
                  device=dev, generator=torch.Generator().manual_seed(SEED))
    layer = model.layers[0]
    attrs = model.compute_attributes_dense(graph)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    # the tabled inputs (chip_smoke.kernel_inputs)
    edge_attr, dist2, edge_geo = attrs[0], attrs[2], attrs[3]
    n, k = graph.edge_mask.shape
    npad = graph.gather_loc.shape[0]
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=TILE,
                           u=graph.gather_tab.shape[1])
    mask = graph.edge_mask & (torch.rand((n, k), generator=gen, device=dev) > 0.1)
    mask[n - 37:] = False
    loc = graph.gather_loc.clone()
    loc[n - 37:] = cfg.u
    h = torch.randn((npad, cfg.f), generator=gen, device=dev)
    h[n - 37:] = 0.0
    pad = lambda x: torch.cat([x, x.new_zeros((npad - n,) + x.shape[1:])])
    targs = [pad(dist2).reshape(npad * k, 1), pad(edge_attr).reshape(npad * k, 4),
             pad(mask.float()).reshape(npad * k, 1)]
    h, d2, attr, maskf = (x.to(bf).contiguous() for x in [h] + targs)
    loc = loc.reshape(npad * k, 1).contiguous()
    gtab = graph.gather_tab.contiguous()
    w4 = layer._folded_weights(bf)
    ws = fm.split_weights(cfg, *w4)
    tabs = (graph.gather_rev_dense, graph.gather_rem_pos, graph.gather_rem_node)
    d_agg = torch.randn((npad, cfg.f), generator=gen, device=dev).to(bf)
    ta = (cfg, h, d2, attr, maskf, loc, gtab)
    # the untabled inputs on the same graph (chip_smoke.km_inputs): hs3 by
    # the senders, the geometry with the same masks
    kcfg = fm.MessageConfig(hs=cfg.hs, hv=cfg.hv, k=k, tile=TILE)
    geo = edge_geo.float().reshape(n, k, 6).clone()
    geo[..., 5] = mask.float()
    senders = torch.clamp(graph.senders.long(), max=n - 1)
    hs3 = torch.cat([h[:n][senders.t()], h.new_zeros((k, npad - n, cfg.f))], 1).contiguous()
    geo2 = pad(geo.reshape(n, k * 6)).to(bf).contiguous()
    ka = (kcfg, hs3, h, geo2)
    # the packed inputs at pack 2 (chip_smoke.flat_inputs): node-major sender
    # rows [Npad*K/2, 2F], the flat geometry with the same masks
    p = 2
    fcfg = fm.MessageConfig(hs=cfg.hs, hv=cfg.hv, k=k, tile=TILE, pack=p)
    r = npad * k // p
    hsf = torch.cat([h[:n][senders], h.new_zeros((npad - n, k, cfg.f))]).reshape(r, p * cfg.f)
    fa = (fcfg, hsf.contiguous(), h, d2.reshape(r, p), attr.reshape(r, 4 * p),
          maskf.reshape(r, p))

    with torch.no_grad():
        agg = fm.fused_message_aggregate_tabled_fwd(*ta, *w4)
        d_hu, d_hr, part = fm.tab_bwd_kernel(*ta, ws, d_agg)
        dws = fm._split_partials(cfg, fm.tab_bwd_reduce(part))
        kagg = fm.fused_message_aggregate_km_fwd(*ka, *w4)
        k_hs, k_hr, kpart = fm.km_bwd_kernel(*ka, ws, d_agg)
        kdws = fm._split_partials(cfg, fm.tab_bwd_reduce(kpart))
        fagg = fm.fused_message_aggregate_fwd(*fa, *w4)
        f_hs, f_hr, fpart = fm.flat_bwd_kernel(*fa, ws, d_agg)
        fdws = fm._split_partials(cfg, fm.tab_bwd_reduce(fpart))
        torch.cuda.synchronize()
        digests = {"#1 agg": _digest(agg), "#2 d_hu": _digest(d_hu), "#2 d_hr": _digest(d_hr),
                   "#2 partials": _digest(part), "#3 agg": _digest(kagg),
                   "#5 d_hs": _digest(k_hs), "#5 d_hr": _digest(k_hr),
                   "#5 partials": _digest(kpart), "#6 agg": _digest(fagg),
                   "#7 d_hs": _digest(f_hs), "#7 d_hr": _digest(f_hr),
                   "#7 partials": _digest(fpart)}
        # the plain versions a route at a time (their fp32 rows of the widest
        # widths do not fit the card together)
        names = ("W0a", "W1Sa", "W1Va", "W0b", "W1Sb", "W1Vb")
        ulps = {}
        for (fn, bn), fwd_plain, bwd_plain, inputs, got in (
                (("#1 agg", "#2"), fm.fused_message_aggregate_tabled_plain, fm.tab_bwd_plain,
                 ta, (agg, d_hu, d_hr, dws)),
                (("#3 agg", "#5"), fm.fused_message_aggregate_km_plain, fm.km_bwd_plain, ka,
                 (kagg, k_hs, k_hr, kdws)),
                (("#6 agg", "#7"), fm.fused_message_aggregate_plain, fm.flat_bwd_plain, fa,
                 (fagg, f_hs, f_hr, fdws))):
            ulps[fn] = _ulps(got[0], fwd_plain(*inputs, *w4))
            r_s, r_r, r_dws = bwd_plain(*inputs, ws, d_agg)
            ulps[f"{bn} {'d_hu' if bn == '#2' else 'd_hs'}"] = _ulps(got[1], r_s)
            ulps[f"{bn} d_hr"] = _ulps(got[2], r_r)
            for nm, a, b in zip(names, got[3], r_dws):
                ulps[f"{bn} {nm}"] = _ulps(a, b)
            del r_s, r_r, r_dws
            torch.cuda.empty_cache()
        rerun = fm.tab_bwd_kernel(*ta, ws, d_agg)
        bitwise = dict(tab_bwd=all(torch.equal(x, y) for x, y in zip((d_hu, d_hr, part), rerun)))
        del rerun
        calls = {
            "#1": lambda: fm.fused_message_aggregate_tabled_fwd(*ta, *w4),
            "#2 main": lambda: fm.tab_bwd_kernel(*ta, ws, d_agg),
            "#2 whole": lambda: fm.fused_message_aggregate_tabled_bwd(*ta, *tabs, *w4, d_agg),
            "#3": lambda: fm.fused_message_aggregate_km_fwd(*ka, *w4),
            "#5 main": lambda: fm.km_bwd_kernel(*ka, ws, d_agg),
            "#6": lambda: fm.fused_message_aggregate_fwd(*fa, *w4),
            "#7 main": lambda: fm.flat_bwd_kernel(*fa, ws, d_agg),
        }
        times = {nm: _events(fn, 10) for nm, fn in calls.items()}
        device = {nm: _device(fn, 10) for nm, fn in calls.items()}
        clocks = bwd_clocks(fm, ta, ws, d_agg, Path(args.clocks)) if args.clocks else None
        reduce = reduce_times(fm, part)
        occupancy = None
        if fm._variant(h, cfg) and hasattr(fm, "wide_occupancy"):
            occupancy = {f"{nm} {d}": fm.wide_occupancy(c, form, d == "bwd", rows)
                         for nm, c, form, rows in (("#1/#2", cfg, "tab", npad),
                                                   ("#3/#5", kcfg, "km", npad),
                                                   ("#6/#7", fcfg, "flat", npad))
                         for d in ("fwd", "bwd")}
    print(json.dumps(dict(
        tag=args.tag, package=scalable_e3_gnn_torch.__file__, card=card, hidden=args.hidden,
        wide=args.wide,
        receivers=n, npad=npad,
        valid_slots=int(mask.sum()), u=cfg.u, partials=list(part.shape), event_ms=times,
        device=device, ulps=ulps, bitwise=bitwise, digests=digests, phase_clocks=clocks,
        occupancy=occupancy, reduce=reduce,
        sm_clock_mhz=subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                     "--format=csv,noheader"], capture_output=True, text=True,
                                    timeout=60).stdout.strip())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
