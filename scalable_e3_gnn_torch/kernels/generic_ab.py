"""Before/after A/B of the untabled generic message kernels #11 and #13 at one
config-5 node block, for two checkouts of the port on one card, or of two
gate activations of one checkout.

    python scalable_e3_gnn_torch/kernels/generic_ab.py [--repo DIR] [--tag NAME]
        [--act NAME] [--tabled] [--dtype float32]

Imports ``scalable_e3_gnn_torch`` from DIR (default: the checkout holding
this file), makes the same bf16 inputs from a seed on the card (400,000
receivers of a 10M-node cloud, K=16, the lmax=2 message layers of
``chip_smoke.py``'s config 5, random senders, attributes and masks, the last
37 receivers without a valid slot), runs #11 (without and with save),
#13 (whole; its chain; its weight gradients) and #12 (from the saved ys)
and prints one JSON line: a
SHA-256 of every output's bytes (two checkouts computed the same bits where
the hashes agree), the device time per launch of every kernel by
torch.profiler, CUDA-event times per call, peak memory, and the card's name
and power limit.  Compare two checkouts only within one call, in turns
(parent, change, change, parent).

``--act`` builds the message layers with another gate activation of
``ops/gate.py``'s ACTIVATIONS (``silu``, the default, ``tanh``,
``gelu_tanh``, ``relu``, ``softplus``; checkouts without the table take
silu only), so two activations are timed at the same shapes, in turns.
``--tabled`` times the tabled kernels instead, #8 (without and with save)
and #9 (whole: chain, weight gradients, table sum, reduction; and its
chain), and takes the digests of #10 (whole) too, on bench.py's 250k lmax=2
graph (uniform points from the seed, r =
0.04 * (100000 / 250000)^(1/3), K=16, octree 7 levels, cell capacity 64,
symmetrized, gather tables at tile 200), random features, attributes of the
graph with extra masked slots, and #14 whole (backward tile 200) on the same
graph without its tables.  ``--dtype float32`` runs the fp32 instances and
prints the digests only.  Checkouts whose chain returns ``(d_hs, d_hr, dy1,
dy2, m0, m1)`` (two message layers) and those whose chain returns ``(d_hs,
d_hr, dys, ms)`` (any count) are both driven.

``--clocks`` (this checkout's sources only) builds both sources once more
with ``GENERIC_FWD_CLOCKS`` / ``GENERIC_WGRAD_CLOCKS`` into a scratch
directory and prints #11's cycles per block in each phase (rows and gather,
layer 1, gate, layer 2, K-sum; each ending at a block barrier) and the
weight-gradient kernel's cycles per block waiting for its chunks, in thread
0's multiplies and at the barrier after them, read by ``clock64`` on thread
0.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

N_BLOCK = 400_000  # config 5: 10M points in 25 node blocks
N_CLOUD = 10_000_000
K = 16
HIDDEN = "24x0e+12x1o+6x2e"
SEED = 11


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()).hexdigest()


def _events(fn, iters: int, warmup: int = 1) -> float:
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
            out[ev.key[:80]] = dict(ms=ev.self_device_time_total / 1e3 / ev.count,
                                    per_call=ev.count / iters)
    return out


def _profiling_lib(name: str, macro: str, out_dir: Path):
    import ctypes
    import subprocess as sp

    from scalable_e3_gnn_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{name}-{macro.lower()}.so"
    sp.run([build._nvcc(), *build.NVCC_FLAGS, f"-D{macro}", "-o", str(lib_path),
            str(build.CSRC / f"{name}.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def _chain_rows(out):
    """(dys, ms) of a chain's result: a list per layer (this checkout) or
    the two-layer tuple (d_hs, d_hr, dy1, dy2, m0, m1) of an older one."""
    return (list(out[2:4]), list(out[4:6])) if len(out) == 6 else (out[2], out[3])


def _wgrad_untabled(fmg, cfg, hs, h, geo2, dys, ms, splits):
    """The untabled weight-gradient kernel through either checkout's API."""
    import inspect

    if len(inspect.signature(fmg.generic_bwd_wgrad).parameters) == 7:
        return fmg.generic_bwd_wgrad(cfg, hs, h, geo2, ms, dys, splits)
    return fmg.generic_bwd_wgrad(cfg, hs, h, geo2, ms[1], dys[0], dys[1], splits)


def wgrad_clocks(fmg, cfg, hs, h, geo2, dys, ms, splits: int, out_dir: Path) -> dict:
    """The untabled weight-gradient kernel's cycles per block, from the
    profiling build: waiting for chunks, thread 0's multiplies, the barrier
    after them."""
    import ctypes

    lib = _profiling_lib("fused_message_generic_tab_bwd", "GENERIC_WGRAD_CLOCKS", out_dir)
    fn = lib.fused_message_generic_tab_bwd_wgrad
    fn.restype, fn.argtypes = fmg._BWD_SIGS["fused_message_generic_tab_bwd_wgrad"]
    lib.generic_wgrad_cycles.restype = ctypes.c_int
    lib.generic_wgrad_cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    nl, widths, table = fmg._layers(cfg, h.device)
    rows = dys[0].shape[0]
    part = torch.empty((splits, cfg.nw), dtype=torch.float32, device=h.device)
    m = fmg._flat(ms[1:]) if nl > 1 else None
    call = lambda: fn(1, geo2.data_ptr(), None, fmg._ptr(m), fmg._flat(dys).data_ptr(),
                      hs.data_ptr(), h.data_ptr(), table.data_ptr(), part.data_ptr(),
                      rows // cfg.k, cfg.f, cfg.k, cfg.a, nl, widths, splits,
                      fmg.WGRAD_GROUP[torch.bfloat16], torch.cuda.current_stream().cuda_stream)
    cyc = (ctypes.c_ulonglong * 4)()
    assert call() == 0
    torch.cuda.synchronize()
    lib.generic_wgrad_cycles(cyc)
    assert call() == 0
    torch.cuda.synchronize()
    assert lib.generic_wgrad_cycles(cyc) == 0
    blocks = nl * -(-cfg.a // fmg.WGRAD_GROUP[torch.bfloat16]) * splits
    chunks = -(-rows // 64)
    names = ("wait", "multiply", "barrier")
    return dict(cycles_per_block={names[i]: cyc[i] / blocks for i in range(3)},
                chunks_per_block=chunks / splits,
                partials_equal=bool(torch.equal(part, fmg.generic_bwd_wgrad(
                    cfg, hs, h, geo2, ms, dys, splits))))


def phase_clocks(fmg, cfg, hs, h, geo2, ws, sels, out_dir: Path) -> dict:
    """#11's cycles per block in each phase, from the profiling build."""
    import ctypes

    lib = _profiling_lib("fused_message_generic_tab_fwd", "GENERIC_FWD_CLOCKS", out_dir)
    restype, argtypes = fmg._FWD_SIGS["fused_message_generic_fwd"]
    lib.fused_message_generic_fwd.restype, lib.fused_message_generic_fwd.argtypes = \
        restype, argtypes
    lib.generic_fwd_phase_cycles.restype = ctypes.c_int
    lib.generic_fwd_phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    n, f = h.shape
    nl, widths, table = fmg._layers(cfg, h.device)
    _, wpk, masks, chunks, nq = fmg._fwd_weights(cfg, ws)
    out = torch.empty((n, cfg.out_dim), dtype=h.dtype, device=h.device)
    cyc = (ctypes.c_ulonglong * 8)()
    ptrs = [hs.data_ptr(), h.data_ptr(), geo2.data_ptr(), None, fmg._flat(sels).data_ptr(),
            table.data_ptr(), out.data_ptr(), None, wpk.data_ptr(), masks.data_ptr(),
            chunks.data_ptr()]
    call = lambda: lib.fused_message_generic_fwd(
        1, *ptrs, n, f, cfg.k, cfg.a, nl, widths, nq, torch.cuda.current_stream().cuda_stream)
    assert call() == 0
    torch.cuda.synchronize()
    lib.generic_fwd_phase_cycles(cyc)  # drop the warm-up
    iters = 3
    for _ in range(iters):
        assert call() == 0
    torch.cuda.synchronize()
    assert lib.generic_fwd_phase_cycles(cyc) == 0
    blocks = iters * -(-n // (64 // cfg.k))
    names = ("", "rows_gather", "layers_but_last", "gates", "last_layer", "ksum_store")
    per_block = {names[i]: cyc[i] / blocks for i in range(1, 6)}
    return dict(cycles_per_block=per_block, total=sum(per_block.values()),
                fwd_out_equal=bool(torch.equal(out, fmg.generic_fwd(cfg, hs, h, geo2, ws, sels))))


def tabled(fmg, model, dev, dtype, times: bool) -> dict:
    """#8 and #9 on bench.py's 250k lmax=2 graph with tables, #14 on it
    without (``--tabled``): SHA-256 digests of the outputs, CUDA-event ms and
    device ms per launch (``times``)."""
    import numpy as np

    from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph
    from scalable_e3_gnn_torch.graph.octree import build_octree
    from scalable_e3_gnn_torch.graph.radius import radius_graph_cell

    n, lo, hi, bf = 250_000, (0.0,) * 3, (1.0,) * 3, dtype
    pts = np.random.default_rng(SEED).random((n, 3)).astype(np.float32)
    tree = build_octree(pts, lo, hi, num_levels=7, device=dev)
    edges = radius_graph_cell(tree, 0.04 * (100_000 / n) ** (1 / 3), lo, hi, max_neighbors=K,
                              cell_capacity=64)
    feats = np.zeros((n, 5), np.float32)
    graph = DenseEdgeGraph.from_radius_edges(feats, tree.points, edges, symmetrize=True)
    graph = graph.with_gather_tables(tile=200)
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, K, 200)
    with torch.no_grad():
        geo = model.compute_attributes_dense(graph)[3].reshape(n, K, -1).clone()
    a = geo.shape[-1] - 2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    geo[..., a + 1] *= (torch.rand((n, K), generator=gen, device=dev) > 0.1).float()
    cfg = kern.config(a, graph.gather_tab.shape[1])
    h = torch.randn((n, cfg.f), generator=gen, device=dev).to(bf)
    d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(bf)
    args = (h, geo.reshape(n, -1).to(bf).contiguous(), graph.gather_loc, graph.gather_tab,
            [w.contiguous() for w in kern.fold(bf)], kern.selections(dev))
    with torch.no_grad():
        agg, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
        d_hu, d_hr, dws = fmg.generic_tab_bwd_kernels(cfg, *args, d_agg, ys=ys)
        r_hu, r_hr, r_dws = fmg.generic_tab_bwd_kernels(cfg, *args, d_agg)
        from scalable_e3_gnn_torch.ops.gather_scatter import gather_km

        ucfg = kern.config(a, 0)
        hs = gather_km(h, graph.senders)
        v_hs, v_hr, v_dws = fmg.generic_bwd_vjp_kernels(ucfg, hs, *args[:2], *args[4:], d_agg,
                                                        200)
        torch.cuda.synchronize()
        digests = {nm: _digest(t) for nm, t in (("agg", agg), ("y1", ys[0]), ("y2", ys[1]),
                                                 ("d_hu", d_hu), ("d_hr", d_hr), ("dw1", dws[0]),
                                                 ("dw2", dws[1]), ("rep_d_hu", r_hu),
                                                 ("rep_d_hr", r_hr), ("rep_dw1", r_dws[0]),
                                                 ("rep_dw2", r_dws[1]), ("vjp_d_hs", v_hs),
                                                 ("vjp_d_hr", v_hr), ("vjp_dw1", v_dws[0]),
                                                 ("vjp_dw2", v_dws[1]))}
        del hs, v_hs, v_hr, v_dws, r_hu, r_hr, r_dws
        if not times:
            return dict(points=n, k=K, tile=200, digests=digests)
        times = dict(
            fwd_ms=_events(lambda: fmg.generic_tab_fwd(cfg, *args), 5),
            save_ms=_events(lambda: fmg.generic_tab_fwd(cfg, *args, save=True), 3),
            bwd9_ms=_events(lambda: fmg.generic_tab_bwd_kernels(cfg, *args, d_agg, ys=ys), 3),
            chain9_ms=_events(lambda: fmg.generic_tab_bwd_chain(cfg, *args, d_agg, ys), 3))
        device = dict(fwd=_device(lambda: fmg.generic_tab_fwd(cfg, *args), 5),
                      bwd9=_device(lambda: fmg.generic_tab_bwd_kernels(cfg, *args, d_agg, ys=ys),
                                   3))
    return dict(points=n, k=K, tile=200, valid_slots=int((geo[..., a + 1] > 0).sum()),
                edges_symmetrized=int(graph.edge_mask.sum()), digests=digests, times=times,
                device=device, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--clocks", default="", help="scratch directory for the profiling build")
    ap.add_argument("--act", default="silu", help="the gate activation (ops/gate.py)")
    ap.add_argument("--tabled", action="store_true", help="#8 and #9 at the 250k graph")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="float32: the fp32 instances, digests only")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import scalable_e3_gnn_torch
    from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
    from scalable_e3_gnn_torch.models.segnn import SEGNN

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), getattr(torch, args.dtype)
    times = args.dtype == "bfloat16"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    act = {}
    if args.act != "silu":
        from scalable_e3_gnn_torch.ops.gate import ACTIVATIONS

        act = dict(act={a.name: a.fn for a in ACTIVATIONS}[args.act])
    model = SEGNN("2x0e+1x1o", HIDDEN, "1x1o", lmax_attr=2, num_layers=1, layout="cm",
                  use_pallas=True, device=dev, generator=torch.Generator().manual_seed(0), **act)
    if args.tabled:
        out = tabled(fmg, model, dev, bf, times)
        print(json.dumps(dict(tag=args.tag, act=args.act, dtype=args.dtype,
                              package=scalable_e3_gnn_torch.__file__, card=card, **out)),
              flush=True)
        return 0
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, K, 200, residual_bwd=False)
    cfg = kern.config(9, 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = N_BLOCK
    h_ext = torch.randn((N_CLOUD, cfg.f), generator=gen, device=dev).to(bf)
    senders = torch.randint(0, N_CLOUD, (n, K), generator=gen, device=dev)
    hs = h_ext[senders.t()].contiguous()
    h = h_ext[:n].contiguous()
    del h_ext, senders
    geo = torch.randn((n, K, cfg.a + 2), generator=gen, device=dev)
    geo[..., cfg.a] = torch.rand((n, K), generator=gen, device=dev) * 0.01
    geo[..., cfg.a + 1] = (torch.rand((n, K), generator=gen, device=dev) > 0.1).float()
    geo[n - 37:, :, cfg.a + 1] = 0.0
    geo2 = geo.reshape(n, -1).to(bf).contiguous()
    del geo
    d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(bf)
    ws = [w.contiguous() for w in kern.fold(bf)]
    sels = kern.selections(dev)
    a = (hs, h, geo2, ws, sels)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = fmg._wgrad_splits(cfg, n * K, sms)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        agg = fmg.generic_fwd(cfg, *a)
        agg_s, ys = fmg.generic_fwd(cfg, *a, save=True)
        d_hs, d_hr, dws = fmg.generic_bwd_kernels(cfg, *a, d_agg)
        res_hs, res_hr, res_dws = fmg.generic_bwd_kernels(cfg, *a, d_agg, ys=ys)
        dys, ms = _chain_rows(fmg.generic_bwd_chain(cfg, *a, d_agg))
        wgrad = lambda: _wgrad_untabled(fmg, cfg, hs, h, geo2, dys, ms, splits)
        part = wgrad()
        torch.cuda.synchronize()
        digests = {nm: _digest(t) for nm, t in (
            ("agg", agg), ("agg_save", agg_s), ("y1", ys[0]), ("y2", ys[1]), ("d_hs", d_hs),
            ("d_hr", d_hr), ("dw1", dws[0]), ("dw2", dws[1]), ("dy1", dys[0]), ("dy2", dys[1]),
            ("m1", ms[1]), ("res_d_hs", res_hs), ("res_d_hr", res_hr), ("res_dw1", res_dws[0]),
            ("res_dw2", res_dws[1]))}
        digests["wgrad_sum"] = _digest(part.sum(0))
        del agg_s, ys, d_hs, d_hr, dws, res_hs, res_hr, res_dws
        if not times:
            print(json.dumps(dict(tag=args.tag, act=args.act, dtype=args.dtype, card=card,
                                  package=scalable_e3_gnn_torch.__file__, block=n, k=K,
                                  digests=digests)), flush=True)
            return 0
        times = dict(
            fwd_ms=_events(lambda: fmg.generic_fwd(cfg, *a), 5),
            save_ms=_events(lambda: fmg.generic_fwd(cfg, *a, save=True), 3),
            rep_ms=_events(lambda: fmg.generic_bwd_kernels(cfg, *a, d_agg), 3),
            chain_ms=_events(lambda: fmg.generic_bwd_chain(cfg, *a, d_agg), 3),
            wgrad_ms=_events(wgrad, 3))
        device = dict(fwd=_device(lambda: fmg.generic_fwd(cfg, *a), 5),
                      rep=_device(lambda: fmg.generic_bwd_kernels(cfg, *a, d_agg), 3))
        clocks = dict(fwd=phase_clocks(fmg, cfg, *a, Path(args.clocks)),
                      wgrad=wgrad_clocks(fmg, cfg, hs, h, geo2, dys, ms, splits,
                                         Path(args.clocks))) if args.clocks else None
    print(json.dumps(dict(
        tag=args.tag, act=args.act, dtype=args.dtype, package=scalable_e3_gnn_torch.__file__,
        card=card, block=n,
        k=K,
        splits=splits, valid_slots=int((geo2.view(n, K, -1)[..., -1] > 0).sum()),
        plan_tiles=dict(fwd=cfg.plan.counts("fwd"), dm=cfg.plan.counts("dm"))
        if getattr(cfg, "plan", None) is not None else None,
        digests=digests, times=times, device=device, phase_clocks=clocks,
        sm_clock_mhz=subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                     "--format=csv,noheader"], capture_output=True, text=True,
                                    timeout=60).stdout.strip(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
