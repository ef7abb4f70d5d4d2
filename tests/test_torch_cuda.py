"""PyTorch port on the GPU: the hand-written CUDA kernels (the lmax=1 forward,
and the backward with its epilogue) against their plain PyTorch versions at
three widths, config 3's among them, the backward's determinism, and the SEGNN
forward and gradients through the kernels against the plain path; the generic
(lmax=2) forward kernel against its plain version at three widths, the
lmax=2 config's among them, and the lmax=2 SEGNN forward through it; its save
mode and the generic backward kernels (#9 residual, #10 replay, with the
weight-gradient kernel, the table sum and the reduction) against their plain
versions, #9 against #10, their determinism, and lmax=2 SEGNN gradients
through them against the plain path; the untabled kernels (#11 with its
save mode, #12 residual, #13 replay) against their plain versions, #12
against #13, their determinism, and lmax=2 SEGNN gradients through them
(no tables, the sym-regather entry, and edge_chunks with remat_layers)
against the plain path; the untabled lmax=1 kernels (#3 forward, #5
backward with the reduction) against their plain versions at three widths,
#5's determinism, and config-3-width SEGNN gradients through them
(symmetrized, unsymmetrized, node blocks) against the plain path; the packed
lmax=1 kernels (#6 forward, #7 backward with the reduction) against their
plain versions at p = 2, 3, 4 and three widths, their determinism, and
``SEGNN(pack=p)`` gradients through them against the plain path; the
weight-gradient reduction bit for bit against the in-order fold at its three
main-path shapes, odd widths and an unaligned base; the halo ring (#15)
against its plain version bit for bit at P = 1-8 (odd H and F, and F = 80
in both dtypes), its gradient and wrapper checks, #15 between two processes
on the card bit for bit gloo's all-gather (and a skipped publish raising),
the worker's two-rank ring worlds (dense and COO) bit for bit its all_gather
worlds, a forward alone raising on both ranks when one skips a publish,
the generic kernels #8-#14 under the gate activations besides silu (every
route against its plain version in fp32 and bf16, lmax=2 SEGNN gradients
against the plain path, the raise outside the set, no spill in any
activation's build beyond silu's), and a 4-way partitioned
SEGNN on the card (both exchange backends) against the unpartitioned plain
path; the COO partitioned path on the card (both backends) against the
unpartitioned COO model, the dense dp step (2 clouds x 4 partitions) through
#3/#5 against the plain path's mean of the clouds' losses, and the
overlapped exchange against the serialized one, bit for bit; and #8-#14 at
one and three message layers (``SEGNNLayer(num_message_layers=L)``: every
route against its plain version in fp32 and bf16, three A=36 layers, lmax=2
SEGNN gradients through the residual, replay and vjp backwards against the
plain path; ``-k msg_layers``); and #8-#14 at hidden widths past the bench
configs' (C1 > 192, D > 128: every route against its plain version in fp32
and bf16 at three widths, the blocked walks over the plan's tiles bitwise
over every tile, #11/#14 at A=36, SEGNN gradients against the plain path,
the raise past the shared-memory bound, no spill in the silu builds;
``-k wide``); and the lmax=1 kernels #1-#7 in bf16 past 32x0e+16x1o on
the Wide kernels (every addressing, forward and backward, against its
plain version at four widths, their determinism, the Wide kernels bit for
bit the Bench kernels at the Bench widths, the raise past the
shared-memory bound; ``-k lmax1_wide``).

These tests need a CUDA card and skip without one.  They import no JAX, so
they run on a machine without it (``--noconftest`` skips the JAX-only
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from scalable_e3_gnn_torch.graph.container import DenseEdgeGraph, SteerableGraph
from scalable_e3_gnn_torch.graph.octree import build_octree
from scalable_e3_gnn_torch.graph.radius import radius_graph_cell, suggest_cell_capacity
from scalable_e3_gnn_torch.kernels import fused_message as fm
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.kernels import halo_ring as hr
from scalable_e3_gnn_torch.models import segnn as segnn_mod
from scalable_e3_gnn_torch.models.segnn import SEGNN, SEGNNLayer
from scalable_e3_gnn_torch.ops.gate import ACTIVATIONS
from scalable_e3_gnn_torch.parallel import halo as dist
from scalable_e3_gnn_torch.parallel.partition import (partition_graph, partition_graph_dense,
                                                      shared_caps)

pytestmark = pytest.mark.cuda

ACTS = {act.name: act for act in ACTIVATIONS}

LO, HI = (0.0,) * 3, (1.0,) * 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(dev, n, k, radius, tile, seed=0):
    pts = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    tree = build_octree(pts, LO, HI, num_levels=5, device=dev)
    cap = suggest_cell_capacity(tree, radius, LO, HI)
    e = radius_graph_cell(tree, radius, LO, HI, max_neighbors=k, cell_capacity=cap)
    feats = np.random.default_rng(seed + 1).standard_normal((n, 5)).astype(np.float32)
    g = DenseEdgeGraph.from_radius_edges(feats, tree.points, e, symmetrize=True)
    return g, g.with_gather_tables(tile=tile)


# (hidden irreps, K, points, table tile); the last two at config 3's width,
# K = 20 with receivers that straddle the bf16 engine's 16-row tiles
WIDTHS = [("16x0e+8x1o", 8, 200, 32), ("8x0e+12x1o", 13, 1000, 64),
          ("32x0e+16x1o", 24, 3000, 160), ("32x0e+16x1o", 20, 2000, 160)]


def _layer_args(dev, monkeypatch, hidden, k, n, tile, dtype, run=True):
    """The arguments the model hands the tabled kernel (cfg, h, geometry,
    tables, folded weights), captured from one layer's dispatch (run: the
    kernel runs on them, else zeros stand for its result)."""
    g, gt = _graph(dev, n, k, 0.25, tile)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", num_layers=1, layout="cm", use_pallas=True,
                  device=dev, generator=torch.Generator().manual_seed(1))
    layer = model.layers[0]
    attrs = model.compute_attributes_dense(gt)
    gen = torch.Generator(device=dev).manual_seed(2)
    h = torch.randn((n, model.hidden_irreps.dim), generator=gen, device=dev).to(dtype)
    calls = []
    real = fm.fused_message_aggregate_tabled
    monkeypatch.setattr(segnn_mod, "fused_message_aggregate_tabled",
                        lambda *a: calls.append(a) or (real(*a) if run else torch.zeros_like(a[1])))
    with torch.no_grad():
        layer._fused_messages_tabled(h, attrs[0].to(dtype), attrs[2].to(dtype), gt.edge_mask, gt)
    (args,) = calls
    assert args[1].shape[0] == gt.gather_loc.shape[0]
    return args


def _fwd_args(args):
    return args[:7] + args[10:]  # without the reverse tables


@pytest.mark.parametrize("hidden,k,n,tile", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, monkeypatch, hidden, k, n, tile, dtype):
    """fp32: 1e-4 * max(1, |ref|) (sum order); bf16: 3e-2 * max|ref|
    (rounding of the layer-1 outputs and the slot messages)."""
    args = _fwd_args(_layer_args(dev, monkeypatch, hidden, k, n, tile, dtype))
    before = fm.TAB_FWD.launches
    with torch.no_grad():
        got = fm.fused_message_aggregate_tabled_fwd(*args).float()
        ref = fm.fused_message_aggregate_tabled_plain(*args).float()
    torch.cuda.synchronize()
    assert fm.TAB_FWD.launches == before + 1
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    if dtype == torch.float32:
        assert (err <= 1e-4 * ref.abs().clamp(min=1.0)).all(), float(err.max())
    else:
        assert float(err.max()) <= 3e-2 * float(ref.abs().max())


def _bwd_problem(dev, monkeypatch, hidden, k, n, tile, dtype, run=True):
    """Kernel arguments with extra masked slots and a random cotangent."""
    args = list(_layer_args(dev, monkeypatch, hidden, k, n, tile, dtype, run))
    gen = torch.Generator(device=dev).manual_seed(3)
    maskf = args[4]
    args[4] = (maskf * (torch.rand(maskf.shape, generator=gen, device=dev) > 0.1)).to(dtype)
    d_agg = torch.randn(args[1].shape, generator=gen, device=dev).to(dtype)
    return args, d_agg


@pytest.mark.parametrize("hidden,k,n,tile", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(dev, monkeypatch, hidden, k, n, tile, dtype):
    """The backward kernel + epilogue against the plain backward.  fp32: d_h
    1e-4 * max(1, |ref|) elementwise (sum order), each weight gradient 1e-4 *
    its max|ref| (sums over every slot); bf16: 5e-2 * max|ref| (the cotangent
    intermediates round to bf16)."""
    args, d_agg = _bwd_problem(dev, monkeypatch, hidden, k, n, tile, dtype)
    before = (fm.TAB_BWD.launches, fm.TAB_BWD_REDUCE.launches)
    got = fm.fused_message_aggregate_tabled_bwd(*args, d_agg)
    ref = fm.fused_message_aggregate_tabled_bwd_plain(*args, d_agg)
    torch.cuda.synchronize()
    assert (fm.TAB_BWD.launches, fm.TAB_BWD_REDUCE.launches) == (before[0] + 1, before[1] + 1)
    for i, (x, y) in enumerate(zip(got, ref, strict=True)):
        assert x.dtype == y.dtype and x.shape == y.shape
        x, y = x.float(), y.float()
        assert torch.isfinite(x).all()
        err = (x - y).abs()
        if dtype == torch.float32 and i == 0:
            assert (err <= 1e-4 * y.abs().clamp(min=1.0)).all(), float(err.max())
        elif dtype == torch.float32:
            assert float(err.max()) <= 1e-4 * float(y.abs().max()), (i, float(err.max()))
        else:
            assert float(err.max()) <= 5e-2 * float(y.abs().max()), (i, float(err.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_is_deterministic(dev, monkeypatch, dtype):
    """Two runs give bit-identical gradients: the weight-gradient partials
    are summed in block order and the table rows in slot order."""
    args, d_agg = _bwd_problem(dev, monkeypatch, *WIDTHS[2], dtype)
    one = fm.fused_message_aggregate_tabled_bwd(*args, d_agg)
    two = fm.fused_message_aggregate_tabled_bwd(*args, d_agg)
    for x, y in zip(one, two, strict=True):
        assert torch.equal(x, y)


def test_segnn_gradients_kernel_match_plain_path(dev):
    """fp32 MSE-loss gradients of every parameter through the kernels and
    through autograd of the plain path: 1e-4 * max|ref| per parameter."""
    g, gt = _graph(dev, 2000, 12, 0.12, 160)
    m_k = SEGNN("2x0e+1x1o", "16x0e+8x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=True, device=dev, generator=torch.Generator().manual_seed(4))
    m_p = SEGNN("2x0e+1x1o", "16x0e+8x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((2000, 3), generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    before = fm.TAB_BWD.launches
    ((m_k(gt) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    assert fm.TAB_BWD.launches == before + 2
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


def test_segnn_forward_kernel_matches_plain_path(dev):
    g, gt = _graph(dev, 2000, 12, 0.12, 160)
    m_k = SEGNN("2x0e+1x1o", "16x0e+8x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=True, device=dev, generator=torch.Generator().manual_seed(3))
    m_p = SEGNN("2x0e+1x1o", "16x0e+8x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    before = fm.TAB_FWD.launches
    with torch.no_grad():
        got, ref = m_k(gt), m_p(g)
    assert fm.TAB_FWD.launches == before + 2
    assert (got - ref).abs().max() <= 1e-4 * max(1.0, float(ref.abs().max()))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g, gt = _graph(dev, 200, 8, 0.25, 32)
    cfg = fm.MessageConfig(hs=16, hv=8, k=8, tile=32, u=gt.gather_tab.shape[1])
    npad = gt.gather_loc.shape[0]
    h = torch.zeros((npad, cfg.f), device=dev, dtype=torch.float16)
    geo = lambda w: torch.zeros((npad * 8, w), device=dev, dtype=torch.float16)
    ws = [torch.zeros(s, device=dev, dtype=torch.float16) for s in
          ((49, 24), (49, 8), (24, 24), (24, 8))]
    args = (cfg, h, geo(1), geo(4), geo(1), gt.gather_loc.reshape(-1, 1), gt.gather_tab)
    tabs = (gt.gather_rev_dense, gt.gather_rem_pos, gt.gather_rem_node)
    with pytest.raises(TypeError):
        fm.fused_message_aggregate_tabled_fwd(*args, *ws)
    with pytest.raises(TypeError):
        fm.fused_message_aggregate_tabled_bwd(*args, *tabs, *ws, torch.zeros_like(h))


# the lmax=1 kernels past the Bench kernels' widths (#1-#7 on the Wide
# kernels, ``-k lmax1_wide``): each multiplicity past its cap alone, neither
# a multiple of the padding, twice the bench width in both, and the
# instances m = 3 and m = 4
L1_WIDE = ["48x0e+16x1o", "32x0e+24x1o", "40x0e+20x1o", "64x0e+32x1o", "96x0e+48x1o",
           "128x0e+64x1o"]
# twice the bench width (the fp32 check path's and the reruns' width)
L1_TWICE = "64x0e+32x1o"
# a width past the Wide kernels' largest instance (m = 5)
L1_PAST_SMEM = "160x0e+80x1o"


@pytest.mark.parametrize("hidden", L1_WIDE)
def test_lmax1_wide_tabled_matches_plain(dev, monkeypatch, hidden):
    """#1, and #2 with the reduction and the epilogue, in bf16 at a wide
    width against the plain versions under the bench width's limits (3e-2
    and 5e-2 of max|ref|)."""
    args, d_agg = _bwd_problem(dev, monkeypatch, hidden, 24, 3000, 160, torch.bfloat16)
    before = (fm.TAB_FWD.launches, fm.TAB_BWD.launches, fm.TAB_BWD_REDUCE.launches)
    with torch.no_grad():
        got = fm.fused_message_aggregate_tabled_fwd(*_fwd_args(args)).float()
        ref = fm.fused_message_aggregate_tabled_plain(*_fwd_args(args)).float()
    bgot = fm.fused_message_aggregate_tabled_bwd(*args, d_agg)
    bref = fm.fused_message_aggregate_tabled_bwd_plain(*args, d_agg)
    torch.cuda.synchronize()
    assert (fm.TAB_FWD.launches, fm.TAB_BWD.launches, fm.TAB_BWD_REDUCE.launches) == tuple(
        b + 1 for b in before)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 3e-2 * float(ref.abs().max())
    for i, (x, y) in enumerate(zip(bgot, bref, strict=True)):
        assert x.dtype == y.dtype and x.shape == y.shape
        x, y = x.float(), y.float()
        assert torch.isfinite(x).all(), i
        assert float((x - y).abs().max()) <= 5e-2 * float(y.abs().max()), i


@pytest.mark.parametrize("hidden", L1_WIDE)
def test_lmax1_wide_km_matches_plain(dev, hidden):
    """#3 and #5 (+ the reduction) in bf16 at a wide width against their
    plain versions under the bench width's limits (_check_generic,
    _check_bwd); receivers without a valid slot give exact zeros."""
    cfg, args, ws, d_agg = _km_problem(dev, hidden, 24, 2000, 2, torch.bfloat16)
    before = (fm.KM_FWD.launches, fm.KM_BWD.launches)
    with torch.no_grad():
        got = fm.fused_message_aggregate_km_fwd(cfg, *args, *ws)
        ref = fm.fused_message_aggregate_km_plain(cfg, *args, *ws)
        ws6 = fm.split_weights(cfg, *ws)
        bgot = fm.km_bwd_kernels(cfg, *args, ws6, d_agg)
        bref = fm.km_bwd_plain(cfg, *args, ws6, d_agg)
    torch.cuda.synchronize()
    assert (fm.KM_FWD.launches, fm.KM_BWD.launches) == (before[0] + 1, before[1] + 1)
    _check_generic(got, ref, torch.bfloat16)
    assert (got[1000 - 37:1000] == 0).all()
    _check_bwd(bgot, bref, torch.bfloat16)


@pytest.mark.parametrize("hidden", L1_WIDE)
def test_lmax1_wide_flat_matches_plain(dev, hidden):
    """#6 and #7 (+ the reduction) at p = 2 in bf16 at a wide width against
    their plain versions, as test_lmax1_wide_km_matches_plain."""
    cfg, args, ws, d_agg = _flat_problem(dev, hidden, 24, 2000, 2, 2, torch.bfloat16)
    before = (fm.FLAT_FWD.launches, fm.FLAT_BWD.launches)
    with torch.no_grad():
        got = fm.fused_message_aggregate_fwd(cfg, *args, *ws)
        ref = fm.fused_message_aggregate_plain(cfg, *args, *ws)
        ws6 = fm.split_weights(cfg, *ws)
        bgot = fm.flat_bwd_kernels(cfg, *args, ws6, d_agg)
        bref = fm.flat_bwd_plain(cfg, *args, ws6, d_agg)
    torch.cuda.synchronize()
    assert (fm.FLAT_FWD.launches, fm.FLAT_BWD.launches) == (before[0] + 1, before[1] + 1)
    _check_generic(got, ref, torch.bfloat16)
    assert (got[1000 - 37:1000] == 0).all()
    _check_bwd(bgot, bref, torch.bfloat16)


def test_lmax1_wide_fp32_matches_plain(dev, monkeypatch):
    """The fp32 kernels (the FMA check path) at 64x0e+32x1o, where their
    rows and weights do not fit shared memory beside each other: smaller
    groups, the backward's weight gradients and weights in global memory.
    Every addressing against its plain version: 1e-4 * max(1, |ref|)
    elementwise (agg, d_h, d_hs, d_hr), 1e-4 * max|ref| per weight block."""
    hidden = L1_TWICE
    args, d_agg = _bwd_problem(dev, monkeypatch, hidden, 24, 3000, 160, torch.float32)
    cfg, a, ws, k_agg = _km_problem(dev, hidden, 24, 2000, 2, torch.float32)
    fcfg, fa, fws, f_agg = _flat_problem(dev, hidden, 24, 2000, 2, 2, torch.float32)
    with torch.no_grad():
        pairs = [
            (fm.fused_message_aggregate_tabled_fwd(*_fwd_args(args)),
             fm.fused_message_aggregate_tabled_plain(*_fwd_args(args))),
            (fm.fused_message_aggregate_km_fwd(cfg, *a, *ws),
             fm.fused_message_aggregate_km_plain(cfg, *a, *ws)),
            (fm.fused_message_aggregate_fwd(fcfg, *fa, *fws),
             fm.fused_message_aggregate_plain(fcfg, *fa, *fws))]
        bwds = [(fm.fused_message_aggregate_tabled_bwd(*args, d_agg),
                 fm.fused_message_aggregate_tabled_bwd_plain(*args, d_agg)),
                (fm.fused_message_aggregate_km_bwd(cfg, *a, *ws, k_agg),
                 fm.fused_message_aggregate_km_bwd_plain(cfg, *a, *ws, k_agg)),
                (fm.fused_message_aggregate_bwd(fcfg, *fa, *fws, f_agg),
                 fm.fused_message_aggregate_bwd_plain(fcfg, *fa, *fws, f_agg))]
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert torch.isfinite(got).all()
        assert ((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all()
    for got, ref in bwds:
        n_act = 1 if len(got) == 5 else 2  # the tabled d_h, or d_hs and d_hr
        for i, (x, y) in enumerate(zip(got, ref, strict=True)):
            err = (x - y).abs()
            if i < n_act:
                assert (err <= 1e-4 * y.abs().clamp(min=1.0)).all(), (i, float(err.max()))
            else:
                assert float(err.max()) <= 1e-4 * float(y.abs().max()), (i, float(err.max()))


def _lmax1_routes(dev, monkeypatch, hidden):
    """Every lmax=1 route's forward and backward outputs in bf16 at a width
    (the backward's per-block partials, before the reduction)."""
    out = {}
    args, d_agg = _bwd_problem(dev, monkeypatch, hidden, 24, 3000, 160, torch.bfloat16)
    cfg = args[0]
    ws6 = fm.split_weights(cfg, *args[10:])
    with torch.no_grad():
        out["tab"] = (fm.fused_message_aggregate_tabled_fwd(*_fwd_args(args)),
                      *fm.tab_bwd_kernel(cfg, *args[1:7], ws6, d_agg))
        cfg, a, ws, d_agg = _km_problem(dev, hidden, 24, 2000, 2, torch.bfloat16)
        out["km"] = (fm.fused_message_aggregate_km_fwd(cfg, *a, *ws),
                     *fm.km_bwd_kernel(cfg, *a, fm.split_weights(cfg, *ws), d_agg))
        cfg, a, ws, d_agg = _flat_problem(dev, hidden, 24, 2000, 2, 2, torch.bfloat16)
        out["flat"] = (fm.fused_message_aggregate_fwd(cfg, *a, *ws),
                       *fm.flat_bwd_kernel(cfg, *a, fm.split_weights(cfg, *ws), d_agg))
    torch.cuda.synchronize()
    return out


def test_lmax1_wide_is_deterministic(dev, monkeypatch):
    """Two runs of every route at 64x0e+32x1o are bitwise equal: the Wide
    backward's weight-gradient jobs each sum in a fixed order."""
    one = _lmax1_routes(dev, monkeypatch, L1_TWICE)
    two = _lmax1_routes(dev, monkeypatch, L1_TWICE)
    for route in one:
        for x, y in zip(one[route], two[route], strict=True):
            assert torch.equal(x, y), route


@pytest.mark.parametrize("hidden", ["32x0e+16x1o", "16x0e+8x1o"])
def test_lmax1_wide_kernels_are_bench_bitwise(dev, monkeypatch, hidden):
    """The Wide kernels' block walk at widths the Bench kernels take (the
    Bench bound set to 0 sends bf16 to the Wide library): one block of each
    kind over the Bench order of k-steps, so every output, the backward's
    partials among them, is the Bench kernels' bit for bit."""
    bench = _lmax1_routes(dev, monkeypatch, hidden)
    monkeypatch.setattr(fm, "BENCH_HS", 0)
    wide = _lmax1_routes(dev, monkeypatch, hidden)
    for route in bench:
        for i, (x, y) in enumerate(zip(wide[route], bench[route], strict=True)):
            assert torch.equal(x, y), (route, i)


def test_lmax1_wide_past_smem_raises(dev, monkeypatch):
    """Past the Wide kernels' largest instance the bf16 wrappers raise before
    any launch, naming the widths and the largest instance, every route
    forward and backward."""
    args, t_agg = _bwd_problem(dev, monkeypatch, L1_PAST_SMEM, 8, 256, 32, torch.bfloat16,
                               run=False)
    t_ws6 = fm.split_weights(args[0], *args[10:])
    cfg, a, ws, d_agg = _km_problem(dev, L1_PAST_SMEM, 8, 256, 1, torch.bfloat16)
    ws6 = fm.split_weights(cfg, *ws)
    fa = _flat_problem(dev, L1_PAST_SMEM, 8, 256, 1, 2, torch.bfloat16)
    kerns = (fm.TAB_FWD, fm.TAB_BWD, fm.KM_FWD, fm.KM_BWD, fm.FLAT_FWD, fm.FLAT_BWD)
    before = [kern.launches for kern in kerns]
    calls = (lambda: fm.fused_message_aggregate_tabled_fwd(*_fwd_args(args)),
             lambda: fm.tab_bwd_kernel(args[0], *args[1:7], t_ws6, t_agg),
             lambda: fm.fused_message_aggregate_km_fwd(cfg, *a, *ws),
             lambda: fm.km_bwd_kernel(cfg, *a, ws6, d_agg),
             lambda: fm.fused_message_aggregate_fwd(fa[0], *fa[1], *fa[2]),
             lambda: fm.flat_bwd_kernel(fa[0], *fa[1], fm.split_weights(fa[0], *fa[2]), fa[3]))
    for call in calls:
        with pytest.raises(ValueError, match="the largest instance built is m = 4"):
            call()
    assert [kern.launches for kern in kerns] == before


def test_lmax1_bf16_kernels_do_not_spill(dev, tmp_path):
    """Every bf16 engine kernel the two lmax=1 builds hold (#1-#7 on the
    Bench and the Wide kernels, each addressing): ptxas reports no spill."""
    import re
    import subprocess

    from scalable_e3_gnn_torch.kernels import build

    seen = []
    # each source's plain build and its Wide kernels' (LMAX1_WIDE=1)
    for name, defines in [(nm, d) for nm in ("fused_message_tab_fwd", "fused_message_tab_bwd")
                          for d in fm._VARIANTS]:
        out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                              "-o", str(tmp_path / f"{name}{len(defines)}.so"),
                              str(build.CSRC / f"{name}.cu")], capture_output=True, text=True,
                             check=True)
        log = out.stdout + out.stderr
        for entry in re.split(r"Compiling entry function", log)[1:]:
            fn = entry.split("'")[1]
            if "_mma" not in fn:
                continue
            seen.append(fn)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            assert spill is not None and spill.groups() == ("0", "0"), entry[:300]
    # the Bench and the Wide kernels, forward and backward, are among them
    for kern in ("fwd_mma", "bwd_mma", "fwd_wide_mma", "bwd_wide_mma"):
        assert any(f"fused_message_{kern}" in fn for fn in seen), (kern, seen)


# (hidden irreps, K, points): tiles 160, 192 and 200 (_pick_generic_tile);
# the last is the lmax=2 config's width
GENERIC_WIDTHS = [("4x0e+2x1o+2x2e", 8, 480), ("8x0e+4x1o+3x2e", 13, 960),
                  ("24x0e+12x1o+6x2e", 16, 2000)]


def _generic_problem(dev, hidden, k, n, dtype, seed=0):
    """Kernel #8's arguments from an lmax=2 model's first layer on a real
    graph: random features, a masked tail (the last 37 receivers without
    senders or valid slots) and extra masked slots."""
    tile = SEGNNLayer._pick_generic_tile(n)
    _, gt = _graph(dev, n, k, 0.25, tile, seed=seed)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", lmax_attr=2, num_layers=1, layout="cm",
                  use_pallas=True, device=dev, generator=torch.Generator().manual_seed(seed))
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, k, tile)
    geo = model.compute_attributes_dense(gt)[3].reshape(n, k, -1).clone()
    a = geo.shape[-1] - 2
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).float()
    geo[n - 37:, :, a + 1] = 0.0
    cfg = kern.config(a, gt.gather_tab.shape[1])
    loc = gt.gather_loc.clone()
    loc[n - 37:] = cfg.u
    h = torch.randn((n, cfg.f), generator=gen, device=dev)
    h[n - 37:] = 0.0
    args = (h.to(dtype), geo.reshape(n, -1).to(dtype).contiguous(), loc, gt.gather_tab,
            [w.contiguous() for w in kern.fold(dtype)], kern.selections(dev))
    return cfg, args


def _check_generic(got, ref, dtype):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    if dtype == torch.float32:
        assert (err <= 1e-4 * ref.abs().clamp(min=1.0)).all(), float(err.max())
    else:
        r = ref.abs()
        ulp = torch.exp2(torch.floor(torch.log2(r.clamp(min=float(r.mean())))) - 7)
        ulps = err / ulp
        assert float(ulps.max()) <= 4, float(ulps.max())
        assert float((ulps > 1).float().mean()) <= 0.01


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_kernel_matches_plain(dev, hidden, k, n, dtype):
    """fp32: 1e-4 * max(1, |ref|) (sum order); bf16, where both round at the
    same points: 4 bf16 ulps of max(|ref|, mean|ref|) elementwise, at most 1%
    of the elements over 1 ulp (a sum order flips a rounding now and then)."""
    cfg, args = _generic_problem(dev, hidden, k, n, dtype)
    before = fmg.GENERIC_TAB_FWD.launches
    with torch.no_grad():
        got = fmg.generic_tab_fwd(cfg, *args)
        ref = fmg.generic_tab_fwd_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fmg.GENERIC_TAB_FWD.launches == before + 1
    assert got.shape == ref.shape == (n, cfg.out_dim) and got.dtype == dtype
    _check_generic(got, ref, dtype)
    assert (got[n - 37:] == 0).all()  # no valid slot: an exact zero


# a width whose bf16 blocks need more shared memory than the card has
# (C1 = 961, D = 576: the forward 268,576 bytes, the backward 397,008)
PAST_SMEM = "128x0e+64x1o+32x2e"


def test_generic_kernel_wide_bf16_raises(dev):
    """Past the shared-memory bound (a block's rows do not fit) the bf16
    wrappers raise, naming the bytes, before any launch, the tabled and the
    untabled forward alike."""
    cfg, args = _generic_problem(dev, PAST_SMEM, 8, 480, torch.bfloat16)
    assert cfg.widths[0][0] > 192 and cfg.widths[0][1] > 128
    before = fmg.GENERIC_TAB_FWD.launches, fmg.GENERIC_FWD.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fmg.generic_tab_fwd(cfg, *args)
    h = args[0]
    hs = h[None].expand(cfg.k, *h.shape).contiguous()
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fmg.generic_fwd(dataclasses.replace(cfg, u=0), hs, h, *args[1:2], *args[4:])
    assert (fmg.GENERIC_TAB_FWD.launches, fmg.GENERIC_FWD.launches) == before


def test_generic_segnn_forward_kernel_matches_plain_path(dev):
    """The lmax=2 SEGNN forward through kernel #8 (one launch per layer)
    against the plain path, fp32: 1e-4 * max(1, max|ref|)."""
    n = 2000
    g, gt = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    m_k = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", lmax_attr=2, num_layers=2,
                layout="cm", use_pallas=True, device=dev,
                generator=torch.Generator().manual_seed(3))
    m_p = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", lmax_attr=2, num_layers=2,
                layout="cm", use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    before = fmg.GENERIC_TAB_FWD.launches
    with torch.no_grad():
        got, ref = m_k(gt), m_p(g)
    assert fmg.GENERIC_TAB_FWD.launches == before + 2
    assert (got - ref).abs().max() <= 1e-4 * max(1.0, float(ref.abs().max()))


def test_generic_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, args = _generic_problem(dev, *GENERIC_WIDTHS[0], torch.float32)
    h, geo2, loc, gtab, ws, sels = args
    strided = torch.empty((geo2.shape[0], 2 * geo2.shape[1]), device=dev)[:, ::2]
    strided.copy_(geo2)
    with pytest.raises(ValueError, match="contiguous"):
        fmg.generic_tab_fwd(cfg, h, strided, loc, gtab, ws, sels)
    with pytest.raises(ValueError, match="must be on"):
        fmg.generic_tab_fwd(cfg, h, geo2, loc.cpu(), gtab, ws, sels)
    with pytest.raises(TypeError):
        fmg.generic_tab_fwd(cfg, h.half(), geo2.half(), loc, gtab, [w.half() for w in ws], sels)


def _generic_bwd_problem(dev, hidden, k, n, dtype):
    cfg, args = _generic_problem(dev, hidden, k, n, dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(dtype)
    return cfg, args, d_agg


def _check_bwd(got, ref, dtype):
    """d_hu and d_hr elementwise (fp32: 1e-4 * max(1, |ref|)); the weight
    gradients against their max|ref| (fp32: 1e-4, sums over every slot in
    another order); bf16, where kernel and plain version round at the same
    points: elementwise within 8 bf16 ulps of max(|ref|, mean|ref|), at most
    1% of the elements over 1 ulp (an fp32 sum in another order flips a
    rounding of dy or dm now and then, and the sums carry it on; at the
    lmax=2 config's shapes the worst reading was 5 ulps and 3.4e-5)."""
    d_hu, d_hr, dws = got
    r_hu, r_hr, rws = ref
    for i, (x, y) in enumerate([(d_hu, r_hu), (d_hr, r_hr), *zip(dws, rws)]):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        x, y = x.float(), y.float()
        assert torch.isfinite(x).all(), i
        err = (x - y).abs()
        if dtype == torch.float32:
            scale = y.abs().clamp(min=1.0) if i < 2 else float(y.abs().max())
            assert (err <= 1e-4 * scale).all(), (i, float(err.max()))
        else:
            r = y.abs()
            ulp = torch.exp2(torch.floor(torch.log2(r.clamp(min=float(r.mean())))) - 7)
            ulps = err / ulp
            assert float(ulps.max()) <= 8, (i, float(ulps.max()))
            assert float((ulps > 1).float().mean()) <= 0.01, (i, float((ulps > 1).float().mean()))


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_fwd_save_matches_plain(dev, hidden, k, n, dtype):
    """Kernel #8 in save mode: agg equal to the kernel without save, agg and
    both ys against the plain version as in test_generic_kernel_matches_plain."""
    cfg, args = _generic_problem(dev, hidden, k, n, dtype)
    with torch.no_grad():
        agg, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
        ref_agg, ref_ys = fmg.generic_tab_fwd_plain(cfg, *args, save=True)
        assert torch.equal(agg, fmg.generic_tab_fwd(cfg, *args))
    torch.cuda.synchronize()
    for got, ref in [(agg, ref_agg), *zip(ys, ref_ys)]:
        assert got.shape == ref.shape and got.dtype == dtype
        _check_generic(got, ref, dtype)


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
def test_generic_bwd_kernels_match_plain(dev, hidden, k, n, dtype, residual):
    """#9 (from #8's saved ys) or #10 (replay), with the weight-gradient
    kernel, the table sum and the reduction, against the plain backward;
    each kernel's counter moves by one."""
    cfg, args, d_agg = _generic_bwd_problem(dev, hidden, k, n, dtype)
    with torch.no_grad():
        ys = fmg.generic_tab_fwd(cfg, *args, save=True)[1] if residual else None
        kerns = (fmg.GENERIC_TAB_BWD_RES, fmg.GENERIC_TAB_BWD_REP, fmg.GENERIC_TAB_BWD_WGRAD,
                 fmg.GENERIC_TAB_BWD_TABLE, fm.TAB_BWD_REDUCE)
        before = [kern.launches for kern in kerns]
        got = fmg.generic_tab_bwd(cfg, *args, d_agg, ys=ys)
        torch.cuda.synchronize()
        moved = [kern.launches - b for kern, b in zip(kerns, before)]
        assert moved == [int(residual), int(not residual), 1, 1, 1]
        ref = fmg.generic_tab_bwd_plain(cfg, *args, d_agg, ys=ys)
    _check_bwd(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_bwd_residual_equals_replay_and_reruns(dev, dtype):
    """#9 from #8's saved ys and #10 replaying them run the same arithmetic:
    bitwise equal; two runs of each bitwise equal (no float atomics)."""
    cfg, args, d_agg = _generic_bwd_problem(dev, *GENERIC_WIDTHS[2], dtype)
    with torch.no_grad():
        ys = fmg.generic_tab_fwd(cfg, *args, save=True)[1]
        runs = [fmg.generic_tab_bwd(cfg, *args, d_agg, ys=y) for y in (ys, None, ys, None)]
    flat = [[r[0], r[1], *r[2]] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other, strict=True))


def test_generic_bwd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, args, d_agg = _generic_bwd_problem(dev, *GENERIC_WIDTHS[0], torch.float32)
    h, geo2, loc, gtab, ws, sels = args
    strided = torch.empty((d_agg.shape[0], 2 * d_agg.shape[1]), device=dev)[:, ::2]
    strided.copy_(d_agg)
    with pytest.raises(ValueError, match="contiguous"):
        fmg.generic_tab_bwd(cfg, *args, strided)
    with pytest.raises(ValueError, match="must be on"):
        fmg.generic_tab_bwd(cfg, h, geo2, loc, gtab, ws, sels, d_agg.cpu())
    wide_cfg, wide_args, wide_d = _generic_bwd_problem(dev, PAST_SMEM, 8, 480, torch.bfloat16)
    before = fmg.GENERIC_TAB_BWD_REP.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fmg.generic_tab_bwd(wide_cfg, *wide_args, wide_d)
    assert fmg.GENERIC_TAB_BWD_REP.launches == before


@pytest.mark.parametrize("mode", ["residual", "remat_kernel"])
def test_generic_segnn_gradients_kernel_match_plain_path(dev, mode):
    """fp32 MSE gradients of every parameter of a 2-layer lmax=2 SEGNN
    through #8 and #9 (residual) or #10 (remat_kernel) against autograd of
    the plain path: 1e-4 * max|ref| per parameter."""
    n = 2000
    g, gt = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    kw = dict(remat=True, remat_kernel=True, residual_bwd=False) if mode == "remat_kernel" else {}
    m_k = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", lmax_attr=2, num_layers=2,
                layout="cm", use_pallas=True, device=dev,
                generator=torch.Generator().manual_seed(6), **kw)
    m_p = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", lmax_attr=2, num_layers=2,
                layout="cm", use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(8),
                         device=dev)
    kern = fmg.GENERIC_TAB_BWD_RES if mode == "residual" else fmg.GENERIC_TAB_BWD_REP
    before = kern.launches
    ((m_k(gt) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    assert kern.launches == before + 2
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


def _untab_problem(dev, hidden, k, n, dtype):
    """The untabled kernels' arguments on kernel #8's problem: hs =
    h[senders.T] (clamped) on the same graph, h, the geometry with its masked
    tail, the folded weights, and a random cotangent."""
    cfg_tab, (h, geo2, _, _, ws, sels), d_agg = _generic_bwd_problem(dev, hidden, k, n, dtype)
    tile = SEGNNLayer._pick_generic_tile(n)
    g, _ = _graph(dev, n, k, 0.25, tile)
    hs = h[torch.clamp(g.senders.t(), max=n - 1).long()].contiguous()
    cfg = fmg.GenericConfig(k=cfg_tab.k, tile=cfg_tab.tile, u=0, a=cfg_tab.a,
                            widths=cfg_tab.widths)
    return cfg, (hs, h, geo2, ws, sels), d_agg


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("save", [False, True])
def test_untabled_fwd_kernel_matches_plain(dev, hidden, k, n, dtype, save):
    """#11 (and its save mode: agg equal to the kernel without save, both ys)
    against its plain version, as test_generic_kernel_matches_plain."""
    cfg, args, _ = _untab_problem(dev, hidden, k, n, dtype)
    before = fmg.GENERIC_FWD.launches
    with torch.no_grad():
        got = fmg.generic_fwd(cfg, *args, save=save)
        ref = fmg.generic_fwd_plain(cfg, *args, save=save)
        pairs = [(got, ref)]
        if save:
            pairs = [(got[0], ref[0]), *zip(got[1], ref[1])]
            assert torch.equal(got[0], fmg.generic_fwd(cfg, *args))
    torch.cuda.synchronize()
    assert fmg.GENERIC_FWD.launches == before + 1 + int(save)
    for x, y in pairs:
        assert x.shape == y.shape and x.dtype == dtype
        _check_generic(x, y, dtype)
    assert (pairs[0][0][n - 37:] == 0).all()  # no valid slot: an exact zero


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
def test_untabled_bwd_kernels_match_plain(dev, hidden, k, n, dtype, residual):
    """#12 (from #11's saved ys) or #13 (replay), with the weight-gradient
    kernel and the reduction, against the plain backward (d_hs [K, N, F] in
    the place of d_hu); each kernel's counter moves by one, the table sum's
    not at all."""
    cfg, args, d_agg = _untab_problem(dev, hidden, k, n, dtype)
    with torch.no_grad():
        ys = fmg.generic_fwd(cfg, *args, save=True)[1] if residual else None
        kerns = (fmg.GENERIC_BWD_RES, fmg.GENERIC_BWD_REP, fmg.GENERIC_TAB_BWD_WGRAD,
                 fmg.GENERIC_TAB_BWD_TABLE, fm.TAB_BWD_REDUCE)
        before = [kern.launches for kern in kerns]
        got = fmg.generic_bwd(cfg, *args, d_agg, ys=ys)
        torch.cuda.synchronize()
        moved = [kern.launches - b for kern, b in zip(kerns, before)]
        assert moved == [int(residual), int(not residual), 1, 0, 1]
        ref = fmg.generic_bwd_plain(cfg, *args, d_agg, ys=ys)
    assert got[0].shape == (k, n, cfg.f)
    _check_bwd(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_untabled_bwd_residual_equals_replay_and_reruns(dev, dtype):
    """#12 from #11's saved ys and #13 replaying them: bitwise equal, and
    two runs of each bitwise equal (no float atomics)."""
    cfg, args, d_agg = _untab_problem(dev, *GENERIC_WIDTHS[2], dtype)
    with torch.no_grad():
        ys = fmg.generic_fwd(cfg, *args, save=True)[1]
        runs = [fmg.generic_bwd(cfg, *args, d_agg, ys=y) for y in (ys, None, ys, None)]
    flat = [[r[0], r[1], *r[2]] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other, strict=True))


def _planned(cfg, args, d_agg):
    """The untabled problem with its folded layers' tile plan (``kern.config``)
    beside a copy of the config without one (every tile: the dense product)."""
    assert cfg.plan is not None
    return cfg, dataclasses.replace(cfg, plan=None), args, d_agg


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
def test_untabled_sparse_tiles_equal_every_tile_bitwise(dev, hidden, k, n):
    """bf16 #11 (with and without save), #12, #13 and #14 over the plan's
    nonzero tiles are bitwise the same kernels over every tile (a skipped
    tile adds exactly 0), and within the plain versions' limits; the widths
    include an odd F (35: m_0 rebuilt element by element)."""
    cfg, dense, args, d_agg = _planned(*_vjp_problem(dev, hidden, k, n, torch.bfloat16))
    assert sum(cfg.plan.counts("fwd")) < sum(fmg._tile_plan(dense).counts("fwd"))
    bt = 40
    with torch.no_grad():
        for c in (cfg, dense):
            c_out = [fmg.generic_fwd(c, *args), *fmg.generic_fwd(c, *args, save=True)[1]]
            ys = c_out[1:]
            c_out += [*fmg.generic_bwd(c, *args, d_agg)[:2], *fmg.generic_bwd(c, *args, d_agg)[2]]
            c_out += [*fmg.generic_bwd(c, *args, d_agg, ys=ys)[:2],
                      *fmg.generic_bwd(c, *args, d_agg, ys=ys)[2]]
            v = fmg.generic_bwd_vjp(c, *args, d_agg, bt)
            c_out += [v[0], v[1], *v[2]]
            if c is cfg:
                got = c_out
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, c_out, strict=True))
        _check_generic(got[0], fmg.generic_fwd_plain(cfg, *args), torch.bfloat16)
        ref = fmg.generic_bwd_plain(cfg, *args, d_agg)
    _check_bwd((got[3], got[4], got[5:7]), ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attr36_sparse_tiles_equal_every_tile_bitwise(dev, dtype):
    """At A = 36 (14% of the tiles listed) #11 and #14 over the plan's tiles
    equal the kernels over every tile bitwise, and the plain versions within
    their limits."""
    cfg, dense, args, d_agg = _planned(*_vjp_problem(dev, *GENERIC_WIDTHS[2], dtype,
                                                     lmax_attr=5))
    assert cfg.a == 36
    with torch.no_grad():
        got = [fmg.generic_fwd(c, *args) for c in (cfg, dense)]
        bwd = [fmg.generic_bwd_vjp(c, *args, d_agg, 200) for c in (cfg, dense)]
        torch.cuda.synchronize()
        assert torch.equal(*got)
        assert all(torch.equal(x, y) for x, y in zip([bwd[0][0], bwd[0][1], *bwd[0][2]],
                                                     [bwd[1][0], bwd[1][1], *bwd[1][2]]))
        _check_generic(got[0], fmg.generic_fwd_plain(cfg, *args), dtype)
        _check_bwd(bwd[0], fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 200), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_untabled_planned_residual_equals_replay_and_reruns(dev, dtype):
    """With the tile plan, #12 from #11's saved ys and #13 replaying them are
    bitwise equal, and two runs of each bitwise equal."""
    cfg, _, args, d_agg = _planned(*_vjp_problem(dev, *GENERIC_WIDTHS[2], dtype))
    with torch.no_grad():
        ys = fmg.generic_fwd(cfg, *args, save=True)[1]
        runs = [fmg.generic_bwd(cfg, *args, d_agg, ys=y) for y in (ys, None, ys, None)]
    flat = [[r[0], r[1], *r[2]] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other, strict=True))


@pytest.mark.parametrize("hidden,k,n", GENERIC_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_rebuilt_m0_equals_the_chains_bitwise(dev, hidden, k, n, dtype):
    """The weight-gradient kernel's m_0 rebuilt from hs, h and geo2 (#12 /
    #13) gives bitwise the partials of the same kernel reading the chain's
    m_0 rows, and ``_m0_rows`` is the chain's m_0 bit for bit (the vjp chain
    still writes it)."""
    cfg, args, d_agg = _vjp_problem(dev, hidden, k, n, dtype)
    hs, h, geo2 = args[:3]
    with torch.no_grad():
        _, _, dys, ms = fmg.generic_bwd_chain(cfg, *args, d_agg, vjp=True)
        assert torch.equal(fmg._m0_rows(cfg, hs, h, geo2), ms[0])
        for splits in (1, 5):
            got = fmg.generic_bwd_wgrad(cfg, hs, h, geo2, ms, dys, splits)
            ref = fmg.generic_tab_bwd_wgrad(cfg, geo2, ms, dys, splits)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), splits


UNTABLED_MODES = {  # the untabled dispatches: model settings, graph, kernels that must run
    "residual": (dict(remat=True), True, (fmg.GENERIC_FWD, fmg.GENERIC_BWD_RES)),
    "sym_regather": (dict(remat=True, remat_kernel=True), True,
                     (fmg.GENERIC_FWD, fmg.GENERIC_BWD_REP)),
    "edge_chunks": (dict(remat=True, remat_kernel=True, edge_chunks=4, remat_layers=2), False,
                    (fmg.GENERIC_FWD, fmg.GENERIC_BWD_REP)),
}


@pytest.mark.parametrize("mode", sorted(UNTABLED_MODES))
def test_untabled_segnn_gradients_kernel_match_plain_path(dev, mode):
    """fp32 MSE gradients of every parameter of a 2-layer lmax=2 SEGNN on a
    graph without tables, through the untabled kernels (take_dense_symmetric_km
    and #12; the sym-regather entry and #13; node blocks with layer-group
    remat and #13 on a graph without reverse slots), against autograd of the
    plain path: 1e-4 * max|ref| per parameter; none of the tabled kernels
    runs."""
    n = 2000
    kw, sym, kerns = UNTABLED_MODES[mode]
    g, _ = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    if not sym:
        g = g._replace(reverse_slot=None)
    m_k = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", lmax_attr=2, num_layers=2,
                layout="cm", use_pallas=True, device=dev,
                generator=torch.Generator().manual_seed(9), **kw)
    m_p = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", lmax_attr=2, num_layers=2,
                layout="cm", use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(10),
                         device=dev)
    tabled = (fmg.GENERIC_TAB_FWD, fmg.GENERIC_TAB_BWD_RES, fmg.GENERIC_TAB_BWD_REP)
    before = [kern.launches for kern in kerns + tabled]
    ((m_k(g) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    moved = [kern.launches - b for kern, b in zip(kerns + tabled, before)]
    assert all(x > 0 for x in moved[:2]) and moved[2:] == [0, 0, 0], moved
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


# ---- kernel #14: the fallback backward (the vjp chain, the per-tile weight
# gradients, the reduction)

def _vjp_problem(dev, hidden, k, n, dtype, lmax_attr=2):
    """#14's arguments on kernel #8's problem (the masked tail of 37
    receivers: zero rows, no valid slot), at the model's attribute order."""
    tile = SEGNNLayer._pick_generic_tile(n)
    g, _ = _graph(dev, n, k, 0.25, tile)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", lmax_attr=lmax_attr, num_layers=1, layout="cm",
                  use_pallas=True, device=dev, generator=torch.Generator().manual_seed(3))
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, k, tile)
    geo = model.compute_attributes_dense(g)[3].reshape(n, k, -1).clone()
    a = geo.shape[-1] - 2
    gen = torch.Generator(device=dev).manual_seed(4)
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).float()
    geo[n - 37:, :, a + 1] = 0.0
    cfg = kern.config(a, 0)
    h = torch.randn((n, cfg.f), generator=gen, device=dev)
    h[n - 37:] = 0.0
    hs = h[torch.clamp(g.senders.t(), max=n - 1).long()].contiguous()
    d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(dtype)
    args = (hs.to(dtype), h.to(dtype), geo.reshape(n, -1).to(dtype).contiguous(),
            [w.contiguous() for w in kern.fold(dtype)], kern.selections(dev))
    return cfg, args, d_agg


@pytest.mark.parametrize("bwd_tile", [200, 80])
@pytest.mark.parametrize("hidden,k,n", [GENERIC_WIDTHS[0], GENERIC_WIDTHS[2]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vjp_bwd_kernels_match_plain(dev, hidden, k, n, dtype, bwd_tile):
    """#14 (the vjp chain, the per-tile weight-gradient kernel, the reduction)
    against its plain version at two backward tiles, as the untabled
    backwards (``_check_bwd``); the tail's rows are exact zeros; one chain,
    one weight-gradient launch per group of tiles and one reduction each."""
    if n % bwd_tile:
        bwd_tile = 40
    cfg, args, d_agg = _vjp_problem(dev, hidden, k, n, dtype)
    kerns = (fmg.GENERIC_BWD_VJP, fmg.GENERIC_BWD_VJP_WGRAD, fm.TAB_BWD_REDUCE,
             fmg.GENERIC_BWD_REP, fmg.GENERIC_TAB_BWD_WGRAD)
    with torch.no_grad():
        before = [kern.launches for kern in kerns]
        got = fmg.generic_bwd_vjp(cfg, *args, d_agg, bwd_tile)
        torch.cuda.synchronize()
        assert [kern.launches - b for kern, b in zip(kerns, before)] == [1, 1, 1, 0, 0]
        ref = fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, bwd_tile)
    _check_bwd(got, ref, dtype)
    assert (got[0][:, n - 37:] == 0).all() and (got[1][n - 37:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vjp_bwd_reruns_bitwise_and_groups_of_tiles(dev, dtype, monkeypatch):
    """Two runs of #14 bitwise equal (no float atomics), also when the
    partials are held in groups of 3 tiles (9 weight-gradient launches):
    the tiles are added in the same order."""
    cfg, args, d_agg = _vjp_problem(dev, *GENERIC_WIDTHS[2], dtype)
    with torch.no_grad():
        runs = [fmg.generic_bwd_vjp(cfg, *args, d_agg, 80) for _ in range(2)]
        (c1a, da, _), (c1b, db, _) = cfg.widths
        monkeypatch.setattr(fmg, "_VJP_PARTIAL_BYTES", 3 * 4 * cfg.a * (c1a * da + c1b * db))
        before = fmg.GENERIC_BWD_VJP_WGRAD.launches
        runs.append(fmg.generic_bwd_vjp(cfg, *args, d_agg, 80))
        assert fmg.GENERIC_BWD_VJP_WGRAD.launches - before == 9
    flat = [[r[0], r[1], *r[2]] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other, strict=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attr36_kernels_match_plain(dev, dtype):
    """At lmax_attr=5 (A = 36, the geometry 38 values per slot) the forward
    #11 and the backward #14 against their plain versions, at the lmax=2
    config's hidden width."""
    cfg, args, d_agg = _vjp_problem(dev, *GENERIC_WIDTHS[2], dtype, lmax_attr=5)
    assert cfg.a == 36
    with torch.no_grad():
        _check_generic(fmg.generic_fwd(cfg, *args), fmg.generic_fwd_plain(cfg, *args), dtype)
        got = fmg.generic_bwd_vjp(cfg, *args, d_agg, 200)
        ref = fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 200)
    _check_bwd(got, ref, dtype)


VJP_MODELS = {  # model settings of the two #14 paths
    "replay_off": dict(lmax_attr=2, remat=True, residual_bwd=False, replay_bwd=False),
    "lmax_attr5": dict(lmax_attr=5),
}


@pytest.mark.parametrize("name", sorted(VJP_MODELS))
def test_vjp_segnn_gradients_kernel_match_plain_path(dev, name):
    """fp32 MSE gradients of every parameter of a 2-layer SEGNN whose message
    backward is #14 (``replay_bwd=False``; ``lmax_attr=5``), on a graph with
    tables (which #14 bypasses), against autograd of the plain path: 1e-4 *
    max|ref| per parameter; per step two launches each of #11 and #14, none
    of the tabled kernels, #12 or #13."""
    n = 2000
    _, gt = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    kw = VJP_MODELS[name]
    m_k = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", num_layers=2, layout="cm",
                use_pallas=True, device=dev, generator=torch.Generator().manual_seed(9), **kw)
    m_p = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", num_layers=2, layout="cm",
                use_pallas=False, device=dev, lmax_attr=kw["lmax_attr"])
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(10),
                         device=dev)
    kerns = (fmg.GENERIC_FWD, fmg.GENERIC_BWD_VJP, fmg.GENERIC_TAB_FWD, fmg.GENERIC_TAB_BWD_RES,
             fmg.GENERIC_TAB_BWD_REP, fmg.GENERIC_BWD_RES, fmg.GENERIC_BWD_REP)
    before = [kern.launches for kern in kerns]
    ((m_k(gt) - target) ** 2).mean().backward()
    assert [kern.launches - b for kern, b in zip(kerns, before)] == [2, 2, 0, 0, 0, 0, 0]
    ((m_p(gt) - target) ** 2).mean().backward()
    for (nm, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (nm, err)


# ---- #8-#14 under the other gate activations (tanh, gelu, relu, softplus:
# one library of each generic source per activation)

ACT_NAMES = [act.name for act in ACTIVATIONS[1:]]


@pytest.fixture(scope="module")
def generic_act_libs():
    """Every activation's library of both generic sources, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scalable_e3_gnn_torch.kernels.build import build_libraries

    return build_libraries(sorted({nm for kern in fmg.KERNELS for nm in kern.library_names}))


def _act_problem(dev, name, dtype, n=2000, k=16, hidden="24x0e+12x1o+6x2e"):
    """#8's and #11's arguments (the masked tail, extra masked slots) of a
    model gated by the activation, at the lmax=2 config's width."""
    tile = SEGNNLayer._pick_generic_tile(n)
    g, gt = _graph(dev, n, k, 0.25, tile)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", lmax_attr=2, num_layers=1, layout="cm",
                  use_pallas=True, act=ACTS[name].fn, device=dev,
                  generator=torch.Generator().manual_seed(13))
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, k, tile)
    geo = model.compute_attributes_dense(gt)[3].reshape(n, k, -1).clone()
    a = geo.shape[-1] - 2
    gen = torch.Generator(device=dev).manual_seed(14)
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).float()
    geo[n - 37:, :, a + 1] = 0.0
    cfg = kern.config(a, gt.gather_tab.shape[1])
    assert cfg.act == ACTS[name].code
    loc = gt.gather_loc.clone()
    loc[n - 37:] = cfg.u
    h = torch.randn((n, cfg.f), generator=gen, device=dev)
    h[n - 37:] = 0.0
    hs = h[torch.clamp(g.senders.t(), max=n - 1).long()].contiguous()
    d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(dtype)
    ws, sels = [w.contiguous() for w in kern.fold(dtype)], kern.selections(dev)
    geo2 = geo.reshape(n, -1).to(dtype).contiguous()
    tab = (h.to(dtype), geo2, loc, gt.gather_tab, ws, sels)
    untab = (hs.to(dtype), h.to(dtype), geo2, ws, sels)
    return cfg, dataclasses.replace(cfg, u=0), tab, untab, d_agg


def _act_routes_match_plain(dev, name, dtype, explain_vjp=False, **problem):
    """Every route of ``_act_problem(dev, name, dtype, **problem)`` against
    its plain version at the limits of the silu gate's tests (with
    ``explain_vjp``, #14 at ``_check_vjp``'s, as the wide silu tests hold
    it); each kernel launched once per call."""
    cfg, ucfg, tab, untab, d_agg = _act_problem(dev, name, dtype, **problem)
    counted = (fmg.GENERIC_TAB_FWD, fmg.GENERIC_TAB_BWD_RES, fmg.GENERIC_TAB_BWD_REP,
               fmg.GENERIC_FWD, fmg.GENERIC_BWD_RES, fmg.GENERIC_BWD_REP, fmg.GENERIC_BWD_VJP)
    before = [kern.launches for kern in counted]
    with torch.no_grad():
        agg, ys = fmg.generic_tab_fwd(cfg, *tab, save=True)
        ref_agg, ref_ys = fmg.generic_tab_fwd_plain(cfg, *tab, save=True)
        for got, ref in [(fmg.generic_tab_fwd(cfg, *tab), ref_agg), (agg, ref_agg),
                         *zip(ys, ref_ys)]:
            _check_generic(got, ref, dtype)
        for y in (ys, None):
            _check_bwd(fmg.generic_tab_bwd(cfg, *tab, d_agg, ys=y),
                       fmg.generic_tab_bwd_plain(cfg, *tab, d_agg, ys=y), dtype)
        uagg, uys = fmg.generic_fwd(ucfg, *untab, save=True)
        ref_uagg, ref_uys = fmg.generic_fwd_plain(ucfg, *untab, save=True)
        for got, ref in [(fmg.generic_fwd(ucfg, *untab), ref_uagg), (uagg, ref_uagg),
                         *zip(uys, ref_uys)]:
            _check_generic(got, ref, dtype)
        for y in (uys, None):
            _check_bwd(fmg.generic_bwd(ucfg, *untab, d_agg, ys=y),
                       fmg.generic_bwd_plain(ucfg, *untab, d_agg, ys=y), dtype)
        got = fmg.generic_bwd_vjp(ucfg, *untab, d_agg, 80)
        moved = [kern.launches - b for kern, b in zip(counted, before)]  # _check_vjp launches
        ref = fmg.generic_bwd_vjp_plain(ucfg, *untab, d_agg, 80)
        if explain_vjp:
            _check_vjp(ucfg, untab, d_agg, got, ref, dtype)
        else:
            _check_bwd(got, ref, dtype)
    torch.cuda.synchronize()
    assert moved == [2, 1, 1, 2, 1, 1, 1], moved
    assert (agg[-37:] == 0).all() and (uagg[-37:] == 0).all()


@pytest.mark.parametrize("name", ACT_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_kernels_match_plain(dev, generic_act_libs, name, dtype):
    """Under each activation every route against its plain version, at the
    limits of the silu gate's tests: #8 (and save), #9, #10, #11 (and save),
    #12, #13 and #14; each kernel launched once per call."""
    _act_routes_match_plain(dev, name, dtype)


@pytest.mark.parametrize("name", ACT_NAMES)
def test_act_segnn_gradients_kernel_match_plain_path(dev, generic_act_libs, name):
    """fp32 MSE gradients of every parameter of a 2-layer lmax=2
    ``SEGNN(act=...)`` through #8 and #9 against autograd of the plain path:
    1e-4 * max|ref| per parameter, the forward 1e-4 * max(1, max|ref|)."""
    n = 2000
    g, gt = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    kw = dict(lmax_attr=2, num_layers=2, layout="cm", act=ACTS[name].fn, device=dev)
    m_k = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", use_pallas=True,
                generator=torch.Generator().manual_seed(6), **kw)
    m_p = SEGNN("2x0e+1x1o", "24x0e+12x1o+6x2e", "1x1o", use_pallas=False, **kw)
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(8),
                         device=dev)
    before = [fmg.GENERIC_TAB_FWD.launches, fmg.GENERIC_TAB_BWD_RES.launches]
    out_k, out_p = m_k(gt), m_p(g)
    ((out_k - target) ** 2).mean().backward()
    ((out_p - target) ** 2).mean().backward()
    assert [fmg.GENERIC_TAB_FWD.launches, fmg.GENERIC_TAB_BWD_RES.launches] == \
        [before[0] + 2, before[1] + 2]
    out_k, out_p = out_k.detach(), out_p.detach()
    assert float((out_k - out_p).abs().max()) <= 1e-4 * max(1.0, float(out_p.abs().max()))
    for (nm, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (nm, err)


def test_act_outside_the_set_raises_on_the_card(dev):
    """An activation the kernels do not take raises ``ValueError`` naming the
    set on the card too; no kernel is launched and no plain gate runs."""
    n = 480
    _, gt = _graph(dev, n, 8, 0.25, SEGNNLayer._pick_generic_tile(n))
    m = SEGNN("2x0e+1x1o", "4x0e+2x1o+2x2e", "1x1o", lmax_attr=2, num_layers=1, layout="cm",
              use_pallas=True, act=torch.sigmoid, device=dev)
    before = fmg.GENERIC_TAB_FWD.launches
    with pytest.raises(ValueError, match="activations silu"):
        with torch.no_grad():
            m(gt)
    assert fmg.GENERIC_TAB_FWD.launches == before


def test_generic_act_variants_spill_no_more_than_silu(dev, tmp_path):
    """ptxas of every activation's build of both generic sources: per kernel
    instance no more spill stores or loads than the silu build's."""
    import re
    import subprocess

    from scalable_e3_gnn_torch.kernels import build

    procs = {}
    for src in ("fused_message_generic_tab_fwd", "fused_message_generic_tab_bwd"):
        for act in ACTIVATIONS:
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DGENERIC_ACT={act.code}",
                   "-o", str(tmp_path / f"{src}-{act.code}.so"), str(build.CSRC / f"{src}.cu")]
            procs[src, act.code] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)
    spills = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log[-2000:]
        for entry in re.split(r"Compiling entry function", log)[1:]:
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            spills[key + (entry.split("'")[1],)] = tuple(map(int, sp.groups()))
    for (src, code, fn), sp in spills.items():
        silu = spills[src, 0, fn]
        assert sp[0] <= silu[0] and sp[1] <= silu[1], (src, code, fn, sp, silu)
    assert len(spills) == 5 * len([k for k in spills if k[1] == 0])


# the untabled lmax=1 kernels (#3 forward, #5 backward): (hidden, K, points,
# node blocks); the third is config 3's width, its 1000-node blocks pad to
# 1024; the last straddles the bf16 engine's 16-row tiles (K = 20)
KM_WIDTHS = [("16x0e+8x1o", 8, 256, 1), ("8x0e+12x1o", 13, 960, 1),
             ("32x0e+16x1o", 24, 2000, 2), ("32x0e+16x1o", 20, 1000, 1)]


def _km_problem(dev, hidden, k, n, chunks, dtype, seed=0):
    """#3/#5's arguments as the model hands them over for its first node
    block: hs3 = h[senders.T] [K, Npad, F], the receivers' rows and the
    geometry (with extra masked slots and a masked tail of 37 receivers),
    zero-padded to the km tile; the folded weights of a model's layer; a
    random cotangent."""
    g, _ = _graph(dev, n, k, 0.25, 32, seed=seed)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", num_layers=1, layout="cm", use_pallas=True,
                  device=dev, generator=torch.Generator().manual_seed(seed))
    c = n // chunks
    tile = SEGNNLayer._pick_km_tile(c)
    npad = -(-c // tile) * tile
    geo = model.compute_attributes_dense(g)[3][:c].reshape(c, k, 6).clone()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    geo[..., 5] *= (torch.rand((c, k), generator=gen, device=dev) > 0.1).float()
    geo[c - 37:, :, 5] = 0.0
    f = model.hidden_irreps.dim
    h = torch.randn((n, f), generator=gen, device=dev)
    hs3 = h[torch.clamp(g.senders[:c].t(), max=n - 1).long()]
    pad = npad - c
    hs3 = torch.cat([hs3, hs3.new_zeros((k, pad, f))], dim=1)
    hr = torch.cat([h[:c], h.new_zeros((pad, f))])
    geo2 = torch.cat([geo.reshape(c, k * 6), geo.new_zeros((pad, k * 6))])
    layer = model.layers[0]
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=tile)
    d_agg = torch.randn((npad, f), generator=gen, device=dev).to(dtype)
    args = [x.to(dtype).contiguous() for x in (hs3, hr, geo2)]
    return cfg, args, layer._folded_weights(dtype), d_agg


@pytest.mark.parametrize("hidden,k,n,chunks", KM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_km_fwd_kernel_matches_plain(dev, hidden, k, n, chunks, dtype):
    """#3 against its plain version (the same km2 rounding points): fp32 1e-4
    * max(1, |ref|); bf16 within 4 ulps of max(|ref|, mean|ref|), at most 1%
    of the elements over 1 ulp (fp32 sums in another order flip a rounding
    now and then); receivers without a valid slot give exact zeros."""
    cfg, args, ws, _ = _km_problem(dev, hidden, k, n, chunks, dtype)
    before = fm.KM_FWD.launches
    with torch.no_grad():
        got = fm.fused_message_aggregate_km_fwd(cfg, *args, *ws)
        ref = fm.fused_message_aggregate_km_plain(cfg, *args, *ws)
    torch.cuda.synchronize()
    assert fm.KM_FWD.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    _check_generic(got, ref, dtype)
    c = n // chunks
    assert (got[c - 37:] == 0).all()


@pytest.mark.parametrize("hidden,k,n,chunks", KM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_km_bwd_kernels_match_plain(dev, hidden, k, n, chunks, dtype):
    """#5 and the reduction against the plain backward, as
    test_untabled_bwd_kernels_match_plain (d_hs [K, N, F] in the place of
    d_hu); d_hs is zero on masked slots; no tabled kernel runs."""
    cfg, args, ws, d_agg = _km_problem(dev, hidden, k, n, chunks, dtype)
    ws6 = fm.split_weights(cfg, *ws)
    kerns = (fm.KM_BWD, fm.TAB_BWD_REDUCE, fm.TAB_BWD)
    before = [kern.launches for kern in kerns]
    with torch.no_grad():
        got = fm.km_bwd_kernels(cfg, *args, ws6, d_agg)
        torch.cuda.synchronize()
        assert [kern.launches - b for kern, b in zip(kerns, before)] == [1, 1, 0]
        ref = fm.km_bwd_plain(cfg, *args, ws6, d_agg)
    assert got[0].shape == (k,) + tuple(args[1].shape)
    _check_bwd(got, ref, dtype)
    dead = args[2].reshape(-1, k, 6)[..., 5].t() == 0
    assert (got[0][dead] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_km_bwd_is_deterministic(dev, dtype):
    """Two runs of #5 + the reduction are bitwise equal (no float atomics)."""
    cfg, args, ws, d_agg = _km_problem(dev, *KM_WIDTHS[2], dtype)
    one = fm.fused_message_aggregate_km_bwd(cfg, *args, *ws, d_agg)
    two = fm.fused_message_aggregate_km_bwd(cfg, *args, *ws, d_agg)
    for x, y in zip(one, two, strict=True):
        assert torch.equal(x, y)


def test_km_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, args, ws, d_agg = _km_problem(dev, *KM_WIDTHS[0], torch.float32)
    with pytest.raises(TypeError):
        fm.fused_message_aggregate_km_fwd(cfg, *(x.half() for x in args), *(w.half() for w in ws))
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_message_aggregate_km_fwd(cfg, args[0].transpose(1, 2).contiguous().transpose(1, 2),
                                          *args[1:], *ws)
    with pytest.raises(ValueError, match="must be on"):
        fm.fused_message_aggregate_km_bwd(cfg, *args[:2], args[2].cpu(), *ws, d_agg)


KM_MODES = {  # model settings, symmetrized graph
    "symmetrized": (dict(), True),
    "unsymmetrized": (dict(remat=True), False),
    "edge_chunks": (dict(remat=True, edge_chunks=2), True),
}


@pytest.mark.parametrize("mode", sorted(KM_MODES))
def test_km_segnn_gradients_kernel_match_plain_path(dev, mode):
    """fp32 MSE gradients of every parameter of a 2-layer config-3-width
    SEGNN on a graph without tables, through #3 and #5 (senders by
    take_dense_symmetric_km, by gather_km, and in node blocks of 1000 padded
    to 1024), against autograd of the plain path: 1e-4 * max|ref| per
    parameter; none of the tabled kernels runs."""
    n = 2000
    kw, sym = KM_MODES[mode]
    g, _ = _graph(dev, n, 24, 0.12, 160)
    if not sym:
        g = g._replace(reverse_slot=None)
    m_k = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=True, device=dev, generator=torch.Generator().manual_seed(11), **kw)
    m_p = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(12),
                         device=dev)
    kerns = (fm.KM_FWD, fm.KM_BWD, fm.TAB_FWD, fm.TAB_BWD)
    before = [kern.launches for kern in kerns]
    ((m_k(g) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    moved = [kern.launches - b for kern, b in zip(kerns, before)]
    blocks = kw.get("edge_chunks", 1)
    # each block checkpointed under remat recomputes its forward: 2 x #3
    assert moved == [(2 if blocks > 1 else 1) * 2 * blocks, 2 * blocks, 0, 0], moved
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


# the packed lmax=1 kernels (#6 forward, #7 backward): (hidden, K, points,
# node blocks, pack); the last two are config 3's width, whose 1000-node
# blocks pad to 1024
FLAT_CASES = [("16x0e+8x1o", 8, 256, 1, 2), ("16x0e+8x1o", 8, 256, 1, 4),
              ("8x0e+12x1o", 12, 960, 1, 3), ("32x0e+16x1o", 24, 2000, 2, 2),
              ("32x0e+16x1o", 24, 2000, 2, 4), ("32x0e+16x1o", 20, 1000, 1, 4)]


def _flat_problem(dev, hidden, k, n, chunks, p, dtype, seed=0):
    """#6/#7's arguments as the model hands them over for its first node
    block: hs = h[senders] [Npad*K/p, p*F], the receivers' rows, d2, attr and
    maskf [Npad*K/p, .] (with extra masked slots and a masked tail of 37
    receivers), zero-padded to the km tile; the folded weights of a model's
    layer; a random cotangent."""
    g, _ = _graph(dev, n, k, 0.25, 32, seed=seed)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", num_layers=1, layout="cm", use_pallas=True,
                  device=dev, generator=torch.Generator().manual_seed(seed))
    c = n // chunks
    tile = SEGNNLayer._pick_km_tile(c)
    npad = -(-c // tile) * tile
    geo = model.compute_attributes_dense(g)[3][:c].reshape(c, k, 6).clone()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    geo[..., 5] *= (torch.rand((c, k), generator=gen, device=dev) > 0.1).float()
    geo[c - 37:, :, 5] = 0.0
    f = model.hidden_irreps.dim
    h = torch.randn((n, f), generator=gen, device=dev)
    pad = lambda x: torch.cat([x, x.new_zeros((npad - c,) + x.shape[1:])])
    r = npad * k // p
    hs = pad(h[torch.clamp(g.senders[:c], max=n - 1).long()]).reshape(r, p * f)
    geo = pad(geo)
    args = [hs, pad(h[:c]), geo[..., 4].reshape(r, p), geo[..., :4].reshape(r, 4 * p),
            geo[..., 5].reshape(r, p)]
    layer = model.layers[0]
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=tile, pack=p)
    d_agg = torch.randn((npad, f), generator=gen, device=dev).to(dtype)
    return cfg, [x.to(dtype).contiguous() for x in args], layer._folded_weights(dtype), d_agg


@pytest.mark.parametrize("hidden,k,n,chunks,p", FLAT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_fwd_kernel_matches_plain(dev, hidden, k, n, chunks, p, dtype):
    """#6 against its plain version (the same rounding points): as
    test_km_fwd_kernel_matches_plain; receivers without a valid slot give
    exact zeros; two runs are bitwise equal."""
    cfg, args, ws, _ = _flat_problem(dev, hidden, k, n, chunks, p, dtype)
    before = fm.FLAT_FWD.launches
    with torch.no_grad():
        got = fm.fused_message_aggregate_fwd(cfg, *args, *ws)
        again = fm.fused_message_aggregate_fwd(cfg, *args, *ws)
        ref = fm.fused_message_aggregate_plain(cfg, *args, *ws)
    torch.cuda.synchronize()
    assert fm.FLAT_FWD.launches == before + 2
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.equal(got, again)
    _check_generic(got, ref, dtype)
    c = n // chunks
    assert (got[c - 37:] == 0).all()


@pytest.mark.parametrize("hidden,k,n,chunks,p", FLAT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_bwd_kernels_match_plain(dev, hidden, k, n, chunks, p, dtype):
    """#7 and the reduction against the plain backward, as
    test_km_bwd_kernels_match_plain (d_hs [Npad*K/p, p*F]); d_hs is zero on
    masked slots; no other lmax=1 backward runs."""
    cfg, args, ws, d_agg = _flat_problem(dev, hidden, k, n, chunks, p, dtype)
    ws6 = fm.split_weights(cfg, *ws)
    kerns = (fm.FLAT_BWD, fm.TAB_BWD_REDUCE, fm.TAB_BWD, fm.KM_BWD)
    before = [kern.launches for kern in kerns]
    with torch.no_grad():
        got = fm.flat_bwd_kernels(cfg, *args, ws6, d_agg)
        torch.cuda.synchronize()
        assert [kern.launches - b for kern, b in zip(kerns, before)] == [1, 1, 0, 0]
        ref = fm.flat_bwd_plain(cfg, *args, ws6, d_agg)
    assert got[0].shape == args[0].shape
    _check_bwd(got, ref, dtype)
    f = args[1].shape[1]
    dead = args[4].reshape(-1) == 0
    assert (got[0].reshape(-1, f)[dead] == 0).all()


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_bwd_is_deterministic(dev, dtype, p):
    """Two runs of #7 + the reduction are bitwise equal (no float atomics)."""
    cfg, args, ws, d_agg = _flat_problem(dev, *FLAT_CASES[3][:4], p, dtype)
    one = fm.fused_message_aggregate_bwd(cfg, *args, *ws, d_agg)
    two = fm.fused_message_aggregate_bwd(cfg, *args, *ws, d_agg)
    for x, y in zip(one, two, strict=True):
        assert torch.equal(x, y)


def test_flat_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, args, ws, d_agg = _flat_problem(dev, *FLAT_CASES[0], torch.float32)
    with pytest.raises(TypeError):
        fm.fused_message_aggregate_fwd(cfg, *(x.half() for x in args), *(w.half() for w in ws))
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_message_aggregate_fwd(cfg, args[0].t().contiguous().t(), *args[1:], *ws)
    with pytest.raises(ValueError, match="must be on"):
        fm.fused_message_aggregate_bwd(cfg, *args[:2], args[2].cpu(), *args[3:], *ws, d_agg)


FLAT_MODES = {  # model settings, symmetrized graph
    "symmetrized": (dict(), True),
    "unsymmetrized": (dict(remat=True), False),
    "edge_chunks": (dict(remat=True, edge_chunks=2), True),
}


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("mode", sorted(FLAT_MODES))
def test_flat_segnn_gradients_kernel_match_plain_path(dev, mode, p):
    """fp32 MSE gradients of every parameter of a 2-layer config-3-width
    ``SEGNN(pack=p)`` on a graph without tables, through #6 and #7 (senders
    by take_dense_symmetric, by gather, and in node blocks of 1000 padded to
    1024), against autograd of the plain path: 1e-4 * max|ref| per parameter;
    none of the other lmax=1 kernels runs."""
    n = 2000
    kw, sym = FLAT_MODES[mode]
    g, _ = _graph(dev, n, 24, 0.12, 160)
    if not sym:
        g = g._replace(reverse_slot=None)
    m_k = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=True, pack=p, device=dev,
                generator=torch.Generator().manual_seed(13), **kw)
    m_p = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(14),
                         device=dev)
    kerns = (fm.FLAT_FWD, fm.FLAT_BWD, fm.KM_FWD, fm.KM_BWD, fm.TAB_FWD, fm.TAB_BWD)
    before = [kern.launches for kern in kerns]
    ((m_k(g) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    moved = [kern.launches - b for kern, b in zip(kerns, before)]
    blocks = kw.get("edge_chunks", 1)
    # each block checkpointed under remat recomputes its forward: 2 x #6
    assert moved == [(2 if blocks > 1 else 1) * 2 * blocks, 2 * blocks, 0, 0, 0, 0], moved
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


# the halo ring (#15): (P, H, F); odd H and F take the element path, F = 80
# (config 3's hidden width) the 16-byte path in both dtypes; P = 1 copies
RING_CASES = [(p, h, f) for p in range(1, 9) for h, f in ((37, 13), (129, 80))]


@pytest.mark.parametrize("p,h,f", RING_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernel_matches_plain_bitwise(dev, p, h, f, dtype):
    x = torch.randn((p, h, f), generator=torch.Generator(device=dev).manual_seed(p * h),
                    device=dev).to(dtype)
    before = hr.RING.launches
    got = hr.ring_all_gather_fwd(x)
    torch.cuda.synchronize()
    assert hr.RING.launches == before + 1
    assert torch.equal(got, hr.ring_all_gather_plain(x))


# the weight-gradient reduction: config 3's #2 partials (strips), #12's and
# #14's at 250k (16-byte columns), two stages of strips, and odd NW (strips,
# wide and narrow), with one row
REDUCE_SHAPES = [(132, 9280), (22, 263412), (128, 263412), (264, 9280), (22, 263413),
                 (7, 1001), (1, 4099), (33, 3)]


@pytest.mark.parametrize("nblocks,nw", REDUCE_SHAPES)
def test_reduce_kernel_is_the_in_order_fold_bitwise(dev, nblocks, nw):
    x = torch.randn((nblocks, nw), generator=torch.Generator(device=dev).manual_seed(nw),
                    device=dev)
    before = fm.TAB_BWD_REDUCE.launches
    got = fm.tab_bwd_reduce(x)
    torch.cuda.synchronize()
    assert fm.TAB_BWD_REDUCE.launches == before + 1
    fold = torch.zeros(nw, device=dev)
    for row in x:
        fold += row
    assert torch.equal(got, fold)
    ref = fm.tab_bwd_reduce_plain(x)
    assert float((got - ref).abs().max()) <= 1e-6 * max(1.0, float(ref.abs().max()))


def test_reduce_kernel_on_an_unaligned_view(dev):
    """A view whose base is not 16-byte aligned takes one column a thread."""
    buf = torch.randn(5 * 1024 + 1, device=dev)
    x = buf[1:].view(5, 1024)
    fold = torch.zeros(1024, device=dev)
    for row in x:
        fold += row
    assert torch.equal(fm.tab_bwd_reduce(x), fold)


def test_ring_gradient_and_wrapper_checks(dev):
    x = torch.randn((4, 33, 80), device=dev, requires_grad=True)
    (hr.ring_all_gather(x) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, 8 * x.detach(), rtol=1e-6, atol=0)
    with pytest.raises(TypeError):
        hr.ring_all_gather_fwd(torch.zeros((2, 4, 4), dtype=torch.float16, device=dev))
    with pytest.raises(ValueError):
        hr.ring_all_gather_fwd(torch.zeros((2, 4, 8), device=dev)[:, :, ::2])


def test_ring_between_processes_equals_gloo_bitwise(dev):
    """#15 between two processes on the card (``parallel.ring_stress``): 20
    exchanges a shape back to back (config 3's [2, H, 80] in bf16 and fp32,
    odd H and F), every pool bit for bit gloo's all-gather of the same
    exports; then the last rank skips a publish and every rank raises
    within the bound, naming it."""
    from scalable_e3_gnn_torch.parallel import ring_stress

    got = ring_stress.run_world(world=2, exchanges=20, skip_at=3, timeout_s=2.0,
                                wall_timeout_s=240.0)
    assert not got["fails"], got["fails"]
    for out in got["ranks"].values():
        assert out["launches"]["halo_ipc_publish"] == 3 * 20
        assert out["launches"]["halo_ipc_gather"] == 3 * (20 + 20)  # and the re-gathers
        assert out["fault"]["nan_slots"] == [1]


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_ring_worker_world_equals_all_gather_world(dev, tmp_path, layout):
    """``dense_worker.run_world`` with two ranks on the card under each
    backend (fp32, P=4, 2 Adam steps): the ring world's forward, losses and
    final parameters bit for bit the all_gather world's; per rank and step
    one publish and one gather a layer."""
    from scalable_e3_gnn_torch.parallel import dense_worker

    n = 2000
    kw = dict(input_irreps="2x0e+1x1o", hidden_irreps="32x0e+16x1o", output_irreps="1x1o",
              num_layers=2)
    if layout == "dense":
        g, _ = _graph(dev, n, 24, 0.12, 160)
        arrays = [g.positions, g.nodes, g.senders, g.edge_mask]
        extra, kw = {}, dict(kw, layout="cm", use_pallas=True)
    else:
        g, host = _coo_graph(dev, n, 24, 0.1)
        arrays = [host[0], host[1], host[2], host[4]]
        extra = dict(receivers=host[3], layout="coo")
    model = SEGNN(**kw, device="cpu", generator=torch.Generator().manual_seed(31))
    target = np.random.default_rng(32).standard_normal((n, 3)).astype(np.float32)
    runs = {}
    for backend in ("all_gather", "ring"):
        dense_worker.write_inputs(tmp_path / f"in_{backend}", *arrays, target, kw,
                                  model.state_dict(), num_parts=4, steps=2, lr=1e-3,
                                  compute_dtype="float32", backend=backend, **extra)
        report, res = dense_worker.run_world(tmp_path / f"in_{backend}", tmp_path / backend, 2,
                                             wall_timeout_s=300.0, max_restarts=0)
        assert report.ok and sorted(res) == [0, 1], report
        runs[backend] = res, {r: dict(np.load(tmp_path / backend / f"rank{r}.npz"))
                              for r in range(2)}
    (res_a, files_a), (res_r, files_r) = runs["all_gather"], runs["ring"]
    for r in range(2):
        assert res_r[r]["backend"] == "ring" and res_r[r]["losses"] == res_a[r]["losses"]
        assert files_r[r].keys() == files_a[r].keys()
        for k in files_a[r]:
            assert files_r[r][k].tobytes() == files_a[r][k].tobytes(), (r, k)
        for per_step in res_r[r]["launches_per_step"]:
            assert per_step["halo_ipc_publish"] == per_step["halo_ipc_gather"] == 2
        assert all(m["gather"] > 0 for m in res_r[r]["ring_ms_per_step"])


_FORWARD_FAULT_RANK = """
import json, sys, time
import torch
from scalable_e3_gnn_torch.parallel import halo
from scalable_e3_gnn_torch.parallel.dense_worker import setup

r = setup(sys.argv[1])
group = r.group
ring = group.ipc_ring()
ring.timeout_s = float(sys.argv[2])
fwd = halo.make_dist_forward_dense(r.model, group, "ring")
layers = len(r.model.layers)
with torch.no_grad():
    clean = fwd(r.shards, r.attrs)
    torch.cuda.synchronize()
    if group.rank == 1:  # skip the publish of the next forward's first exchange
        publish = ring.publish
        ring.publish = lambda x, e: None if e == layers + 1 else publish(x, e)
    t0, raised = time.perf_counter(), None
    try:
        fwd(r.shards, r.attrs)
    except RuntimeError as err:
        raised = str(err)
print("FAULT " + json.dumps(dict(rank=group.rank, clean_finite=bool(torch.isfinite(clean).all()),
                                 raised=raised, seconds=time.perf_counter() - t0)), flush=True)
"""


def test_ring_forward_alone_raises_when_a_peer_skips_a_publish(dev, tmp_path):
    """Two ranks on the card run the dense partitioned forward under ring
    (no train step), then a second forward in which rank 1 does not publish
    its first exchange: that forward raises ``RuntimeError`` on both ranks,
    naming rank 1 and the exchange, within the wait bound plus a margin,
    instead of returning the NaN the gather left in the pool."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from scalable_e3_gnn_torch.parallel import dense_worker

    n, layers, bound_s = 2000, 2, 2.0
    kw = dict(input_irreps="2x0e+1x1o", hidden_irreps="32x0e+16x1o", output_irreps="1x1o",
              num_layers=layers, layout="cm", use_pallas=True)
    g, _ = _graph(dev, n, 24, 0.12, 160)
    model = SEGNN(**kw, device="cpu", generator=torch.Generator().manual_seed(31))
    target = np.random.default_rng(32).standard_normal((n, 3)).astype(np.float32)
    dense_worker.write_inputs(tmp_path / "in", g.positions, g.nodes, g.senders, g.edge_mask,
                              target, kw, model.state_dict(), num_parts=4, steps=1, lr=1e-3,
                              compute_dtype="float32", backend="ring")
    script = tmp_path / "rank.py"
    script.write_text(_FORWARD_FAULT_RANK)
    root = str(Path(__file__).resolve().parents[1])
    port = dense_worker._free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": "0",
               "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / "in"), str(bound_s)], env=env,
            cwd=root, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    res = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            for ln in out.splitlines():
                if ln.startswith("FAULT "):
                    got = json.loads(ln[len("FAULT "):])
                    res[got["rank"]] = got
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sorted(res) == [0, 1]
    for r, got in res.items():
        assert got["clean_finite"], r
        assert got["raised"] is not None, f"rank {r}'s forward returned without raising"
        assert f"rank 1's exchange {layers + 1}" in got["raised"], got["raised"]
        assert got["seconds"] <= layers * bound_s + 10.0, got


@pytest.mark.parametrize("backend", ["all_gather", "ring"])
def test_dist_segnn_on_card_matches_plain_path(dev, backend):
    """A 2-layer config-3-width SEGNN partitioned 4 ways on the card through
    #3/#5 (and #15 under ring): the fp32 forward un-permuted and the MSE
    gradients against the unpartitioned plain path (1e-4 * max(1, |ref|) and
    1e-4 * max|ref| per parameter), and the ring forward equal to the
    all_gather one bit for bit."""
    n = 2000
    g, _ = _graph(dev, n, 24, 0.12, 160)
    m_k = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=True, device=dev, generator=torch.Generator().manual_seed(15))
    m_p = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    part = partition_graph_dense(*(x.cpu().numpy() for x in (g.positions, g.nodes, g.senders,
                                                             g.edge_mask)), num_parts=4)
    group = dist.PartitionGroup(4, dev)
    shards = dist.shard_partitioned_dense(part, group)
    gids = torch.as_tensor(part.global_ids, device=dev).long()
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(16),
                         device=dev)
    kerns = (fm.KM_FWD, fm.KM_BWD, hr.RING)
    before = [kern.launches for kern in kerns]
    step = dist.make_dist_train_step_dense(m_k, torch.optim.SGD(m_k.parameters(), lr=0.0),
                                           group, backend)
    loss = step(shards, target[gids.clamp(min=0)])["loss"]
    moved = [kern.launches - b for kern, b in zip(kerns, before)]
    assert moved == [2 * 4 * 2, 2 * 4 * 2, 2 if backend == "ring" else 0], moved
    ref_loss = ((m_p(g) - target) ** 2).mean()
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5, atol=0)
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)
    with torch.no_grad():
        out = dist.make_dist_forward_dense(m_k, group, backend)(shards)
        other = dist.make_dist_forward_dense(m_k, group, "all_gather")(shards)
        ref = m_p(g)
    assert torch.equal(out, other)
    flat, keep = out.reshape(-1, 3), gids.reshape(-1) >= 0
    full = torch.zeros_like(ref)
    full[gids.reshape(-1)[keep]] = flat[keep]
    assert bool(((full - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all())


def _coo_graph(dev, n, k, radius, seed=0):
    """A cell radius graph on the card as the receiver-sorted COO graph, and
    its host arrays for ``partition_graph``."""
    pts = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    tree = build_octree(pts, LO, HI, num_levels=5, device=dev)
    cap = suggest_cell_capacity(tree, radius, LO, HI)
    e = radius_graph_cell(tree, radius, LO, HI, max_neighbors=k, cell_capacity=cap)
    feats = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (n, 5)).astype(np.float32)).to(dev)
    g = SteerableGraph(nodes=feats, positions=tree.points, senders=e.senders,
                       receivers=e.receivers, node_graph=torch.zeros(n, dtype=torch.int32,
                                                                     device=dev),
                       node_mask=torch.ones(n, dtype=torch.bool, device=dev), edge_mask=e.mask)
    arrays = tuple(x.cpu().numpy() for x in (tree.points, feats, e.senders, e.receivers, e.mask))
    return g.with_plans(), arrays


@pytest.mark.parametrize("backend", ["all_gather", "ring"])
def test_coo_dist_on_card_matches_unpartitioned(dev, backend):
    """The COO partitioned path at P=4 on the card: the forward against the
    unpartitioned COO model (2e-5 * max(1, max|ref|)), #15 once per layer
    under ring and nothing else, ring equal to all_gather bit for bit; the
    step's MSE gradients within 5e-5 * max|ref| per parameter, the loss
    within 1e-6 relative."""
    n = 3000
    g, arrays = _coo_graph(dev, n, 24, 0.1)
    model = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, lmax_attr=1, device=dev,
                  generator=torch.Generator().manual_seed(21))
    ref_model = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, device=dev)
    ref_model.load_state_dict(model.state_dict())
    part = partition_graph(*arrays, num_parts=4)
    group = dist.PartitionGroup(4, dev)
    shards = dist.shard_partitioned(part, group)
    with torch.no_grad():
        ref = ref_model(g)
        before = {kern.name: kern.launches for kern in fm.KERNELS + fmg.KERNELS + hr.KERNELS}
        out = dist.make_dist_forward(model, group, backend)(shards)
        torch.cuda.synchronize()
        moved = {kern.name: kern.launches - before[kern.name]
                 for kern in fm.KERNELS + fmg.KERNELS + hr.KERNELS}
        other = dist.make_dist_forward(model, group, "all_gather")(shards)
    assert moved == {k: (2 if backend == "ring" and k == hr.RING.name else 0) for k in moved}
    assert torch.equal(out, other)
    got = out.reshape(-1, 3)[:n]
    assert float((got - ref).abs().max()) <= 2e-5 * max(1.0, float(ref.abs().max()))
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(22),
                         device=dev)
    gids = torch.as_tensor(part.global_ids, device=dev).long().clamp(min=0)
    step = dist.make_dist_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), group,
                                     backend)
    loss = step(shards, target[gids])["loss"]
    ref_loss = ((ref_model(g) - target) ** 2).mean()
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-6, atol=0)
    for (name, a), b in zip(model.named_parameters(), ref_model.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 5e-5 * float(b.grad.abs().max()), (name, err)


def _dp_dense(dev, use_pallas, seeds=(0, 1), n=2000):
    """Two clouds at config 3's width partitioned 4 ways under shared caps,
    a model, the group and the clouds' shards, targets and graphs."""
    clouds = [_graph(dev, n, 24, 0.12, 160, seed=s)[0] for s in seeds]
    host = lambda g: [x.cpu().numpy() for x in (g.positions, g.nodes, g.senders, g.edge_mask)]
    parts = [partition_graph_dense(*host(g), num_parts=4) for g in clouds]
    caps = shared_caps(parts)
    parts = [partition_graph_dense(*host(g), num_parts=4, **caps) for g in clouds]
    model = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                  use_pallas=use_pallas, device=dev, generator=torch.Generator().manual_seed(23))
    group = dist.PartitionGroup(4, dev)
    shards = [dist.shard_partitioned_dense(p, group) for p in parts]
    gen = torch.Generator(device=dev).manual_seed(24)
    targets = [torch.randn((n, 3), generator=gen, device=dev) for _ in clouds]
    stacked = torch.stack([t[torch.as_tensor(p.global_ids, device=dev).long().clamp(min=0)]
                           for t, p in zip(targets, parts)])
    return clouds, model, group, shards, targets, stacked


def test_dense_dp_on_card_matches_plain_path(dev):
    """dp 2 x graph 4 through #3/#5: 2 clouds x 4 partitions x 2 blocks x 2
    layers of each and of the reduction per step; the gradients within 1e-4
    * max|ref| per parameter of the plain path's mean of the clouds' MSEs."""
    clouds, model, group, shards, targets, stacked = _dp_dense(dev, True)
    plain = SEGNN("2x0e+1x1o", "32x0e+16x1o", "1x1o", num_layers=2, layout="cm",
                  use_pallas=False, device=dev)
    plain.load_state_dict(model.state_dict())
    step = dist.make_dist_train_step_dense(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                           group, dp=dist.CloudGroup(2, group))
    kerns = (fm.KM_FWD, fm.KM_BWD, fm.TAB_BWD_REDUCE)
    before = [kern.launches for kern in kerns]
    loss = step(shards, stacked)["loss"]
    moved = [kern.launches - b for kern, b in zip(kerns, before)]
    assert moved == [2 * 4 * 2 * 2] * 3, moved
    ref = sum(((plain(g) - t) ** 2).mean() for g, t in zip(clouds, targets)) / 2
    ref.backward()
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-5, atol=0)
    for (name, a), b in zip(model.named_parameters(), plain.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


@pytest.mark.parametrize("backend", ["all_gather", "ring"])
def test_overlap_equals_serialized_on_card(dev, backend):
    """The bf16 dense dp step through the kernels, overlapped and
    serialized: the same forward, losses and parameters after 2 Adam steps,
    bit for bit."""
    runs = []
    for serialize in (False, True):
        _, model, group, shards, _, stacked = _dp_dense(dev, True)
        bf = torch.bfloat16
        attrs = [[tuple(a.to(bf) for a in at) for at in dist.make_dist_geometry_dense(
            model, group)(s)] for s in shards]
        shards = [[sh._replace(nodes=sh.nodes.to(bf), positions_ext=sh.positions_ext.to(bf))
                   for sh in s] for s in shards]
        with torch.no_grad():
            fwd = dist.make_dist_forward_dense(copy.deepcopy(model).to(bf), group, backend,
                                               _serialize_exchange=serialize)
            out = fwd(shards[0], attrs[0])
        step = dist.make_dist_train_step_dense(
            model, torch.optim.Adam(model.parameters(), lr=1e-3), group, backend,
            compute_dtype=bf, dp=dist.CloudGroup(2, group), _serialize_exchange=serialize)
        losses = [step(shards, stacked, attrs)["loss"].item() for _ in range(2)]
        runs.append((out, losses, [p.detach().clone() for p in model.parameters()]))
    (f0, l0, p0), (f1, l1, p1) = runs
    assert torch.equal(f0, f1) and l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))



# ---- #8-#14 at other counts of message layers (SEGNNLayer(num_message_layers=L))

def _msg_layers_model(dev, hidden, lmax_attr, num_layers, n_msg, seed=0, **kw):
    """An lmax=2 SEGNN whose layers each run ``n_msg`` gated message layers,
    built as a user would: the model's layers replaced by SEGNNLayers of
    that count."""
    kw.setdefault("use_pallas", True)
    model = SEGNN("2x0e+1x1o", hidden, "1x1o", lmax_attr=lmax_attr, num_layers=num_layers,
                  layout="cm", device=dev, generator=torch.Generator().manual_seed(seed), **kw)
    gen = torch.Generator().manual_seed(seed + 1)
    model.layers = torch.nn.ModuleList(
        SEGNNLayer(model.hidden_irreps, model.attr_irreps, num_message_layers=n_msg, layout="cm",
                   device=dev, generator=gen, **kw)
        for _ in range(num_layers))
    return model


def _msg_layers_problem(dev, n_msg, dtype, lmax_attr=2, hidden="24x0e+12x1o+6x2e", k=16,
                        n=2000):
    """The tabled and untabled kernels' arguments for one layer of
    ``n_msg`` message layers on a real graph, kernel #8's masked tail and
    extra masked slots, and a cotangent."""
    tile = SEGNNLayer._pick_generic_tile(n)
    g, gt = _graph(dev, n, k, 0.25, tile)
    model = _msg_layers_model(dev, hidden, lmax_attr, 1, n_msg, seed=5)
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, k, tile)
    geo = model.compute_attributes_dense(gt)[3].reshape(n, k, -1).clone()
    a = geo.shape[-1] - 2
    gen = torch.Generator(device=dev).manual_seed(6)
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).float()
    geo[n - 37:, :, a + 1] = 0.0
    cfg = kern.config(a, gt.gather_tab.shape[1])
    loc = gt.gather_loc.clone()
    loc[n - 37:] = cfg.u
    h = torch.randn((n, cfg.f), generator=gen, device=dev)
    h[n - 37:] = 0.0
    hs = h[torch.clamp(g.senders.t(), max=n - 1).long()].contiguous()
    ws, sels = [w.contiguous() for w in kern.fold(dtype)], kern.selections(dev)
    geo2 = geo.reshape(n, -1).to(dtype).contiguous()
    d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(dtype)
    tab = (h.to(dtype), geo2, loc, gt.gather_tab, ws, sels)
    ucfg = dataclasses.replace(cfg, u=0)
    return cfg, tab, ucfg, (hs.to(dtype), h.to(dtype), geo2, ws, sels), d_agg


MSG_LAYERS = [1, 3]


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msg_layers_tabled_match_plain(dev, n_msg, dtype):
    """#8 (and its save mode: every layer's y), #9 and #10 at one and three
    message layers against their plain versions, at the two-layer limits
    (``_check_generic``, ``_check_bwd``); #9 = #10 bitwise."""
    cfg, args, _, _, d_agg = _msg_layers_problem(dev, n_msg, dtype)
    assert len(cfg.widths) == n_msg
    before = [kern.launches for kern in fmg.KERNELS[:5]]
    with torch.no_grad():
        agg, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
        ref_agg, ref_ys = fmg.generic_tab_fwd_plain(cfg, *args, save=True)
        assert torch.equal(agg, fmg.generic_tab_fwd(cfg, *args)) and len(ys) == n_msg
        for got, ref in [(agg, ref_agg), *zip(ys, ref_ys, strict=True)]:
            _check_generic(got, ref, dtype)
        res = fmg.generic_tab_bwd(cfg, *args, d_agg, ys=ys)
        rep = fmg.generic_tab_bwd(cfg, *args, d_agg)
        torch.cuda.synchronize()
        _check_bwd(res, fmg.generic_tab_bwd_plain(cfg, *args, d_agg), dtype)
    assert len(res[2]) == n_msg
    assert all(torch.equal(x, y) for x, y in zip([res[0], res[1], *res[2]],
                                                 [rep[0], rep[1], *rep[2]], strict=True))
    moved = [kern.launches - b for kern, b in zip(fmg.KERNELS[:5], before)]
    assert moved == [2, 1, 1, 2, 2], moved


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msg_layers_untabled_match_plain(dev, n_msg, dtype):
    """#11 (and save), #12 and #13 at one and three message layers against
    their plain versions (``_check_generic``, ``_check_bwd``); #12 = #13
    bitwise, reruns bitwise."""
    _, _, cfg, args, d_agg = _msg_layers_problem(dev, n_msg, dtype)
    with torch.no_grad():
        agg, ys = fmg.generic_fwd(cfg, *args, save=True)
        ref_agg, ref_ys = fmg.generic_fwd_plain(cfg, *args, save=True)
        assert torch.equal(agg, fmg.generic_fwd(cfg, *args)) and len(ys) == n_msg
        for got, ref in [(agg, ref_agg), *zip(ys, ref_ys, strict=True)]:
            _check_generic(got, ref, dtype)
        runs = [fmg.generic_bwd(cfg, *args, d_agg, ys=y) for y in (ys, None, ys)]
        torch.cuda.synchronize()
        _check_bwd(runs[0], fmg.generic_bwd_plain(cfg, *args, d_agg), dtype)
    flat = [[r[0], r[1], *r[2]] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other, strict=True))


def _check_vjp(cfg, args, d_agg, got, ref, dtype):
    """#14 against its plain version as ``_check_bwd``, except for bf16
    d_hs elements over 8 ulps: such an element passes only where its slot
    row is explained (``PERF.md`` section 2, ``chip_smoke.explain_d_hs``):
    #14's own last stage (``_layer_vjp``, JAX's AD rounding), fed the
    kernel's dy_0 of that row, gives the kernel's d_hs row within one ulp,
    so the excess comes from a dy_0 that an fp32 sum upstream, in another
    order, rounded across a bf16 step.  At most 1% of d_hs over 1 ulp."""
    if dtype == torch.float32:
        return _check_bwd(got, ref, dtype)
    d_hs, r_hs = got[0].float(), ref[0].float()
    r = r_hs.abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp(min=float(r.mean())))) - 7)
    ulps = (d_hs - r_hs).abs() / ulp
    assert torch.isfinite(d_hs).all() and float((ulps > 1).float().mean()) <= 0.01
    over = ulps > 8
    if over.any():
        k, n, f = d_hs.shape
        kk, ii = torch.nonzero(over.any(dim=-1), as_tuple=True)
        c1, d0, _ = cfg.widths[0]
        hs, h, geo2, ws, sels = args
        with torch.no_grad():
            dy0 = fmg.generic_bwd_chain(cfg, *args, d_agg, vjp=True)[2][0][ii * k + kk, :d0]
            attr = geo2.reshape(n * k, cfg.a + 2)[ii * k + kk, :cfg.a].float()
            refed = fmg._layer_vjp(dy0, attr, ws[0].float(), None, c1, cfg.a, 1)[0][:, :f]
        r_ulps = (d_hs[kk, ii] - refed.float()).abs() / ulp[kk, ii]
        assert not bool((over[kk, ii] & (r_ulps > 1)).any()), float(r_ulps[over[kk, ii]].max())
    _check_bwd((ref[0], got[1], got[2]), ref, dtype)


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msg_layers_vjp_match_plain(dev, n_msg, dtype):
    """#14 (the vjp chain, the per-tile weight gradients, the reduction) at
    one and three message layers against its plain version at backward tile
    80 (``_check_vjp``), reruns bitwise; the chain's dy and m rows are every
    layer's."""
    _, _, cfg, args, d_agg = _msg_layers_problem(dev, n_msg, dtype)
    with torch.no_grad():
        got = fmg.generic_bwd_vjp(cfg, *args, d_agg, 80)
        again = fmg.generic_bwd_vjp(cfg, *args, d_agg, 80)
        _, _, dys, ms = fmg.generic_bwd_chain(cfg, *args, d_agg, vjp=True)
        torch.cuda.synchronize()
        _check_vjp(cfg, args, d_agg, got, fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 80), dtype)
    assert len(dys) == len(ms) == n_msg and all(m is not None for m in ms)
    assert all(torch.equal(x, y) for x, y in zip([got[0], got[1], *got[2]],
                                                 [again[0], again[1], *again[2]], strict=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msg_layers_attr36_match_plain(dev, dtype):
    """Three non-foldable message layers (``lmax_attr=5``, A=36, few
    irreps): #11 and #14 against their plain versions."""
    _, _, cfg, args, d_agg = _msg_layers_problem(dev, 3, dtype, lmax_attr=5,
                                                 hidden="8x0e+4x1o+2x2e", k=8, n=480)
    assert cfg.a == 36 and len(cfg.widths) == 3
    with torch.no_grad():
        _check_generic(fmg.generic_fwd(cfg, *args), fmg.generic_fwd_plain(cfg, *args), dtype)
        got = fmg.generic_bwd_vjp(cfg, *args, d_agg, 80)
        torch.cuda.synchronize()
        _check_vjp(cfg, args, d_agg, got, fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 80), dtype)


@pytest.mark.parametrize("n_msg", MSG_LAYERS)
@pytest.mark.parametrize("mode", ["residual", "replay", "vjp"])
def test_msg_layers_segnn_gradients_match_plain(dev, n_msg, mode):
    """fp32 gradients of every parameter of a two-layer lmax=2 model of
    ``n_msg`` message layers through the kernels (tabled #8/#9, tabled
    #8/#10 under ``remat_kernel``, untabled #11/#14 with neither
    hand-structured backward) against the plain path: 1e-4 * max|ref|."""
    n = 2000
    kw = dict(residual=dict(), replay=dict(remat_kernel=True),
              vjp=dict(residual_bwd=False, replay_bwd=False))[mode]
    m_k = _msg_layers_model(dev, "24x0e+12x1o+6x2e", 2, 2, n_msg, seed=9, **kw)
    m_p = _msg_layers_model(dev, "24x0e+12x1o+6x2e", 2, 2, n_msg, seed=9, use_pallas=False)
    m_p.load_state_dict(m_k.state_dict())
    g, gt = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    want = dict(residual=fmg.GENERIC_TAB_BWD_RES, replay=fmg.GENERIC_TAB_BWD_REP,
                vjp=fmg.GENERIC_BWD_VJP)[mode]
    before = want.launches
    ((m_k(gt if mode != "vjp" else g) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    assert want.launches - before == 2
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


# ---- #8-#14 at hidden widths past the bench configs' (C1 > 192, D > 128)

# (hidden irreps, K, points): C1 / D of layer 1 (301, 180), (257, 150)
# (SEGNN's QM9 width, F = 128) and (501, 300)
WIDE = [("40x0e+20x1o+10x2e", 8, 480), ("46x0e+14x1o+8x2e", 16, 960),
        ("64x0e+32x1o+18x2e", 8, 480)]


def _wide_problem(dev, hidden, k, n, dtype, lmax_attr=2):
    cfg, tab, ucfg, untab, d_agg = _msg_layers_problem(dev, 2, dtype, lmax_attr=lmax_attr,
                                                       hidden=hidden, k=k, n=n)
    assert cfg.widths[0][0] > 192 and cfg.widths[0][1] > 128
    return cfg, tab, ucfg, untab, d_agg


@pytest.mark.parametrize("hidden,k,n", WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_tabled_match_plain(dev, hidden, k, n, dtype):
    """#8 (and its save mode), #9 and #10 at the wide widths against their
    plain versions at the bench widths' limits (``_check_generic``,
    ``_check_bwd``); #9 = #10 bitwise; each kernel launched."""
    cfg, args, _, _, d_agg = _wide_problem(dev, hidden, k, n, dtype)
    before = [kern.launches for kern in fmg.KERNELS[:5]]
    with torch.no_grad():
        agg, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
        ref_agg, ref_ys = fmg.generic_tab_fwd_plain(cfg, *args, save=True)
        assert torch.equal(agg, fmg.generic_tab_fwd(cfg, *args))
        for got, ref in [(agg, ref_agg), *zip(ys, ref_ys, strict=True)]:
            _check_generic(got, ref, dtype)
        res = fmg.generic_tab_bwd(cfg, *args, d_agg, ys=ys)
        rep = fmg.generic_tab_bwd(cfg, *args, d_agg)
        torch.cuda.synchronize()
        _check_bwd(res, fmg.generic_tab_bwd_plain(cfg, *args, d_agg), dtype)
    assert all(torch.equal(x, y) for x, y in zip([res[0], res[1], *res[2]],
                                                 [rep[0], rep[1], *rep[2]], strict=True))
    moved = [kern.launches - b for kern, b in zip(fmg.KERNELS[:5], before)]
    assert moved == [2, 1, 1, 2, 2], moved
    assert (agg[n - 37:] == 0).all()


@pytest.mark.parametrize("hidden,k,n", WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_untabled_match_plain(dev, hidden, k, n, dtype):
    """#11 (and save), #12 and #13 at the wide widths against their plain
    versions; #12 = #13 bitwise, reruns bitwise."""
    _, _, cfg, args, d_agg = _wide_problem(dev, hidden, k, n, dtype)
    before = [kern.launches for kern in (fmg.GENERIC_FWD, fmg.GENERIC_BWD_RES,
                                         fmg.GENERIC_BWD_REP)]
    with torch.no_grad():
        agg, ys = fmg.generic_fwd(cfg, *args, save=True)
        ref_agg, ref_ys = fmg.generic_fwd_plain(cfg, *args, save=True)
        assert torch.equal(agg, fmg.generic_fwd(cfg, *args))
        for got, ref in [(agg, ref_agg), *zip(ys, ref_ys, strict=True)]:
            _check_generic(got, ref, dtype)
        runs = [fmg.generic_bwd(cfg, *args, d_agg, ys=y) for y in (ys, None, ys)]
        torch.cuda.synchronize()
        _check_bwd(runs[0], fmg.generic_bwd_plain(cfg, *args, d_agg), dtype)
    flat = [[r[0], r[1], *r[2]] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other, strict=True))
    moved = [kern.launches - b for kern, b in zip(
        (fmg.GENERIC_FWD, fmg.GENERIC_BWD_RES, fmg.GENERIC_BWD_REP), before)]
    assert moved == [2, 2, 1], moved


@pytest.mark.parametrize("hidden,k,n", WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_vjp_match_plain(dev, hidden, k, n, dtype):
    """#14 at the wide widths against its plain version at backward tile 80
    (``_check_vjp``), reruns bitwise."""
    _, _, cfg, args, d_agg = _wide_problem(dev, hidden, k, n, dtype)
    before = fmg.GENERIC_BWD_VJP.launches, fmg.GENERIC_BWD_VJP_WGRAD.launches
    with torch.no_grad():
        got = fmg.generic_bwd_vjp(cfg, *args, d_agg, 80)
        again = fmg.generic_bwd_vjp(cfg, *args, d_agg, 80)
        torch.cuda.synchronize()
        _check_vjp(cfg, args, d_agg, got, fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 80), dtype)
    assert all(torch.equal(x, y) for x, y in zip([got[0], got[1], *got[2]],
                                                 [again[0], again[1], *again[2]], strict=True))
    assert (fmg.GENERIC_BWD_VJP.launches - before[0],
            fmg.GENERIC_BWD_VJP_WGRAD.launches - before[1]) == (2, 2)


@pytest.mark.parametrize("name", ACT_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_act_kernels_match_plain(dev, generic_act_libs, name, dtype):
    """At 64x0e+32x1o+18x2e (three column blocks of each GEMM, the gate in
    three blocks) under each activation but silu: every route against its
    plain version at the limits of the wide silu tests
    (``_act_routes_match_plain``; #14 by ``_check_vjp``)."""
    hidden, k, n = WIDE[2]
    _act_routes_match_plain(dev, name, dtype, explain_vjp=True, hidden=hidden, k=k, n=n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_attr36_match_plain(dev, dtype):
    """At lmax_attr=5 (A = 36) and 40x0e+20x1o+10x2e: #11 and #14 against
    their plain versions."""
    _, _, cfg, args, d_agg = _wide_problem(dev, *WIDE[0], dtype, lmax_attr=5)
    assert cfg.a == 36
    with torch.no_grad():
        _check_generic(fmg.generic_fwd(cfg, *args), fmg.generic_fwd_plain(cfg, *args), dtype)
        got = fmg.generic_bwd_vjp(cfg, *args, d_agg, 80)
        torch.cuda.synchronize()
        _check_vjp(cfg, args, d_agg, got, fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, 80), dtype)


@pytest.mark.parametrize("hidden,k,n", WIDE)
def test_wide_sparse_tiles_equal_every_tile_bitwise(dev, hidden, k, n):
    """bf16 at the wide widths: the blocked walks over the plan's nonzero
    tiles (#8 with save, #10, #11, #12, #14) are bitwise the same kernels over
    every tile (a skipped tile adds exactly 0, in any column block)."""
    cfg, targs, ucfg, uargs, d_agg = _wide_problem(dev, hidden, k, n, torch.bfloat16)
    outs = []
    with torch.no_grad():
        for tc, uc in ((cfg, ucfg), (dataclasses.replace(cfg, plan=None),
                                     dataclasses.replace(ucfg, plan=None))):
            agg, ys = fmg.generic_tab_fwd(tc, *targs, save=True)
            rep = fmg.generic_tab_bwd(tc, *targs, d_agg)
            uys = fmg.generic_fwd(uc, *uargs, save=True)[1]
            res = fmg.generic_bwd(uc, *uargs, d_agg, ys=uys)
            vjp = fmg.generic_bwd_vjp(uc, *uargs, d_agg, 80)
            outs.append([agg, *ys, rep[0], rep[1], *rep[2], *uys, res[0], res[1], *res[2],
                         vjp[0], vjp[1], *vjp[2]])
        torch.cuda.synchronize()
    assert sum(cfg.plan.counts("fwd")) < sum(fmg._tile_plan(
        dataclasses.replace(cfg, plan=None)).counts("fwd"))
    assert all(torch.equal(x, y) for x, y in zip(*outs, strict=True))


@pytest.mark.parametrize("mode", ["residual", "replay", "vjp"])
def test_wide_segnn_gradients_match_plain(dev, mode):
    """fp32 gradients of every parameter of a two-layer model at
    40x0e+20x1o+10x2e through the kernels (tabled #8/#9, tabled #8/#10
    under ``remat_kernel``, untabled #11/#14 with neither hand-structured
    backward) against the plain path: 1e-4 * max|ref|."""
    n = 2000
    kw = dict(residual=dict(), replay=dict(remat_kernel=True),
              vjp=dict(residual_bwd=False, replay_bwd=False))[mode]
    m_k = _msg_layers_model(dev, WIDE[0][0], 2, 2, 2, seed=9, **kw)
    m_p = _msg_layers_model(dev, WIDE[0][0], 2, 2, 2, seed=9, use_pallas=False)
    m_p.load_state_dict(m_k.state_dict())
    g, gt = _graph(dev, n, 16, 0.12, SEGNNLayer._pick_generic_tile(n))
    target = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    want = dict(residual=fmg.GENERIC_TAB_BWD_RES, replay=fmg.GENERIC_TAB_BWD_REP,
                vjp=fmg.GENERIC_BWD_VJP)[mode]
    before = want.launches
    ((m_k(gt if mode != "vjp" else g) - target) ** 2).mean().backward()
    ((m_p(g) - target) ** 2).mean().backward()
    assert want.launches - before == 2
    for (name, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-4 * float(b.grad.abs().max()), (name, err)


def test_wide_generic_builds_do_not_spill(dev, tmp_path):
    """ptxas of the silu builds of both generic sources (every kernel
    instance): no spill stores or loads; with
    ``test_generic_act_variants_spill_no_more_than_silu``, no build of any
    activation spills."""
    import re
    import subprocess

    from scalable_e3_gnn_torch.kernels import build

    seen = 0
    for src in ("fused_message_generic_tab_fwd", "fused_message_generic_tab_bwd"):
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp_path / f"{src}.so"),
               str(build.CSRC / f"{src}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        assert proc.returncode == 0, proc.stdout[-2000:]
        for entry in re.split(r"Compiling entry function", proc.stdout)[1:]:
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            assert sp is not None and sp.groups() == ("0", "0"), entry[:300]
            seen += 1
    assert seen >= 20
