"""PyTorch port, the launch plans of the kernels, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); what
their wrappers decide before a launch is plain Python and is tested here:

- the weight-gradient reduction (``kernels.fused_message.reduce_plan``):
  the column kernel, four columns a thread (16-byte loads), where NW is a
  multiple of 4, both bases are 16-byte aligned and NW / 4 columns give
  every SM a block (four where the rows fill half a strip stage); else
  strips of 32 columns staged through shared memory
  (any NW, any alignment); rows in batches or stages;
- the halo all-gather #15 (``kernels.halo_ring.ring_plan``): the widest
  word that divides a chunk's bytes and both bases (the tail path for odd
  H and F), one word of the exports a thread, at any P including 1;
- the reduction's function: the in-order fold (``acc += partials[b]``,
  b = 0..n-1, in fp32), which the kernel computes bit for bit, against the
  plain version (``torch.sum``) within 1e-6 * max(1, max|ref|): fp32 sums of
  the same rows in another order;
- the all-gather's function through the kernel's own flat addressing
  (``pools[r*P*chunk + i] = exports[i]``) against the plain version;
- the generic message kernels' tile plan (``kernels.tile_plan``): the
  nonzero tiles at the lmax=2 config, that they cover the fold at any
  parameters (A = 9 and 36), packing against ``_mma_layout``, an emulation
  of the engine over the listed tiles against every tile (bitwise), the
  ring's chunk table, the rebuilt m_0 rows against the chain's;
- the library build's hash over the included headers.
"""

import numpy as np
import pytest
import torch

from scalable_e3_gnn_torch.kernels import build
from scalable_e3_gnn_torch.kernels import fused_message as fm
from scalable_e3_gnn_torch.kernels import halo_ring as hr
from scalable_e3_gnn_torch.kernels import tile_plan as tp_mod

H100_SMS = 132
ALIGNED = (1 << 20, 1 << 24)


S = dict(cols=False, threads=fm.STRIP_THREADS, rows=fm.STRIP_ROWS)  # the strip kernel
C4 = dict(cols=True, threads=fm.COL_THREADS, rows=fm.COL_ROWS)  # 16-byte column loads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nblocks,nw,ptrs,want", [
    # config 3's #2 partials: 9280 / 4 columns would leave SMs without a
    # block, so strips of 32 columns, the 132 rows in one stage
    (132, 9280, ALIGNED, dict(S, grid=290, batches=1)),
    (264, 9280, ALIGNED, dict(S, grid=290, batches=2)),
    # #12's and #14's partials at 250k: columns, 16-byte loads
    (22, 263412, ALIGNED, dict(C4, grid=1029, batches=2)),
    (128, 263412, ALIGNED, dict(C4, grid=1029, batches=8)),
    # NW not a multiple of 4: strips, the last one part full
    (22, 263413, ALIGNED, dict(S, grid=8232, batches=1)),
    (5, 1001, ALIGNED, dict(S, grid=32, batches=1)),
    (33, 3, ALIGNED, dict(S, grid=1, batches=1)),
    # a base off 16 bytes (partials, then out)
    (22, 263412, (ALIGNED[0] + 4, ALIGNED[1]), dict(S, grid=8232, batches=1)),
    (22, 263412, (ALIGNED[0], ALIGNED[1] + 8), dict(S, grid=8232, batches=1)),
    # one row, and none
    (1, 263412, ALIGNED, dict(C4, grid=1029, batches=1)),
    (1, 9280, ALIGNED, dict(S, grid=290, batches=1)),
    (0, 9280, ALIGNED, dict(S, grid=290, batches=0)),
    # either side of one block per SM at four columns a thread
    (64, 4 * 64 * H100_SMS, ALIGNED, dict(C4, grid=H100_SMS, batches=4)),
    (64, 4 * 64 * H100_SMS - 4, ALIGNED, dict(S, grid=1056, batches=1)),
    # rows that fill half a strip stage: either side of COL_BLOCKS_PER_SM
    # blocks per SM
    (132, 4 * 4 * 64 * H100_SMS, ALIGNED, dict(C4, grid=4 * H100_SMS, batches=9)),
    (132, 4 * 4 * 64 * H100_SMS - 4, ALIGNED, dict(S, grid=4224, batches=1)),
    # the Wide #2's partials: 64x0e+32x1o and 96x0e+48x1o (strips, as timed),
    # 128x0e+64x1o (columns)
    (132, 36992, ALIGNED, dict(S, grid=1156, batches=1)),
    (132, 83136, ALIGNED, dict(S, grid=2598, batches=1)),
    (132, 147712, ALIGNED, dict(C4, grid=577, batches=9)),
])
def test_reduce_plan(nblocks, nw, ptrs, want):
    plan = fm.reduce_plan(nblocks, nw, ptrs, H100_SMS)
    assert plan == want
    # every column has a thread, and no block is wholly past the end
    per_block = 4 * plan["threads"] if plan["cols"] else fm.STRIP_COLS
    assert plan["grid"] * per_block >= nw > (plan["grid"] - 1) * per_block


def _fold(x):
    """The kernel's function: each column summed in row order in fp32, from 0."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32)
    for row in x:
        acc += row
    return acc


@pytest.mark.parametrize("nblocks,nw,seed", [(132, 9280, 0), (22, 2634, 1), (128, 2634, 2),
                                             (7, 1001, 3), (1, 263, 4)])
def test_in_order_fold_against_plain_reduce(nblocks, nw, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((nblocks, nw))
                         .astype(np.float32))
    ref = fm.tab_bwd_reduce_plain(x)
    got = _fold(x)
    assert float((got - ref).abs().max()) <= 1e-6 * max(1.0, float(ref.abs().max()))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(fm.tab_bwd_reduce(x), ref)
    if nblocks == 1:
        assert torch.equal(got, x[0])


@pytest.mark.parametrize("p,h,f,elem,ptrs,want", [
    # config 3's P=4 shape in bf16 and fp32: 16-byte words
    (4, 3090, 80, 2, ALIGNED, dict(vec_bytes=16, chunk=30900, grid=483)),
    (4, 3090, 80, 4, ALIGNED, dict(vec_bytes=16, chunk=61800, grid=966)),
    # odd H and F: the element (bf16) and word (fp32) tail paths
    (2, 37, 13, 2, ALIGNED, dict(vec_bytes=2, chunk=481, grid=4)),
    (8, 61, 7, 4, ALIGNED, dict(vec_bytes=4, chunk=427, grid=14)),
    (4, 129, 80, 2, ALIGNED, dict(vec_bytes=16, chunk=1290, grid=21)),
    (3, 37, 6, 2, ALIGNED, dict(vec_bytes=4, chunk=111, grid=2)),
    # P = 1: one pool, the exports copied
    (1, 37, 13, 4, ALIGNED, dict(vec_bytes=4, chunk=481, grid=2)),
    (1, 3090, 80, 2, ALIGNED, dict(vec_bytes=16, chunk=30900, grid=121)),
    # a base only 8-byte aligned
    (4, 3090, 80, 2, (ALIGNED[0] + 8, ALIGNED[1]), dict(vec_bytes=8, chunk=61800, grid=966)),
])
def test_ring_plan(p, h, f, elem, ptrs, want):
    plan = hr.ring_plan(p, h * f * elem, ptrs)
    assert plan == dict(threads=hr.THREADS, **want)
    assert plan["grid"] * plan["threads"] >= p * plan["chunk"]


def test_ring_plan_without_a_word():
    with pytest.raises(ValueError):
        hr.ring_plan(2, 3, ALIGNED)


@pytest.mark.parametrize("p,h,f", [(1, 37, 13), (2, 37, 13), (4, 129, 80), (8, 61, 7)])
def test_ring_flat_addressing_is_the_all_gather(p, h, f):
    """The kernel's addressing, word by word: flat index i of the exports
    goes to pools[r*P*chunk + i] for every r."""
    x = torch.from_numpy(np.random.default_rng(p * h).standard_normal((p, h, f))
                         .astype(np.float32))
    n = x.numel()
    flat = x.reshape(-1)
    pools = torch.empty(p * n)
    for r in range(p):
        pools[r * n + torch.arange(n)] = flat
    assert torch.equal(pools.view(p, p, h, f), hr.ring_all_gather_plain(x))
    assert torch.equal(hr.ring_all_gather_fwd(x), hr.ring_all_gather_plain(x))


# ---- the generic message kernels' tile plan (kernels/tile_plan.py)

def _generic_kern(lmax_attr: int, hidden: str = "24x0e+12x1o+6x2e", seed: int = 0):
    from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
    from scalable_e3_gnn_torch.models.segnn import SEGNN

    model = SEGNN("2x0e+1x1o", hidden, "1x1o", lmax_attr=lmax_attr, num_layers=1, layout="cm",
                  use_pallas=True, device="cpu", generator=torch.Generator().manual_seed(seed))
    return fmg.FusedMessageGeneric(model.layers[0].message_layers, 16, 200)


def test_tile_plan_counts_at_the_lmax2_config():
    """The lmax=2 config (hidden 24x0e+12x1o+6x2e, A=9): 483 of 1,512 and
    228 of 756 forward tiles, 456 and 219 dm tiles hold a nonzero."""
    plan = _generic_kern(2).tile_plan()
    assert plan.a == 9 and plan.widths == ((181, 108), (90, 108))
    assert plan.counts("fwd") == (483, 228)
    assert plan.counts("dm") == (456, 219)
    dense = tp_mod.TilePlan.dense(9, plan.widths)
    assert dense.counts("fwd") == (1512, 756) and dense.counts("dm") == (1449, 756)


@pytest.mark.parametrize("lmax_attr", [2, 5])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tile_plan_covers_every_nonzero_of_the_fold(lmax_attr, seed):
    """For A = 9 and 36 and three parameter seeds, every nonzero of the
    folded, column-permuted W' lies in a listed forward tile and a listed
    dm tile (the plan comes from the structure, not from these values)."""
    kern = _generic_kern(lmax_attr)
    plan = kern.tile_plan()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for layer in kern.layers:
            for p in layer.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape))))
    for i, w in enumerate(kern.fold(torch.float32)):
        c1, _ = plan.widths[i]
        rows, cols = (w != 0).nonzero(as_tuple=True)
        assert rows.numel() > 0
        c, k = (rows // c1).numpy(), (rows % c1).numpy()
        n = cols.numpy()
        fb, db = tp_mod.FWD_BLOCK, tp_mod.DM_BLOCK
        fwd, dm = plan.block_masks[("fwd", i)], plan.block_masks[("dm", i)]
        assert ((fwd[n // 8 // fb, c, k // 16] >> (n // 8 % fb)) & 1).all()
        assert ((dm[k // 8 // db, c, n // 16] >> (k // 8 % db)) & 1).all()
    assert plan.a == (36 if lmax_attr == 5 else 9)


@pytest.mark.parametrize("kind", ["fwd", "dm"])
def test_pack_then_unpack_is_the_mma_layout(kind):
    """The packed tiles scattered back are ``_mma_layout``'s tensor bit for
    bit (the listed tiles hold every nonzero); the vjp's dm stream is the
    same tiles with the components' runs last first."""
    from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg

    kern = _generic_kern(2)
    plan = kern.tile_plan()
    ws = kern.fold(torch.bfloat16)
    for i, (c1, d) in enumerate(plan.widths):
        packed = plan.pack(ws, [(kind, i, False)])
        assert packed.numel() == 128 * plan.counts(kind)[i]
        assert torch.equal(fmg._mma_layout(plan.unpack(packed, kind, i), 9, c1, d),
                           fmg._mma_layout(ws[i], 9, c1, d))
        if kind == "dm":
            (masks,) = plan.block_masks[("dm", i)]  # one column block at this width
            per_c = [sum(bin(int(m)).count("1") for m in row) for row in masks]
            runs = list(packed.split([128 * x for x in per_c]))
            assert torch.equal(plan.pack(ws, [("dm", i, True)]), torch.cat(runs[::-1]))


def _stream_order(plan, kind, layer):
    """(c, k-step, n-tile) -> the tile's place in its stream, walking the
    stream as the engine does: column blocks, then rows (c, k-step), each
    row's n-tiles in the block."""
    masks = plan.block_masks[(kind, layer)]
    width = tp_mod.FWD_BLOCK if kind == "fwd" else tp_mod.DM_BLOCK
    order = {}
    for b in range(masks.shape[0]):
        for c in range(plan.a):
            for ks in range(masks.shape[2]):
                for j in range(width):
                    if (int(masks[b, c, ks]) >> j) & 1:
                        order[(c, ks, b * width + j)] = len(order)
    return order


def _emulate(plan, packed, kind, layer, x, attr, listed_only=True):
    """The engine's product for the rows x in fp32, its tiles decoded from
    the packed stream in fragment order (lane 4 g + t holds B[2t, g],
    B[2t+1, g], B[2t+8, g], B[2t+9, g]): per component c a fresh sum over the
    k-steps in order, each tile's 16-deep product added, scaled by attr_c,
    summed over c.  ``listed_only=False`` walks every tile of the dense
    layout and multiplies the unlisted ones as zeros."""
    c1, d = plan.widths[layer]
    kdim, ndim = (c1, d) if kind == "fwd" else (d, c1)
    kp, np_ = -(-kdim // 16) * 16, -(-ndim // 8) * 8
    xs = torch.zeros((x.shape[0], kp))
    xs[:, :kdim] = x.float()
    lane = torch.arange(32)
    kk = (2 * (lane % 4)[:, None] + torch.tensor([0, 1, 8, 9])[None, :]).reshape(-1)
    nn = (lane // 4).repeat_interleave(4)
    tiles = packed.float().view(-1, 128)
    order = _stream_order(plan, kind, layer)
    acc = torch.zeros((x.shape[0], np_))
    for c in range(plan.a):
        t = torch.zeros_like(acc)
        for ks in range(kp // 16):
            for nt in range(np_ // 8):
                j = order.get((c, ks, nt))
                if j is None and listed_only:
                    continue
                b = torch.zeros((16, 8))
                if j is not None:
                    b[kk, nn] = tiles[j]
                t[:, nt * 8:nt * 8 + 8] += xs[:, ks * 16:ks * 16 + 16] @ b
        acc += t * attr[:, c:c + 1]
    return acc[:, :ndim]


@pytest.mark.parametrize("kind", ["fwd", "dm"])
def test_engine_emulation_listed_tiles_equal_every_tile_bitwise(kind):
    """A plain emulation of the engine's per-component k-order over the
    listed tiles equals the same emulation over every tile bitwise (a zero
    tile adds exactly 0 in fp32), and the dense product within fp32 sums."""
    kern = _generic_kern(2, hidden="4x0e+2x1o+2x2e")
    plan = kern.tile_plan()
    ws = kern.fold(torch.bfloat16)
    rng = np.random.default_rng(5)
    for layer, (c1, d) in enumerate(plan.widths):
        packed = plan.pack(ws, [(kind, layer, False)])
        kdim = c1 if kind == "fwd" else d
        x = torch.from_numpy(rng.standard_normal((48, kdim)).astype(np.float32)).bfloat16()
        attr = torch.from_numpy(rng.standard_normal((48, plan.a)).astype(np.float32))
        got = _emulate(plan, packed, kind, layer, x, attr)
        every = _emulate(plan, packed, kind, layer, x, attr, listed_only=False)
        assert torch.equal(got, every)
        w = ws[layer].float().view(plan.a, c1, d)
        ref = sum((x.float() @ (w[c] if kind == "fwd" else w[c].T)) * attr[:, c:c + 1]
                  for c in range(plan.a))
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lmax_attr", [2, 5])
def test_chunk_table_holds_whole_rows(lmax_attr):
    """The ring's chunks: at most 32 tiles, whole rows (a mask's tiles),
    every stream starting a chunk, the last entry the end; the engine's rule
    (a row past the chunk opens the next) walks exactly these chunks."""
    plan = _generic_kern(lmax_attr).tile_plan()
    for replay in (True, False):
        for vjp in (False, True):
            streams = ((("fwd", 0, False), ("fwd", 1, False)) if replay else ()) + (
                ("dm", 1, vjp), ("dm", 0, vjp))
            table, per = plan.chunk_table(streams)
            assert len(table) == sum(per) + 1
            assert table[-1] == sum(len(plan.index([s])) // 128 for s in streams)
            assert (np.diff(table) <= tp_mod.CHUNK_TILES).all() and (np.diff(table) > 0).all()
            q, i = 0, 0
            for s, nq in zip(streams, per):
                q0, ce = q, table[q]
                assert table[q] == i  # a stream starts a chunk
                for n in plan._rows(*s):
                    if n == 0:
                        continue
                    if i + n > ce:
                        assert table[q] == i  # the row opens the next chunk
                        ce = table[q + 1]
                        q += 1
                    assert i + n <= ce
                    i += n
                assert q - q0 == nq


@pytest.mark.parametrize("hidden", ["24x0e+12x1o+6x2e", "8x0e+4x1o+3x2e"])
def test_rebuilt_m0_rows_equal_the_chains_m0(hidden):
    """The weight-gradient kernel's m_0 rows rebuilt from hs, h and geo2
    (``_m0_rows``: [hs[k, i] || h[i] || d2 || 0], the kernel's addressing)
    equal the chain's m_0 bitwise, at an even and an odd F (90, 35)."""
    from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg

    kern = _generic_kern(2, hidden=hidden)
    cfg = kern.config(9, 0)
    n, k, f = 37, cfg.k, cfg.f
    rng = np.random.default_rng(6)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
    hs, h, geo2 = mk(k, n, f), mk(n, f), mk(n, k * (cfg.a + 2))
    got = fmg._m0_rows(cfg, hs, h, geo2)
    ref = fmg._slot_rows_km(cfg, hs, h, geo2, 0, n)[0]
    assert got.shape == (n * k, -(-(2 * f + 1) // 16) * 16)
    assert torch.equal(got[:, :2 * f + 1], ref) and (got[:, 2 * f + 1:] == 0).all()
    # the untabled weight-gradient wrapper's plain version reads those rows
    m1, dy1, dy2 = mk(n * k, 96), mk(n * k, 112), mk(n * k, 112)
    assert torch.equal(fmg.generic_bwd_wgrad(cfg, hs, h, geo2, [None, m1], [dy1, dy2], 3),
                       fmg.generic_tab_bwd_wgrad_plain(cfg, geo2, [got, m1], [dy1, dy2], 3))


def test_config_carries_the_plan_only_at_its_attribute_width():
    """``FusedMessageGeneric.config`` attaches the plan of its layers at their
    attribute width; configs compare without it."""
    from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg

    kern = _generic_kern(2)
    cfg = kern.config(9, 0)
    assert cfg.plan is kern.tile_plan() and kern.config(4, 0).plan is None
    assert cfg == fmg.GenericConfig(k=16, tile=200, u=0, a=9, widths=cfg.widths)
    assert fmg._tile_plan(fmg.GenericConfig(k=16, tile=200, u=0, a=9, widths=cfg.widths)) \
        .counts("fwd") == (1512, 756)


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header it includes
    (and theirs): an edited header never loads a stale library."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    first = build._lib_path("k")
    assert [p.name for p in build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert build._lib_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build._lib_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert build._lib_path("k") not in (first, second)
