"""PyTorch port, the generic message kernels #8-#14 at hidden widths past
the bench configs' (layer 1's C1 = 2F+1 > 192, D > 128), against the JAX
package on the same numpy inputs (its Pallas kernels in interpret mode,
compiled once per width): the plain version of every CUDA route at
40x0e+20x1o+10x2e (C1 = 301, D = 180) and 64x0e+32x1o+18x2e (501, 300) (the
tabled forward with its save mode, the residual and the replay backward, the
untabled forward with save and both its backwards, the fallback backward #14
at two backward tiles), a one-layer SEGNN's forward and every parameter's
gradient at SEGNN's QM9 width 46x0e+14x1o+8x2e (F = 128: C1 = 257); and the
kernels' host-side arguments at those widths: the tile plan lists exactly the
tiles that hold a structural nonzero of the fold, its streams follow its
column-block masks in the engine's order (``csrc/generic_mma.cuh``), no chunk
splits a row, the layer table points at each layer's block masks; at the
bench width the streams, masks, chunks and packed weights are the unblocked
ones.

Tolerances, each with its reason (those of ``test_torch_msg_layers.py``):
- fp32 against the JAX kernels: agg, the saved ys, d_hu, d_hs and d_hr atol
  2e-5 (the same math, GEMMs summed in another order); dW' 1e-5 * max|ref|
  (sums over every slot in another order).
- the model: the output atol 2e-5, every gradient 1e-4 * max|ref| per leaf
  (fp32 through the message layers and the update, sums in another order).
- the host-side arguments and the weights' round trip: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.kernels import tile_plan as tp_mod
from scalable_e3_gnn_torch.models.segnn import SEGNNLayer
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax
from tests.test_torch_msg_layers import (ATOL, N, VJP_TILES, _check, _compiled, _jax_routes,
                                         _problem, _slot_major)

WIDE = ["40x0e+20x1o+10x2e", "64x0e+32x1o+18x2e"]  # the JAX routes' widths
QM9 = "46x0e+14x1o+8x2e"  # SEGNN's QM9 width: 128 hidden features at lmax 2
PLAN_WIDTHS = WIDE + [QM9, "48x0e+24x1o+12x2e"]  # the host-side checks' widths


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hidden", WIDE)
def test_wide_tabled_routes_plain_match_jax(hidden):
    """#8 with its save mode, #9 from the saved ys and #10 by replay at a
    wide width: the port's plain versions against ``_fwd_call_tab``,
    ``_bwd_call_res_tab`` and ``_bwd_call_rep_tab``."""
    p, r = _problem(2, hidden=hidden), _jax_routes(2, hidden)
    cfg, args = p["cfg_t"], p["targs_t"]
    assert cfg.widths[0][0] > 192 and cfg.widths[0][1] > 128
    (out, ys), res, rep = r["tab"], r["tab_res"], r["tab_rep"]
    with torch.no_grad():
        agg, tys = fmg.generic_tab_fwd(cfg, *args, save=True)
        got_res = fmg.generic_tab_bwd(cfg, *args, p["d_agg"], ys=tys)
        got_rep = fmg.generic_tab_bwd(cfg, *args, p["d_agg"])
    _check([(agg, out)] + [(y, _slot_major(yj, N, p["k"])) for y, yj in zip(tys, ys)])
    for got, (dp, dhu, dhr) in ((got_res, res), (got_rep, rep)):
        _check([(got[0], dhu), (got[1], dhr)], [(dw, d["w_folded"]) for dw, d in zip(got[2], dp)])


@pytest.mark.parametrize("hidden", WIDE)
def test_wide_untabled_routes_plain_match_jax(hidden):
    """#11 with its save mode, #12 from the saved ys and #13 by replay at a
    wide width against ``_fwd_call``, ``_bwd_call_res`` and
    ``_bwd_call_rep``."""
    p, r = _problem(2, hidden=hidden), _jax_routes(2, hidden)
    cfg, args = p["cfg_u"], p["targs_u"]
    (out, ys), res, rep = r["untab"], r["untab_res"], r["untab_rep"]
    with torch.no_grad():
        agg, tys = fmg.generic_fwd(cfg, *args, save=True)
        got_res = fmg.generic_bwd(cfg, *args, p["d_agg"], ys=tys)
        got_rep = fmg.generic_bwd(cfg, *args, p["d_agg"])
    _check([(agg, out)] + [(y, _slot_major(yj, N, p["k"])) for y, yj in zip(tys, ys)])
    for got, (dp, dhs, dhr) in ((got_res, res), (got_rep, rep)):
        _check([(got[0], dhs), (got[1], dhr)], [(dw, d["w_folded"]) for dw, d in zip(got[2], dp)])


@pytest.mark.parametrize("bwd_tile", VJP_TILES)
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_vjp_route_plain_matches_jax(hidden, bwd_tile):
    """#14's plain version at a wide width against ``_bwd_call`` (the
    in-kernel ``jax.vjp``) at two backward tiles."""
    p = _problem(2, hidden=hidden)
    dp, dhs, dhr = _jax_routes(2, hidden)[f"vjp_{bwd_tile}"]
    with torch.no_grad():
        got = fmg.generic_bwd_vjp(p["cfg_u"], *p["targs_u"], p["d_agg"], bwd_tile)
    _check([(got[0], dhs), (got[1], dhr)], [(dw, d["w_folded"]) for dw, d in zip(got[2], dp)])


def test_qm9_width_model_matches_jax():
    """The one-layer SEGNN at 46x0e+14x1o+8x2e (lmax_attr=2, 128 points,
    K=8, geo-only attributes as bench.py passes them, the tabled dispatch):
    its output and every parameter's MSE gradient against the JAX model
    through its kernels, JAX's parameters carried from the port's seeded
    ones (``params_to_jax``); and the parameters back (``params_from_jax``)
    bit for bit."""
    p = _problem(2, hidden=QM9)
    jm, params, tm, jgt, tgt = p["jm"], p["params"], p["tm"], p["jgt"], p["tgt"]
    assert p["cfg_t"].widths[0][0] == 257
    target = np.random.default_rng(11).standard_normal((N, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ja = jax.jit(jm.compute_attributes_dense)(jgt)
        jat = (None, ja[1], None, ja[3])

        def loss(pr):
            out = jm(pr, jgt, attrs=jat)
            return jnp.mean((out - target) ** 2), out

        jgrad, ref = _compiled(jax.grad(loss, has_aux=True), params)
    tm.zero_grad()
    ta = tm.compute_attributes_dense(tgt)
    assert tm.layers[0]._tab_eligible(N, tgt)
    out = tm(tgt, attrs=(None, ta[1], None, ta[3]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    got = params_to_jax(tm, grad=True)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jgrad)))
    assert len(flat_got) == len(flat_ref)
    for path, g in flat_got:
        r = flat_ref[path]
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), (path, np.abs(g - r).max())
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


# ---- the host-side arguments: the plan, its column blocks, chunks, the layer table

@functools.lru_cache(maxsize=None)
def _kern(hidden):
    """A two-message-layer lmax=2 layer (A=9) at ``hidden``, K=16, tile 200,
    with its tile plan."""
    layer = SEGNNLayer(hidden, "1x0e+1x1o+1x2e", layout="cm", use_pallas=True, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    kern = fmg.FusedMessageGeneric(layer.message_layers, 16, 200)
    return kern, kern.config(9, 640)


def _index(kind, a, c1, d):
    return (tp_mod._fwd_index if kind == "fwd" else tp_mod._dm_index)(a, c1, d)


@pytest.mark.parametrize("hidden", PLAN_WIDTHS)
def test_plan_lists_exactly_the_fold_nonzeros(hidden):
    """At each width the plan lists, per layer and GEMM, exactly the 16x8
    tiles that hold a structural nonzero of the folded, column-permuted W'
    (every nonzero lies in a listed tile, and no listed tile is all zeros);
    the folded weights at seeded parameters come back whole from the packed
    tiles."""
    kern, cfg = _kern(hidden)
    plan = cfg.plan
    nz = tp_mod.fold_structure(kern.layers, [perm for perm, _, _ in kern._gate_fast])
    ws = kern.fold(torch.float32)
    for i, (c1, d, _) in enumerate(cfg.widths):
        for kind in ("fwd", "dm"):
            idx = _index(kind, 9, c1, d)
            flat = np.append(nz[i].reshape(-1), False)
            want = flat[idx].any(axis=-1)  # [A, outer, inner]: the tiles with a nonzero
            tiles = plan._streams[(kind, i, False)]
            assert len(tiles) == int(want.sum()) == plan.counts(kind)[i]
            assert all(flat[t].any() for t in tiles)  # no listed tile is all zeros
            back = plan.unpack(plan.pack(ws, [(kind, i, False)]), kind, i)
            assert torch.equal(back, ws[i])  # every nonzero lies in a listed tile


@pytest.mark.parametrize("hidden", PLAN_WIDTHS)
def test_streams_follow_the_block_masks(hidden):
    """Walking each stream as the engine does (``gemm_fwd``, ``gemm_dm``,
    ``gemm_dm_vjp``: column block, then component (last first for #14's
    vjp), then k-step, then the set bits of the block's mask), every tile is
    the one at that place of W'; the blocks are 16 n-tiles (128 columns of D)
    forward and 24 (192 columns of C1) for dm, as the masks' counts say."""
    _, cfg = _kern(hidden)
    plan = cfg.plan
    blocks = []
    for i, (c1, d, _) in enumerate(cfg.widths):
        for kind, block, nb in (("fwd", tp_mod.FWD_BLOCK, tp_mod.fwd_blocks(d)),
                                ("dm", tp_mod.DM_BLOCK, tp_mod.dm_blocks(c1))):
            idx = _index(kind, 9, c1, d)
            masks = plan.block_masks[(kind, i)]
            assert masks.shape == (nb, 9, idx.shape[1]) and masks.dtype == np.uint32
            assert nb == -(-idx.shape[2] // block)
            blocks.append(nb)
            for rev in ((False, True) if kind == "dm" else (False,)):
                stream, j = plan._streams[(kind, i, rev)], 0
                for b in range(nb):
                    for c in (range(8, -1, -1) if rev else range(9)):
                        for o in range(idx.shape[1]):
                            m = int(masks[b, c, o])
                            assert m < 1 << block
                            for t in range(block):
                                if (m >> t) & 1:
                                    assert np.array_equal(stream[j], idx[c, o, b * block + t])
                                    j += 1
                assert j == len(stream)
    assert max(blocks) > 1


@pytest.mark.parametrize("hidden", PLAN_WIDTHS)
def test_chunks_hold_whole_rows_and_the_layer_table_blocks(hidden):
    """No chunk of the kernels' streams splits a row (a (block, c, k-step)
    mask's tiles) or holds more than ``CHUNK_TILES``; the device mask array
    is every layer's forward block masks, then every layer's dm block masks,
    and the layer table's mask offsets point at them."""
    kern, cfg = _kern(hidden)
    plan = cfg.plan
    for streams in (fmg._fwd_streams(cfg), fmg._chain_streams(cfg, True),
                    fmg._chain_streams(cfg, False), fmg._chain_streams(cfg, True, True)):
        table, per = plan.chunk_table(streams)
        rows = np.concatenate([plan._rows(*st) for st in streams])
        bounds = set(np.concatenate([[0], np.cumsum(rows)]).tolist())
        assert set(table.tolist()) <= bounds  # every chunk starts (and ends) at a row
        assert (np.diff(table) <= tp_mod.CHUNK_TILES).all() and rows.max() <= 24
        assert table[-1] == rows.sum() and sum(per) == len(table) - 1
    flat = plan.masks("cpu").numpy().view(np.uint32)
    lt = {nm: fmg.layer_table(cfg)[:, j] for j, nm in enumerate(fmg._LAYER_FIELDS)}
    for i, (c1, d, _) in enumerate(cfg.widths):
        for kind, off in (("fwd", lt["mask_fwd"][i]), ("dm", lt["mask_dm"][i])):
            bm = plan.block_masks[(kind, i)].reshape(-1)
            assert np.array_equal(flat[off:off + bm.size], bm)
    assert lt["mask_dm"][-1] + plan.block_masks[("dm", len(cfg.widths) - 1)].size == flat.size


def test_bench_width_streams_masks_and_weights_unchanged():
    """At the bench width (24x0e+12x1o+6x2e, A=9: C1 = 181 and 90, D = 108;
    config 5's layers too) every GEMM has one column block, and the streams,
    masks, chunk tables and packed weights are the unblocked ones: tiles in
    (c, k-step, n-tile) order, #14's dm runs per component last first, one
    uint32 mask per (c, k-step)."""
    kern, cfg = _kern("24x0e+12x1o+6x2e")
    plan = cfg.plan
    nz = tp_mod.fold_structure(kern.layers, [perm for perm, _, _ in kern._gate_fast])
    old_masks = []
    for kind in ("fwd", "dm"):
        for i, (c1, d, _) in enumerate(cfg.widths):
            idx = _index(kind, 9, c1, d)
            listed = np.append(nz[i].reshape(-1), False)[idx].any(axis=-1)
            old_masks.append((listed.astype(np.uint64) << np.arange(listed.shape[2],
                                                                    dtype=np.uint64))
                             .sum(axis=-1).astype(np.uint32))
            tiles = idx[listed]
            assert np.array_equal(plan._streams[(kind, i, False)], tiles)
            assert plan.block_masks[(kind, i)].shape[0] == 1
            if kind == "dm":
                runs = np.split(tiles, np.cumsum(listed.reshape(9, -1).sum(axis=1))[:-1])
                assert np.array_equal(plan._streams[(kind, i, True)], np.concatenate(runs[::-1]))
    flat = np.concatenate([m.reshape(-1) for m in old_masks])
    assert plan.masks("cpu").numpy().tolist() == flat.view(np.int32).tolist()
    ws = kern.fold(torch.bfloat16)
    for streams in (fmg._fwd_streams(cfg), fmg._chain_streams(cfg, True),
                    fmg._chain_streams(cfg, True, True)):
        wpk = plan.args(ws, streams)[0]
        whole = torch.cat([w.reshape(-1) for w in ws] + [ws[0].new_zeros(1)])
        base = np.cumsum([0] + [9 * c1 * d for c1, d, _ in cfg.widths])
        idx = np.concatenate([np.where(plan._streams[st] >= 0, plan._streams[st] + base[st[1]],
                                       base[-1]).reshape(-1) for st in streams])
        assert torch.equal(wpk, whole[torch.from_numpy(idx)])
