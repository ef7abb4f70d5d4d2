"""Fused SEGNN message MLP + neighbourhood aggregation (lmax=1): the tabled
gather, the untabled slot-major (km) form and the packed node-major form.

Counterpart of ``scalable_e3_gnn_tpu/kernels/fused_message.py::
fused_message_aggregate_tabled``, ``fused_message_aggregate_km`` and
``fused_message_aggregate`` with their custom VJPs.  Per receiver i and slot k:

    agg[i] = sum_k mask[i,k] * MLP2(MLP1([h_s || h_r || d^2], sh), sh)

two gated L1 tensor-product layers (silu scalars, sigmoid-gated vectors) with
the edge's sh attribute, where the sender row is ``h[gtab[i // tile,
loc[i,k]]]`` and ``loc == U`` means no sender (a zero row).

Forward, two implementations of one function:

- ``fused_message_aggregate_tabled_plain``: PyTorch ops with the TPU
  kernel's rounding points (inputs in the data dtype, products accumulated in
  fp32, the layer-1 outputs cast to the data dtype between the layers, each
  masked slot message cast to the data dtype before the fp32 K-sum, the
  output cast at the end).  The CPU tests and the on-card checks use it.
- ``fused_message_aggregate_tabled_fwd``: a CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel
  ``csrc/fused_message_tab_fwd.cu`` or raises.

Backward (the counterpart of ``_vjp_bwd_tab``), likewise:

- ``fused_message_aggregate_tabled_bwd_plain``: recompute both layers, then
  the hand VJP of ``_layer_bwd``.  The cotangent intermediates ``d_o1``,
  ``d_o0``, ``d_A``, ``d_Xvs``, ``d_f0``, ``d_Xs``, ``d_Xv`` and the masked
  ``d_m`` are cast to the data dtype; weight gradients accumulate in fp32
  and are cast to the weights' dtype at the end.  Sender cotangents fold into
  the per-tile table (``d_hu``), receiver cotangents sum over K (``d_hr``).
- ``fused_message_aggregate_tabled_bwd``: the hand-written kernel
  ``csrc/fused_message_tab_bwd.cu`` for CUDA tensors (which gives ``d_hu``,
  ``d_hr`` and the fp32 weight gradients, reduced over blocks in a fixed
  order), the plain version for CPU tensors.

In bf16 every kernel of this module (#1-#7) runs on the tensor-core engine
``csrc/lmax1_mma.cuh``: up to 32x0e+16x1o on its Bench kernels (the layers
padded to that width, held in registers), wider on its Wide kernels, built
as instances m = 1 .. ``WIDE_MAX_M`` of m scalar blocks (32 lanes) and m
vector blocks (16 channels); a width runs ``wide_instance(hs, hv)``, its
missing blocks zero-padded, walked a column block at a time with the
weights streamed through shared memory, and a width past the largest
instance raises before any launch.  The Wide forward takes a scratch buffer
for its packed weights (``fused_message_fwd_scratch_bytes``); the Wide
backward keeps them past its partials.  In fp32 (the check path) on the
FMA units.  Each source builds a library for the plain kernels (fp32, the
Bench kernels) and one for each Wide instance (``LMAX1_WIDE=1`` with
``LMAX1_WIDE_M=m``), all compiled side by side; the wrappers pick one by
the widths (``_variant``).

Both backward forms end in the same PyTorch epilogue, the split reverse-table
gather-sum ``d_h = d_hr + sum_q d_hu[revd[:, q]] + segment_sum(d_hu[remp],
remn)``; its segment sum is ``torch.segment_reduce`` over the node-sorted
remainder, so it is deterministic on either device.

``fused_message_aggregate_tabled`` is the differentiable entry point
(``FusedMessageTabled``, the counterpart of the JAX ``custom_vjp``).
Geometry (``d2``, ``attr``, ``maskf``) and the index tables get no
cotangent: they are graph constants during training.

The km form (``fused_message_aggregate_km``, ``FusedMessageKm``) takes the
senders pre-gathered slot-major, hs3 [K, N, F] (row k*N + i), and the
geometry node-major, geo2 [N, K*6]; the same two CUDA sources serve it under
a compile-time addressing flag (#3/#4 forward, #5 backward with the same
reduction), beside their plain versions ``fused_message_aggregate_km_plain``
(the km2 form's rounding points) and ``km_bwd_plain``.  Its backward returns
d_hs per slot; the caller's gather (``take_dense_symmetric_km`` or
``gather_km``) carries it back to the nodes.

The packed form (``fused_message_aggregate``, ``FusedMessage``; the TPU's
``pack > 1`` path) takes the senders pre-gathered node-major and the
geometry flat, in the JAX operand shapes: hs [N*K/p, p*F], d2 and maskf
[N*K/p, p], attr [N*K/p, 4p], contiguous views of the [N*K, .] rows (row
i*K + k = slot k of receiver i).  The same two CUDA sources serve it under a
third addressing (#6 forward, #7 backward with the same reduction).  The
TPU's lane packing is a layout; what ``pack`` changes in the result is where
bf16 rounds: the p masked slot messages of a group are summed in fp32 and
rounded once before the fp32 sum over the K/p groups, and likewise the
receiver cotangent ``d_hr``; otherwise the rounding is the tabled kernel's
(``fused_message_aggregate_plain``, ``flat_bwd_plain``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .build import CudaKernel

__all__ = ["MessageConfig", "FusedMessageTabled", "fused_message_aggregate_tabled",
           "fused_message_aggregate_tabled_fwd", "fused_message_aggregate_tabled_plain",
           "fused_message_aggregate_tabled_bwd", "fused_message_aggregate_tabled_bwd_plain",
           "split_weights", "sender_epilogue", "tab_bwd_plain", "tab_bwd_kernels", "tab_bwd_kernel",
           "tab_bwd_reduce", "tab_bwd_reduce_plain", "reduce_plan",
           "FusedMessageKm", "fused_message_aggregate_km", "fused_message_aggregate_km_fwd",
           "fused_message_aggregate_km_plain", "fused_message_aggregate_km_bwd",
           "fused_message_aggregate_km_bwd_plain", "km_bwd_plain", "km_bwd_kernel",
           "km_bwd_kernels",
           "FusedMessage", "fused_message_aggregate", "fused_message_aggregate_fwd",
           "fused_message_aggregate_plain", "fused_message_aggregate_bwd",
           "fused_message_aggregate_bwd_plain", "flat_bwd_plain", "flat_bwd_kernel",
           "flat_bwd_kernels",
           "TAB_FWD", "TAB_BWD", "TAB_BWD_REDUCE", "KM_FWD", "KM_BWD", "FLAT_FWD", "FLAT_BWD",
           "KERNELS", "WIDE_MAX_M", "wide_instance", "wide_occupancy"]

CG110 = 1.0 / math.sqrt(3.0)
CG011 = 1.0 / math.sqrt(3.0)

# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
# the Wide kernels' instances (csrc/lmax1_mma.cuh: LMAX1_WIDE_MAX_M): m scalar
# blocks of 32 lanes and m vector blocks of 16 channels, m = 1 .. WIDE_MAX_M
WIDE_MAX_M = 4
# the libraries of each lmax=1 source: the plain build and one library of the
# Wide kernels an instance (``LMAX1_WIDE_M``), so that the instances compile
# side by side (see ``_variant``)
WIDE_BUILDS = {m: ("LMAX1_WIDE=1", f"LMAX1_WIDE_M={m}") for m in range(1, WIDE_MAX_M + 1)}
_VARIANTS = ((), *WIDE_BUILDS.values())
TAB_FWD = CudaKernel("fused_message_tab_fwd", {
    # dtype, hs, hv, k
    "fused_message_tab_fwd_smem_bytes": (ctypes.c_long, [_I] * 4),
    # dtype, 14 pointers (h, d2, attr, maskf, loc, gtab, 6 weights, out,
    # scratch), npad, hs, hv, k, tile, u, stream
    "fused_message_tab_fwd": (_I, [_I] + [_P] * 14 + [_I] * 6 + [_P]),
    # dtype, hs, hv: the bytes of the scratch a launch takes (0: none)
    "fused_message_fwd_scratch_bytes": (ctypes.c_long, [_I] * 3),
    # addressing (0 tabled, 1 km, 2 flat), hs, hv, k, out [2] (warps a
    # block, blocks an SM): the Wide kernel's shared memory a block
    "lmax1_wide_fwd_config": (ctypes.c_long, [_I] * 4 + [_P]),
}, variants=_VARIANTS)
TAB_BWD = CudaKernel("fused_message_tab_bwd", {
    # dtype, hs, hv, k, tile, u
    "fused_message_tab_bwd_smem_bytes": (ctypes.c_long, [_I] * 6),
    # dtype, hs, hv, k, tile, u, ntiles: blocks of the main kernel (sizes its scratch)
    "fused_message_tab_bwd_grid": (_I, [_I] * 7),
    # dtype, 13 inputs (h, d2, attr, maskf, loc, gtab, 6 weights, d_agg),
    # 4 outputs/scratch (d_hu, d_hr, d_hs scratch, weight partials),
    # npad, hs, hv, k, tile, u, grid, stream
    "fused_message_tab_bwd": (_I, [_I] + [_P] * 17 + [_I] * 7 + [_P]),
    # dtype, hs, hv, grid: the floats of the partials' buffer
    "fused_message_bwd_partials_floats": (ctypes.c_long, [_I] * 4),
    # addressing, hs, hv, k, tile, u, n, out [2] (warps a block, blocks an
    # SM): the Wide kernel's shared memory a block
    "lmax1_wide_bwd_config": (ctypes.c_long, [_I] * 7 + [_P]),
}, variants=_VARIANTS)
# the same source's reduction: the fixed-order sum of the per-block
# weight-gradient partials ([nblocks, nw] -> [nw] fp32)
TAB_BWD_REDUCE = CudaKernel("fused_message_tab_bwd_reduce", {
    # partials, out, nblocks, nw, the column kernel (1) or the strips (0), stream
    "fused_message_tab_bwd_reduce": (_I, [_P, _P, _I, _I, _I, _P]),
}, source_name="fused_message_tab_bwd")
# the reduction's two kernels (the constants of the source): strips of
# STRIP_COLS columns, STRIP_THREADS threads loading STRIP_ROWS rows a stage;
# four columns a thread in blocks of COL_THREADS, COL_ROWS rows a batch
STRIP_COLS, STRIP_THREADS, STRIP_ROWS = 32, 256, 136
COL_THREADS, COL_ROWS = 64, 16
# where the partials' rows fill at least half a strip stage, the column
# kernel's blocks an SM at the least: with fewer, the strips were faster
# (H100 device ms, strips against columns, kernels/lmax1_ab.py: [132, 36992]
# 0.00538-0.00569 / 0.00677-0.00685, [132, 83136] 0.01697 / 0.01813)
COL_BLOCKS_PER_SM = 4

# the untabled (km) kernels #3/#4 and #5: the same two sources, the senders
# read from the slot-major hs3 [K, N, F] (row k*N + i) and the geometry from
# the node-major geo2 [N, K*6]
KM_FWD = CudaKernel("fused_message_km_fwd", {
    "fused_message_tab_fwd_smem_bytes": (ctypes.c_long, [_I] * 4),
    # dtype, 11 pointers (hs3, hr, geo2, 6 weights, out, scratch), n, hs,
    # hv, k, stream
    "fused_message_km_fwd": (_I, [_I] + [_P] * 11 + [_I] * 4 + [_P]),
    "fused_message_fwd_scratch_bytes": (ctypes.c_long, [_I] * 3),
}, source_name="fused_message_tab_fwd", variants=_VARIANTS)
KM_BWD = CudaKernel("fused_message_km_bwd", {
    # dtype, hs, hv, k
    "fused_message_km_bwd_smem_bytes": (ctypes.c_long, [_I] * 4),
    # dtype, hs, hv, k, n: blocks of the main kernel
    "fused_message_km_bwd_grid": (_I, [_I] * 5),
    # dtype, 10 inputs (hs3, hr, geo2, 6 weights, d_agg), 3 outputs (d_hs,
    # d_hr, weight partials), n, hs, hv, k, grid, stream
    "fused_message_km_bwd": (_I, [_I] + [_P] * 13 + [_I] * 5 + [_P]),
    "fused_message_bwd_partials_floats": (ctypes.c_long, [_I] * 4),
}, source_name="fused_message_tab_bwd", variants=_VARIANTS)

# the packed node-major kernels #6 and #7: the same two sources, the senders
# read from hs [N*K, F] (row i*K + k) and the geometry from the flat d2,
# attr, maskf rows; pack sets where the K-sum and d_hr round
FLAT_FWD = CudaKernel("fused_message_flat_fwd", {
    "fused_message_tab_fwd_smem_bytes": (ctypes.c_long, [_I] * 4),
    # dtype, 13 pointers (hs, hr, d2, attr, maskf, 6 weights, out, scratch),
    # n, hs, hv, k, pack, stream
    "fused_message_flat_fwd": (_I, [_I] + [_P] * 13 + [_I] * 5 + [_P]),
    "fused_message_fwd_scratch_bytes": (ctypes.c_long, [_I] * 3),
}, source_name="fused_message_tab_fwd", variants=_VARIANTS)
FLAT_BWD = CudaKernel("fused_message_flat_bwd", {
    "fused_message_km_bwd_smem_bytes": (ctypes.c_long, [_I] * 4),
    # dtype, hs, hv, k, n: blocks of the main kernel
    "fused_message_flat_bwd_grid": (_I, [_I] * 5),
    # dtype, 12 inputs (hs, hr, d2, attr, maskf, 6 weights, d_agg), 3 outputs
    # (d_hs, d_hr, weight partials), n, hs, hv, k, pack, grid, stream
    "fused_message_flat_bwd": (_I, [_I] + [_P] * 15 + [_I] * 6 + [_P]),
    "fused_message_bwd_partials_floats": (ctypes.c_long, [_I] * 4),
}, source_name="fused_message_tab_bwd", variants=_VARIANTS)

KERNELS = (TAB_FWD, TAB_BWD, TAB_BWD_REDUCE, KM_FWD, KM_BWD, FLAT_FWD, FLAT_BWD)


@dataclass(frozen=True)
class MessageConfig:
    hs: int  # scalar multiplicity of the hidden irreps
    hv: int  # vector multiplicity
    k: int  # neighbour slots per node
    tile: int = 64  # receivers per gather-table tile
    u: int = 0  # compact sender-table size
    # slots per group of the packed form (K % pack == 0): the K-sum and d_hr
    # round once per group
    pack: int = 1

    def __post_init__(self):
        if self.pack < 1 or self.k % self.pack:
            raise ValueError(f"pack {self.pack} does not divide K = {self.k}")

    @property
    def f(self) -> int:  # flat hidden dim (cm layout)
        return self.hs + 3 * self.hv

    @property
    def s1(self) -> int:  # scalars entering layer 1 (h_s || h_r || d^2)
        return 2 * self.hs + 1

    @property
    def v1(self) -> int:  # vector channels (per component) entering layer 1
        return 2 * self.hv

    def weight_shapes(self):
        """The six weight blocks (W0, W1S, W1V per layer), as the kernels take them."""
        s1, v1, hs, hv = self.s1, self.v1, self.hs, self.hv
        return [(s1 + v1, hs + hv), (s1, hv), (v1, hv), (hs + hv, hs + hv), (hs, hv), (hv, hv)]


def split_weights(cfg: MessageConfig, w0e1, w1o1, w0e2, w1o2):
    """Reference-layout weights -> (W0, W1S, W1V) per layer.

    ``W1S`` are the rows of ``w_l1o`` fed by scalars, ``W1V`` the rows fed by
    vectors; the TPU kernel's block-diagonal copy of ``W1V`` is a layout for
    its matrix unit and is not needed here."""
    return (w0e1, w1o1[: cfg.s1], w1o1[cfg.s1 :], w0e2, w1o2[: cfg.hs], w1o2[cfg.hs :])


def _join_weight_grads(dws, dtype):
    """Six fp32 blocks -> the four reference-layout gradients in ``dtype``
    (``d_w1o*`` is the row concat ``[dW1S; dW1V]``)."""
    dw0a, dw1sa, dw1va, dw0b, dw1sb, dw1vb = dws
    return (dw0a.to(dtype), torch.cat([dw1sa, dw1va]).to(dtype),
            dw0b.to(dtype), torch.cat([dw1sb, dw1vb]).to(dtype))


def _check_blocks(cfg, ws, ref_name, ref, named):
    """The six weight blocks' shapes, and the named inputs and the weights in
    the dtype of ``ref``."""
    for i, (w, shp) in enumerate(zip(ws, cfg.weight_shapes())):
        if tuple(w.shape) != shp:
            raise ValueError(f"weight block {i} has shape {tuple(w.shape)}, wants {shp}")
    for name, x in (*named, *(("weight", w) for w in ws)):
        if x.dtype != ref.dtype:
            raise TypeError(f"{name} is {x.dtype}, {ref_name} is {ref.dtype}")


def _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws):
    npad, f = h.shape
    if f != cfg.f:
        raise ValueError(f"h has {f} features, config wants {cfg.f}")
    if npad % cfg.tile:
        raise ValueError(f"rows {npad} are not a multiple of the tile {cfg.tile}")
    e = npad * cfg.k
    for name, x, width in (("d2", d2, 1), ("attr", attr, 4), ("maskf", maskf, 1), ("loc", loc, 1)):
        if tuple(x.shape) != (e, width):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, wants {(e, width)}")
    if tuple(gtab.shape) != (npad // cfg.tile, cfg.u):
        raise ValueError(f"gtab has shape {tuple(gtab.shape)}, wants {(npad // cfg.tile, cfg.u)}")
    if loc.dtype != torch.int32 or gtab.dtype != torch.int32:
        raise TypeError("loc and gtab must be int32")
    _check_blocks(cfg, ws, "h", h, (("d2", d2), ("attr", attr), ("maskf", maskf)))


def _check_d_agg(h, d_agg):
    """The cotangent of agg: the receivers' shape and dtype."""
    if d_agg.shape != h.shape or d_agg.dtype != h.dtype:
        raise ValueError(f"d_agg is {d_agg.dtype} {tuple(d_agg.shape)}, wants "
                         f"{h.dtype} {tuple(h.shape)}")


def _check_tables(h, revd, remp, remn):
    npad = h.shape[0]
    if revd.dim() != 2 or revd.shape[0] != npad:
        raise ValueError(f"revd has shape {tuple(revd.shape)}, wants ({npad}, q0)")
    if remp.dim() != 1 or remp.shape != remn.shape:
        raise ValueError(f"remp {tuple(remp.shape)} and remn {tuple(remn.shape)} must be equal 1-D")
    for name, x in (("revd", revd), ("remp", remp), ("remn", remn)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32")


def _layer(xs, xv, s, v, w0, w1s, w1v, hs, rnd=None):
    """One gated L1 TP layer in fp32.  xs [R, S]; xv [R, 3, V]; s [R, 1];
    v [R, 3].  Returns m0 [R, hs], m1 [R, 3, hv] and the residuals the VJP
    reads: (xs, f0, xvs, o0, o1).

    ``rnd`` (rounds to the data dtype and widens back) selects the km2
    form's rounding points (``_tp_layer_km2``): w0's vector rows come
    already scaled by CG110 and rounded (``_fold_cg``), so the dot lanes
    are not scaled here, and A and the gate's sigmoid are rounded before
    they are used."""
    dot = xv[:, 0] * v[:, 0:1] + xv[:, 1] * v[:, 1:2] + xv[:, 2] * v[:, 2:3]
    f0 = torch.cat([xs * s, dot if rnd else CG110 * dot], dim=-1)
    o0 = f0 @ w0
    a = xs @ w1s
    if rnd:
        a = rnd(a)
    xvs = xv * s[:, :, None]
    o1 = CG011 * (v[:, :, None] * a[:, None, :] + xvs @ w1v)  # [R, 3, hv]
    m0 = F.silu(o0[:, :hs])
    g = torch.sigmoid(o0[:, hs:])
    m1 = o1 * (rnd(g) if rnd else g)[:, None, :]
    return m0, m1, (xs, f0, xvs, o0, o1)


def _layer_vjp(res, d_m0, d_m1, s, v, w0, w1s, w1v, hs, rnd):
    """VJP of ``_layer`` with respect to its inputs and weights (s and v are
    constants), the counterpart of ``_layer_bwd``.  ``rnd`` rounds to the data
    dtype and widens back to fp32.  Returns d_xs [R, S], d_xv [R, 3, V],
    dW0, dW1S, dW1V (fp32)."""
    xs, f0, xvs, o0, o1 = res
    g = torch.sigmoid(o0[:, hs:])
    d_o1 = rnd(d_m1 * g[:, None, :])
    d_g = (d_m1 * o1).sum(dim=1)
    sg = torch.sigmoid(o0[:, :hs])
    dsilu = sg * (1.0 + o0[:, :hs] * (1.0 - sg))
    d_o0 = rnd(torch.cat([d_m0 * dsilu, d_g * g * (1.0 - g)], dim=-1))
    d_b = CG011 * d_o1  # [R, 3, hv]
    d_a = rnd(CG011 * (d_o1 * v[:, :, None]).sum(dim=1))  # [R, hv]
    d_xvs = rnd(d_b @ w1v.T)  # [R, 3, V]
    dw1v = torch.einsum("rcv,rch->vh", xvs, d_b)
    d_xs = d_a @ w1s.T
    dw1s = xs.T @ d_a
    d_f0 = rnd(d_o0 @ w0.T)
    dw0 = f0.T @ d_o0
    n_s = xs.shape[1]
    d_xs = rnd(d_xs + d_f0[:, :n_s] * s)
    d_dot = CG110 * d_f0[:, n_s:]
    d_xv = rnd(d_xvs * s[:, :, None] + d_dot[:, None, :] * v[:, :, None])
    return d_xs, d_xv, dw0, dw1s, dw1v


def _slot_inputs(cfg, h, d2, attr, loc, gtab):
    """Layer-1 inputs of every slot in fp32: xs [E, S1] = [h_s || h_r || d2],
    xv [E, 3, V1] = [h_s,c || h_r,c], and the sh scalar s [E, 1] and vector
    v [E, 3]; also the flat table index of each slot's sender (U*ntiles for
    no sender)."""
    npad, f = h.shape
    hs, hv, k, u = cfg.hs, cfg.hv, cfg.k, cfg.u
    e = npad * k
    hf = h.float()
    # senders through the per-tile table; loc == U selects the zero row
    flat = gtab.long().reshape(-1)
    hu = torch.cat([hf[torch.clamp(flat, max=npad - 1)], hf.new_zeros((1, f))])
    locl = loc.long().reshape(-1)
    tile_of = torch.arange(e, device=h.device) // (cfg.tile * k)
    slot_tab = torch.where(locl < u, tile_of * u + locl, flat.numel())
    hs_rows = hu[slot_tab]  # [E, F]
    hr_rows = hf.repeat_interleave(k, dim=0)
    xs = torch.cat([hs_rows[:, :hs], hr_rows[:, :hs], d2.float()], dim=-1)
    xv = torch.cat([hs_rows[:, hs:].reshape(e, 3, hv), hr_rows[:, hs:].reshape(e, 3, hv)], -1)
    return xs, xv, attr[:, 0:1].float(), attr[:, 1:4].float(), slot_tab


def fused_message_aggregate_tabled_plain(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                         w0e1, w1o1, w0e2, w1o2):
    """agg [Npad, F] in h's dtype, by PyTorch ops (any device).

    h [Npad, F] cm-layout node features, Npad a multiple of cfg.tile;
    d2/attr/maskf [Npad*K, 1|4|1] edge geometry in h's dtype; loc [Npad*K, 1]
    int32 slot -> table index (pad U); gtab [Npad/tile, U] int32 node ids
    (pad Npad); weights with norms folded in, in the reference row layout.
    """
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws)
    dt = h.dtype
    npad, f = h.shape
    e = npad * cfg.k
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.float() for w in ws)
    xs, xv, s, v, _ = _slot_inputs(cfg, h, d2, attr, loc, gtab)
    m0, m1, _ = _layer(xs, xv, s, v, w0a, w1sa, w1va, cfg.hs)
    m0, m1 = m0.to(dt).float(), m1.to(dt).float()
    m0, m1, _ = _layer(m0, m1, s, v, w0b, w1sb, w1vb, cfg.hs)
    msg = (torch.cat([m0, m1.reshape(e, 3 * cfg.hv)], dim=-1) * maskf.float()).to(dt).float()
    return msg.reshape(npad, cfg.k, f).sum(dim=1).to(dt)


def sender_epilogue(d_hr, d_hu, revd, remp, remn):
    """d_h [Npad, F] = d_hr + the sender cotangents gathered from the tables.

    The counterpart of the split reverse-table epilogue of ``_vjp_bwd_tab``:
    node v's sender cotangent is the sum of its ``d_hu`` rows over the tiles
    whose tables hold it; the first ``q0`` of them come through the dense
    ``revd`` [Npad, q0] (pad ntiles*U: dropped), the rest through the
    node-sorted remainder ``remp``/``remn`` (pad node Npad: dropped), summed
    per node in fp32 by ``torch.segment_reduce`` (fixed order, no atomics)."""
    dt = d_hr.dtype
    npad = d_hr.shape[0]
    nrow = d_hu.shape[0]
    acc = d_hr
    for q in range(revd.shape[1]):
        idx = revd[:, q].long()
        valid = (idx < nrow).to(dt)[:, None]
        acc = acc + d_hu[torch.clamp(idx, max=nrow - 1)] * valid
    rem = d_hu[torch.clamp(remp.long(), max=nrow - 1)].float()
    offsets = torch.searchsorted(remn, torch.arange(npad + 1, dtype=remn.dtype,
                                                    device=remn.device))
    seg = torch.segment_reduce(rem, "sum", offsets=offsets.long(), axis=0, unsafe=True)
    return acc + seg.to(dt)


def _rows_bwd(cfg: MessageConfig, xs1, xv1, s, v, maskf, ws, d_rows, dt, acc=torch.float32):
    """The backward over slot rows (the stacked-lane ``_layer_bwd`` of the
    TPU kernels): recompute both layers, then the hand VJP, the cotangent
    intermediates rounded to ``dt``.  ``d_rows`` [E, F] is the receiver
    cotangent of every slot row (fp32).  Returns the sender and receiver
    parts of the layer-1 input cotangents, d_hs and d_hr rows [E, F] (fp32
    holding ``dt`` values), and the six fp32 weight-gradient blocks.
    ``acc``: the dtype of the sums between the roundings (float64: the
    same rounding points with the sums exact to fp32, a reference for
    implementations that sum in another order)."""
    hs, hv = cfg.hs, cfg.hv
    e = xs1.shape[0]
    rnd = lambda x: x.to(dt).to(acc)
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.to(acc) for w in ws)
    m0, m1, res1 = _layer(xs1, xv1, s, v, w0a, w1sa, w1va, hs)
    _, _, res2 = _layer(rnd(m0), rnd(m1), s, v, w0b, w1sb, w1vb, hs)
    # d_agg at every slot, masked and cast to the data dtype
    d_m = rnd(d_rows * maskf.to(acc))
    d_xs2, d_xv2, dw0b, dw1sb, dw1vb = _layer_vjp(
        res2, d_m[:, :hs], d_m[:, hs:].reshape(e, 3, hv), s, v, w0b, w1sb, w1vb, hs, rnd)
    d_xs1, d_xv1, dw0a, dw1sa, dw1va = _layer_vjp(
        res1, d_xs2, d_xv2, s, v, w0a, w1sa, w1va, hs, rnd)
    # layer-1 input cotangents -> sender and receiver features (d2 is geometry)
    d_hs = torch.cat([d_xs1[:, :hs], d_xv1[:, :, :hv].reshape(e, 3 * hv)], dim=-1)
    d_hrr = torch.cat([d_xs1[:, hs:2 * hs], d_xv1[:, :, hv:].reshape(e, 3 * hv)], dim=-1)
    return d_hs, d_hrr, (dw0a, dw1sa, dw1va, dw0b, dw1sb, dw1vb)


def tab_bwd_plain(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab, ws, d_agg):
    """The plain backward up to the epilogue, on split weights ``ws`` (six
    blocks): (d_hu [ntiles*U, F], d_hr [Npad, F], six fp32 weight-gradient
    blocks)."""
    dt = h.dtype
    npad, f = h.shape
    k = cfg.k
    xs1, xv1, s, v, slot_tab = _slot_inputs(cfg, h, d2, attr, loc, gtab)
    d_hs, d_hrr, dws = _rows_bwd(cfg, xs1, xv1, s, v, maskf, ws,
                                 d_agg.float().repeat_interleave(k, dim=0), dt)
    d_hr = d_hrr.reshape(npad, k, f).sum(dim=1).to(dt)
    ntab = gtab.numel()
    valid = slot_tab < ntab
    d_hu = h.new_zeros((ntab, f), dtype=torch.float32)
    d_hu.index_add_(0, slot_tab[valid], d_hs[valid])
    return d_hu.to(dt), d_hr, dws


def fused_message_aggregate_tabled_bwd_plain(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                             revd, remp, remn, w0e1, w1o1, w0e2, w1o2, d_agg):
    """(d_h, d_w0e1, d_w1o1, d_w0e2, d_w1o2) by PyTorch ops (any device).

    Arguments as in the plain forward, plus the split reverse table
    ``revd`` [Npad, q0], ``remp``/``remn`` [M] (int32) and the cotangent
    ``d_agg`` [Npad, F] in h's dtype.  d_h is in h's dtype, the weight
    gradients in the weights' dtype."""
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws)
    _check_tables(h, revd, remp, remn)
    if d_agg.shape != h.shape:
        raise ValueError(f"d_agg has shape {tuple(d_agg.shape)}, wants {tuple(h.shape)}")
    d_hu, d_hr, dws = tab_bwd_plain(cfg, h, d2, attr, maskf, loc, gtab, ws, d_agg)
    return (sender_epilogue(d_hr, d_hu, revd, remp, remn),
            *_join_weight_grads(dws, w0e1.dtype))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# the widths the Bench kernels take (csrc/lmax1_mma.cuh: fits)
BENCH_HS, BENCH_HV = 32, 16
def wide_instance(hs: int, hv: int) -> int:
    """The Wide kernels' instance m that a width runs: max(ns, nv), ns =
    ceil(hs / 32) scalar blocks and nv = ceil(hv / 16) vector blocks (at
    least one each; the missing blocks zero-padded).  Raises ValueError,
    naming the widths and the largest instance, past WIDE_MAX_M."""
    m = max(1, -(-hs // 32), -(-hv // 16))
    if m > WIDE_MAX_M:
        raise ValueError(
            f"widths {hs}x0e+{hv}x1o need the Wide kernels' instance m = {m}; the largest "
            f"instance built is m = {WIDE_MAX_M} ({32 * WIDE_MAX_M}x0e+{16 * WIDE_MAX_M}x1o)")
    return m


def _variant(x, cfg: MessageConfig) -> tuple:
    """The library of a launch on ``x``: the Wide kernels' instance for bf16
    past the Bench widths (raising past the largest instance), else the
    plain one."""
    wide = cfg.hs > BENCH_HS or cfg.hv > BENCH_HV
    if x.dtype == torch.bfloat16 and wide:
        return WIDE_BUILDS[wide_instance(cfg.hs, cfg.hv)]
    return ()


def _fwd_scratch(lib, cfg: MessageConfig, code: int, device):
    """The scratch a forward launch takes (the Wide kernels' packed weights),
    or None."""
    nbytes = lib.fused_message_fwd_scratch_bytes(code, cfg.hs, cfg.hv)
    return torch.empty((nbytes,), dtype=torch.uint8, device=device) if nbytes > 0 else None


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def wide_occupancy(cfg: MessageConfig, form: str, backward: bool, n: int) -> dict:
    """The Wide kernel's launch at ``cfg``'s widths on the current card
    (``form`` "tab", "km" or "flat"; ``n`` receivers): its instance, warps a
    block, blocks an SM (the occupancy query), warps an SM and shared memory
    a block (bytes)."""
    addr = {"tab": 0, "km": 1, "flat": 2}[form]
    m = wide_instance(cfg.hs, cfg.hv)
    out = (ctypes.c_int * 2)()
    if backward:
        smem = TAB_BWD.lib(WIDE_BUILDS[m]).lmax1_wide_bwd_config(
            addr, cfg.hs, cfg.hv, cfg.k, cfg.tile, cfg.u, n, ctypes.addressof(out))
    else:
        smem = TAB_FWD.lib(WIDE_BUILDS[m]).lmax1_wide_fwd_config(
            addr, cfg.hs, cfg.hv, cfg.k, ctypes.addressof(out))
    return dict(instance=m, warps_per_block=out[0],
                blocks_per_sm=out[1], warps_per_sm=out[0] * out[1], smem_bytes_per_block=smem)


def _check_smem(smem: int) -> None:
    """Raise, naming the bytes, where a block needs more shared memory than
    the card has (before any launch)."""
    if smem > _MAX_SMEM:
        raise ValueError(f"widths need {smem} bytes of shared memory per block (max {_MAX_SMEM})")


def _partials(lib, cfg: MessageConfig, code: int, grid: int, device):
    """The per-block weight-gradient partials [grid, NW] fp32, a view of the
    buffer the main kernel takes (the Wide kernels keep their accumulators
    past it)."""
    nw = sum(a * b for a, b in cfg.weight_shapes())
    total = lib.fused_message_bwd_partials_floats(code, cfg.hs, cfg.hv, grid)
    buf = torch.empty((total,), dtype=torch.float32, device=device)
    return buf[:grid * nw].view(grid, nw)


def _cuda_args(h, args):
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {h.dtype}")
    for x in args:
        if x.device != h.device:
            raise ValueError(f"all inputs must be on {h.device}, found {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def fused_message_aggregate_tabled_fwd(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                       w0e1, w1o1, w0e2, w1o2):
    """agg [Npad, F]: the hand-written CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Arguments as in the plain version."""
    if h.device.type == "cpu":
        return fused_message_aggregate_tabled_plain(cfg, h, d2, attr, maskf, loc, gtab,
                                                    w0e1, w1o1, w0e2, w1o2)
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws)
    args = (h, d2, attr, maskf, loc, gtab, *ws)
    _cuda_args(h, args)
    _check_slot_rows(h.shape[0], cfg.k)
    lib = TAB_FWD.lib(_variant(h, cfg))
    code = _DTYPE_CODE[h.dtype]
    smem = lib.fused_message_tab_fwd_smem_bytes(code, cfg.hs, cfg.hv, cfg.k)
    _check_smem(smem)
    out = torch.empty_like(h)
    scratch = _fwd_scratch(lib, cfg, code, h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = lib.fused_message_tab_fwd(
            code, *(x.data_ptr() for x in args), out.data_ptr(), _ptr(scratch),
            h.shape[0], cfg.hs, cfg.hv, cfg.k, cfg.tile, cfg.u, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_tab_fwd launch failed with CUDA error {rc}")
    TAB_FWD.launches += 1
    return out


def tab_bwd_kernel(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab, ws, d_agg):
    """The backward's main CUDA kernel (``csrc/fused_message_tab_bwd.cu``) on
    split weights ``ws`` (six blocks): returns ``(d_hu [ntiles*U, F], d_hr
    [Npad, F], partials [grid, NW] fp32)``, the per-block weight-gradient
    sums that ``tab_bwd_reduce`` adds up."""
    _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws)
    _check_d_agg(h, d_agg)
    args = (h, d2, attr, maskf, loc, gtab, *ws, d_agg)
    _cuda_args(h, args)
    _check_slot_rows(h.shape[0], cfg.k)
    lib = TAB_BWD.lib(_variant(h, cfg))
    code = _DTYPE_CODE[h.dtype]
    dims = (cfg.hs, cfg.hv, cfg.k, cfg.tile, cfg.u)
    smem = lib.fused_message_tab_bwd_smem_bytes(code, *dims)
    _check_smem(smem)
    npad, f = h.shape
    ntiles = npad // cfg.tile
    with torch.cuda.device(h.device):
        grid = lib.fused_message_tab_bwd_grid(code, *dims, ntiles)
    if grid < 1:
        raise RuntimeError(f"fused_message_tab_bwd: no launch configuration (code {grid})")
    d_hu = torch.empty((ntiles * cfg.u, f), dtype=h.dtype, device=h.device)
    d_hr = torch.empty_like(h)
    # the d_hs rows the table sums read (data dtype): the fp32 kernel's per
    # block, for the tile it is on; the bf16 kernel's per slot (it sums the
    # tables after all its rounds), and the per-block fp32 weight-gradient
    # partial sums
    rows = npad * cfg.k if h.dtype == torch.bfloat16 else grid * cfg.tile * cfg.k
    dhs_scratch = torch.empty((rows, f), dtype=h.dtype, device=h.device)
    partials = _partials(lib, cfg, code, grid, h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = lib.fused_message_tab_bwd(
            code, *(x.data_ptr() for x in args), d_hu.data_ptr(),
            d_hr.data_ptr(), dhs_scratch.data_ptr(), partials.data_ptr(), npad, *dims,
            grid, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_tab_bwd launch failed with CUDA error {rc}")
    TAB_BWD.launches += 1
    return d_hu, d_hr, partials


def tab_bwd_reduce_plain(partials):
    """[nblocks, NW] fp32 -> [NW]: the sum over blocks, by PyTorch."""
    return partials.sum(dim=0)


def reduce_plan(nblocks: int, nw: int, ptrs, sms: int) -> dict:
    """The reduction's launch for partials [nblocks, nw] at base addresses
    ``ptrs`` (partials, out) on a card of ``sms`` SMs: the column kernel
    (``cols``, four columns a thread, one 16-byte load a row) where nw is a
    multiple of 4, every base 16-byte aligned and nw / 4 columns give each SM
    a block of COL_THREADS (COL_BLOCKS_PER_SM blocks where the rows fill half
    a strip stage); else the strip kernel (any nw and alignment).  Both fold
    each column in block order: the same bits.  ``grid`` blocks of
    ``threads``; ``batches`` trips over ``rows`` rows each (the rows a block
    has in flight at once)."""
    per_sm = 1 if 2 * nblocks < STRIP_ROWS else COL_BLOCKS_PER_SM
    if nw % 4 == 0 and all(p % 16 == 0 for p in ptrs) and nw >= 4 * COL_THREADS * per_sm * sms:
        return dict(cols=True, threads=COL_THREADS, grid=-(-nw // (4 * COL_THREADS)),
                    rows=COL_ROWS, batches=-(-nblocks // COL_ROWS))
    return dict(cols=False, threads=STRIP_THREADS, grid=-(-nw // STRIP_COLS), rows=STRIP_ROWS,
                batches=-(-nblocks // STRIP_ROWS))


def tab_bwd_reduce(partials):
    """[nblocks, NW] fp32 -> [NW] fp32 summed in block order: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if partials.device.type == "cpu":
        return tab_bwd_reduce_plain(partials)
    if partials.device.type != "cuda":
        raise ValueError(f"no kernel for device {partials.device}")
    if partials.dtype != torch.float32 or partials.dim() != 2 or not partials.is_contiguous():
        raise TypeError("partials must be a contiguous 2-D float32 tensor")
    nblocks, nw = partials.shape
    out = torch.empty((nw,), dtype=torch.float32, device=partials.device)
    if nw == 0:
        return out
    sms = torch.cuda.get_device_properties(partials.device).multi_processor_count
    plan = reduce_plan(nblocks, nw, (partials.data_ptr(), out.data_ptr()), sms)
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    with torch.cuda.device(partials.device):
        rc = TAB_BWD_REDUCE.lib().fused_message_tab_bwd_reduce(
            partials.data_ptr(), out.data_ptr(), nblocks, nw, int(plan["cols"]), stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_tab_bwd_reduce launch failed with CUDA error {rc}")
    TAB_BWD_REDUCE.launches += 1
    return out


def tab_bwd_kernels(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab, ws, d_agg):
    """The kernel counterpart of ``tab_bwd_plain``: the main kernel, then the
    fixed-order reduction of its weight-gradient partials."""
    d_hu, d_hr, partials = tab_bwd_kernel(cfg, h, d2, attr, maskf, loc, gtab, ws, d_agg)
    return d_hu, d_hr, _split_partials(cfg, tab_bwd_reduce(partials))


def fused_message_aggregate_tabled_bwd(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                       revd, remp, remn, w0e1, w1o1, w0e2, w1o2, d_agg):
    """(d_h, d_w0e1, d_w1o1, d_w0e2, d_w1o2): the hand-written CUDA kernel
    plus the epilogue for CUDA tensors, the plain version for CPU tensors.
    Arguments as in ``fused_message_aggregate_tabled_bwd_plain``."""
    if h.device.type == "cpu":
        return fused_message_aggregate_tabled_bwd_plain(
            cfg, h, d2, attr, maskf, loc, gtab, revd, remp, remn, w0e1, w1o1, w0e2, w1o2,
            d_agg)
    _check_tables(h, revd, remp, remn)
    _cuda_args(h, (revd, remp, remn))
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    d_hu, d_hr, dws = tab_bwd_kernels(cfg, h, d2, attr, maskf, loc, gtab, ws, d_agg)
    return (sender_epilogue(d_hr, d_hu, revd, remp, remn),
            *_join_weight_grads(dws, w0e1.dtype))


class FusedMessageTabled(torch.autograd.Function):
    """The tabled fused message with its hand-written backward: the
    counterpart of the JAX ``custom_vjp`` (``_vjp_fwd_tab``/``_vjp_bwd_tab``).

    Only the inputs are saved; the backward recomputes both layers and reads
    each sender row through the table, so the gathered table ``h[gtab]`` is
    never stored."""

    @staticmethod
    def forward(ctx, cfg, h, d2, attr, maskf, loc, gtab, revd, remp, remn,
                w0e1, w1o1, w0e2, w1o2):
        ctx.cfg = cfg
        ctx.save_for_backward(h, d2, attr, maskf, loc, gtab, revd, remp, remn,
                              w0e1, w1o1, w0e2, w1o2)
        return fused_message_aggregate_tabled_fwd(cfg, h, d2, attr, maskf, loc, gtab,
                                                  w0e1, w1o1, w0e2, w1o2)

    @staticmethod
    def backward(ctx, d_agg):
        saved = ctx.saved_tensors
        d_agg = d_agg.to(saved[0].dtype).contiguous()
        d_h, dw0e1, dw1o1, dw0e2, dw1o2 = fused_message_aggregate_tabled_bwd(
            ctx.cfg, *saved, d_agg)
        # cfg, h, d2, attr, maskf, loc, gtab, revd, remp, remn, 4 weights
        return (None, d_h) + (None,) * 8 + (dw0e1, dw1o1, dw0e2, dw1o2)


def fused_message_aggregate_tabled(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                   revd, remp, remn, w0e1, w1o1, w0e2, w1o2):
    """agg [Npad, F], differentiable in h and the four weights.

    Arguments as in the JAX ``fused_message_aggregate_tabled``: those of the
    plain forward plus the split reverse table (``revd``, ``remp``,
    ``remn``) that the backward's epilogue reads.  CUDA tensors run the
    hand-written kernels (or raise), CPU tensors the plain versions."""
    return FusedMessageTabled.apply(cfg, h, d2, attr, maskf, loc, gtab, revd, remp, remn,
                                    w0e1, w1o1, w0e2, w1o2)


# ---------------------------------------------------------------------------
# Untabled, slot-major (km): the counterpart of ``fused_message_aggregate_km``.
# The senders come pre-gathered as hs3 [K, N, F] (row k*N + i = slot k of
# receiver i) and the geometry as the node-major packed geo2 [N, K*6] (sh 4,
# d2, mask per slot).  The forward rounds where the TPU's default form, km2,
# rounds; the backward where its default backward, the stacked-lane
# ``_bwd_kernel_km``, rounds (the tabled backward's rounding, no table fold).
# ---------------------------------------------------------------------------


def _check_km(cfg: MessageConfig, hs3, hr, geo2, ws):
    """The shapes ``_fwd_call_km`` asserts, and one dtype for all inputs."""
    n, f = hr.shape
    if f != cfg.f:
        raise ValueError(f"hr has {f} features, config wants {cfg.f}")
    if n % cfg.tile:
        raise ValueError(f"rows {n} are not a multiple of the tile {cfg.tile}")
    if tuple(hs3.shape) != (cfg.k, n, cfg.f):
        raise ValueError(f"hs3 has shape {tuple(hs3.shape)}, wants {(cfg.k, n, cfg.f)}")
    if tuple(geo2.shape) != (n, cfg.k * 6):
        raise ValueError(f"geo2 has shape {tuple(geo2.shape)}, wants {(n, cfg.k * 6)}")
    _check_blocks(cfg, ws, "hr", hr, (("hs3", hs3), ("geo2", geo2)))


def _km_slot_inputs(cfg: MessageConfig, hs3, hr, geo2, acc=torch.float32):
    """Layer-1 inputs of every slot row (slot-major, row k*N + i) in fp32:
    xs [E, S1], xv [E, 3, V1], the sh scalar s [E, 1] and vector v [E, 3],
    and the mask [E, 1]; in ``acc`` (fp32 unless given)."""
    k, n, f = hs3.shape
    hs, hv = cfg.hs, cfg.hv
    e = k * n
    hsf = hs3.to(acc).reshape(e, f)
    hrf = hr.to(acc).repeat(k, 1)
    g = geo2.to(acc).reshape(n, k, 6).transpose(0, 1).reshape(e, 6)
    xs = torch.cat([hsf[:, :hs], hrf[:, :hs], g[:, 4:5]], dim=-1)
    xv = torch.cat([hsf[:, hs:].reshape(e, 3, hv), hrf[:, hs:].reshape(e, 3, hv)], dim=-1)
    return xs, xv, g[:, 0:1], g[:, 1:4], g[:, 5:6]


def _ksum(x):
    """[K, N, F] -> [N, F]: the slots added in slot order in fp32 (``_ksum_km``)."""
    acc = x[0].float()
    for j in range(1, x.shape[0]):
        acc = acc + x[j].float()
    return acc


def _fold_cg(w0, n_s):
    """W0 with its vector rows (row n_s on) scaled by CG110 and rounded in
    the weight dtype: the km2 form's ``w0v`` (``_km2_mats``)."""
    cg = torch.tensor(CG110, dtype=w0.dtype, device=w0.device)
    return torch.cat([w0[:n_s], cg * w0[n_s:]])


def fused_message_aggregate_km_plain(cfg: MessageConfig, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2):
    """agg [N, F] in hr's dtype, by PyTorch ops (any device).

    hs3 [K, N, F] slot-major sender rows; hr [N, F] receiver rows, N a
    multiple of cfg.tile; geo2 [N, K*6] node-major geometry (sh 4, d2, mask
    per slot); weights with norms folded in, in the reference row layout.
    Rounds to the data dtype where the km2 form does: the CG110-scaled W0
    vector rows, A, the gate's sigmoid and each layer's output; the masked
    slot messages sum over K in fp32 in slot order."""
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_km(cfg, hs3, hr, geo2, ws)
    dt = hr.dtype
    k, n, f = hs3.shape
    rnd = lambda x: x.to(dt).float()
    w0a, w1sa, w1va, w0b, w1sb, w1vb = ws
    w0a, w0b = _fold_cg(w0a, cfg.s1), _fold_cg(w0b, cfg.hs)
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.float() for w in (w0a, w1sa, w1va, w0b, w1sb, w1vb))
    xs, xv, s, v, mask = _km_slot_inputs(cfg, hs3, hr, geo2)
    m0, m1, _ = _layer(xs, xv, s, v, w0a, w1sa, w1va, cfg.hs, rnd)
    m0, m1, _ = _layer(rnd(m0), rnd(m1), s, v, w0b, w1sb, w1vb, cfg.hs, rnd)
    msg = rnd(torch.cat([m0, m1.reshape(k * n, 3 * cfg.hv)], dim=-1)) * mask
    return _ksum(msg.reshape(k, n, f)).to(dt)


def km_bwd_plain(cfg: MessageConfig, hs3, hr, geo2, ws, d_agg, acc=torch.float32):
    """The plain km backward on split weights ``ws`` (six blocks): (d_hs
    [K, N, F] written per slot, d_hr [N, F] (the fp32 K-sum, cast), six fp32
    weight-gradient blocks).  Rounds where ``_bwd_kernel_km`` does; ``acc``
    as in ``_rows_bwd``."""
    dt = hr.dtype
    k, n, f = hs3.shape
    xs1, xv1, s, v, mask = _km_slot_inputs(cfg, hs3, hr, geo2, acc)
    d_hs, d_hrr, dws = _rows_bwd(cfg, xs1, xv1, s, v, mask, ws, d_agg.to(acc).repeat(k, 1), dt,
                                 acc)
    return (d_hs.to(dt).reshape(k, n, f), _ksum(d_hrr.reshape(k, n, f)).to(dt), dws)


def fused_message_aggregate_km_bwd_plain(cfg: MessageConfig, hs3, hr, geo2, w0e1, w1o1, w0e2,
                                         w1o2, d_agg):
    """(d_hs, d_hr, d_w0e1, d_w1o1, d_w0e2, d_w1o2) by PyTorch ops (any
    device): arguments as in the plain forward plus the cotangent d_agg
    [N, F]; the weight gradients in the weights' dtype."""
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_km(cfg, hs3, hr, geo2, ws)
    _check_d_agg(hr, d_agg)
    d_hs, d_hr, dws = km_bwd_plain(cfg, hs3, hr, geo2, ws, d_agg)
    return (d_hs, d_hr, *_join_weight_grads(dws, w0e1.dtype))


def _check_slot_rows(n, k):
    if k * n >= 2 ** 31:
        raise ValueError(f"K*N = {k * n} slot rows: the kernels index rows in 32 bits")


def fused_message_aggregate_km_fwd(cfg: MessageConfig, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2):
    """agg [N, F]: the hand-written CUDA kernel (#3/#4) for CUDA tensors, the
    plain version for CPU tensors.  Arguments as in the plain version."""
    if hr.device.type == "cpu":
        return fused_message_aggregate_km_plain(cfg, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2)
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_km(cfg, hs3, hr, geo2, ws)
    args = (hs3, hr, geo2, *ws)
    _cuda_args(hr, args)
    _check_slot_rows(hr.shape[0], cfg.k)
    lib = KM_FWD.lib(_variant(hr, cfg))
    code = _DTYPE_CODE[hr.dtype]
    smem = lib.fused_message_tab_fwd_smem_bytes(code, cfg.hs, cfg.hv, cfg.k)
    _check_smem(smem)
    out = torch.empty_like(hr)
    scratch = _fwd_scratch(lib, cfg, code, hr.device)
    stream = torch.cuda.current_stream(hr.device).cuda_stream
    with torch.cuda.device(hr.device):
        rc = lib.fused_message_km_fwd(code, *(x.data_ptr() for x in args), out.data_ptr(),
                                      _ptr(scratch), hr.shape[0], cfg.hs, cfg.hv, cfg.k, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_km_fwd launch failed with CUDA error {rc}")
    KM_FWD.launches += 1
    return out


def km_bwd_kernel(cfg: MessageConfig, hs3, hr, geo2, ws, d_agg):
    """The km backward's main CUDA kernel (#5, ``csrc/fused_message_tab_bwd.cu``)
    on split weights ``ws``: returns ``(d_hs [K, N, F], d_hr [N, F],
    partials [grid, NW] fp32)``, the per-block weight-gradient sums that
    ``tab_bwd_reduce`` adds up."""
    _check_km(cfg, hs3, hr, geo2, ws)
    _check_d_agg(hr, d_agg)
    args = (hs3, hr, geo2, *ws, d_agg)
    _cuda_args(hr, args)
    _check_slot_rows(hr.shape[0], cfg.k)
    lib = KM_BWD.lib(_variant(hr, cfg))
    code = _DTYPE_CODE[hr.dtype]
    dims = (cfg.hs, cfg.hv, cfg.k)
    smem = lib.fused_message_km_bwd_smem_bytes(code, *dims)
    _check_smem(smem)
    n = hr.shape[0]
    with torch.cuda.device(hr.device):
        grid = lib.fused_message_km_bwd_grid(code, *dims, n)
    if grid < 1:
        raise RuntimeError(f"fused_message_km_bwd: no launch configuration (code {grid})")
    d_hs = torch.empty_like(hs3)
    d_hr = torch.empty_like(hr)
    partials = _partials(lib, cfg, code, grid, hr.device)
    stream = torch.cuda.current_stream(hr.device).cuda_stream
    with torch.cuda.device(hr.device):
        rc = lib.fused_message_km_bwd(code, *(x.data_ptr() for x in args),
                                      d_hs.data_ptr(), d_hr.data_ptr(), partials.data_ptr(), n,
                                      *dims, grid, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_km_bwd launch failed with CUDA error {rc}")
    KM_BWD.launches += 1
    return d_hs, d_hr, partials


def _split_partials(cfg: MessageConfig, dw):
    """[NW] -> the six weight-gradient blocks (views)."""
    dws, off = [], 0
    for a, b in cfg.weight_shapes():
        dws.append(dw[off:off + a * b].view(a, b))
        off += a * b
    return tuple(dws)


def km_bwd_kernels(cfg: MessageConfig, hs3, hr, geo2, ws, d_agg):
    """The kernel counterpart of ``km_bwd_plain``: the main kernel, then
    the fixed-order reduction of its weight-gradient partials."""
    d_hs, d_hr, partials = km_bwd_kernel(cfg, hs3, hr, geo2, ws, d_agg)
    return d_hs, d_hr, _split_partials(cfg, tab_bwd_reduce(partials))


def fused_message_aggregate_km_bwd(cfg: MessageConfig, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2,
                                   d_agg):
    """(d_hs, d_hr, d_w0e1, d_w1o1, d_w0e2, d_w1o2): the hand-written CUDA
    kernels (#5 and the reduction) for CUDA tensors, the plain version for
    CPU tensors.  Arguments as in ``fused_message_aggregate_km_bwd_plain``."""
    if hr.device.type == "cpu":
        return fused_message_aggregate_km_bwd_plain(cfg, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2,
                                                    d_agg)
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    d_hs, d_hr, dws = km_bwd_kernels(cfg, hs3, hr, geo2, ws, d_agg)
    return (d_hs, d_hr, *_join_weight_grads(dws, w0e1.dtype))


class FusedMessageKm(torch.autograd.Function):
    """The untabled fused message with its hand-written backward: the
    counterpart of the JAX ``custom_vjp`` of ``fused_message_aggregate_km``
    (``_vjp_fwd_km``/``_vjp_bwd_km``).  Saves its inputs; the backward
    recomputes both layers.  The geometry gets no gradient."""

    @staticmethod
    def forward(ctx, cfg, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2):
        ctx.cfg = cfg
        ctx.save_for_backward(hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2)
        return fused_message_aggregate_km_fwd(cfg, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2)

    @staticmethod
    def backward(ctx, d_agg):
        saved = ctx.saved_tensors
        d_agg = d_agg.to(saved[1].dtype).contiguous()
        d_hs, d_hr, *dws = fused_message_aggregate_km_bwd(ctx.cfg, *saved, d_agg)
        return (None, d_hs, d_hr, None, *dws)


def fused_message_aggregate_km(cfg: MessageConfig, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2):
    """agg [N, F], differentiable in hs3, hr and the four weights.

    Arguments as in the JAX ``fused_message_aggregate_km``: hs3 [K, N, F]
    slot-major sender rows (``gather_km`` or ``take_dense_symmetric_km``),
    hr [N, F], geo2 [N, K*6], the folded weights; N a multiple of cfg.tile.
    CUDA tensors run the hand-written kernels (or raise), CPU tensors the
    plain versions."""
    return FusedMessageKm.apply(cfg, hs3, hr, geo2, w0e1, w1o1, w0e2, w1o2)


# ---------------------------------------------------------------------------
# Packed, node-major: the counterpart of ``fused_message_aggregate`` (the
# TPU's pack > 1 path).  The senders come pre-gathered as hs [N*K/p, p*F]
# and the geometry as d2, maskf [N*K/p, p] and attr [N*K/p, 4p]: contiguous
# views of the node-major rows (row i*K + k = slot k of receiver i).  The
# rounding is the tabled kernel's, except that the K-sum of the forward and
# d_hr of the backward round once per group of p slots.
# ---------------------------------------------------------------------------


def _check_flat(cfg: MessageConfig, hs, hr, d2, attr, maskf, ws):
    """The shapes ``_fwd_call`` asserts, and one dtype for all inputs."""
    n, f = hr.shape
    p = cfg.pack
    if f != cfg.f:
        raise ValueError(f"hr has {f} features, config wants {cfg.f}")
    if n % cfg.tile:
        raise ValueError(f"rows {n} are not a multiple of the tile {cfg.tile}")
    r = n * cfg.k // p
    for name, x, width in (("hs", hs, p * f), ("d2", d2, p), ("attr", attr, 4 * p),
                           ("maskf", maskf, p)):
        if tuple(x.shape) != (r, width):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, wants {(r, width)}")
    _check_blocks(cfg, ws, "hr", hr, (("hs", hs), ("d2", d2), ("attr", attr), ("maskf", maskf)))


def _flat_slot_inputs(cfg: MessageConfig, hs, hr, d2, attr, maskf):
    """Layer-1 inputs of every slot row (node-major, row i*K + k) in fp32:
    xs [E, S1], xv [E, 3, V1], the sh scalar s [E, 1] and vector v [E, 3],
    and the mask [E, 1]."""
    n, f = hr.shape
    e = n * cfg.k
    hsf = hs.float().reshape(e, f)
    hrf = hr.float().repeat_interleave(cfg.k, dim=0)
    a = attr.float().reshape(e, 4)
    xs = torch.cat([hsf[:, :cfg.hs], hrf[:, :cfg.hs], d2.float().reshape(e, 1)], dim=-1)
    xv = torch.cat([hsf[:, cfg.hs:].reshape(e, 3, cfg.hv),
                    hrf[:, cfg.hs:].reshape(e, 3, cfg.hv)], dim=-1)
    return xs, xv, a[:, 0:1], a[:, 1:4], maskf.float().reshape(e, 1)


def _group_sum(cfg: MessageConfig, rows, dt):
    """[N*K, F] fp32 slot rows -> [N, F] in ``dt``: per receiver, each group
    of ``pack`` consecutive slots summed in fp32 in slot order and rounded to
    ``dt`` (the packed form's ``msum``), the K/pack groups summed in fp32 (its
    ``E^T`` product)."""
    n = rows.shape[0] // cfg.k
    g = rows.reshape(n, cfg.k // cfg.pack, cfg.pack, -1)
    acc = g[:, :, 0]
    for j in range(1, cfg.pack):
        acc = acc + g[:, :, j]
    return acc.to(dt).float().sum(dim=1).to(dt)


def fused_message_aggregate_plain(cfg: MessageConfig, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2,
                                  w1o2):
    """agg [N, F] in hr's dtype, by PyTorch ops (any device).

    hs [N*K/p, p*F] node-major sender rows (p = cfg.pack); hr [N, F]
    receiver rows, N a multiple of cfg.tile; d2, maskf [N*K/p, p] and attr
    [N*K/p, 4p] the geometry of the same slots; weights with norms folded in,
    in the reference row layout.  Rounds where the tabled kernel does, the
    K-sum once per group of p slots."""
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_flat(cfg, hs, hr, d2, attr, maskf, ws)
    dt = hr.dtype
    e = hr.shape[0] * cfg.k
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.float() for w in ws)
    xs, xv, s, v, mask = _flat_slot_inputs(cfg, hs, hr, d2, attr, maskf)
    m0, m1, _ = _layer(xs, xv, s, v, w0a, w1sa, w1va, cfg.hs)
    m0, m1 = m0.to(dt).float(), m1.to(dt).float()
    m0, m1, _ = _layer(m0, m1, s, v, w0b, w1sb, w1vb, cfg.hs)
    return _group_sum(cfg, torch.cat([m0, m1.reshape(e, 3 * cfg.hv)], dim=-1) * mask, dt)


def flat_bwd_plain(cfg: MessageConfig, hs, hr, d2, attr, maskf, ws, d_agg):
    """The plain packed backward on split weights ``ws`` (six blocks): (d_hs
    [N*K/p, p*F] written per slot, d_hr [N, F] (per-group rounded), six fp32
    weight-gradient blocks).  Rounds where ``_bwd_kernel`` does."""
    dt = hr.dtype
    xs1, xv1, s, v, mask = _flat_slot_inputs(cfg, hs, hr, d2, attr, maskf)
    d_hs, d_hrr, dws = _rows_bwd(cfg, xs1, xv1, s, v, mask, ws,
                                 d_agg.float().repeat_interleave(cfg.k, dim=0), dt)
    return d_hs.to(dt).reshape(hs.shape), _group_sum(cfg, d_hrr, dt), dws


def fused_message_aggregate_bwd_plain(cfg: MessageConfig, hs, hr, d2, attr, maskf, w0e1, w1o1,
                                      w0e2, w1o2, d_agg):
    """(d_hs, d_hr, d_w0e1, d_w1o1, d_w0e2, d_w1o2) by PyTorch ops (any
    device): arguments as in the plain forward plus the cotangent d_agg
    [N, F]; the weight gradients in the weights' dtype.  The geometry gets no
    cotangent."""
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_flat(cfg, hs, hr, d2, attr, maskf, ws)
    _check_d_agg(hr, d_agg)
    d_hs, d_hr, dws = flat_bwd_plain(cfg, hs, hr, d2, attr, maskf, ws, d_agg)
    return (d_hs, d_hr, *_join_weight_grads(dws, w0e1.dtype))


def fused_message_aggregate_fwd(cfg: MessageConfig, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2,
                                w1o2):
    """agg [N, F]: the hand-written CUDA kernel (#6) for CUDA tensors, the
    plain version for CPU tensors.  Arguments as in the plain version."""
    if hr.device.type == "cpu":
        return fused_message_aggregate_plain(cfg, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2,
                                             w1o2)
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_flat(cfg, hs, hr, d2, attr, maskf, ws)
    args = (hs, hr, d2, attr, maskf, *ws)
    _cuda_args(hr, args)
    _check_slot_rows(hr.shape[0], cfg.k)
    lib = FLAT_FWD.lib(_variant(hr, cfg))
    code = _DTYPE_CODE[hr.dtype]
    smem = lib.fused_message_tab_fwd_smem_bytes(code, cfg.hs, cfg.hv, cfg.k)
    _check_smem(smem)
    out = torch.empty_like(hr)
    scratch = _fwd_scratch(lib, cfg, code, hr.device)
    stream = torch.cuda.current_stream(hr.device).cuda_stream
    with torch.cuda.device(hr.device):
        rc = lib.fused_message_flat_fwd(code, *(x.data_ptr() for x in args),
                                        out.data_ptr(), _ptr(scratch), hr.shape[0], cfg.hs,
                                        cfg.hv, cfg.k, cfg.pack, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_flat_fwd launch failed with CUDA error {rc}")
    FLAT_FWD.launches += 1
    return out


def flat_bwd_kernel(cfg: MessageConfig, hs, hr, d2, attr, maskf, ws, d_agg):
    """The packed backward's main CUDA kernel (#7, ``csrc/fused_message_tab_bwd.cu``)
    on split weights ``ws``: returns ``(d_hs [N*K/p, p*F], d_hr [N, F],
    partials [grid, NW] fp32)``, the per-block weight-gradient sums that
    ``tab_bwd_reduce`` adds up."""
    _check_flat(cfg, hs, hr, d2, attr, maskf, ws)
    _check_d_agg(hr, d_agg)
    args = (hs, hr, d2, attr, maskf, *ws, d_agg)
    _cuda_args(hr, args)
    _check_slot_rows(hr.shape[0], cfg.k)
    lib = FLAT_BWD.lib(_variant(hr, cfg))
    code = _DTYPE_CODE[hr.dtype]
    dims = (cfg.hs, cfg.hv, cfg.k)
    smem = lib.fused_message_km_bwd_smem_bytes(code, *dims)
    _check_smem(smem)
    n = hr.shape[0]
    with torch.cuda.device(hr.device):
        grid = lib.fused_message_flat_bwd_grid(code, *dims, n)
    if grid < 1:
        raise RuntimeError(f"fused_message_flat_bwd: no launch configuration (code {grid})")
    d_hs = torch.empty_like(hs)
    d_hr = torch.empty_like(hr)
    partials = _partials(lib, cfg, code, grid, hr.device)
    stream = torch.cuda.current_stream(hr.device).cuda_stream
    with torch.cuda.device(hr.device):
        rc = lib.fused_message_flat_bwd(code, *(x.data_ptr() for x in args),
                                        d_hs.data_ptr(), d_hr.data_ptr(), partials.data_ptr(), n,
                                        *dims, cfg.pack, grid, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_flat_bwd launch failed with CUDA error {rc}")
    FLAT_BWD.launches += 1
    return d_hs, d_hr, partials


def flat_bwd_kernels(cfg: MessageConfig, hs, hr, d2, attr, maskf, ws, d_agg):
    """The kernel counterpart of ``flat_bwd_plain``: the main kernel, then
    the fixed-order reduction of its weight-gradient partials."""
    d_hs, d_hr, partials = flat_bwd_kernel(cfg, hs, hr, d2, attr, maskf, ws, d_agg)
    return d_hs, d_hr, _split_partials(cfg, tab_bwd_reduce(partials))


def fused_message_aggregate_bwd(cfg: MessageConfig, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2,
                                w1o2, d_agg):
    """(d_hs, d_hr, d_w0e1, d_w1o1, d_w0e2, d_w1o2): the hand-written CUDA
    kernels (#7 and the reduction) for CUDA tensors, the plain version for
    CPU tensors.  Arguments as in ``fused_message_aggregate_bwd_plain``."""
    if hr.device.type == "cpu":
        return fused_message_aggregate_bwd_plain(cfg, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2,
                                                 w1o2, d_agg)
    ws = split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    d_hs, d_hr, dws = flat_bwd_kernels(cfg, hs, hr, d2, attr, maskf, ws, d_agg)
    return (d_hs, d_hr, *_join_weight_grads(dws, w0e1.dtype))


class FusedMessage(torch.autograd.Function):
    """The packed fused message with its hand-written backward: the
    counterpart of the JAX ``custom_vjp`` of ``fused_message_aggregate``
    (``_vjp_fwd``/``_vjp_bwd``).  Saves its inputs; the backward recomputes
    both layers.  The geometry gets no gradient."""

    @staticmethod
    def forward(ctx, cfg, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2, w1o2):
        ctx.cfg = cfg
        ctx.save_for_backward(hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2, w1o2)
        return fused_message_aggregate_fwd(cfg, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2, w1o2)

    @staticmethod
    def backward(ctx, d_agg):
        saved = ctx.saved_tensors
        d_agg = d_agg.to(saved[1].dtype).contiguous()
        d_hs, d_hr, *dws = fused_message_aggregate_bwd(ctx.cfg, *saved, d_agg)
        # cfg, hs, hr, d2, attr, maskf, 4 weights
        return (None, d_hs, d_hr, None, None, None, *dws)


def fused_message_aggregate(cfg: MessageConfig, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2, w1o2):
    """agg [N, F], differentiable in hs, hr and the four weights.

    Arguments as in the JAX ``fused_message_aggregate``: with p = cfg.pack,
    hs [N*K/p, p*F] node-major sender rows (``take_dense_symmetric`` or
    ``gather``, reshaped), hr [N, F], d2 and maskf [N*K/p, p], attr
    [N*K/p, 4p], the folded weights; N a multiple of cfg.tile, K % p == 0.
    CUDA tensors run the hand-written kernels (or raise), CPU tensors the
    plain versions."""
    return FusedMessage.apply(cfg, hs, hr, d2, attr, maskf, w0e1, w1o1, w0e2, w1o2)
