"""Generic fused message MLP + neighbourhood aggregation.

Counterpart of ``scalable_e3_gnn_tpu/kernels/fused_message_generic.py::
FusedMessageGeneric`` for any hidden irreps and attribute order (the lmax=2
configurations), through its three entries: ``geo_call_tab`` (senders
through per-tile tables: the forward ``_fwd_call_tab`` #8 and the backwards
``_bwd_call_res_tab`` #9 and ``_bwd_call_rep_tab`` #10), ``geo_call`` (a
slot-major sender operand ``hs [K, N, F]``: ``_fwd_call`` #11, ``_bwd_call_res``
#12, ``_bwd_call_rep`` #13 and the fallback ``_bwd_call`` #14) and
``geo_call_sym`` (the gather inside the autograd Function, #11 and #13, sender
gradients by the reverse-slot gather-sum).  Per receiver i and slot k:

    m_0    = [x_s || h[i] || d2[i,k]]                                 (C1 = 2F+1)
    y_l    = sum_c (m_l @ W'_l,c) * attr_c[i,k]                       (C2 = A)
    m_l+1  = y_l[:, :dk] * sigmoid(y_l)[:, sel_l]                     (silu gate)
    agg[i] = sum_k mask[i,k] * m_L

for any number L >= 1 of message layers (``SEGNNLayer(num_message_layers=L)``,
as JAX's kernels take any count): the CUDA routes get the layers' widths
from a per-config layer table (``layer_table``, ``csrc/generic_mma.cuh``
``LayerField``) and run the layers in a loop, L a runtime value.

with the sender row ``x_s = h[gtab[i // tile, loc[i,k]]]`` (tabled) or
``x_s = hs[k, i]`` (untabled).  ``W'_l`` [A*C1, D] is the message layer's
CG-folded weight matrix (``TensorProduct.fold_params``, fp32) with its columns permuted to
``scalars || gated || gates`` (``Gate.fast_tables``), and ``sel_l`` [dk] the
sigmoid lane that multiplies each output lane.  ``loc == U`` means no sender
(a zero row).  The geometry rides the node-major packed stream ``geo2``
[N, K*(A+2)] (per slot ``attr || d2 || mask``).

The gate's scalar activation is ``cfg.act``, a code of ``ops/gate.py``'s
``ACTIVATIONS`` (silu, tanh, gelu in JAX's default tanh form, relu,
softplus), and a compile-time constant of the CUDA libraries: each source is
built once per activation (``GENERIC_ACT``, ``csrc/gate_act.cuh``).  Silu
keeps the selection form above on every lane, as JAX's kernels do for
silu/sigmoid (``Gate.fast_apply``).  Any other activation takes JAX's concat
form (``Gate.__call__``, which JAX's kernels apply then): the scalar lanes
(``sel_l[j] == j``: a gated lane selects a gate column past dk) are
rnd(act(y) in fp32), the gated lanes as above.  The weights keep the
``scalars || gated || gates`` permutation for every activation: only the
outputs have to match JAX's, and JAX permutes nothing for a concat gate.

Non-foldable message layers (attributes wider than 32, ``lmax_attr >= 5``, or
``TensorProduct(mode="sparse")``) take the same kernels on their CG-folded
weights and the selection gate: #11 and #14.  The JAX kernel evaluates them
component-wise (its sparse TP) with the concat gate: the same function, with
other bf16 rounding points (fp32 agrees within 2e-5; ``ROADMAP.md`` records
the bf16 gap).

Forward rounding points (the TPU kernel's, in both implementations): operands
in the data dtype; each component's GEMM accumulated in fp32 and scaled by
attr_c in fp32, summed over c in fp32, cast to the data dtype (y); sigmoid in
fp32 cast to the dtype; the gate product in the dtype; ``msg * mask`` in the
dtype; the K-sum in fp32; the output cast to the dtype.  The save mode also
returns every layer's pre-gate ``y`` [N*K, D] (node-major slot rows; on the
card views of one buffer, the layers one after the other, which the
residual backward reads in place).

Backward rounding points of #9-#13 (``_transpose_chain`` with the VJP of
the gate as JAX's AD computes it): dm_L = (K-repeat of d_agg in fp32) * mask
cast to the dtype; per layer, last to first, dy = the gate's VJP at y
(``_gate_vjp``; silu: products in the dtype, the sigmoid branch in fp32, the
selection transpose summed in fp32, each cast to the dtype, the two branches
added in the dtype; another activation: the scalar lanes its fp32 VJP
rounded once, each gate's copies summed in the dtype one at a time); dya_c
= dy * attr_c in the dtype; dW'_c = m^T dya_c summed in fp32; dm = sum_c
dya_c W'_c^T in fp32 cast to the dtype.  d_hu (per tile,
per table entry) and d_hr (per receiver) are fp32 sums of dm_0's rounded
sender and receiver columns, cast to the dtype; untabled, d_hs [K, N, F] is
dm_0's rounded sender columns, one row per slot.  #14 (JAX's AD of the tile
forward, ``_layer_vjp``) differs in three places: dya_c stays fp32; each
component's dm_c is cast to the dtype and the components are added in the
dtype, the last first; dW'_c is summed per backward tile (``bwd_tile``
receivers) in fp32, cast to the dtype, and the tiles are added in fp32 in
tile order, so in bf16 the tile changes dW'.  In fp32 #14 is #13's function.

- ``generic_tab_fwd_plain`` / ``generic_tab_bwd_plain`` (tabled),
  ``generic_fwd_plain`` / ``generic_bwd_plain`` and ``generic_bwd_vjp_plain``
  (untabled): PyTorch ops, in chunks of receivers so the [rows, C1]
  temporaries stay bounded.  The CPU tests and the on-card checks use them.
  The backwards replay the forward (``ys=None``, kernel #10's / #13's
  function) or read the saved ys (#9's / #12's).
- ``generic_tab_fwd`` / ``generic_tab_bwd``, ``generic_fwd`` / ``generic_bwd``
  and ``generic_bwd_vjp``: a CPU tensor goes to the plain version; a CUDA
  tensor goes to the hand-written kernels (``csrc/fused_message_generic_tab_fwd.cu``,
  ``csrc/fused_message_generic_tab_bwd.cu``, one source for each direction
  with a compile-time sender addressing and, in the backward, a chain mode,
  and the fixed-order reduction of ``csrc/fused_message_tab_bwd.cu``) or
  raises.  In bf16 their GEMMs multiply only the folded weights' nonzero
  tiles (``cfg.plan``, ``kernels/tile_plan.py``; a config without a plan
  takes every tile), bitwise the dense product.
- ``generic_sender_epilogue``: the split reverse-table gather-sum of
  ``call_tab_bwd``, in its order.
- ``FusedMessageGenericTabled``, ``FusedMessageGenericUntabled`` and
  ``FusedMessageGenericSym``: the autograd Functions; ``FusedMessageGeneric``
  the per-layer object the model dispatches to (folds and permutes the
  weights outside the Functions, so autograd carries dW' to the parameters).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.gate import ACTIVATIONS, activation
from ..ops.gather_scatter import gather_km, reverse_slot_gather_sum_km
from ..ops.tensor_product import TensorProduct
from .build import CudaKernel
from .fused_message import _DTYPE_CODE, _cuda_args, tab_bwd_reduce
from .tile_plan import TilePlan, dm_blocks, fold_structure, fwd_blocks

__all__ = ["GenericConfig", "FusedMessageGeneric", "FusedMessageGenericTabled",
           "fused_message_generic_tabled", "generic_tab_fwd", "generic_tab_fwd_plain",
           "generic_tab_bwd", "generic_tab_bwd_plain", "generic_tab_bwd_kernels",
           "generic_tab_bwd_chain", "generic_tab_bwd_wgrad", "generic_tab_bwd_wgrad_plain",
           "generic_tab_bwd_table", "generic_tab_bwd_table_plain",
           "generic_sender_epilogue", "generic_fwd", "generic_fwd_plain", "generic_bwd",
           "generic_bwd_plain", "generic_bwd_kernels", "generic_bwd_chain",
           "generic_bwd_vjp", "generic_bwd_vjp_plain", "generic_bwd_vjp_kernels",
           "generic_bwd_vjp_wgrad", "generic_bwd_vjp_wgrad_plain", "generic_bwd_wgrad",
           "generic_bwd_wgrad_plain",
           "FusedMessageGenericUntabled", "FusedMessageGenericSym", "GENERIC_TAB_FWD",
           "GENERIC_TAB_BWD_RES", "GENERIC_TAB_BWD_REP", "GENERIC_TAB_BWD_WGRAD",
           "GENERIC_TAB_BWD_TABLE", "GENERIC_FWD", "GENERIC_BWD_RES", "GENERIC_BWD_REP",
           "GENERIC_BWD_VJP", "GENERIC_BWD_VJP_WGRAD", "KERNELS", "vjp_group"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_W = ctypes.POINTER(ctypes.c_int)  # the layers' (C1, D, dk), host memory
_FWD_SRC = "fused_message_generic_tab_fwd"
_FWD_SIGS = {
    # dtype, k, a, layers, widths -> bytes (negative: widths not taken)
    "fused_message_generic_tab_fwd_smem_bytes": (ctypes.c_long, [_I] * 4 + [_W]),
    # -> the shared memory a block may take (bytes; csrc/generic_mma.cuh kMaxSmem)
    "fused_message_generic_tab_fwd_max_smem": (ctypes.c_long, []),
    # dtype, 12 pointers (h, geo2, loc, gtab, the flat fp32 weights, the flat
    # selections, the layer table, out, the save mode's flat ys (null: no
    # save); bf16: the packed tiles, the plan's masks, the chunks), n, f, k,
    # a, tile, u, layers, widths, chunks of every stream, stream
    "fused_message_generic_tab_fwd": (_I, [_I] + [_P] * 12 + [_I] * 7 + [_W, _I, _P]),
    # dtype, 11 pointers (hs, h, geo2, weights, selections, layer table, out,
    # ys; packed tiles, masks, chunks), n, f, k, a, layers, widths, chunks,
    # stream
    "fused_message_generic_fwd": (_I, [_I] + [_P] * 11 + [_I] * 5 + [_W, _I, _P]),
}
# one library of each source per gate activation: the activation is a
# compile-time constant (GENERIC_ACT, csrc/gate_act.cuh), silu's the plain build
_ACT_VARIANTS = tuple(() if act.code == 0 else (f"GENERIC_ACT={act.code}",)
                      for act in ACTIVATIONS)


def _kernel(name: str, sigs: dict, source: str) -> CudaKernel:
    return CudaKernel(name, sigs, source_name=source, variants=_ACT_VARIANTS)


# kernel #8 (tabled) and #11 (untabled): one source, one kernel template
GENERIC_TAB_FWD = _kernel("fused_message_generic_tab_fwd", _FWD_SIGS, _FWD_SRC)
GENERIC_FWD = _kernel("fused_message_generic_fwd", _FWD_SIGS, _FWD_SRC)
_BWD_SRC = "fused_message_generic_tab_bwd"
_BWD_SIGS = {
    # dtype, k, a, layers, widths -> bytes of the chain kernel (negative: not taken)
    "fused_message_generic_tab_bwd_smem_bytes": (ctypes.c_long, [_I] * 4 + [_W]),
    # -> the shared memory a block may take (bytes; csrc/generic_mma.cuh kMaxSmem)
    "fused_message_generic_tab_bwd_max_smem": (ctypes.c_long, []),
    # dtype, replay, 17 pointers (h, geo2, loc, gtab, flat fp32 weights, flat
    # selections, layer table, the flat saved ys in, d_agg, d_hs, d_hr, the
    # flat dy rows, m_0, m_1.. flat, packed tiles, masks, chunks), n, f, k,
    # a, tile, u, layers, widths, chunks of every stream, stream
    "fused_message_generic_tab_bwd_chain": (_I, [_I, _I] + [_P] * 17 + [_I] * 7 + [_W, _I, _P]),
    # dtype, 8 pointers (geo2, m_0, m_1.. flat, dy flat, hs, h, layer table,
    # partials; hs, h null: m_0 read), n, f, k, a, layers, widths, splits,
    # group, stream
    "fused_message_generic_tab_bwd_wgrad": (_I, [_I] + [_P] * 8 + [_I] * 5 + [_W, _I, _I, _P]),
    # dtype, d_hs, loc, d_hu, n, f, k, tile, u, stream
    "fused_message_generic_tab_bwd_table": (_I, [_I, _P, _P, _P] + [_I] * 5 + [_P]),
    # dtype, mode (0 residual, 1 replay, 2 vjp), 16 pointers (hs, h, geo2,
    # weights, selections, layer table, ys in, d_agg, d_hs, d_hr, dy, m_0
    # (null: not written), m_1.., packed tiles, masks, chunks), n, f, k, a,
    # layers, widths, chunks, stream
    "fused_message_generic_bwd_chain": (_I, [_I, _I] + [_P] * 16 + [_I] * 5 + [_W, _I, _P]),
    # dtype, 6 pointers (geo2, m_0, m_1.., dy, layer table, partials), n, k,
    # a, layers, widths, tile_rows, tile0, ntiles, stream
    "fused_message_generic_bwd_wgrad_tiles": (_I, [_I] + [_P] * 6 + [_I] * 4 + [_W] + [_I] * 3
                                              + [_P]),
}
# kernels #9 / #12 (residual) and #10 / #13 (replay), tabled / untabled: one
# source, one chain kernel template; all four share the weight-gradient
# kernel and the lmax=1 backward's fixed-order reduction, the tabled two
# also the table sum
GENERIC_TAB_BWD_RES = _kernel("fused_message_generic_tab_bwd_res", _BWD_SIGS, _BWD_SRC)
GENERIC_TAB_BWD_REP = _kernel("fused_message_generic_tab_bwd_rep", _BWD_SIGS, _BWD_SRC)
GENERIC_TAB_BWD_WGRAD = _kernel("fused_message_generic_tab_bwd_wgrad", _BWD_SIGS, _BWD_SRC)
GENERIC_TAB_BWD_TABLE = _kernel("fused_message_generic_tab_bwd_table", _BWD_SIGS, _BWD_SRC)
GENERIC_BWD_RES = _kernel("fused_message_generic_bwd_res", _BWD_SIGS, _BWD_SRC)
GENERIC_BWD_REP = _kernel("fused_message_generic_bwd_rep", _BWD_SIGS, _BWD_SRC)
# kernel #14 (the JAX fallback backward): the chain in its vjp mode, the
# per-tile weight-gradient kernel, then the fixed-order reduction
GENERIC_BWD_VJP = _kernel("fused_message_generic_bwd_vjp", _BWD_SIGS, _BWD_SRC)
GENERIC_BWD_VJP_WGRAD = _kernel("fused_message_generic_bwd_vjp_wgrad", _BWD_SIGS, _BWD_SRC)

KERNELS = (GENERIC_TAB_FWD, GENERIC_TAB_BWD_RES, GENERIC_TAB_BWD_REP, GENERIC_TAB_BWD_WGRAD,
           GENERIC_TAB_BWD_TABLE, GENERIC_FWD, GENERIC_BWD_RES, GENERIC_BWD_REP,
           GENERIC_BWD_VJP, GENERIC_BWD_VJP_WGRAD)


@dataclass(frozen=True)
class GenericConfig:
    k: int  # neighbour slots per node
    tile: int  # receivers per gather-table tile
    u: int  # compact sender-table size
    a: int  # attribute width (C2 = (lmax+1)^2)
    widths: Tuple[Tuple[int, int, int], ...]  # per message layer (C1, D, dk)
    # the gate's scalar activation: its code in ops/gate.py ACTIVATIONS (0
    # silu: the selection form; else the concat form), a compile-time
    # constant of the CUDA libraries (GENERIC_ACT)
    act: int = 0
    # the folded weights' nonzero tiles (kernels/tile_plan.py); None: every
    # tile, for weights of unknown structure
    plan: Optional[TilePlan] = field(default=None, compare=False, repr=False)

    @property
    def f(self) -> int:  # hidden feature width: layer 1 takes 2F+1
        return (self.widths[0][0] - 1) // 2

    @property
    def out_dim(self) -> int:
        return self.widths[-1][2]

    def dense_flops_per_slot(self) -> int:
        """Multiply-adds x 2 of the dense folded GEMMs for one slot, as the
        kernel runs them (most of W' is structural zeros)."""
        return 2 * sum(self.a * c1 * d for c1, d, _ in self.widths)

    @property
    def nw(self) -> int:
        """Entries of every layer's W' [A*C1, D], one after the other: the
        weight-gradient partials' row."""
        return sum(self.a * c1 * d for c1, d, _ in self.widths)


def _check_inputs(cfg: GenericConfig, h, geo2, loc, gtab, ws, sels):
    """The tabled kernels' arguments (N a multiple of the tile)."""
    n = h.shape[0]
    if n % cfg.tile:
        raise ValueError(f"rows {n} are not a multiple of the tile {cfg.tile}")
    if tuple(loc.shape) != (n, cfg.k):
        raise ValueError(f"loc has shape {tuple(loc.shape)}, wants {(n, cfg.k)}")
    if tuple(gtab.shape) != (n // cfg.tile, cfg.u):
        raise ValueError(f"gtab has shape {tuple(gtab.shape)}, wants {(n // cfg.tile, cfg.u)}")
    if loc.dtype != torch.int32 or gtab.dtype != torch.int32:
        raise TypeError("loc and gtab must be int32")
    _check_common(cfg, h, geo2, ws, sels)


def _check_common(cfg: GenericConfig, h, geo2, ws, sels):
    n, f = h.shape
    if f != cfg.f:
        raise ValueError(f"h has {f} features, config wants {cfg.f}")
    if tuple(geo2.shape) != (n, cfg.k * (cfg.a + 2)):
        raise ValueError(f"geo2 has shape {tuple(geo2.shape)}, wants {(n, cfg.k * (cfg.a + 2))}")
    if geo2.dtype != h.dtype:
        raise TypeError(f"geo2 is {geo2.dtype}, h is {h.dtype}")
    if len(ws) != len(cfg.widths) or len(sels) != len(cfg.widths):
        raise ValueError(f"{len(ws)} weights and {len(sels)} selections for "
                         f"{len(cfg.widths)} layers")
    c1_next = 2 * f + 1
    for i, (w, sel, (c1, d, dk)) in enumerate(zip(ws, sels, cfg.widths)):
        if c1 != c1_next:
            raise ValueError(f"layer {i} takes {c1} features, the previous gives {c1_next}")
        if tuple(w.shape) != (cfg.a * c1, d) or w.dtype != h.dtype:
            raise ValueError(f"weight {i} is {w.dtype} {tuple(w.shape)}, wants "
                             f"{h.dtype} {(cfg.a * c1, d)}")
        if tuple(sel.shape) != (dk,) or sel.dtype != torch.int32:
            raise ValueError(f"selection {i} is {sel.dtype} {tuple(sel.shape)}, wants int32 ({dk},)")
        c1_next = dk


def _check_bwd_inputs(cfg: GenericConfig, h, d_agg, ys):
    n = h.shape[0]
    if tuple(d_agg.shape) != (n, cfg.out_dim) or d_agg.dtype != h.dtype:
        raise ValueError(f"d_agg is {d_agg.dtype} {tuple(d_agg.shape)}, wants "
                         f"{h.dtype} {(n, cfg.out_dim)}")
    if ys is not None:
        if len(ys) != len(cfg.widths):
            raise ValueError(f"{len(ys)} saved ys for {len(cfg.widths)} layers")
        for i, (y, (_, d, _)) in enumerate(zip(ys, cfg.widths)):
            if tuple(y.shape) != (n * cfg.k, d) or y.dtype != h.dtype:
                raise ValueError(f"saved y {i} is {y.dtype} {tuple(y.shape)}, wants "
                                 f"{h.dtype} {(n * cfg.k, d)}")


def _slot_rows(cfg: GenericConfig, h, geo2, loc, gtab, s: int, e: int):
    """Layer-1 input rows of receivers [s, e) in the data dtype, m_0 [(e-s)*K,
    2F+1], with their attributes (fp32 of the dtype values) [rows, A], slot
    masks [rows, 1] (dtype) and flat table index (ntiles*U: no sender)."""
    n, f = h.shape
    k, a, u = cfg.k, cfg.a, cfg.u
    c = e - s
    flat = gtab.reshape(-1).long()
    locc = loc[s:e].long()
    tile_of = (torch.arange(s, e, device=h.device) // cfg.tile)[:, None]
    slot_tab = tile_of * u + torch.clamp(locc, max=u - 1)
    snd = flat[slot_tab]
    valid = (locc < u) & (snd < n)
    hs = torch.where(valid[..., None], h[torch.clamp(snd, max=n - 1)], h.new_zeros(()))
    g3 = geo2[s:e].reshape(c, k, a + 2)
    m = torch.cat([hs, h[s:e, None, :].expand(c, k, f), g3[..., a:a + 1]], dim=-1)
    tab = torch.where(locc < u, slot_tab, flat.numel())
    return (m.reshape(c * k, 2 * f + 1), g3[..., :a].reshape(c * k, a).float(),
            g3[..., a + 1].reshape(c * k, 1), tab.reshape(-1))


def _layer_y(m, w, attr, c1: int, a: int):
    """y = sum_c (m @ W_c) * attr_c: each product in fp32, scaled in fp32,
    summed over c in fp32, cast to m's dtype."""
    mf = m.float()
    acc = None
    for cc in range(a):
        t = (mf @ w[cc * c1:(cc + 1) * c1]) * attr[:, cc:cc + 1]
        acc = t if acc is None else acc + t
    return acc.to(m.dtype)


def _scalar_lanes(sel, dk: int):
    """The gate's scalar lanes (bool [dk]): on the permuted columns a scalar
    lane j selects itself (sel_j = j) and a gated lane selects a gate column
    (sel_j >= dk), so the selection alone tells them apart."""
    return sel[:dk] == torch.arange(dk, device=sel.device)


def _gate(y, sel, dk: int, act: int = 0):
    """The gate on permuted pre-gate y: silu (``act`` 0) in the selection
    form ``y[:, :dk] * rnd(sigmoid(y))[:, sel]`` (``Gate.fast_apply``);
    any other activation of ``ACTIVATIONS`` in JAX's concat form
    (``Gate.__call__``): the scalar lanes rnd(act(y) in fp32), the gated lanes
    as silu's, y * rnd(sigmoid(y_gate)) in the dtype."""
    sg = torch.sigmoid(y.float()).to(y.dtype)
    out = y[:, :dk] * sg[:, sel]
    if act == 0:
        return out
    scal = ACTIVATIONS[act].fn(y[:, :dk].float()).to(y.dtype)
    return torch.where(_scalar_lanes(sel, dk), scal, out)


def _gate_copies(sel, dk: int):
    """Per copy index c, the gated lanes that hold the c-th copy of their
    gate (ascending lanes: the c-th component in the cm layout) and those
    gates' columns, as two int64 tensors; c = 0 first."""
    sl = sel[:dk].tolist()
    seen: dict = {}
    lanes: list = []
    for j, s in enumerate(sl):
        if s == j:  # a scalar lane
            continue
        c = seen[s] = seen.get(s, -1) + 1
        if c == len(lanes):
            lanes.append(([], []))
        lanes[c][0].append(j)
        lanes[c][1].append(s)
    return [(torch.tensor(ls, device=sel.device), torch.tensor(gs, device=sel.device))
            for ls, gs in lanes]


def _gate_vjp(y, dout, sel, dk: int, act: int = 0):
    """dy of ``_gate`` at y for the cotangent ``dout`` [rows, dk], as JAX's AD
    computes it in y's dtype.

    Silu (``Gate.fast_apply``): the direct branch dout * multiplier in the
    dtype; the selection transpose of dout * y summed in fp32 and cast; the
    sigmoid's VJP g * (s * (1 - s)) in fp32 and cast; the two branches added
    in the dtype.

    Any other activation (the concat form, ``Gate.__call__``): the scalar
    lanes rnd(act's VJP in fp32 at y, dout) (``Activation.vjp``); the gated
    lanes dout * rnd(sigmoid(y_gate)) in the dtype; each gate column the
    cotangent of its d concatenated copies, dout * y in the dtype, summed
    over the copies in component order with every partial sum rounded to the
    dtype (the order in which JAX's backward pass accumulates a variable's
    cotangents: XLA on the CPU rounds each of these adds in bf16, unlike the
    fp32 sum of the selection transpose), then times s (1 - s) in fp32 and
    cast."""
    dt = y.dtype
    sig = torch.sigmoid(y.float())
    mlt = sig.to(dt)[:, sel]
    d_direct = dout * mlt
    if act == 0:
        d_mlt = (dout * y[:, :dk]).float()
        d_sg = torch.zeros_like(sig).index_add_(1, sel, d_mlt).to(dt)
        d_sig = (d_sg.float() * (sig * (1.0 - sig))).to(dt)
        return torch.cat([d_direct + d_sig[:, :dk], d_sig[:, dk:]], dim=-1)
    d_scal = ACTIVATIONS[act].vjp(y[:, :dk].float(), dout.float()).to(dt)
    d_lanes = torch.where(_scalar_lanes(sel, dk), d_scal, d_direct)
    d_cp = dout * y[:, :dk]
    d_g = torch.zeros_like(y)
    for c, (lanes, gates) in enumerate(_gate_copies(sel, dk)):
        d_g[:, gates] = d_cp[:, lanes] if c == 0 else d_g[:, gates] + d_cp[:, lanes]
    d_sig = (d_g.float() * (sig * (1.0 - sig))).to(dt)
    return torch.cat([d_lanes, d_sig[:, dk:]], dim=-1)


def _rows_fwd(cfg: GenericConfig, m, attr, wts, sels, last_gate: bool = True):
    """One chunk of slot rows through the message layers: ``(ms, ys)``, each
    layer's input (then, with ``last_gate``, the message) and pre-gate y."""
    ms, ys = [m], []
    for i, (w, sel, (c1, _, dk)) in enumerate(zip(wts, sels, cfg.widths)):
        y = _layer_y(ms[-1], w, attr, c1, cfg.a)
        ys.append(y)
        if last_gate or i + 1 < len(wts):
            ms.append(_gate(y, sel, dk, cfg.act))
    return ms, ys


def _layer_dm(dy, attr_dt, w, c1: int, a: int, m=None, dw=None):
    """dm = sum_c (dy * attr_c) W'_c^T of one layer, each dya_c rounded to the
    dtype, the products and the sum over c in fp32, cast to the dtype; with
    ``m`` [rows, C1], m^T dya_c is added into ``dw`` (fp32) too."""
    mf = None if m is None else m.float()
    acc = None
    for cc in range(a):
        dya = (dy * attr_dt[:, cc:cc + 1]).float()
        if mf is not None:
            dw[cc * c1:(cc + 1) * c1] += mf.T @ dya
        t = dya @ w[cc * c1:(cc + 1) * c1].T
        acc = t if acc is None else acc + t
    return acc.to(dy.dtype)


def _rows_bwd(cfg: GenericConfig, m0, attr, mask, wts, sels, d_agg, ys, dws, dys=None):
    """dm_0 [rows, C1] (the data dtype) of one chunk of slot rows for the
    receivers' cotangent ``d_agg`` [rows / K, dk_last]: the forward replayed
    (``ys=None``) or read from the chunk's saved ys, then the transpose
    chain; each layer's dW' is added into ``dws`` (fp32), and each layer's dy
    into the list ``dys`` when given (first layer first)."""
    dt = m0.dtype
    if ys is None:
        ms, ys = _rows_fwd(cfg, m0, attr, wts, sels, last_gate=False)
    else:
        ms = [m0] + [_gate(y, sel, dk, cfg.act) for y, sel, (_, _, dk)
                     in zip(ys[:-1], sels, cfg.widths)]
    attr_dt = attr.to(dt)
    dm = (d_agg.float().repeat_interleave(cfg.k, dim=0) * mask.float()).to(dt)
    for i in range(len(wts) - 1, -1, -1):
        c1, _, dk = cfg.widths[i]
        dy = _gate_vjp(ys[i], dm, sels[i], dk, cfg.act)
        if dys is not None:
            dys.insert(0, dy)
        dm = _layer_dm(dy, attr_dt, wts[i], c1, cfg.a, ms[i], dws[i])
    return dm


def generic_tab_fwd_plain(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence,
                          chunk_rows: int = 1 << 18, save: bool = False):
    """agg [N, dk_last] in h's dtype, by PyTorch ops (any device); with
    ``save``, ``(agg, [y_1 .. y_L])``, each y the pre-gate layer output [N*K, D]
    in h's dtype, one row per slot (node-major).

    h [N, F] cm-layout node features, N a multiple of cfg.tile; geo2
    [N, K*(A+2)] in h's dtype; loc [N, K] int32 slot -> table index (pad U);
    gtab [N/tile, U] int32 node ids (pad N); ws per layer the folded, column-
    permuted weights [A*C1, D] in h's dtype; sels per layer [dk] int32.
    Receivers go in chunks of ``chunk_rows // K``."""
    _check_inputs(cfg, h, geo2, loc, gtab, ws, sels)
    dt = h.dtype
    n = h.shape[0]
    k = cfg.k
    wts = [w.float() for w in ws]
    sels = [s.long() for s in sels]
    out = torch.empty((n, cfg.out_dim), dtype=dt, device=h.device)
    ys = [torch.empty((n * k, d), dtype=dt, device=h.device) for _, d, _ in cfg.widths] \
        if save else None
    step = max(1, chunk_rows // k)
    for s in range(0, n, step):
        e = min(n, s + step)
        m, attr, mask, _ = _slot_rows(cfg, h, geo2, loc, gtab, s, e)
        ms, yc = _rows_fwd(cfg, m, attr, wts, sels)
        if save:
            for y, yo in zip(yc, ys):
                yo[s * k:e * k] = y
        out[s:e] = (ms[-1] * mask).reshape(e - s, k, -1).float().sum(dim=1).to(dt)
    return (out, ys) if save else out


def generic_tab_bwd_plain(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence,
                          d_agg, ys: Optional[Sequence] = None, chunk_rows: int = 1 << 18):
    """The backward of the tabled generic message up to the epilogue, by
    PyTorch ops (any device): ``(d_hu [ntiles*U, F], d_hr [N, F], [dW'_1,
    dW'_2] fp32)`` for the cotangent ``d_agg`` [N, dk_last] in h's dtype.

    ``ys=None`` replays the forward (kernel #10's function); with the saved
    ``ys`` of ``generic_tab_fwd_plain(save=True)`` it reads them (#9's).
    Both round y where the forward does, so both give the same result."""
    _check_inputs(cfg, h, geo2, loc, gtab, ws, sels)
    _check_bwd_inputs(cfg, h, d_agg, ys)
    dt = h.dtype
    n, f = h.shape
    k = cfg.k
    wts = [w.float() for w in ws]
    sels = [s.long() for s in sels]
    ntab = gtab.numel()
    d_hu = torch.zeros((ntab + 1, f), dtype=torch.float32, device=h.device)
    d_hr = torch.empty((n, f), dtype=dt, device=h.device)
    dws = [torch.zeros_like(w) for w in wts]
    step = max(1, chunk_rows // k)
    for s in range(0, n, step):
        e = min(n, s + step)
        m0, attr, mask, tab = _slot_rows(cfg, h, geo2, loc, gtab, s, e)
        yc = [y[s * k:e * k] for y in ys] if ys is not None else None
        dm = _rows_bwd(cfg, m0, attr, mask, wts, sels, d_agg[s:e], yc, dws)
        d_hu.index_add_(0, tab, dm[:, :f].float())
        d_hr[s:e] = dm[:, f:2 * f].reshape(e - s, k, f).float().sum(dim=1).to(dt)
    return d_hu[:ntab].to(dt), d_hr, dws


def _mma_layout(w, a: int, c1: int, d: int, dmul: int = 8):
    """[A*C1, D] -> [A, D rounded up to dmul, C1 rounded up to 16], transposed
    and zero-padded: each attribute component's W^T as the tensor cores read
    it (the dense reference of the tile plan's packed tiles)."""
    dp, kp = -(-d // dmul) * dmul, -(-c1 // 16) * 16
    out = w.new_zeros((a, dp, kp))
    out[:, :d, :c1] = w.view(a, c1, d).transpose(1, 2)
    return out


_DENSE_PLANS: dict = {}
_LAYER_TABLES: dict = {}
# the layer table's fields, per layer (csrc/generic_mma.cuh LayerField)
_LAYER_FIELDS = ("c1", "d", "dk", "mask_fwd", "mask_dm", "w_off", "sel_off", "y_off", "dy_off",
                 "m_off", "gate_off")


def _tile_plan(cfg: GenericConfig) -> TilePlan:
    """The plan of cfg's folded weights, or one of every tile when cfg has
    none (weights of unknown structure: the same engine, no tile skipped)."""
    key = (cfg.a, tuple((c1, d) for c1, d, _ in cfg.widths))
    plan = cfg.plan
    if plan is None:
        plan = _DENSE_PLANS.get(key)
        if plan is None:
            plan = _DENSE_PLANS[key] = TilePlan.dense(*key)
    if (plan.a, plan.widths) != key:
        raise ValueError(f"the tile plan is for A={plan.a}, widths {plan.widths}, not {key}")
    return plan


def layer_table(cfg: GenericConfig) -> "np.ndarray":
    """int32 [L, 11]: per message layer the kernels' descriptor
    (``_LAYER_FIELDS``, ``csrc/generic_mma.cuh`` LayerField): C1, D, dk; the
    first word of its forward and of its dm masks in the plan's mask array
    (every layer's forward block masks, ``fwd_blocks(D)`` x A x C1/16 words,
    then every layer's dm block masks, ``dm_blocks(C1)`` x A x D/16); the first
    element of its W' [A*C1, D] in the layers' flat weights (and of the
    weight-gradient partials' row); of its selections; in units of N*K slot
    rows, the first row block of its y (D wide), of its dy (D rounded up to
    8) and, from layer 1 on, of its m (C1 rounded up to 16; m_0 lives
    apart); and of its gate tables in the chain's shared memory (2 dk + D +
    1 ints a layer)."""
    a = cfg.a
    fwd_total = sum(fwd_blocks(d) * a * (-(-c1 // 16)) for c1, d, _ in cfg.widths)
    rows, acc = [], dict(fw=0, dm=0, w=0, sel=0, y=0, dy=0, m=0, gate=0)
    for i, (c1, d, dk) in enumerate(cfg.widths):
        rows.append([c1, d, dk, acc["fw"], fwd_total + acc["dm"], acc["w"], acc["sel"], acc["y"],
                     acc["dy"], acc["m"], acc["gate"]])
        acc["fw"] += fwd_blocks(d) * a * (-(-c1 // 16))
        acc["dm"] += dm_blocks(c1) * a * (-(-d // 16))
        acc["w"] += a * c1 * d
        acc["sel"] += dk
        acc["y"] += d
        acc["dy"] += -(-d // 8) * 8
        acc["m"] += -(-c1 // 16) * 16 if i else 0
        acc["gate"] += 2 * dk + d + 1
    return np.array(rows, np.int32).reshape(len(cfg.widths), len(_LAYER_FIELDS))


def _layers(cfg: GenericConfig, device):
    """(L, the layers' (C1, D, dk) as a host ctypes array, ``layer_table``
    on ``device``), built once per (A, widths, device)."""
    key = (cfg.a, cfg.widths, str(device))
    if key not in _LAYER_TABLES:
        flat = [v for w in cfg.widths for v in w]
        _LAYER_TABLES[key] = (len(cfg.widths), (ctypes.c_int * len(flat))(*flat),
                              torch.from_numpy(layer_table(cfg)).to(device))
    return _LAYER_TABLES[key]


def _fwd_streams(cfg: GenericConfig) -> tuple:
    """The forward kernel's weight streams: every layer's forward tiles."""
    return tuple(("fwd", i, False) for i in range(len(cfg.widths)))


def _chain_streams(cfg: GenericConfig, replay: bool, vjp: bool = False) -> tuple:
    """The chain's weight streams in the order it takes them: every layer's
    forward tiles, first to last (replay only), then every layer's dm tiles,
    last first (components last first for #14's ``vjp``)."""
    dm = tuple(("dm", i, vjp) for i in reversed(range(len(cfg.widths))))
    return (_fwd_streams(cfg) if replay else ()) + dm


def _flat(ts):
    """One flat tensor of the tensors ``ts`` one after the other: their own
    storage when they already lie so (views of one buffer, as the kernels'
    outputs do), else a copy."""
    ts = list(ts)
    if (len({t.untyped_storage().data_ptr() for t in ts}) == 1
            and len({t.dtype for t in ts}) == 1 and all(t.is_contiguous() for t in ts)
            and all(a.data_ptr() + a.numel() * a.element_size() == b.data_ptr()
                    for a, b in zip(ts[:-1], ts[1:]))):
        return ts[0].as_strided((sum(t.numel() for t in ts),), (1,))
    return torch.cat([t.reshape(-1) for t in ts])


def _views(flat, shapes):
    """``flat`` cut into consecutive views of the given shapes."""
    out, o = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[o:o + n].view(shape))
        o += n
    return out


def _fwd_weights(cfg: GenericConfig, ws):
    """The forward kernel's weight arguments (the flat weights, packed
    tiles, masks, chunks, chunk count): fp32 the layers' weights one after
    the other, bf16 the plan's forward tiles of every layer."""
    if ws[0].dtype != torch.bfloat16:
        return _flat(ws), None, None, None, 0
    wpk, masks, chunks, per = _tile_plan(cfg).args(ws, _fwd_streams(cfg))
    return None, wpk, masks, chunks, sum(per)


def _chain_weights(cfg: GenericConfig, ws, replay: bool, vjp: bool = False):
    """The chain kernel's weight arguments (flat weights, packed tiles,
    masks, chunks, chunk count): bf16 the streams in the chain's order
    (``_chain_streams``)."""
    if ws[0].dtype != torch.bfloat16:
        return _flat(ws), None, None, None, 0
    wpk, masks, chunks, per = _tile_plan(cfg).args(ws, _chain_streams(cfg, replay, vjp))
    return None, wpk, masks, chunks, sum(per)


def _fwd_lib(kernel: CudaKernel, cfg: GenericConfig, x):
    """The forward source's library for cfg's gate activation, after
    checking that its kernel takes the widths in x's dtype: any width whose
    block fits the card's shared memory (``ValueError`` naming the bytes
    otherwise, before any launch)."""
    nl, widths, _ = _layers(cfg, x.device)
    lib = kernel.lib(_ACT_VARIANTS[cfg.act])
    smem = lib.fused_message_generic_tab_fwd_smem_bytes(_DTYPE_CODE[x.dtype], cfg.k, cfg.a, nl,
                                                         widths)
    if smem < 0:
        raise ValueError(f"the kernel does not take K={cfg.k}, widths {cfg.widths} in {x.dtype}")
    limit = lib.fused_message_generic_tab_fwd_max_smem()
    if smem > limit:
        raise ValueError(f"widths {cfg.widths} need {smem} bytes of shared memory per block "
                         f"in {x.dtype} (max {limit})")
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def generic_tab_fwd(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence,
                    save: bool = False):
    """agg [N, dk_last] (with ``save``, ``(agg, [y_1 .. y_L])``): the hand-
    written CUDA kernel for CUDA tensors (any number of message layers), the
    plain version for CPU tensors.  Arguments as in the plain version."""
    if h.device.type == "cpu":
        return generic_tab_fwd_plain(cfg, h, geo2, loc, gtab, ws, sels, save=save)
    _check_inputs(cfg, h, geo2, loc, gtab, ws, sels)
    _cuda_args(h, (h, geo2, loc, gtab, *ws, *sels))
    n, f = h.shape
    code = _DTYPE_CODE[h.dtype]
    lib = _fwd_lib(GENERIC_TAB_FWD, cfg, h)
    nl, widths, table = _layers(cfg, h.device)
    w, wpk, masks, chunks, nq = _fwd_weights(cfg, ws)
    out = torch.empty((n, cfg.out_dim), dtype=h.dtype, device=h.device)
    shapes = [(n * cfg.k, d) for _, d, _ in cfg.widths]
    yflat = h.new_empty((sum(r * d for r, d in shapes),)) if save else None
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = lib.fused_message_generic_tab_fwd(
            code, *(_ptr(x) for x in (h, geo2, loc, gtab, w, _flat(sels), table, out, yflat, wpk,
                                      masks, chunks)),
            n, f, cfg.k, cfg.a, cfg.tile, cfg.u, nl, widths, nq, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_generic_tab_fwd launch failed with CUDA error {rc}")
    GENERIC_TAB_FWD.launches += 1
    return (out, _views(yflat, shapes)) if save else out


# attribute components per block of the weight-gradient kernel (the CUDA
# source's kGroup in bf16; one in fp32)
WGRAD_GROUP = {torch.bfloat16: 2, torch.float32: 1}


def _wgrad_splits(cfg: GenericConfig, rows: int, sms: int) -> int:
    """Row ranges of the weight-gradient kernel (its partials' leading dim):
    the fewest that make layers x A x ranges whole waves of ``sms``, at most
    one per 1024 slot rows (two layers at A=9 on 132 SMs: 22 ranges).  The
    ranges do not depend on how many components a block takes (two in
    bf16: 220 blocks at two layers, A=9), so each range's partial sums, and
    dW', are bitwise those of one component a block."""
    per_range = len(cfg.widths) * cfg.a
    return max(1, min(math.lcm(per_range, sms) // per_range, rows // 1024))


def _bwd_lib(cfg: GenericConfig, x):
    """The backward source's library for cfg's gate activation, after
    checking that its kernels take the widths in x's dtype (as
    ``_fwd_lib``)."""
    nl, widths, _ = _layers(cfg, x.device)
    lib = GENERIC_TAB_BWD_RES.lib(_ACT_VARIANTS[cfg.act])
    smem = lib.fused_message_generic_tab_bwd_smem_bytes(_DTYPE_CODE[x.dtype], cfg.k, cfg.a, nl,
                                                         widths)
    if smem < 0:
        raise ValueError(f"the kernel does not take K={cfg.k}, widths {cfg.widths} in {x.dtype}")
    limit = lib.fused_message_generic_tab_bwd_max_smem()
    if smem > limit:
        raise ValueError(f"widths {cfg.widths} need {smem} bytes of shared memory per block "
                         f"in {x.dtype} (max {limit})")
    return lib


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _chain_buffers(cfg: GenericConfig, h, m0: bool = True):
    """The chain's outputs but d_hs: d_hr [N, F], every layer's dy [N*K, D
    rounded up to 8] (views of one buffer, layer order), m_0 [N*K, C1
    rounded up to 16] (None without ``m0``) and m_1 .. m_L-1 likewise (views
    of one buffer, None at one layer), in h's dtype; then the two flat
    buffers (dy, m_1..)."""
    n, f = h.shape
    rows = n * cfg.k
    new = lambda *shape: torch.empty(shape, dtype=h.dtype, device=h.device)
    dy_shapes = [(rows, -(-d // 8) * 8) for _, d, _ in cfg.widths]
    m_shapes = [(rows, -(-c1 // 16) * 16) for c1, _, _ in cfg.widths[1:]]
    dy = new(sum(r * c for r, c in dy_shapes))
    m = new(sum(r * c for r, c in m_shapes)) if m_shapes else None
    ms = [new(rows, -(-cfg.widths[0][0] // 16) * 16) if m0 else None]
    ms += _views(m, m_shapes) if m is not None else []
    return new(n, f), _views(dy, dy_shapes), ms, dy, m


def generic_tab_bwd_chain(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence,
                          d_agg, ys: Optional[Sequence] = None):
    """The chain kernel: #9 with the saved ``ys``, #10 (replay) without.
    Returns ``(d_hs [N*K, F], d_hr [N, F], dys, ms)``: the rounded sender
    cotangent of every slot, the receivers' K-sums, and for the
    weight-gradient kernel each layer's dy ([N*K, D rounded up to 8]) and
    input m ([N*K, C1 rounded up to 16]) per slot, zero-padded, first layer
    first."""
    _check_inputs(cfg, h, geo2, loc, gtab, ws, sels)
    _check_bwd_inputs(cfg, h, d_agg, ys)
    _cuda_args(h, (h, geo2, loc, gtab, *ws, *sels, d_agg, *(ys or ())))
    lib = _bwd_lib(cfg, h)
    nl, widths, table = _layers(cfg, h.device)
    n, f = h.shape
    replay = ys is None
    w, wpk, masks, chunks, nq = _chain_weights(cfg, ws, replay)
    dev, dt = h.device, h.dtype
    d_hs = torch.empty((n * cfg.k, f), dtype=dt, device=dev)
    d_hr, dys, ms, dy, m = _chain_buffers(cfg, h)
    y_in = None if replay else _flat(ys)
    with torch.cuda.device(dev):
        rc = lib.fused_message_generic_tab_bwd_chain(
            _DTYPE_CODE[dt], int(replay),
            *(_ptr(x) for x in (h, geo2, loc, gtab, w, _flat(sels), table, y_in, d_agg, d_hs,
                                d_hr, dy, ms[0], m, wpk, masks, chunks)),
            n, f, cfg.k, cfg.a, cfg.tile, cfg.u, nl, widths, nq,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("fused_message_generic_tab_bwd_chain", rc)
    (GENERIC_TAB_BWD_REP if replay else GENERIC_TAB_BWD_RES).launches += 1
    return d_hs, d_hr, dys, ms


def generic_tab_bwd_wgrad_plain(cfg: GenericConfig, geo2, ms: Sequence, dys: Sequence,
                                splits: int):
    """The weight-gradient kernel's function by PyTorch ops: partials
    [splits, NW] fp32, row ``r`` the sum over the r-th range of slot rows
    (chunks of 64 rows split evenly) of m_l^T (dy_l * attr_c rounded), every
    layer's W' flattened one after the other.  ``ms``, ``dys``: each layer's
    input and dy rows, as the chain writes them."""
    rows = ms[0].shape[0]
    attr = geo2.reshape(rows, cfg.a + 2)[:, :cfg.a]
    nch = -(-rows // 64)
    out = []
    for sp in range(splits):
        s, e = nch * sp // splits * 64, min(rows, nch * (sp + 1) // splits * 64)
        parts = []
        for m, dy, (c1, d, _) in zip(ms, dys, cfg.widths, strict=True):
            mf, dyr = m[s:e, :c1].float(), dy[s:e, :d]
            for cc in range(cfg.a):
                parts.append((mf.T @ (dyr * attr[s:e, cc:cc + 1]).float()).reshape(-1))
        out.append(torch.cat(parts))
    return torch.stack(out)


def _wgrad_launch(cfg: GenericConfig, geo2, ms: Sequence, dys: Sequence, hs, h, splits: int):
    """The weight-gradient kernel on CUDA tensors: m_0 from the chain
    (``ms[0]``), or (``hs`` given) rebuilt from hs and h.  Partials [splits,
    NW] fp32."""
    m0 = ms[0] if hs is None else None
    _cuda_args(geo2, tuple(x for x in (geo2, m0, *ms[1:], *dys, hs, h) if x is not None))
    lib = _bwd_lib(cfg, geo2)
    nl, widths, table = _layers(cfg, geo2.device)
    rows = dys[0].shape[0]
    partials = torch.empty((splits, cfg.nw), dtype=torch.float32, device=geo2.device)
    m = _flat(ms[1:]) if nl > 1 else None
    with torch.cuda.device(geo2.device):
        rc = lib.fused_message_generic_tab_bwd_wgrad(
            _DTYPE_CODE[geo2.dtype],
            *(_ptr(x) for x in (geo2, m0, m, _flat(dys), hs, h, table, partials)),
            rows // cfg.k, cfg.f, cfg.k, cfg.a, nl, widths, splits, WGRAD_GROUP[geo2.dtype],
            torch.cuda.current_stream(geo2.device).cuda_stream)
    _launched("fused_message_generic_tab_bwd_wgrad", rc)
    GENERIC_TAB_BWD_WGRAD.launches += 1
    return partials


def generic_tab_bwd_wgrad(cfg: GenericConfig, geo2, ms: Sequence, dys: Sequence, splits: int):
    """The weight-gradient kernel (CUDA tensors; the plain version for CPU
    tensors): partials [splits, NW] fp32 from the chain's outputs."""
    if geo2.device.type == "cpu":
        return generic_tab_bwd_wgrad_plain(cfg, geo2, ms, dys, splits)
    return _wgrad_launch(cfg, geo2, ms, dys, None, None, splits)


def _m0_rows(cfg: GenericConfig, hs, h, geo2):
    """The untabled m_0 of every slot row e = i*K + k as the weight-gradient
    kernel rebuilds it: [hs[k, i] || h[i] || d2 || 0], [N*K, C1 rounded up
    to 16] in h's dtype (the chain's m_0 rows, bit for bit)."""
    n, f = h.shape
    k, a = cfg.k, cfg.a
    e = torch.arange(n * k, device=h.device)
    node, kk = e // k, e % k
    m0 = h.new_zeros((n * k, -(-(2 * f + 1) // 16) * 16))
    m0[:, :f] = hs.reshape(k * n, f)[kk * n + node]
    m0[:, f:2 * f] = h[node]
    m0[:, 2 * f] = geo2.reshape(n * k, a + 2)[:, a]
    return m0


def generic_bwd_wgrad_plain(cfg: GenericConfig, hs, h, geo2, ms: Sequence, dys: Sequence,
                            splits: int):
    """The untabled weight-gradient kernel's function by PyTorch ops: m_0
    rebuilt from hs, h and geo2 (``_m0_rows``; ``ms[0]`` is not read), then
    as ``generic_tab_bwd_wgrad_plain``."""
    return generic_tab_bwd_wgrad_plain(cfg, geo2, [_m0_rows(cfg, hs, h, geo2), *ms[1:]], dys,
                                       splits)


def generic_bwd_wgrad(cfg: GenericConfig, hs, h, geo2, ms: Sequence, dys: Sequence, splits: int):
    """The untabled weight-gradient kernel (CUDA tensors; the plain version
    for CPU tensors): partials [splits, NW] fp32 from the chain's m_1 ..
    m_L-1 and dy rows, m_0 rebuilt from hs [K, N, F] and h [N, F] (#12, #13;
    ``ms[0]`` is not read)."""
    if geo2.device.type == "cpu":
        return generic_bwd_wgrad_plain(cfg, hs, h, geo2, ms, dys, splits)
    return _wgrad_launch(cfg, geo2, ms, dys, hs, h, splits)


def generic_tab_bwd_table_plain(cfg: GenericConfig, d_hs, loc):
    """d_hu [ntiles*U, F]: each table entry's d_hs rows summed in fp32 (the
    table-sum kernel's function, by PyTorch ops)."""
    n = loc.shape[0]
    ntab = n // cfg.tile * cfg.u
    locl = loc.long()
    tab = (torch.arange(n, device=loc.device) // cfg.tile)[:, None] * cfg.u + locl
    tab = torch.where(locl < cfg.u, tab, ntab).reshape(-1)
    acc = torch.zeros((ntab + 1, d_hs.shape[1]), dtype=torch.float32, device=d_hs.device)
    return acc.index_add_(0, tab, d_hs.float())[:ntab].to(d_hs.dtype)


def generic_tab_bwd_table(cfg: GenericConfig, d_hs, loc):
    """The table-sum kernel (CUDA tensors; the plain version for CPU
    tensors): d_hu [ntiles*U, F], each entry's rows summed in slot order."""
    if d_hs.device.type == "cpu":
        return generic_tab_bwd_table_plain(cfg, d_hs, loc)
    _cuda_args(d_hs, (d_hs, loc))
    n = loc.shape[0]
    d_hu = torch.empty((n // cfg.tile * cfg.u, d_hs.shape[1]), dtype=d_hs.dtype,
                       device=d_hs.device)
    with torch.cuda.device(d_hs.device):
        rc = GENERIC_TAB_BWD_TABLE.lib().fused_message_generic_tab_bwd_table(
            _DTYPE_CODE[d_hs.dtype], d_hs.data_ptr(), loc.data_ptr(), d_hu.data_ptr(), n,
            d_hs.shape[1], cfg.k, cfg.tile, cfg.u,
            torch.cuda.current_stream(d_hs.device).cuda_stream)
    _launched("fused_message_generic_tab_bwd_table", rc)
    GENERIC_TAB_BWD_TABLE.launches += 1
    return d_hu


def generic_tab_bwd_kernels(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence,
                            sels: Sequence, d_agg, ys: Optional[Sequence] = None):
    """The CUDA counterpart of ``generic_tab_bwd_plain`` (same arguments and
    results): the chain kernel (#9 with ``ys``, #10 without), the weight-
    gradient kernel, the table sum, then the fixed-order reduction of the
    weight-gradient partials."""
    d_hs, d_hr, dys, ms = generic_tab_bwd_chain(cfg, h, geo2, loc, gtab, ws, sels, d_agg, ys)
    dws = _reduce_wgrad(cfg, geo2, ms, dys)
    del ms, dys
    return generic_tab_bwd_table(cfg, d_hs, loc), d_hr, dws


def generic_tab_bwd(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence,
                    d_agg, ys: Optional[Sequence] = None):
    """``(d_hu, d_hr, [dW'_1 .. dW'_L] fp32)``: the hand-written CUDA kernels
    for CUDA tensors, the plain version for CPU tensors.  Arguments as in
    ``generic_tab_bwd_plain``."""
    if h.device.type == "cpu":
        return generic_tab_bwd_plain(cfg, h, geo2, loc, gtab, ws, sels, d_agg, ys)
    return generic_tab_bwd_kernels(cfg, h, geo2, loc, gtab, ws, sels, d_agg, ys)


# ---- the untabled kernels: #11 (forward), #12 (residual), #13 (replay)

def _check_untab_inputs(cfg: GenericConfig, hs, h, geo2, ws, sels):
    """The untabled kernels' arguments: hs [K, N, F] slot-major sender rows, h
    [N, F] the receivers, geo2 [N, K*(A+2)], weights and selections as in the
    tabled kernel (no tile or table: the untabled kernels take any N)."""
    n, f = h.shape
    if tuple(hs.shape) != (cfg.k, n, f):
        raise ValueError(f"hs has shape {tuple(hs.shape)}, wants {(cfg.k, n, f)}")
    if hs.dtype != h.dtype:
        raise TypeError(f"hs is {hs.dtype}, h is {h.dtype}")
    _check_common(cfg, h, geo2, ws, sels)


def _slot_rows_km(cfg: GenericConfig, hs, h, geo2, s: int, e: int):
    """Layer-1 input rows of receivers [s, e), m_0 [(e-s)*K, 2F+1] in the data
    dtype (node-major slot rows, the sender row hs[k, i]), with their
    attributes (fp32 of the dtype values) [rows, A] and masks [rows, 1]."""
    k, a = cfg.k, cfg.a
    c, f = e - s, h.shape[1]
    g3 = geo2[s:e].reshape(c, k, a + 2)
    m = torch.cat([hs[:, s:e].transpose(0, 1), h[s:e, None, :].expand(c, k, f),
                   g3[..., a:a + 1]], dim=-1)
    return (m.reshape(c * k, 2 * f + 1), g3[..., :a].reshape(c * k, a).float(),
            g3[..., a + 1].reshape(c * k, 1))


def generic_fwd_plain(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence,
                      chunk_rows: int = 1 << 18, save: bool = False):
    """Kernel #11's function by PyTorch ops (any device): agg [N, dk_last] in
    h's dtype; with ``save``, ``(agg, [y_1 .. y_L])``, each y the pre-gate layer
    output [N*K, D] in h's dtype, one row per slot (node-major).

    hs [K, N, F] the slot-major sender rows (``h[senders.T]``), h [N, F] the
    receivers; the rest as in ``generic_tab_fwd_plain``.  The rounding points
    are the tabled kernel's."""
    _check_untab_inputs(cfg, hs, h, geo2, ws, sels)
    dt = h.dtype
    n, k = h.shape[0], cfg.k
    wts = [w.float() for w in ws]
    sels = [s.long() for s in sels]
    out = torch.empty((n, cfg.out_dim), dtype=dt, device=h.device)
    ys = [torch.empty((n * k, d), dtype=dt, device=h.device) for _, d, _ in cfg.widths] \
        if save else None
    step = max(1, chunk_rows // k)
    for s in range(0, n, step):
        e = min(n, s + step)
        m, attr, mask = _slot_rows_km(cfg, hs, h, geo2, s, e)
        ms, yc = _rows_fwd(cfg, m, attr, wts, sels)
        if save:
            for y, yo in zip(yc, ys):
                yo[s * k:e * k] = y
        out[s:e] = (ms[-1] * mask).reshape(e - s, k, -1).float().sum(dim=1).to(dt)
    return (out, ys) if save else out


def generic_bwd_plain(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence, d_agg,
                      ys: Optional[Sequence] = None, chunk_rows: int = 1 << 18):
    """The untabled backward by PyTorch ops (any device): ``(d_hs [K, N, F],
    d_hr [N, F], [dW'_1 .. dW'_L] fp32)`` for the cotangent ``d_agg`` [N,
    dk_last] in h's dtype: d_hs the rounded sender cotangent of every slot,
    d_hr the receivers' fp32 K-sums rounded once.  ``ys=None`` replays the
    forward (kernel #13's function); the saved ys of
    ``generic_fwd_plain(save=True)`` are read instead (#12's)."""
    _check_untab_inputs(cfg, hs, h, geo2, ws, sels)
    _check_bwd_inputs(cfg, h, d_agg, ys)
    dt = h.dtype
    n, f = h.shape
    k = cfg.k
    wts = [w.float() for w in ws]
    sels = [s.long() for s in sels]
    d_hs = torch.empty((k, n, f), dtype=dt, device=h.device)
    d_hr = torch.empty((n, f), dtype=dt, device=h.device)
    dws = [torch.zeros_like(w) for w in wts]
    step = max(1, chunk_rows // k)
    for s in range(0, n, step):
        e = min(n, s + step)
        m0, attr, mask = _slot_rows_km(cfg, hs, h, geo2, s, e)
        yc = [y[s * k:e * k] for y in ys] if ys is not None else None
        dm = _rows_bwd(cfg, m0, attr, mask, wts, sels, d_agg[s:e], yc, dws)
        d_hs[:, s:e] = dm[:, :f].reshape(e - s, k, f).transpose(0, 1)
        d_hr[s:e] = dm[:, f:2 * f].reshape(e - s, k, f).float().sum(dim=1).to(dt)
    return d_hs, d_hr, dws


def generic_fwd(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence,
                save: bool = False):
    """agg [N, dk_last] (with ``save``, ``(agg, [y_1 .. y_L])``): kernel #11,
    hand-written in CUDA, for CUDA tensors (any number of message layers),
    the plain version for CPU tensors.  Arguments as in the plain version."""
    if h.device.type == "cpu":
        return generic_fwd_plain(cfg, hs, h, geo2, ws, sels, save=save)
    _check_untab_inputs(cfg, hs, h, geo2, ws, sels)
    _cuda_args(h, (hs, h, geo2, *ws, *sels))
    n, f = h.shape
    lib = _fwd_lib(GENERIC_FWD, cfg, h)
    nl, widths, table = _layers(cfg, h.device)
    w, wpk, masks, chunks, nq = _fwd_weights(cfg, ws)
    out = torch.empty((n, cfg.out_dim), dtype=h.dtype, device=h.device)
    shapes = [(n * cfg.k, d) for _, d, _ in cfg.widths]
    yflat = h.new_empty((sum(r * d for r, d in shapes),)) if save else None
    with torch.cuda.device(h.device):
        rc = lib.fused_message_generic_fwd(
            _DTYPE_CODE[h.dtype],
            *(_ptr(x) for x in (hs, h, geo2, w, _flat(sels), table, out, yflat, wpk, masks,
                                chunks)),
            n, f, cfg.k, cfg.a, nl, widths, nq, torch.cuda.current_stream(h.device).cuda_stream)
    _launched("fused_message_generic_fwd", rc)
    GENERIC_FWD.launches += 1
    return (out, _views(yflat, shapes)) if save else out


def generic_bwd_chain(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence, d_agg,
                      ys: Optional[Sequence] = None, vjp: bool = False):
    """The untabled chain kernel: #12 with the saved ``ys``, #13 (replay)
    without, #14's chain with ``vjp`` (replay, then the dm GEMMs rounded as
    JAX's AD of the layer: fp32 dya, each component's dm rounded, the
    components added in the dtype).  Returns ``(d_hs [K, N, F], d_hr [N, F],
    dys, ms)``, the last two per layer and slot row for the weight-gradient
    kernel, as the tabled chain writes them; m_0 only for ``vjp`` (else
    ``ms[0]`` is None: #12's and #13's weight gradients rebuild it)."""
    _check_untab_inputs(cfg, hs, h, geo2, ws, sels)
    _check_bwd_inputs(cfg, h, d_agg, ys)
    if vjp and ys is not None:
        raise ValueError("the vjp chain replays the forward: no saved ys")
    _cuda_args(h, (hs, h, geo2, *ws, *sels, d_agg, *(ys or ())))
    lib = _bwd_lib(cfg, h)
    nl, widths, table = _layers(cfg, h.device)
    n, f = h.shape
    replay = ys is None
    mode = 2 if vjp else int(replay)
    w, wpk, masks, chunks, nq = _chain_weights(cfg, ws, replay, vjp)
    d_hs = torch.empty((cfg.k, n, f), dtype=h.dtype, device=h.device)
    d_hr, dys, ms, dy, m = _chain_buffers(cfg, h, m0=vjp)
    y_in = None if replay else _flat(ys)
    with torch.cuda.device(h.device):
        rc = lib.fused_message_generic_bwd_chain(
            _DTYPE_CODE[h.dtype], mode,
            *(_ptr(x) for x in (hs, h, geo2, w, _flat(sels), table, y_in, d_agg, d_hs, d_hr, dy,
                                ms[0], m, wpk, masks, chunks)),
            n, f, cfg.k, cfg.a, nl, widths, nq, torch.cuda.current_stream(h.device).cuda_stream)
    _launched("fused_message_generic_bwd_chain", rc)
    (GENERIC_BWD_VJP if vjp else GENERIC_BWD_REP if replay else GENERIC_BWD_RES).launches += 1
    return d_hs, d_hr, dys, ms


def _split_dw(cfg: GenericConfig, dw):
    """The flat dW' [NW] cut into every layer's [A*C1, D]."""
    return _views(dw, [(cfg.a * c1, d) for c1, d, _ in cfg.widths])


def _reduce_wgrad(cfg: GenericConfig, geo2, ms: Sequence, dys: Sequence, hs=None, h=None):
    """[dW'_1 .. dW'_L] fp32 from the chain's rows (m_0 rebuilt from ``hs``
    and ``h`` when given): the weight-gradient kernel at whole waves on the
    card's SMs, then the fixed-order reduction of
    ``csrc/fused_message_tab_bwd.cu``."""
    sms = torch.cuda.get_device_properties(geo2.device).multi_processor_count
    splits = _wgrad_splits(cfg, dys[0].shape[0], sms)
    partials = (generic_tab_bwd_wgrad(cfg, geo2, ms, dys, splits) if hs is None
                else generic_bwd_wgrad(cfg, hs, h, geo2, ms, dys, splits))
    return _split_dw(cfg, tab_bwd_reduce(partials))


def generic_bwd_kernels(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence, d_agg,
                        ys: Optional[Sequence] = None):
    """The CUDA counterpart of ``generic_bwd_plain`` (same arguments and
    results): the untabled chain (#12 with ``ys``, #13 without), the weight-
    gradient kernel (m_0 rebuilt from hs and h), then the fixed-order
    reduction."""
    d_hs, d_hr, dys, ms = generic_bwd_chain(cfg, hs, h, geo2, ws, sels, d_agg, ys)
    return d_hs, d_hr, _reduce_wgrad(cfg, geo2, ms, dys, hs, h)


def generic_bwd(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence, d_agg,
                ys: Optional[Sequence] = None):
    """``(d_hs, d_hr, [dW'_1 .. dW'_L] fp32)``: the hand-written CUDA kernels
    for CUDA tensors, the plain version for CPU tensors.  Arguments as in
    ``generic_bwd_plain``."""
    if h.device.type == "cpu":
        return generic_bwd_plain(cfg, hs, h, geo2, ws, sels, d_agg, ys)
    return generic_bwd_kernels(cfg, hs, h, geo2, ws, sels, d_agg, ys)


# ---- kernel #14: the fallback backward (JAX's in-kernel ``jax.vjp``)

def _check_bwd_tile(h, bwd_tile: int) -> None:
    n = h.shape[0]
    if bwd_tile < 1 or n % bwd_tile:
        raise ValueError(f"rows {n} are not a multiple of the backward tile {bwd_tile}")


def _layer_vjp(dy, attr, w, m, c1: int, a: int, tile_rows: int):
    """One layer's transpose as JAX's AD of ``_layer_tp`` rounds it: per
    component dya_c = dy * attr_c in fp32, dm_c = dya_c W'_c^T in fp32 cast to
    the dtype and the C2 terms added in the dtype, last component first (the
    order in which JAX's backward pass accumulates m's cotangent); dW'_c per
    backward tile of ``tile_rows`` slot rows, m^T dya_c in fp32 cast to the
    dtype.  Returns ``(dm, parts [tiles, A*C1, D] fp32)``; ``m=None``: dm
    only (parts None)."""
    dt = dy.dtype
    rows, d = dy.shape
    dyf = dy.float()
    parts = None
    if m is not None:
        nt = rows // tile_rows
        mt = m.float().reshape(nt, tile_rows, c1).transpose(1, 2)
        parts = torch.empty((nt, a * c1, d), dtype=torch.float32, device=dy.device)
    dm = None
    for cc in range(a - 1, -1, -1):
        dya = dyf * attr[:, cc:cc + 1]
        if m is not None:
            parts[:, cc * c1:(cc + 1) * c1] = torch.bmm(
                mt, dya.view(nt, tile_rows, d)).to(dt).float()
        t = (dya @ w[cc * c1:(cc + 1) * c1].T).to(dt)
        dm = t if dm is None else dm + t
    return dm, parts


def generic_bwd_vjp_plain(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence, d_agg,
                          bwd_tile: int, chunk_rows: int = 1 << 17,
                          ys: Optional[Sequence] = None):
    """Kernel #14's function by PyTorch ops (any device): ``(d_hs [K, N, F],
    d_hr [N, F], [dW'_1 .. dW'_L] fp32)`` as ``generic_bwd_plain`` returns them,
    with the rounding of JAX's AD of the tile forward: the forward replayed;
    per layer the gate's VJP (``_gate_vjp``), then ``_layer_vjp``; d_hs the
    rounded sender columns of dm_0, d_hr the fp32 K-sum of its rounded
    receiver columns cast once; dW' the per-tile partials (tiles of
    ``bwd_tile`` receivers, N a multiple of it), each rounded to the dtype,
    added in fp32 in tile order.  In fp32 every rounding is the identity and
    this is #13's function.  Receivers go in chunks of whole tiles, about
    ``chunk_rows`` slot rows each.  ``ys``: saved pre-gate ys (the forward's
    save mode) read in place of the replay, to hold the kernel at its own y
    (a derivative that jumps, relu's at 0, turns a y that another fp32 sum
    order puts on the other side into a different dy)."""
    _check_untab_inputs(cfg, hs, h, geo2, ws, sels)
    _check_bwd_inputs(cfg, h, d_agg, ys)
    _check_bwd_tile(h, bwd_tile)
    dt = h.dtype
    n, f = h.shape
    k = cfg.k
    wts = [w.float() for w in ws]
    sels = [s.long() for s in sels]
    d_hs = torch.empty((k, n, f), dtype=dt, device=h.device)
    d_hr = torch.empty((n, f), dtype=dt, device=h.device)
    dws = [torch.zeros_like(w) for w in wts]
    step = max(1, chunk_rows // (bwd_tile * k)) * bwd_tile
    for s in range(0, n, step):
        e = min(n, s + step)
        m0, attr, mask = _slot_rows_km(cfg, hs, h, geo2, s, e)
        if ys is None:
            ms, yc = _rows_fwd(cfg, m0, attr, wts, sels, last_gate=False)
        else:
            yc = [y[s * k:e * k] for y in ys]
            ms = [m0] + [_gate(y, sel, dk, cfg.act) for y, sel, (_, _, dk)
                         in zip(yc[:-1], sels, cfg.widths)]
        dm = (d_agg[s:e].float().repeat_interleave(k, dim=0) * mask.float()).to(dt)
        for i in range(len(wts) - 1, -1, -1):
            c1, _, dk = cfg.widths[i]
            dy = _gate_vjp(yc[i], dm, sels[i], dk, cfg.act)
            dm, parts = _layer_vjp(dy, attr, wts[i], ms[i], c1, cfg.a, bwd_tile * k)
            for part in parts:  # the TPU grid's order
                dws[i] += part
        d_hs[:, s:e] = dm[:, :f].reshape(e - s, k, f).transpose(0, 1)
        d_hr[s:e] = dm[:, f:2 * f].reshape(e - s, k, f).float().sum(dim=1).to(dt)
    return d_hs, d_hr, dws


def generic_bwd_vjp_wgrad_plain(cfg: GenericConfig, geo2, ms: Sequence, dys: Sequence,
                                tile_rows: int, tile0: int, ntiles: int):
    """The per-tile weight-gradient kernel's function by PyTorch ops:
    partials [ntiles, NW] fp32, row t over the slot rows of backward tile
    tile0 + t of m_l^T (dy_l * attr_c in fp32), rounded to the dtype; the
    chain's row layouts and W' order as ``generic_tab_bwd_wgrad_plain``."""
    rows = ms[0].shape[0]
    attr = geo2.reshape(rows, cfg.a + 2)[:, :cfg.a].float()
    out = []
    for t in range(tile0, tile0 + ntiles):
        s, e = t * tile_rows, min(rows, (t + 1) * tile_rows)
        parts = []
        for m, dy, (c1, d, _) in zip(ms, dys, cfg.widths, strict=True):
            mf, dyf = m[s:e, :c1].float(), dy[s:e, :d].float()
            for cc in range(cfg.a):
                parts.append((mf.T @ (dyf * attr[s:e, cc:cc + 1])).to(ms[0].dtype).reshape(-1))
        out.append(torch.cat(parts).float())
    return torch.stack(out)


def generic_bwd_vjp_wgrad(cfg: GenericConfig, geo2, ms: Sequence, dys: Sequence, tile_rows: int,
                          tile0: int, ntiles: int, out=None):
    """The per-tile weight-gradient kernel (CUDA tensors; the plain version for
    CPU tensors): partials [ntiles, NW] fp32 (on the card into ``out`` when
    given)."""
    if geo2.device.type == "cpu":
        return generic_bwd_vjp_wgrad_plain(cfg, geo2, ms, dys, tile_rows, tile0, ntiles)
    _cuda_args(geo2, (geo2, *ms, *dys))
    lib = _bwd_lib(cfg, geo2)
    nl, widths, table = _layers(cfg, geo2.device)
    if out is None:
        out = torch.empty((ntiles, cfg.nw), dtype=torch.float32, device=geo2.device)
    if (tuple(out.shape) != (ntiles, cfg.nw) or out.dtype != torch.float32
            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 {(ntiles, cfg.nw)}")
    m = _flat(ms[1:]) if nl > 1 else None
    with torch.cuda.device(geo2.device):
        rc = lib.fused_message_generic_bwd_wgrad_tiles(
            _DTYPE_CODE[geo2.dtype],
            *(_ptr(x) for x in (geo2, ms[0], m, _flat(dys), table, out)),
            ms[0].shape[0] // cfg.k, cfg.k, cfg.a, nl, widths, tile_rows, tile0, ntiles,
            torch.cuda.current_stream(geo2.device).cuda_stream)
    _launched("fused_message_generic_bwd_wgrad_tiles", rc)
    GENERIC_BWD_VJP_WGRAD.launches += 1
    return out


# bytes of per-tile partials held at once (one group of tiles; 1.05 MB per
# tile at the two-layer lmax=2 config, 4.2 MB at lmax_attr=5)
_VJP_PARTIAL_BYTES = 1 << 27


def vjp_group(cfg: GenericConfig, ntiles: int) -> int:
    """Backward tiles per launch of #14's weight-gradient kernel: as many
    per-tile partials [NW] fp32 as fit in ``_VJP_PARTIAL_BYTES``."""
    return max(1, min(ntiles, _VJP_PARTIAL_BYTES // (4 * cfg.nw)))


def generic_bwd_vjp_kernels(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence,
                            d_agg, bwd_tile: int):
    """The CUDA counterpart of ``generic_bwd_vjp_plain`` (same arguments and
    results): the chain in its vjp mode, then per group of backward tiles the
    per-tile weight-gradient kernel and the fixed-order reduction, whose
    first row is the running sum: every tile's rounded partial is added in
    fp32 in tile order, and only one group's partials are held."""
    _check_bwd_tile(h, bwd_tile)
    d_hs, d_hr, dys, ms = generic_bwd_chain(cfg, hs, h, geo2, ws, sels, d_agg, vjp=True)
    ntiles = h.shape[0] // bwd_tile
    group = vjp_group(cfg, ntiles)
    buf = torch.zeros((group + 1, cfg.nw), dtype=torch.float32, device=h.device)
    dw = buf[0]
    for t0 in range(0, ntiles, group):
        g = min(group, ntiles - t0)
        generic_bwd_vjp_wgrad(cfg, geo2, ms, dys, bwd_tile * cfg.k, t0, g, out=buf[1:1 + g])
        dw = tab_bwd_reduce(buf[:1 + g])
        buf[0].copy_(dw)
    return d_hs, d_hr, _split_dw(cfg, dw)


def generic_bwd_vjp(cfg: GenericConfig, hs, h, geo2, ws: Sequence, sels: Sequence, d_agg,
                    bwd_tile: int):
    """``(d_hs, d_hr, [dW'_1 .. dW'_L] fp32)`` of kernel #14: the hand-written
    CUDA kernels for CUDA tensors, the plain version for CPU tensors.
    Arguments as in ``generic_bwd_vjp_plain``."""
    if h.device.type == "cpu":
        return generic_bwd_vjp_plain(cfg, hs, h, geo2, ws, sels, d_agg, bwd_tile)
    return generic_bwd_vjp_kernels(cfg, hs, h, geo2, ws, sels, d_agg, bwd_tile)


def _segment_sum_in_order(rows, seg, num: int):
    """[num, F]: per segment, its rows added one at a time in their order,
    each sum rounded to the rows' dtype (XLA's sorted ``segment_sum``);
    segment ids >= num are dropped."""
    acc = rows.new_zeros((num, rows.shape[1]))
    seg = seg.long()
    keep = seg < num
    rows, seg = rows[keep], seg[keep]
    if seg.numel() == 0:
        return acc
    counts = torch.bincount(seg, minlength=num)
    starts = torch.cumsum(counts, 0) - counts
    for j in range(int(counts.max())):
        nodes = torch.nonzero(counts > j).squeeze(1)
        acc[nodes] = acc[nodes] + rows[starts[nodes] + j]
    return acc


def generic_sender_epilogue(d_hr, d_hu, revd, remp, remn):
    """d_h [N, F] from the per-tile sender cotangents ``d_hu`` and the
    receiver ones ``d_hr``, in the order of the JAX ``call_tab_bwd``: the
    dense reverse-table gathers ``revd`` [N, q0] (pad ntiles*U: dropped)
    summed first, then the node-sorted remainder ``remp``/``remn`` (pad node
    N: dropped) summed per node in order, then d_hr; every add in the data
    dtype (XLA rounds each one there)."""
    n = d_hr.shape[0]
    nrow = d_hu.shape[0]
    acc = None
    for q in range(revd.shape[1]):
        idx = revd[:, q].long()
        p = d_hu[torch.clamp(idx, max=nrow - 1)] * (idx < nrow).to(d_hu.dtype)[:, None]
        acc = p if acc is None else acc + p
    seg = _segment_sum_in_order(d_hu[torch.clamp(remp.long(), max=nrow - 1)], remn, n)
    acc = seg if acc is None else acc + seg
    return acc + d_hr


class FusedMessageGenericTabled(torch.autograd.Function):
    """The tabled generic message with its hand-written backward: the
    counterpart of the JAX ``custom_vjp`` (``call_tab``/``call_tab_fwd``/
    ``call_tab_bwd``).  Residual mode saves each layer's pre-gate y (#8 in
    save mode, then #9); replay mode keeps node-sized tensors only (#10).
    Sender rows are read through ``gtab`` in both, so ``h[gtab]`` is never
    kept.  Returns the cotangent of h and of the folded weights, nothing for
    the geometry or the tables."""

    @staticmethod
    def forward(ctx, cfg, residual, h, geo2, loc, gtab, revd, remp, remn, sels, *ws):
        ctx.cfg, ctx.sels, ctx.nw = cfg, sels, len(ws)
        if residual and any(ctx.needs_input_grad):  # no save for inference
            agg, ys = generic_tab_fwd(cfg, h, geo2, loc, gtab, ws, sels, save=True)
        else:
            agg, ys = generic_tab_fwd(cfg, h, geo2, loc, gtab, ws, sels), []
        ctx.save_for_backward(h, geo2, loc, gtab, revd, remp, remn, *ws, *ys)
        return agg

    @staticmethod
    def backward(ctx, d_agg):
        saved = ctx.saved_tensors
        h, geo2, loc, gtab, revd, remp, remn = saved[:7]
        ws, ys = saved[7:7 + ctx.nw], saved[7 + ctx.nw:] or None
        d_agg = d_agg.to(h.dtype).contiguous()
        d_hu, d_hr, dws = generic_tab_bwd(ctx.cfg, h, geo2, loc, gtab, ws, ctx.sels, d_agg, ys)
        d_h = generic_sender_epilogue(d_hr, d_hu, revd, remp, remn)
        # cfg, residual, h, geo2, loc, gtab, revd, remp, remn, sels, weights
        return (None, None, d_h) + (None,) * 7 + tuple(
            dw.to(w.dtype) for dw, w in zip(dws, ws))


def fused_message_generic_tabled(cfg: GenericConfig, residual: bool, h, geo2, loc, gtab,
                                 revd, remp, remn, sels, *ws):
    """agg [N, dk_last], differentiable in h and the folded weights ``ws``;
    CUDA tensors run the hand-written kernels (or raise), CPU tensors the
    plain versions.  ``residual`` picks the backward: #9 from the saved ys,
    or #10, which replays the forward."""
    return FusedMessageGenericTabled.apply(cfg, residual, h, geo2, loc, gtab, revd, remp, remn,
                                           tuple(sels), *ws)


class FusedMessageGenericUntabled(torch.autograd.Function):
    """The untabled generic message with its hand-written backward: the
    counterpart of the JAX ``custom_vjp`` of ``geo_call`` (``call``/
    ``call_fwd``/``call_bwd``).  ``mode`` picks the backward as ``call_bwd``
    does: "residual" saves each layer's pre-gate y (#11 in save mode, then
    #12); "replay" keeps the inputs only (#13); "vjp" keeps the inputs only
    and runs #14 at ``bwd_tile``.  Returns the cotangents of hs [K, N, F], of
    h and of the folded weights."""

    @staticmethod
    def forward(ctx, cfg, mode, bwd_tile, hs, h, geo2, sels, *ws):
        ctx.cfg, ctx.mode, ctx.bwd_tile, ctx.sels, ctx.nw = cfg, mode, bwd_tile, sels, len(ws)
        if mode == "residual" and any(ctx.needs_input_grad):  # no save for inference
            agg, ys = generic_fwd(cfg, hs, h, geo2, ws, sels, save=True)
        else:
            agg, ys = generic_fwd(cfg, hs, h, geo2, ws, sels), []
        ctx.save_for_backward(hs, h, geo2, *ws, *ys)
        return agg

    @staticmethod
    def backward(ctx, d_agg):
        saved = ctx.saved_tensors
        hs, h, geo2 = saved[:3]
        ws, ys = saved[3:3 + ctx.nw], saved[3 + ctx.nw:] or None
        d_agg = d_agg.to(h.dtype).contiguous()
        if ctx.mode == "vjp":
            d_hs, d_hr, dws = generic_bwd_vjp(ctx.cfg, hs, h, geo2, ws, ctx.sels, d_agg,
                                              ctx.bwd_tile)
        else:
            d_hs, d_hr, dws = generic_bwd(ctx.cfg, hs, h, geo2, ws, ctx.sels, d_agg, ys)
        # cfg, mode, bwd_tile, hs, h, geo2, sels, weights
        return (None, None, None, d_hs, d_hr, None, None) + tuple(
            dw.to(w.dtype) for dw, w in zip(dws, ws))


class FusedMessageGenericSym(torch.autograd.Function):
    """The symmetric-graph entry (the JAX ``call_sym`` custom_vjp): the sender
    gather ``h[senders.T]`` inside the Function, so only node-sized tensors
    are kept; the backward gathers hs again, runs the replay backward (#13)
    and brings the sender cotangents back through the reverse-slot
    gather-sum, then adds d_hr in the data dtype."""

    @staticmethod
    def forward(ctx, cfg, h, geo2, senders, reverse_slot, sels, *ws):
        ctx.cfg, ctx.sels = cfg, sels
        agg = generic_fwd(cfg, gather_km(h, senders), h, geo2, ws, sels)
        ctx.save_for_backward(h, geo2, senders, reverse_slot, *ws)
        return agg

    @staticmethod
    def backward(ctx, d_agg):
        h, geo2, senders, reverse_slot, *ws = ctx.saved_tensors
        d_agg = d_agg.to(h.dtype).contiguous()
        d_hs, d_hr, dws = generic_bwd(ctx.cfg, gather_km(h, senders), h, geo2, ws, ctx.sels,
                                      d_agg)
        d_h = reverse_slot_gather_sum_km(d_hs, reverse_slot) + d_hr
        # cfg, h, geo2, senders, reverse_slot, sels, weights
        return (None, d_h, None, None, None, None) + tuple(
            dw.to(w.dtype) for dw, w in zip(dws, ws))


class FusedMessageGeneric:
    """Fused message MLP + masked K-slot aggregation for one SEGNN layer's
    message layers (``O3TensorProductGate`` with a generic 'cm'
    ``TensorProduct``, the scalars gated by one activation of
    ``ops/gate.py``'s ``ACTIVATIONS`` and the gates by sigmoid; any other
    callable raises ``ValueError`` naming the set, on any device, where JAX's
    kernels take any callable): on a graph with gather tables
    built at ``tile`` (``geo_call_tab``), on a gathered slot-major sender
    operand (``geo_call``) or on a symmetric graph with the gather inside
    (``geo_call_sym``).

    The backward, as the JAX ``call_bwd`` picks it: ``residual_bwd``, the
    forward saves the pre-gate ys and the backward reads them (#9, #12);
    else ``replay_bwd``, the backward replays the forward (#10, #13); else
    the fallback backward #14 (``geo_call`` only), at ``bwd_tile`` receivers
    per tile (default ``max(tile // 2, 8)``, as JAX): its bf16 weight
    gradient rounds once per tile, so the tile changes that result.  Both
    hand-structured backwards need every layer on the folded-GEMM path
    (``TensorProduct._gemm_default``), so a non-foldable layer (attributes
    wider than 32, ``lmax_attr >= 5``, or ``mode="sparse"``) turns both off.
    Such a layer still runs the same kernels on its CG-folded weights: the
    forward #11 and the backward #14, the folded product and the selection
    gate where the JAX kernel evaluates the layer component-wise with the
    concat gate.  Both compute the same function; in bf16 they round at other
    places (the gate's silu once more, the sparse TP per output component).

    Silu runs the selection gate, as JAX's kernels do; another activation
    runs JAX's concat-form gate in the same kernels, every route (#8-#14),
    the folded weights permuted as for silu (``_gate``, ``_gate_vjp``)."""

    def __init__(self, layers: Sequence, k: int, tile: int, bwd_tile: int = 0,
                 residual_bwd: bool = True, replay_bwd: bool = True) -> None:
        self.layers = list(layers)
        self.k = k
        self.tile = tile
        self.bwd_tile = bwd_tile or max(tile // 2, 8)
        foldable = all(getattr(layer.tp, "_gemm_default", lambda: False)()
                       for layer in self.layers)
        self.residual_bwd = residual_bwd and foldable
        self.replay_bwd = replay_bwd and foldable
        self._gate_fast = []
        acts = set()
        for layer in self.layers:
            g = getattr(layer, "gate", None)
            if not (g is not None and g.layout == "cm" and g.act_gates is torch.sigmoid
                    and isinstance(layer.tp, TensorProduct)):
                raise ValueError("the generic kernels run generic TensorProduct message layers "
                                 "gated in the cm layout, the gates by sigmoid")
            acts.add(activation(g.act_scalars).code)
            self._gate_fast.append(g.fast_tables())
        if len(acts) != 1:
            raise ValueError("the generic kernels take one activation for all message layers")
        (self.act,) = acts
        self.out_dim = self.layers[-1].gate.irreps_out.dim
        self._sels = {}
        self._plan: Optional[TilePlan] = None

    def tile_plan(self) -> TilePlan:
        """The nonzero 16x8 tiles of the folded weights (``fold`` at seeded
        random parameters), built once: what the bf16 kernels multiply."""
        if self._plan is None:
            nz = fold_structure(self.layers, [perm for perm, _, _ in self._gate_fast])
            self._plan = TilePlan(self.layers[0].tp.in2_dim,
                                  [(layer.tp.in1_dim, layer.tp.out_dim) for layer in self.layers],
                                  nz)
        return self._plan

    def config(self, a: int, u: int) -> GenericConfig:
        """The kernels' configuration at attribute width ``a``, with the tile
        plan of these layers' folded weights (their ``fold``: the kernels
        take no other weights with it)."""
        widths = tuple((layer.tp.in1_dim, layer.tp.out_dim, dk)
                       for layer, (_, _, dk) in zip(self.layers, self._gate_fast))
        plan = self.tile_plan() if a == self.layers[0].tp.in2_dim else None
        return GenericConfig(k=self.k, tile=self.tile, u=u, a=a, widths=widths, act=self.act,
                             plan=plan)

    def flops_per_slot(self) -> int:
        """Multiply-adds x 2 that one slot needs: the nonzeros of every
        layer's folded W' (an (l_in, l_attr, l_out) block is nonzero only
        where a CG path exists, and there only where its coefficient is)."""
        return 2 * sum(layer.tp.fold_nonzeros() for layer in self.layers)

    def selections(self, device) -> tuple:
        """Per layer the int32 sigmoid-lane index of each gate output lane
        (views of one buffer, layer order: the kernels read it whole)."""
        key = str(device)
        if key not in self._sels:
            sels = [layer.gate.fast_select(psel).to(dtype=torch.int32)
                    for layer, (_, psel, _) in zip(self.layers, self._gate_fast)]
            self._sels[key] = tuple(_views(torch.cat(sels).to(device), [s.shape for s in sels]))
        return self._sels[key]

    def fold(self, dtype) -> list:
        """Per layer the CG-folded weights (fp32) with columns permuted to
        ``scalars || gated || gates``, cast to ``dtype``: differentiable in
        the parameters, as the JAX ``_fold``."""
        out = []
        for layer, (perm, _, _) in zip(self.layers, self._gate_fast):
            wf = layer.tp.fold_params()
            out.append(wf[:, torch.as_tensor(perm, device=wf.device).long()].to(dtype))
        return out

    def _bwd_mode(self) -> str:
        return "residual" if self.residual_bwd else "replay" if self.replay_bwd else "vjp"

    def geo_call_tab(self, h, geo2, loc, gtab, rev_dense, rem_pos, rem_node):
        """agg [N, dk_last] for h [N, F] (N a multiple of ``tile``), geo2
        [N, K*(A+2)], loc [N, K], gtab [N/tile, U] built at ``tile`` and the
        split reverse table (``rev_dense`` [N, q0], ``rem_pos``/``rem_node``)
        that the backward's epilogue reads.  Needs a hand-structured backward
        (folded layers, ``residual_bwd`` or ``replay_bwd``), as in JAX."""
        if not (self.residual_bwd or self.replay_bwd):
            raise ValueError("geo_call_tab needs a hand-structured backward (folded layers)")
        a = geo2.shape[-1] // self.k - 2
        cfg = self.config(a, gtab.shape[1])
        ws = [w.contiguous() for w in self.fold(h.dtype)]
        tabs = (loc, gtab, rev_dense, rem_pos, rem_node)
        return fused_message_generic_tabled(cfg, self.residual_bwd, h.contiguous(),
                                            geo2.contiguous(), *(t.contiguous() for t in tabs),
                                            self.selections(h.device), *ws)

    def geo_call(self, hs, h, geo2):
        """agg [N, dk_last] for hs [K, N, F] (the slot-major sender rows,
        ``h[senders.T]``), h [N, F] and geo2 [N, K*(A+2)]; the sender
        cotangent goes back through hs (kernels #11, then #12, #13 or #14;
        for #14 N is a multiple of ``bwd_tile``)."""
        cfg = self.config(geo2.shape[-1] // self.k - 2, 0)
        ws = [w.contiguous() for w in self.fold(h.dtype)]
        return FusedMessageGenericUntabled.apply(cfg, self._bwd_mode(), self.bwd_tile,
                                                 hs.contiguous(), h.contiguous(),
                                                 geo2.contiguous(), self.selections(h.device),
                                                 *ws)

    def geo_call_sym(self, h, geo2, senders, reverse_slot):
        """agg [N, dk_last] on a symmetrized fixed-K graph (senders [N, K], the
        node-major reverse slots [N, K], ``graph.radius.symmetrize_dense``),
        the gather inside the autograd Function: only node-sized tensors are
        kept, and the backward replays (#11, #13).  Needs the replay backward,
        as in JAX: a non-foldable layer, or ``replay_bwd=False``, raises."""
        if not self.replay_bwd:
            raise ValueError("geo_call_sym needs the replay backward (folded layers, "
                             "replay_bwd=True)")
        cfg = self.config(geo2.shape[-1] // self.k - 2, 0)
        ws = [w.contiguous() for w in self.fold(h.dtype)]
        return FusedMessageGenericSym.apply(cfg, h.contiguous(), geo2.contiguous(),
                                            senders.contiguous(), reverse_slot.contiguous(),
                                            self.selections(h.device), *ws)
