"""Generic fused message MLP + neighbourhood aggregation, tabled gather, forward.

Counterpart of ``scalable_e3_gnn_tpu/kernels/fused_message_generic.py::
FusedMessageGeneric.geo_call_tab`` (its forward, ``_fwd_call_tab``) for any
hidden irreps and attribute order: the lmax=2 configurations.  Per receiver i
and slot k:

    m_0    = [h[gtab[i // tile, loc[i,k]]] || h[i] || d2[i,k]]     (C1 = 2F+1)
    y_l    = sum_c (m_l @ W'_l,c) * attr_c[i,k]                       (C2 = A)
    m_l+1  = y_l[:, :dk] * sigmoid(y_l)[:, sel_l]                     (fast gate)
    agg[i] = sum_k mask[i,k] * m_L

``W'_l`` [A*C1, D] is the message layer's CG-folded weight matrix
(``TensorProduct.fold_params``, fp32) with its columns permuted to
``scalars || gated || gates`` (``Gate.fast_tables``), and ``sel_l`` [dk] the
sigmoid lane that multiplies each output lane.  ``loc == U`` means no sender
(a zero row).  The geometry rides the node-major packed stream ``geo2``
[N, K*(A+2)] (per slot ``attr || d2 || mask``).

Rounding points (the TPU kernel's, in both implementations): operands in the
data dtype; each component's GEMM accumulated in fp32 and scaled by attr_c in
fp32, summed over c in fp32, cast to the data dtype (y); sigmoid in fp32 cast
to the dtype; the gate product in the dtype; ``msg * mask`` in the dtype; the
K-sum in fp32; the output cast to the dtype.

- ``generic_tab_fwd_plain``: PyTorch ops, in chunks of receivers so the
  [rows, C1] temporaries stay bounded (a whole [4M, 181] fp32 one is 2.9 GB).
  The CPU tests and the on-card checks use it.
- ``generic_tab_fwd``: a CPU tensor goes to the plain version; a CUDA tensor
  goes to the hand-written kernel ``csrc/fused_message_generic_tab_fwd.cu``
  or raises.
- ``fused_message_generic_tabled``: the autograd entry
  (``FusedMessageGenericTabled``); its backward (TPU kernels #9/#10) is not
  ported and raises.
- ``FusedMessageGeneric``: the per-layer object the model dispatches to
  (folds and permutes the weights, then ``geo_call_tab``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .build import CudaKernel
from .fused_message import _DTYPE_CODE, _MAX_SMEM, _cuda_args

__all__ = ["GenericConfig", "FusedMessageGeneric", "FusedMessageGenericTabled",
           "fused_message_generic_tabled", "generic_tab_fwd", "generic_tab_fwd_plain",
           "GENERIC_TAB_FWD", "KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
GENERIC_TAB_FWD = CudaKernel("fused_message_generic_tab_fwd", {
    # dtype, k, a, c1a, da, c1b, db -> bytes (negative: widths not taken)
    "fused_message_generic_tab_fwd_smem_bytes": (ctypes.c_long, [_I] * 7),
    # dtype, 9 pointers (h, geo2, loc, gtab, w1, sel1, w2, sel2, out),
    # n, f, k, a, tile, u, c1a, da, dk1, c1b, db, dk2, stream
    "fused_message_generic_tab_fwd": (_I, [_I] + [_P] * 9 + [_I] * 12 + [_P]),
})

KERNELS = (GENERIC_TAB_FWD,)

_NOT_PORTED_BWD = (
    "the backward of the generic tabled message kernel (TPU kernels #9 "
    "_bwd_call_res_tab and #10 _bwd_call_rep_tab) is ported in a later slice, "
    "the lmax=2 training slice")


@dataclass(frozen=True)
class GenericConfig:
    k: int  # neighbour slots per node
    tile: int  # receivers per gather-table tile
    u: int  # compact sender-table size
    a: int  # attribute width (C2 = (lmax+1)^2)
    widths: Tuple[Tuple[int, int, int], ...]  # per message layer (C1, D, dk)

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


def _check_inputs(cfg: GenericConfig, h, geo2, loc, gtab, ws, sels):
    n, f = h.shape
    if f != cfg.f:
        raise ValueError(f"h has {f} features, config wants {cfg.f}")
    if n % cfg.tile:
        raise ValueError(f"rows {n} are not a multiple of the tile {cfg.tile}")
    if tuple(geo2.shape) != (n, cfg.k * (cfg.a + 2)):
        raise ValueError(f"geo2 has shape {tuple(geo2.shape)}, wants {(n, cfg.k * (cfg.a + 2))}")
    if tuple(loc.shape) != (n, cfg.k):
        raise ValueError(f"loc has shape {tuple(loc.shape)}, wants {(n, cfg.k)}")
    if tuple(gtab.shape) != (n // cfg.tile, cfg.u):
        raise ValueError(f"gtab has shape {tuple(gtab.shape)}, wants {(n // cfg.tile, cfg.u)}")
    if loc.dtype != torch.int32 or gtab.dtype != torch.int32:
        raise TypeError("loc and gtab must be int32")
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


def generic_tab_fwd_plain(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence,
                          chunk_rows: int = 1 << 18):
    """agg [N, dk_last] in h's dtype, by PyTorch ops (any device).

    h [N, F] cm-layout node features, N a multiple of cfg.tile; geo2
    [N, K*(A+2)] in h's dtype; loc [N, K] int32 slot -> table index (pad U);
    gtab [N/tile, U] int32 node ids (pad N); ws per layer the folded, column-
    permuted weights [A*C1, D] in h's dtype; sels per layer [dk] int32.
    Receivers go in chunks of ``chunk_rows // K``."""
    _check_inputs(cfg, h, geo2, loc, gtab, ws, sels)
    dt = h.dtype
    n, f = h.shape
    k, a, u = cfg.k, cfg.a, cfg.u
    flat = gtab.reshape(-1).long()
    wts = [w.float() for w in ws]
    sels = [s.long() for s in sels]
    out = torch.empty((n, cfg.out_dim), dtype=dt, device=h.device)
    step = max(1, chunk_rows // k)
    for s in range(0, n, step):
        e = min(n, s + step)
        c = e - s
        locc = loc[s:e].long()
        tile_of = (torch.arange(s, e, device=h.device) // cfg.tile)[:, None]
        snd = flat[tile_of * u + torch.clamp(locc, max=u - 1)]
        valid = (locc < u) & (snd < n)
        hs = torch.where(valid[..., None], h[torch.clamp(snd, max=n - 1)], h.new_zeros(()))
        g3 = geo2[s:e].reshape(c, k, a + 2)
        m = torch.cat([hs, h[s:e, None, :].expand(c, k, f), g3[..., a:a + 1]], dim=-1)
        m = m.reshape(c * k, 2 * f + 1)
        attr = g3[..., :a].reshape(c * k, a).float()
        for w, sel, (c1, _, dk) in zip(wts, sels, cfg.widths):
            mf = m.float()
            acc = None
            for cc in range(a):
                t = (mf @ w[cc * c1:(cc + 1) * c1]) * attr[:, cc:cc + 1]
                acc = t if acc is None else acc + t
            y = acc.to(dt)
            sg = torch.sigmoid(y.float()).to(dt)
            m = y[:, :dk] * sg[:, sel]
        msg = m * g3[..., a + 1].reshape(c * k, 1)
        out[s:e] = msg.reshape(c, k, -1).float().sum(dim=1).to(dt)
    return out


def _mma_layout(w, a: int, c1: int, d: int):
    """[A*C1, D] -> [A, D rounded up to 8, C1 rounded up to 16], transposed
    and zero-padded: the tensor-core engine's weight layout, one contiguous
    slice per attribute component."""
    dp, kp = -(-d // 8) * 8, -(-c1 // 16) * 16
    out = w.new_zeros((a, dp, kp))
    out[:, :d, :c1] = w.view(a, c1, d).transpose(1, 2)
    return out


def generic_tab_fwd(cfg: GenericConfig, h, geo2, loc, gtab, ws: Sequence, sels: Sequence):
    """agg [N, dk_last]: the hand-written CUDA kernel for CUDA tensors (two
    message layers), the plain version for CPU tensors.  Arguments as in the
    plain version."""
    if h.device.type == "cpu":
        return generic_tab_fwd_plain(cfg, h, geo2, loc, gtab, ws, sels)
    _check_inputs(cfg, h, geo2, loc, gtab, ws, sels)
    _cuda_args(h, (h, geo2, loc, gtab, *ws, *sels))
    if len(cfg.widths) != 2:
        raise NotImplementedError(f"the CUDA kernel runs two message layers, not {len(cfg.widths)}")
    (c1a, da, dk1), (c1b, db, dk2) = cfg.widths
    n, f = h.shape
    code = _DTYPE_CODE[h.dtype]
    lib = GENERIC_TAB_FWD.lib()
    smem = lib.fused_message_generic_tab_fwd_smem_bytes(code, cfg.k, cfg.a, c1a, da, c1b, db)
    if smem < 0:
        raise ValueError(f"the kernel does not take K={cfg.k}, widths {cfg.widths} in {h.dtype}")
    if smem > _MAX_SMEM:
        raise ValueError(f"widths need {smem} bytes of shared memory per block (max {_MAX_SMEM})")
    w1, w2 = ws
    if h.dtype == torch.bfloat16:  # the tensor-core engine's weight layout
        w1, w2 = _mma_layout(w1, cfg.a, c1a, da), _mma_layout(w2, cfg.a, c1b, db)
    out = torch.empty((n, dk2), dtype=h.dtype, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    ptrs = (h, geo2, loc, gtab, w1, sels[0], w2, sels[1], out)
    with torch.cuda.device(h.device):
        rc = lib.fused_message_generic_tab_fwd(
            code, *(x.data_ptr() for x in ptrs), n, f, cfg.k, cfg.a, cfg.tile, cfg.u,
            c1a, da, dk1, c1b, db, dk2, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_generic_tab_fwd launch failed with CUDA error {rc}")
    GENERIC_TAB_FWD.launches += 1
    return out


class FusedMessageGenericTabled(torch.autograd.Function):
    """The tabled generic message forward under autograd: the counterpart of
    the JAX ``custom_vjp`` around ``_fwd_call_tab``.  Its backward is the
    lmax=2 training slice's work and raises here."""

    @staticmethod
    def forward(ctx, cfg, h, geo2, loc, gtab, sels, *ws):
        return generic_tab_fwd(cfg, h, geo2, loc, gtab, ws, sels)

    @staticmethod
    def backward(ctx, d_agg):
        raise NotImplementedError(_NOT_PORTED_BWD)


def fused_message_generic_tabled(cfg: GenericConfig, h, geo2, loc, gtab, sels, *ws):
    """agg [N, dk_last]; CUDA tensors run the hand-written kernel (or raise),
    CPU tensors the plain version.  A backward through it raises."""
    return FusedMessageGenericTabled.apply(cfg, h, geo2, loc, gtab, tuple(sels), *ws)


class FusedMessageGeneric:
    """Fused message MLP + masked K-slot aggregation for one SEGNN layer's
    message layers (``O3TensorProductGate`` with a generic 'cm'
    ``TensorProduct`` on the folded-GEMM path and a silu/sigmoid gate), on a
    graph with gather tables built at ``tile``."""

    def __init__(self, layers: Sequence, k: int, tile: int) -> None:
        self.layers = list(layers)
        self.k = k
        self.tile = tile
        self._gate_fast = []
        for layer in self.layers:
            g = getattr(layer, "gate", None)
            ok = (g is not None and g.layout == "cm" and g.act_scalars is F.silu
                  and g.act_gates is torch.sigmoid
                  and getattr(layer.tp, "_gemm_default", lambda: False)())
            if not ok:
                raise NotImplementedError(
                    "the generic kernel runs folded-GEMM layers with the silu/sigmoid "
                    "selection gate; other message layers are ported in a later slice")
            self._gate_fast.append(g.fast_tables())
        self.out_dim = self.layers[-1].gate.irreps_out.dim
        self._sels = {}

    def config(self, a: int, u: int) -> GenericConfig:
        widths = tuple((layer.tp.in1_dim, layer.tp.out_dim, dk)
                       for layer, (_, _, dk) in zip(self.layers, self._gate_fast))
        return GenericConfig(k=self.k, tile=self.tile, u=u, a=a, widths=widths)

    def flops_per_slot(self) -> int:
        """Multiply-adds x 2 that one slot needs: the nonzeros of every
        layer's folded W' (an (l_in, l_attr, l_out) block is nonzero only
        where a CG path exists, and there only where its coefficient is)."""
        return 2 * sum(layer.tp.fold_nonzeros() for layer in self.layers)

    def selections(self, device) -> tuple:
        """Per layer the int32 sigmoid-lane index of each gate output lane."""
        key = str(device)
        if key not in self._sels:
            self._sels[key] = tuple(
                layer.gate.fast_select(psel).to(device=device, dtype=torch.int32)
                for layer, (_, psel, _) in zip(self.layers, self._gate_fast))
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

    def geo_call_tab(self, h, geo2, loc, gtab):
        """agg [N, dk_last] for h [N, F] (N a multiple of ``tile``), geo2
        [N, K*(A+2)], loc [N, K] and gtab [N/tile, U] built at ``tile``."""
        a = geo2.shape[-1] // self.k - 2
        cfg = self.config(a, gtab.shape[1])
        ws = [w.contiguous() for w in self.fold(h.dtype)]
        return fused_message_generic_tabled(cfg, h.contiguous(), geo2.contiguous(),
                                            loc.contiguous(), gtab.contiguous(),
                                            self.selections(h.device), *ws)
