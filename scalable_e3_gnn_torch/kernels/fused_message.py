"""Fused SEGNN message MLP + neighbourhood aggregation (lmax=1, tabled gather).

Counterpart of ``scalable_e3_gnn_tpu/kernels/fused_message.py::
fused_message_aggregate_tabled``, forward only.  Per receiver i and slot k:

    agg[i] = sum_k mask[i,k] * MLP2(MLP1([h_s || h_r || d^2], sh), sh)

two gated L1 tensor-product layers (silu scalars, sigmoid-gated vectors) with
the edge's sh attribute, where the sender row is ``h[gtab[i // tile,
loc[i,k]]]`` and ``loc == U`` means no sender (a zero row).

Two implementations of one function:

- ``fused_message_aggregate_tabled_plain``: PyTorch ops with the TPU
  kernel's rounding points (inputs in the data dtype, products accumulated in
  fp32, the layer-1 outputs cast to the data dtype between the layers, each
  masked slot message cast to the data dtype before the fp32 K-sum, the
  output cast at the end).  The CPU tests and the on-card checks use it.
- ``fused_message_aggregate_tabled``: the wrapper.  A CPU tensor goes to the
  plain version; a CUDA tensor goes to the hand-written kernel
  ``csrc/fused_message_tab_fwd.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .build import CudaKernel

__all__ = ["MessageConfig", "fused_message_aggregate_tabled",
           "fused_message_aggregate_tabled_plain", "TAB_FWD"]

CG110 = 1.0 / math.sqrt(3.0)
CG011 = 1.0 / math.sqrt(3.0)

# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
TAB_FWD = CudaKernel("fused_message_tab_fwd", {
    "fused_message_tab_fwd_smem_bytes": (ctypes.c_long, [_I] * 3),
    # dtype, 13 pointers (h, d2, attr, maskf, loc, gtab, 6 weights, out),
    # npad, hs, hv, k, tile, u, stream
    "fused_message_tab_fwd": (_I, [_I] + [_P] * 13 + [_I] * 6 + [_P]),
})


@dataclass(frozen=True)
class MessageConfig:
    hs: int  # scalar multiplicity of the hidden irreps
    hv: int  # vector multiplicity
    k: int  # neighbour slots per node
    tile: int = 64  # receivers per gather-table tile
    u: int = 0  # compact sender-table size

    @property
    def f(self) -> int:  # flat hidden dim (cm layout)
        return self.hs + 3 * self.hv

    @property
    def s1(self) -> int:  # scalars entering layer 1 (h_s || h_r || d^2)
        return 2 * self.hs + 1

    @property
    def v1(self) -> int:  # vector channels (per component) entering layer 1
        return 2 * self.hv


def _split_weights(cfg: MessageConfig, w0e1, w1o1, w0e2, w1o2):
    """Reference-layout weights -> (W0, W1S, W1V) per layer.

    ``W1S`` are the rows of ``w_l1o`` fed by scalars, ``W1V`` the rows fed by
    vectors; the TPU kernel's block-diagonal copy of ``W1V`` is a layout for
    its matrix unit and is not needed here."""
    return (w0e1, w1o1[: cfg.s1], w1o1[cfg.s1 :], w0e2, w1o2[: cfg.hs], w1o2[cfg.hs :])


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
    s1, v1, hs, hv = cfg.s1, cfg.v1, cfg.hs, cfg.hv
    want = [(s1 + v1, hs + hv), (s1, hv), (v1, hv), (hs + hv, hs + hv), (hs, hv), (hv, hv)]
    for i, (w, shp) in enumerate(zip(ws, want)):
        if tuple(w.shape) != shp:
            raise ValueError(f"weight block {i} has shape {tuple(w.shape)}, wants {shp}")
    if loc.dtype != torch.int32 or gtab.dtype != torch.int32:
        raise TypeError("loc and gtab must be int32")
    for name, x in (("d2", d2), ("attr", attr), ("maskf", maskf), *(("weight", w) for w in ws)):
        if x.dtype != h.dtype:
            raise TypeError(f"{name} is {x.dtype}, h is {h.dtype}")


def _layer(xs, xv, s, v, w0, w1s, w1v, hs):
    """One gated L1 TP layer in fp32.  xs [R, S]; xv [R, 3, V]; s [R, 1];
    v [R, 3].  Returns m0 [R, hs], m1 [R, 3, hv]."""
    dot = xv[:, 0] * v[:, 0:1] + xv[:, 1] * v[:, 1:2] + xv[:, 2] * v[:, 2:3]
    f0 = torch.cat([xs * s, CG110 * dot], dim=-1)
    o0 = f0 @ w0
    a = xs @ w1s
    b = (xv * s[:, :, None]) @ w1v  # [R, 3, hv]
    o1 = CG011 * (v[:, :, None] * a[:, None, :] + b)
    m0 = F.silu(o0[:, :hs])
    m1 = o1 * torch.sigmoid(o0[:, hs:])[:, None, :]
    return m0, m1


def fused_message_aggregate_tabled_plain(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                         w0e1, w1o1, w0e2, w1o2):
    """agg [Npad, F] in h's dtype, by PyTorch ops (any device).

    h [Npad, F] cm-layout node features, Npad a multiple of cfg.tile;
    d2/attr/maskf [Npad*K, 1|4|1] edge geometry in h's dtype; loc [Npad*K, 1]
    int32 slot -> table index (pad U); gtab [Npad/tile, U] int32 node ids
    (pad Npad); weights with norms folded in, in the reference row layout.
    """
    ws = _split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws)
    dt = h.dtype
    npad, f = h.shape
    hs, hv, k, u = cfg.hs, cfg.hv, cfg.k, cfg.u
    w0a, w1sa, w1va, w0b, w1sb, w1vb = (w.float() for w in ws)
    hf = h.float()
    # senders through the per-tile table; loc == U selects the zero row
    flat = gtab.long().reshape(-1)
    hu = torch.cat([hf[torch.clamp(flat, max=npad - 1)], hf.new_zeros((1, f))])
    locl = loc.long().reshape(-1)
    tile_of = torch.arange(npad * k, device=h.device) // (cfg.tile * k)
    hs_rows = hu[torch.where(locl < u, tile_of * u + locl, flat.numel())]  # [E, F]
    hr_rows = hf.repeat_interleave(k, dim=0)
    e = npad * k
    s = attr[:, 0:1].float()
    v = attr[:, 1:4].float()
    xs = torch.cat([hs_rows[:, :hs], hr_rows[:, :hs], d2.float()], dim=-1)
    xv = torch.cat([hs_rows[:, hs:].reshape(e, 3, hv), hr_rows[:, hs:].reshape(e, 3, hv)], -1)
    m0, m1 = _layer(xs, xv, s, v, w0a, w1sa, w1va, hs)
    m0, m1 = m0.to(dt).float(), m1.to(dt).float()
    m0, m1 = _layer(m0, m1, s, v, w0b, w1sb, w1vb, hs)
    msg = (torch.cat([m0, m1.reshape(e, 3 * hv)], dim=-1) * maskf.float()).to(dt).float()
    return msg.reshape(npad, k, f).sum(dim=1).to(dt)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_message_aggregate_tabled(cfg: MessageConfig, h, d2, attr, maskf, loc, gtab,
                                   w0e1, w1o1, w0e2, w1o2):
    """agg [Npad, F]: the hand-written CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Arguments as in the plain version."""
    if h.device.type == "cpu":
        return fused_message_aggregate_tabled_plain(cfg, h, d2, attr, maskf, loc, gtab,
                                                    w0e1, w1o1, w0e2, w1o2)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    ws = _split_weights(cfg, w0e1, w1o1, w0e2, w1o2)
    _check_inputs(cfg, h, d2, attr, maskf, loc, gtab, ws)
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {h.dtype}")
    args = (h, d2, attr, maskf, loc, gtab, *ws)
    for x in args:
        if x.device != h.device:
            raise ValueError(f"all inputs must be on {h.device}, found {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    lib = TAB_FWD.lib()
    smem = lib.fused_message_tab_fwd_smem_bytes(cfg.hs, cfg.hv, cfg.k)
    if smem > _MAX_SMEM:
        raise ValueError(f"widths need {smem} bytes of shared memory per block (max {_MAX_SMEM})")
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = lib.fused_message_tab_fwd(
            _DTYPE_CODE[h.dtype], *(x.data_ptr() for x in args), out.data_ptr(),
            h.shape[0], cfg.hs, cfg.hv, cfg.k, cfg.tile, cfg.u, stream)
    if rc != 0:
        raise RuntimeError(f"fused_message_tab_fwd launch failed with CUDA error {rc}")
    TAB_FWD.launches += 1
    return out
