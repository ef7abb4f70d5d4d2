"""Equivariant linear layer and norm over steerable features.

Counterpart of ``scalable_e3_gnn_tpu/ops/linear.py``: ``O3Linear``, per-irrep
multiplicity mixing with a 1/sqrt(mul_in) normalization and an optional bias
on even scalars (the model's output head), and ``O3LayerNorm``, the
norm-based equivariant layer norm (no model uses it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.irreps import Irrep, Irreps
from ..utils.device import resolve_device
from .tensor_product import _c, _matmul_f32

__all__ = ["O3Linear", "O3LayerNorm"]


class O3Linear(nn.Module):
    """Per-irrep multiplicity mixing: out_ir = x_ir @ W_ir / sqrt(mul_in).

    Parameters ``w_<irrep>`` [mul_in, mul_out] (e.g. ``w_0e``, ``w_1o``) and
    ``b_0e`` [mul_out of 0e], named as in the JAX package.
    """

    def __init__(
        self,
        irreps_in: Irreps,
        irreps_out: Irreps,
        bias: bool = True,
        layout_in: str = "mul",
        layout_out: str = "mul",
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.layout_in = layout_in
        self.layout_out = layout_out
        self.irreps_in = Irreps(irreps_in).regroup()
        self.irreps_out = Irreps(irreps_out).regroup()
        self.in_dim = self.irreps_in.dim
        self.out_dim = self.irreps_out.dim
        self.use_bias = bias

        self._maps = []  # (ir, in_slice, mul_in, out_slice, mul_out)
        for mo in self.irreps_out:
            sl_out = self.irreps_out.contiguous_slice_for(mo.ir)
            mul_in = self.irreps_in.mul_for(mo.ir)
            if mul_in > 0:
                sl_in = self.irreps_in.contiguous_slice_for(mo.ir)
                self._maps.append((mo.ir, sl_in, mul_in, sl_out, mo.mul))
        for ir, _, mul_in, _, mul_out in self._maps:
            w = torch.randn((mul_in, mul_out), generator=generator, dtype=torch.float64)
            self.register_parameter(f"w_{ir}", nn.Parameter(w.to(device=device, dtype=dtype)))
        if bias and self.irreps_out.mul_for("0e") > 0:
            b = torch.zeros((self.irreps_out.mul_for("0e"),), device=device, dtype=dtype)
            self.b_0e = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        out = torch.zeros(lead + (self.out_dim,), dtype=x.dtype, device=x.device)
        for ir, sl_in, mul_in, sl_out, mul_out in self._maps:
            d = ir.dim
            w = getattr(self, f"w_{ir}")
            w = w / _c(math.sqrt(mul_in), w.dtype)
            if d == 1 or self.layout_in == "cm":
                blk = x[..., sl_in].reshape(lead + (d, mul_in))
                res = _matmul_f32(blk, w).to(x.dtype)  # [..., d, mul_out]
            else:
                blk = x[..., sl_in].reshape(lead + (mul_in, d))
                res = _matmul_f32(blk.transpose(-1, -2), w).to(x.dtype)
            if ir == Irrep(0, 1) and hasattr(self, "b_0e"):
                res = res + self.b_0e.to(x.dtype)
            if d > 1 and self.layout_out == "mul":
                res = res.transpose(-1, -2)
            out[..., sl_out] = res.reshape(lead + (mul_out * d,))
        return out


class O3LayerNorm(nn.Module):
    """Norm-based equivariant layer norm: the scalars (l=0) of each irrep
    group normalized by their mean and variance over the group's channels;
    an l>0 group divided by the RMS of its copies' vector norms (no mean
    removed, which would break equivariance); then a gain per copy,
    ``g_<irrep>`` [mul] (ones at init, as the JAX ``init``)."""

    def __init__(self, irreps: Irreps, eps: float = 1e-6, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        device = resolve_device(device)
        self.irreps = Irreps(irreps).regroup()
        self.eps = eps
        for mi in self.irreps:
            self.register_parameter(
                f"g_{mi.ir}", nn.Parameter(torch.ones((mi.mul,), device=device, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        outs = []
        for mi, sl in zip(self.irreps, self.irreps.slices()):
            blk = x[..., sl].reshape(lead + (mi.mul, mi.ir.dim))
            g = getattr(self, f"g_{mi.ir}")
            if mi.ir.l == 0:
                mu = torch.mean(blk, dim=-2, keepdim=True)
                var = torch.mean((blk - mu) ** 2, dim=-2, keepdim=True)
                blk = (blk - mu) / torch.sqrt(var + self.eps)
            else:
                norms2 = torch.sum(blk * blk, dim=-1)  # [..., mul]
                rms = torch.sqrt(torch.mean(norms2, dim=-1, keepdim=True) + self.eps)
                blk = blk / rms[..., None]
            blk = blk * g[..., :, None]
            outs.append(blk.reshape(lead + (mi.dim,)))
        return torch.cat(outs, dim=-1)
