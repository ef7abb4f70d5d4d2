"""Gate nonlinearity for steerable features.

Counterpart of ``scalable_e3_gnn_tpu/ops/gate.py::Gate.__call__``.  Input
layout ``scalars || gates || gated``: scalars pass through ``act_scalars``, one
l=0 gate per non-scalar irrep copy is squashed by ``act_gates`` and multiplies
its copy channelwise.  ``fast_tables``/``fast_apply`` are the selection form
the generic fused message kernel uses on column-permuted TP outputs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.irreps import Irreps

__all__ = ["Gate"]


class Gate(nn.Module):
    """scalars -> act(scalars); gated -> act(gates) * gated.

    ``irreps_in = irreps_scalars + num_gated x 0e + irreps_gated``;
    ``irreps_out = irreps_scalars + irreps_gated``.
    """

    def __init__(
        self,
        irreps_scalars: Irreps,
        irreps_gated: Irreps,
        act_scalars: Callable = F.silu,
        act_gates: Callable = torch.sigmoid,
        layout: str = "mul",
    ) -> None:
        super().__init__()
        self.layout = layout
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gated = Irreps(irreps_gated)
        if any(mi.ir.l == 0 for mi in self.irreps_gated):
            raise ValueError("irreps_gated must contain only l > 0 irreps")
        if any(mi.ir.l != 0 for mi in self.irreps_scalars):
            raise ValueError("irreps_scalars must contain only l == 0 irreps")
        self.num_gates = self.irreps_gated.num_irreps
        self.irreps_in = self.irreps_scalars + Irreps([(self.num_gates, "0e")]) + self.irreps_gated
        self.irreps_out = self.irreps_scalars + self.irreps_gated
        self.act_scalars = act_scalars
        self.act_gates = act_gates
        self._ns = self.irreps_scalars.dim
        self._gated_shapes = [(mi.mul, mi.ir.dim) for mi in self.irreps_gated]

    def fast_tables(self):
        """(perm, psel, dk) of the selection-form gate.

        Permute the upstream TP's output columns to ``scalars || gated ||
        gates`` (``perm`` indexes the unpermuted ``scalars || gates ||
        gated`` columns), then ``out = y[:, :dk] * (sigmoid(y) @ psel)``.
        ``psel`` [irreps_in.dim, dk] is identity on the scalars, replicates
        gate g to its gated component lanes and is zero on the gated rows,
        so every column holds exactly one 1.  Valid when ``act_scalars`` is
        silu (x * sigmoid(x)) and ``act_gates`` is sigmoid, in 'cm' layout.
        """
        ns, ng = self._ns, self.num_gates
        d_in = self.irreps_in.dim
        dk = self.irreps_out.dim
        perm = list(range(ns)) + list(range(ns + ng, d_in)) + list(range(ns, ns + ng))
        psel = np.zeros((d_in, dk), np.float32)
        for j in range(ns):
            psel[j, j] = 1.0
        col, gi = ns, 0
        for mul, d in self._gated_shapes:
            for _comp in range(d):
                for m in range(mul):
                    psel[dk + gi + m, col] = 1.0
                    col += 1
            gi += mul
        assert col == dk, (col, dk)
        return np.asarray(perm, np.int32), psel, dk

    @staticmethod
    def fast_select(psel) -> torch.Tensor:
        """The row of the single 1 in each column of ``psel``: the sigmoid
        lane that multiplies each output lane (int64 [dk])."""
        return torch.as_tensor(np.asarray(psel)).argmax(dim=0)

    def fast_apply(self, y: torch.Tensor, psel, dk: int) -> torch.Tensor:
        """The selection-form gate on permuted pre-gate features (see
        ``fast_tables``): sigmoid in fp32 cast to y's dtype, each output lane
        times its selected multiplier in y's dtype.  ``psel`` has one 1 per
        column, so the selection is a lookup, bitwise equal to the product
        with ``psel``."""
        sg = torch.sigmoid(y.float()).to(y.dtype)
        sel = self.fast_select(psel).to(y.device)
        return y[..., :dk] * sg[..., sel]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ns, ng = self._ns, self.num_gates
        dt = x.dtype
        scalars = x[..., :ns]
        gates = x[..., ns : ns + ng]
        gated = x[..., ns + ng :]
        # activations in fp32, cast back to the data dtype
        out = [self.act_scalars(scalars.float()).to(dt)] if ns else []
        if ng:
            g = self.act_gates(gates.float()).to(dt)
            gi = off = 0
            for mul, d in self._gated_shapes:
                blk = gated[..., off : off + mul * d]
                if self.layout == "cm":
                    # component-major: the gate repeats once per component
                    out.append(blk * torch.cat([g[..., gi : gi + mul]] * d, dim=-1))
                else:
                    blk = blk.reshape(x.shape[:-1] + (mul, d)) * g[..., gi : gi + mul, None]
                    out.append(blk.reshape(x.shape[:-1] + (mul * d,)))
                gi += mul
                off += mul * d
        return torch.cat(out, dim=-1)
