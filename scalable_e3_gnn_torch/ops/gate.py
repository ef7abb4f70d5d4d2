"""Gate nonlinearity for steerable features.

Counterpart of ``scalable_e3_gnn_tpu/ops/gate.py::Gate.__call__``.  Input
layout ``scalars || gates || gated``: scalars pass through ``act_scalars``, one
l=0 gate per non-scalar irrep copy is squashed by ``act_gates`` and multiplies
its copy channelwise.  The matmul-form gate used inside the generic kernel
(``fast_tables``/``fast_apply``) comes with that kernel's slice.
"""

from __future__ import annotations

from typing import Callable

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
