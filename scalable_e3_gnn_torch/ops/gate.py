"""Gate nonlinearity for steerable features.

Counterpart of ``scalable_e3_gnn_tpu/ops/gate.py::Gate.__call__``.  Input
layout ``scalars || gates || gated``: scalars pass through ``act_scalars``, one
l=0 gate per non-scalar irrep copy is squashed by ``act_gates`` and multiplies
its copy channelwise.  ``fast_tables``/``fast_apply`` are the selection form
the generic fused message kernel uses on column-permuted TP outputs.

``ACTIVATIONS`` lists the scalar activations the generic kernels take (the
``act=`` of ``SEGNN``): each torch callable with its code (the CUDA sources'
``GENERIC_ACT``) and the cotangent that JAX's AD gives its JAX counterpart.
Adding one means an entry here and one in ``csrc/gate_act.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.irreps import Irreps

__all__ = ["Gate", "Activation", "ACTIVATIONS", "activation", "gelu_tanh", "softplus"]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` as JAX defaults it (``approximate=True``): x/2 (1 +
    tanh(sqrt(2/pi) (x + 0.044715 x^3))); not ``F.gelu``'s default erf form."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, JAX's ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) (``F.softplus`` returns x past its threshold of 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# The cotangents below follow JAX's AD of its own function, operation by
# operation, on fp32 x and the fp32 cotangent g.

def _tanh_vjp(x, g):
    # tanh's JVP (g + g t)(1 - t), transposed: c = g (1 - t), c + c t
    t = torch.tanh(x)
    c = g * (1.0 - t)
    return c + c * t


_GELU_S = float(np.float32(np.sqrt(2.0 / np.pi)))


def _gelu_tanh_vjp(x, g):
    # x * cdf, cdf = 0.5 (1 + tanh(s (x + 0.044715 x^3))), transposed from
    # the output back: the product's two branches, tanh's as above, the
    # cubic's 3 x^2
    t = torch.tanh(_GELU_S * (x + 0.044715 * (x * x * x)))
    q = 0.5 * (x * g) * (1.0 - t)
    du = _GELU_S * (q + q * t)
    return g * (0.5 * (1.0 + t)) + du + (0.044715 * du) * (3.0 * (x * x))


def _relu_vjp(x, g):
    # jax.nn.relu's custom JVP: g where x > 0, else 0 (0 at 0)
    return torch.where(x > 0, g, torch.zeros_like(g))


def _softplus_vjp(x, g):
    # logaddexp's custom JVP: g exp(x - logaddexp(x, 0))
    return g * torch.exp(x - softplus(x))


@dataclass(frozen=True)
class Activation:
    """A scalar activation of the generic kernels' gate: its name, its code
    (``GENERIC_ACT`` of the CUDA sources), the torch callable ``SEGNN(act=)``
    takes, and ``vjp(x, g)``, JAX's AD cotangent in fp32 (None for silu,
    whose gate keeps the selection form, ``Gate.fast_apply``)."""
    name: str
    code: int
    fn: Callable
    vjp: Optional[Callable]


ACTIVATIONS = (
    Activation("silu", 0, F.silu, None),
    Activation("tanh", 1, torch.tanh, _tanh_vjp),
    Activation("gelu_tanh", 2, gelu_tanh, _gelu_tanh_vjp),
    Activation("relu", 3, torch.relu, _relu_vjp),
    Activation("softplus", 4, softplus, _softplus_vjp),
)
assert all(act.code == i for i, act in enumerate(ACTIVATIONS))  # ACTIVATIONS[code]


def activation(fn) -> Activation:
    """The table's entry of a torch callable, by identity.  Raises
    ``ValueError`` naming the set for any other callable."""
    for act in ACTIVATIONS:
        if fn is act.fn:
            return act
    names = ", ".join(f"{a.name} ({a.fn.__module__}.{a.fn.__name__})" for a in ACTIVATIONS)
    raise ValueError(f"the generic kernels take the activations {names}, not {fn!r}")


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
