"""The lmax=1 Clebsch-Gordan tensor product (second operand = sh(1)).

Counterpart of ``scalable_e3_gnn_tpu/ops/tensor_product.py::L1TensorProduct``:
the same weight layouts, path concat order, normalization constants (including
the reference's Q1 fan-in overcount) and 'mul' / 'cm' feature layouts, so the
JAX parameters load unchanged and activations agree to fp32 tolerance.  The
generic any-lmax ``TensorProduct`` comes with the lmax=2 slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.irreps import Instruction, Irreps
from ..utils.device import resolve_device

__all__ = ["L1TensorProduct", "CG110", "CG011", "CG111"]

CG110 = 1.0 / math.sqrt(3.0)  # l1.l1 -> l0 dot
CG011 = 1.0 / math.sqrt(3.0)  # l0.l1 -> l1 scale
CG111 = 1.0 / math.sqrt(6.0)  # l1 x l1 -> l1 cross


def _block_groups(irreps: Irreps) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
    """Per-(l, p) list of (flat_start, mul) groups in spec order."""
    out: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    i = 0
    for mi in irreps:
        out.setdefault((mi.ir.l, mi.ir.p), []).append((i, mi.mul))
        i += mi.dim
    return out


def _extract_scalars(x, groups):
    if not groups:
        return x[..., :0]
    return torch.cat([x[..., st : st + m] for st, m in groups], dim=-1)


def _extract_vectors(x, groups, layout):
    """-> [..., 3, M] component-major block, concatenated per group.

    'mul' stores each group [m, 3] row-major (e3nn convention); 'cm' stores
    each group [3, m] row-major: component-major per irrep GROUP, not over
    the whole feature vector.
    """
    lead = x.shape[:-1]
    parts = []
    for st, m in groups:
        blk = x[..., st : st + 3 * m]
        if layout == "mul":
            blk = blk.reshape(lead + (m, 3)).transpose(-1, -2)
        else:
            blk = blk.reshape(lead + (3, m))
        parts.append(blk)
    if not parts:
        return x[..., :0].reshape(lead + (3, 0))
    return torch.cat(parts, dim=-1)


def _cross_cm(a, b):
    """a [..., 3, M] x b [..., 3, 1] -> [..., 3, M] (cyclic in the (y,z,x) basis)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2)


def _dot_cm(a, b):
    """Channelwise dot: a [..., 3, M], b [..., 3, 1] -> [..., M]."""
    return a[..., 0, :] * b[..., 0, :] + a[..., 1, :] * b[..., 1, :] + a[..., 2, :] * b[..., 2, :]


def _matmul_f32(f, w):
    """f @ w with fp32 products and accumulation, whatever the storage dtype."""
    return torch.matmul(f.float(), w.float())


class L1TensorProduct(nn.Module):
    """Weighted CG tensor product, in1/out lmax=1, in2 = sh(1) = ``1x0e+1x1o``.

    Parameters ``w_l0e``, ``w_l0o``, ``w_l1e``, ``w_l1o`` (those with a
    contributing path) have the JAX shapes: rows = path features in forward
    concat order, columns = output multiplicities.  Only
    ``irrep_normalization="component"`` with ``path_normalization`` in
    {"element", "none"} is supported, as in the JAX package.
    """

    def __init__(
        self,
        in1_irreps: Irreps,
        out_irreps: Optional[Irreps] = None,
        irrep_normalization: str = "component",
        path_normalization: str = "element",
        in1_var: Optional[List[float]] = None,
        in2_var: Optional[List[float]] = None,
        out_var: Optional[List[float]] = None,
        layout_in1: str = "mul",
        layout_out: str = "mul",
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        if layout_in1 not in ("mul", "cm") or layout_out not in ("mul", "cm"):
            raise ValueError("layouts must be 'mul' or 'cm'")
        self.layout_in1 = layout_in1
        self.layout_out = layout_out
        in1_irreps = Irreps(in1_irreps)
        out_irreps = Irreps(out_irreps) if out_irreps is not None else in1_irreps
        if in1_irreps.lmax > 1 or out_irreps.lmax > 1:
            raise ValueError("L1TensorProduct requires lmax == 1 for in1 and out")
        if irrep_normalization != "component" or path_normalization not in ("element", "none"):
            raise ValueError(
                "only irrep_normalization='component' with path_normalization in "
                "{'element','none'} is supported"
            )
        self.irreps_in1 = in1_irreps
        self.irreps_in2 = Irreps.spherical_harmonics(1)
        self.irreps_out = out_irreps
        self.in1_dim = in1_irreps.dim
        self.in2_dim = 4
        self.out_dim = out_irreps.dim

        self._g1 = _block_groups(in1_irreps)
        self._go = _block_groups(out_irreps)
        nmul = lambda g, k: sum(m for _, m in g.get(k, []))
        self.num_i1_l0e = nmul(self._g1, (0, 1))
        self.num_i1_l0o = nmul(self._g1, (0, -1))
        self.num_i1_l1e = nmul(self._g1, (1, 1))
        self.num_i1_l1o = nmul(self._g1, (1, -1))
        self.dim_o_l0e = nmul(self._go, (0, 1))
        self.dim_o_l0o = nmul(self._go, (0, -1))
        self.dim_o_l1e = 3 * nmul(self._go, (1, 1))
        self.dim_o_l1o = 3 * nmul(self._go, (1, -1))

        w_shapes = {}
        if (self.num_i1_l0e + self.num_i1_l1o) > 0 and self.dim_o_l0e > 0:
            w_shapes["w_l0e"] = (self.num_i1_l0e + self.num_i1_l1o, self.dim_o_l0e)
        if (self.num_i1_l0o + self.num_i1_l1e) > 0 and self.dim_o_l0o > 0:
            w_shapes["w_l0o"] = (self.num_i1_l0o + self.num_i1_l1e, self.dim_o_l0o)
        if (self.num_i1_l0o + self.num_i1_l1e + self.num_i1_l1o) > 0 and self.dim_o_l1e > 0:
            w_shapes["w_l1e"] = (
                self.num_i1_l0o + self.num_i1_l1e + self.num_i1_l1o, self.dim_o_l1e // 3,
            )
        if (self.num_i1_l0e + self.num_i1_l1o + self.num_i1_l1e) > 0 and self.dim_o_l1o > 0:
            w_shapes["w_l1o"] = (
                self.num_i1_l0e + self.num_i1_l1o + self.num_i1_l1e, self.dim_o_l1o // 3,
            )

        # normalization constants + instruction list, including the Q1 fan-in
        # enumeration (parity binds only to the l_out == 1 branch)
        n1 = len(in1_irreps)
        in1_var = [1.0] * n1 if in1_var is None else [float(v) for v in in1_var]
        if len(in1_var) != n1:
            raise ValueError("len(in1_var) must equal len(in1_irreps)")
        in2_var = [1.0, 1.0] if in2_var is None else [float(v) for v in in2_var]
        if len(in2_var) != len(self.irreps_in2):
            raise ValueError("len(in2_var) must equal len(in2_irreps)")
        out_var_ = [1.0] * len(out_irreps) if out_var is None else [float(v) for v in out_var]
        if len(out_var_) != len(out_irreps):
            raise ValueError("len(out_var) must equal len(out_irreps)")

        self.path_normalization = path_normalization
        self.instructions: List[Instruction] = []
        norm = {
            "l0e": np.zeros(self.dim_o_l0e),
            "l0o": np.zeros(self.dim_o_l0o),
            "l1e": np.zeros(self.dim_o_l1e),
            "l1o": np.zeros(self.dim_o_l1o),
        }
        wi_cols = {k: np.ones(s[1]) for k, s in w_shapes.items()}
        offs = {"l0e": 0, "l0o": 0, "l1e": 0, "l1o": 0}
        col_offs = {"l0e": 0, "l0o": 0, "l1e": 0, "l1o": 0}
        for io_idx, mir_out in enumerate(out_irreps):
            alpha = mir_out.ir.dim * out_var_[io_idx]
            x = 0.0
            ins_this_out = []
            for ii2, mir_in2 in enumerate(self.irreps_in2):
                for ii1, mir_in1 in enumerate(in1_irreps):
                    lo, l1_, l2 = mir_out.ir.l, mir_in1.ir.l, mir_in2.ir.l
                    po, p1, p2 = mir_out.ir.p, mir_in1.ir.p, mir_in2.ir.p
                    if (lo == 0 and l2 == l1_) or ((lo == 1 and (l2 | l1_) != 0) and po == p2 * p1):
                        x += in1_var[ii1] * in2_var[ii2] * mir_in1.mul * mir_in2.mul
                        ins_this_out.append(
                            Instruction(ii1, ii2, io_idx, "uvw", True, alpha,
                                        (mir_in1.mul, mir_in2.mul, mir_out.mul))
                        )
            if path_normalization == "none":
                a = math.sqrt(alpha)
                wi = 1.0 / math.sqrt(x) if x > 0 else 1.0
            else:  # element
                a = math.sqrt(alpha / x) if x > 0 else math.sqrt(alpha)
                wi = 1.0
            self.instructions.extend(ins._replace(path_weight=a) for ins in ins_this_out)
            key = f"l{mir_out.ir.l}{'e' if mir_out.ir.p == 1 else 'o'}"
            norm[key][offs[key] : offs[key] + mir_out.dim] = a
            offs[key] += mir_out.dim
            wkey = "w_" + key
            if wkey in wi_cols:
                wi_cols[wkey][col_offs[key] : col_offs[key] + mir_out.mul] = wi
            col_offs[key] += mir_out.mul

        # numpy float64 constants, cast to the data dtype at use (as JAX does)
        self._norm = norm
        self._norm_mul = {
            k: (norm[k].reshape(-1, 3)[:, 0] if norm[k].size else norm[k])
            for k in ("l1e", "l1o")
        }
        self._wi_cols = wi_cols
        self._w_shapes = w_shapes

        # uniform[-wi, wi] per output column (sorted names, as JAX's init)
        for name in sorted(w_shapes):
            u = torch.rand(w_shapes[name], generator=generator, dtype=torch.float64) * 2 - 1
            w = u * torch.as_tensor(wi_cols[name])
            self.register_parameter(name, nn.Parameter(w.to(dtype=dtype, device=device)))

    def param_shapes(self) -> Dict[str, Tuple[int, int]]:
        return dict(self._w_shapes)

    def _const(self, a, like):
        # JAX casts each norm constant to the data dtype before multiplying
        return torch.as_tensor(a, device=like.device).to(like.dtype).float()

    def forward(self, in1: torch.Tensor, in2: torch.Tensor) -> torch.Tensor:
        """out[..., out_dim] = norm * blockwise GEMMs; any leading batch dims."""
        if in1.shape[-1] != self.in1_dim:
            raise ValueError(f"in1 last dim {in1.shape[-1]} != {self.in1_dim}")
        if in2.shape[-1] != self.in2_dim:
            raise ValueError(f"in2 last dim {in2.shape[-1]} != {self.in2_dim}")
        dt = in1.dtype
        lead = in1.shape[:-1]
        lay = self.layout_in1
        x0e = _extract_scalars(in1, self._g1.get((0, 1), []))
        x0o = _extract_scalars(in1, self._g1.get((0, -1), []))
        x1e = _extract_vectors(in1, self._g1.get((1, 1), []), lay)  # [..., 3, M]
        x1o = _extract_vectors(in1, self._g1.get((1, -1), []), lay)
        s = in2[..., 0:1]
        v = in2[..., 1:4].unsqueeze(-1)  # [..., 3, 1]

        blocks = {}
        if self.dim_o_l0e > 0:
            feats = [x0e * s]
            if self.num_i1_l1o > 0:
                feats.append(CG110 * _dot_cm(x1o, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l0e)
            blocks[(0, 1)] = (res * self._const(self._norm["l0e"], in1)).to(dt)
        if self.dim_o_l0o > 0:
            feats = [x0o * s]
            if self.num_i1_l1e > 0:
                feats.append(CG110 * _dot_cm(x1e, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l0o)
            blocks[(0, -1)] = (res * self._const(self._norm["l0o"], in1)).to(dt)
        if self.dim_o_l1e > 0:
            feats = [CG011 * x0o.unsqueeze(-2) * v]  # [..., 3, n0o]
            if self.num_i1_l1e > 0:
                feats.append(CG011 * x1e * s.unsqueeze(-1))
            if self.num_i1_l1o > 0:
                feats.append(CG111 * _cross_cm(x1o, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l1e)  # [..., 3, m]
            blocks[(1, 1)] = (res * self._const(self._norm_mul["l1e"], in1)).to(dt)
        if self.dim_o_l1o > 0:
            feats = [CG011 * x0e.unsqueeze(-2) * v]
            if self.num_i1_l1o > 0:
                feats.append(CG011 * x1o * s.unsqueeze(-1))
            if self.num_i1_l1e > 0:
                feats.append(CG111 * _cross_cm(x1e, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l1o)
            blocks[(1, -1)] = (res * self._const(self._norm_mul["l1o"], in1)).to(dt)

        # assemble the flat output in spec order
        taken: Dict[Tuple[int, int], int] = {}
        pieces = []
        for mi in self.irreps_out:
            key = (mi.ir.l, mi.ir.p)
            t = taken.get(key, 0)
            if key not in blocks:  # no contributing path
                pieces.append(torch.zeros(lead + (mi.dim,), dtype=dt, device=in1.device))
                continue
            if mi.ir.l == 0:
                pieces.append(blocks[key][..., t : t + mi.mul])
            else:
                blk = blocks[key][..., :, t : t + mi.mul]  # [..., 3, m]
                if self.layout_out == "mul":
                    blk = blk.transpose(-1, -2)
                pieces.append(blk.reshape(lead + (3 * mi.mul,)))
            taken[key] = t + mi.mul
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
