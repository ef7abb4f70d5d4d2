"""Clebsch-Gordan tensor products.

Counterparts of ``scalable_e3_gnn_tpu/ops/tensor_product.py``:

- ``L1TensorProduct``: lmax=1, second operand sh(1).  The same weight
  layouts, path concat order, normalization constants (including the
  reference's Q1 fan-in overcount) and 'mul' / 'cm' feature layouts.
- ``TensorProduct``: the generic fully-connected ('uvw') product for any
  lmax, from the real-basis ``wigner_3j`` tensors, evaluated either
  component-wise (sparse CG) or as C2 narrow GEMMs on the CG-folded weight
  matrix (``fold_params``).

Both take the JAX parameters unchanged and agree with the JAX modules to fp32
tolerance.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.irreps import Instruction, Irreps
from ..core.wigner import wigner_3j
from ..utils.device import resolve_device

__all__ = ["L1TensorProduct", "TensorProduct", "CG110", "CG011", "CG111"]

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


@functools.lru_cache(maxsize=None)
def _c(value: float, dtype) -> torch.Tensor:
    """A constant in the data dtype, as JAX converts a Python float that
    multiplies an array: bf16 data is scaled by the bf16-rounded constant.
    One 0-dim CPU tensor per (value, dtype), made once and never written."""
    return torch.tensor(value, dtype=dtype)


class _MatmulF32(torch.autograd.Function):
    """``f.float() @ w.float()`` ([..., P] x [P, M]) whose backward keeps f
    and w as given: autograd of the casts would keep their fp32 copies,
    twice the bytes of bf16 operands (the update layers' features at 10M
    points).  The gradients are autograd's own: the cotangent times the
    other operand's fp32 copy (its transpose), cast to each operand's dtype."""

    @staticmethod
    def forward(ctx, f, w):
        ctx.save_for_backward(f, w)
        return torch.matmul(f.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        f, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        d_f = d_w = None
        if ctx.needs_input_grad[0]:
            d_f = g2.mm(w.float().t()).reshape(f.shape).to(f.dtype)
        if ctx.needs_input_grad[1]:
            d_w = f.float().reshape(-1, f.shape[-1]).t().mm(g2).to(w.dtype)
        return d_f, d_w


def _matmul_f32(f, w):
    """f @ w with fp32 products and accumulation, whatever the storage dtype."""
    return _MatmulF32.apply(f, w)


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
                feats.append(_c(CG110, dt) * _dot_cm(x1o, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l0e)
            blocks[(0, 1)] = (res * self._const(self._norm["l0e"], in1)).to(dt)
        if self.dim_o_l0o > 0:
            feats = [x0o * s]
            if self.num_i1_l1e > 0:
                feats.append(_c(CG110, dt) * _dot_cm(x1e, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l0o)
            blocks[(0, -1)] = (res * self._const(self._norm["l0o"], in1)).to(dt)
        if self.dim_o_l1e > 0:
            feats = [_c(CG011, dt) * x0o.unsqueeze(-2) * v]  # [..., 3, n0o]
            if self.num_i1_l1e > 0:
                feats.append(_c(CG011, dt) * x1e * s.unsqueeze(-1))
            if self.num_i1_l1o > 0:
                feats.append(_c(CG111, dt) * _cross_cm(x1o, v))
            res = _matmul_f32(torch.cat(feats, dim=-1), self.w_l1e)  # [..., 3, m]
            blocks[(1, 1)] = (res * self._const(self._norm_mul["l1e"], in1)).to(dt)
        if self.dim_o_l1o > 0:
            feats = [_c(CG011, dt) * x0e.unsqueeze(-2) * v]
            if self.num_i1_l1o > 0:
                feats.append(_c(CG011, dt) * x1o * s.unsqueeze(-1))
            if self.num_i1_l1e > 0:
                feats.append(_c(CG111, dt) * _cross_cm(x1e, v))
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


class TensorProduct(nn.Module):
    """Generic fully-connected ('uvw') weighted CG tensor product, any lmax.

    A path (i1, i2) -> io exists iff ``ir_out`` is in ``ir_in1 * ir_in2``::

        out_io = norm_io * sum_paths einsum('ui,vj,ijk->uvk', x1, x2, C) @ W_io

    with ``norm_io = sqrt((2 l_out + 1) / fan_in)`` (component/element
    normalization).  Parameters ``w{io}`` [sum over paths of mul1*mul2,
    mul_out] have the JAX names and shapes and are drawn standard normal, as
    the JAX ``init`` draws them.

    ``mode``: 'auto' evaluates through the CG-folded weight matrix
    (``fold_params``) as C2 narrow GEMMs when in1 is 'cm' and in2 is narrow
    (at most 32 wide), else component-wise over the sparse CG entries;
    'sparse' and 'gemm' force one of the two.
    """

    def __init__(
        self,
        irreps_in1: Irreps,
        irreps_in2: Irreps,
        irreps_out: Irreps,
        irrep_normalization: str = "component",
        path_normalization: str = "element",
        layout_in1: str = "mul",
        layout_out: str = "mul",
        mode: str = "auto",
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        if mode not in ("auto", "sparse", "gemm"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "gemm" and layout_in1 != "cm":
            # the fold plan indexes in1 by its flat cm position
            raise ValueError("mode='gemm' requires layout_in1='cm'")
        if layout_in1 not in ("mul", "cm") or layout_out not in ("mul", "cm"):
            raise ValueError("layouts must be 'mul' or 'cm'")
        if irrep_normalization != "component" or path_normalization != "element":
            raise ValueError("only component/element normalization implemented")
        self.mode = mode
        self.layout_in1 = layout_in1
        self.layout_out = layout_out
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.in1_dim = self.irreps_in1.dim
        self.in2_dim = self.irreps_in2.dim
        self.out_dim = self.irreps_out.dim

        sl1 = self.irreps_in1.slices()
        sl2 = self.irreps_in2.slices()
        self.instructions: List[Instruction] = []
        # per output group: list of (sl1, mul1, l1, sl2, mul2, l2, cg) paths
        self._paths: List[List[tuple]] = [[] for _ in self.irreps_out]
        self._norm: List[float] = []
        self._w_shapes: Dict[str, Tuple[int, int]] = {}
        for io, mo in enumerate(self.irreps_out):
            fan_in = 0
            ins_this_out = []
            for i2, m2 in enumerate(self.irreps_in2):
                for i1, m1 in enumerate(self.irreps_in1):
                    if mo.ir in list(m1.ir * m2.ir):
                        cg = wigner_3j(m1.ir.l, m2.ir.l, mo.ir.l)
                        self._paths[io].append(
                            (sl1[i1], m1.mul, m1.ir.l, sl2[i2], m2.mul, m2.ir.l, cg))
                        fan_in += m1.mul * m2.mul
                        ins_this_out.append(Instruction(i1, i2, io, "uvw", True, 0.0,
                                                        (m1.mul, m2.mul, mo.mul)))
            a = math.sqrt(mo.ir.dim / fan_in) if fan_in > 0 else 0.0
            self.instructions.extend(i._replace(path_weight=a) for i in ins_this_out)
            self._norm.append(a)
            if fan_in > 0 and mo.mul > 0:
                self._w_shapes[f"w{io}"] = (fan_in, mo.mul)

        self._build_gemm_plan()
        self._fold_cache: Dict[str, dict] = {}
        for name in sorted(self._w_shapes):
            w = torch.randn(self._w_shapes[name], generator=generator, dtype=torch.float64)
            self.register_parameter(name, nn.Parameter(w.to(dtype=dtype, device=device)))

    def param_shapes(self) -> Dict[str, Tuple[int, int]]:
        return dict(self._w_shapes)

    def _build_gemm_plan(self) -> None:
        """The index plan of the CG-folded weight matrix.

        The product is ``out = z @ W'`` with ``z = outer(in1, in2)`` (rows
        c2-major: ``zrow = c2 * C1 + c1``) and ``W'`` [C2*C1, out_dim] holding
        every CG coefficient and norm constant times a path weight.  Per
        parameter ``w{io}`` the plan is three flat arrays: the positions in
        ``W'`` (flattened), the positions in ``w{io}`` (flattened) and the fp32
        coefficients, one entry per nonzero of ``W'``."""
        C1, C2 = self.in1_dim, self.in2_dim
        self._gemm_z = C1 * C2
        off, self._out_cm_off = 0, []
        for mo in self.irreps_out:
            self._out_cm_off.append(off)
            off += mo.dim
        self._fold_plan: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for io, mo in enumerate(self.irreps_out):
            name = f"w{io}"
            if name not in self._w_shapes:
                continue
            mul = mo.mul
            tgt, src, coef = [], [], []
            pathrow = 0
            for sl_1, mul1, l1, sl_2, mul2, l2, cg in self._paths[io]:
                d2 = 2 * l2 + 1
                u = np.arange(mul1)[:, None]
                v = np.arange(mul2)[None, :]
                for k in range(mo.ir.dim):
                    cols = self._out_cm_off[io] + k * mul + np.arange(mul)
                    for i, j in zip(*np.nonzero(cg[:, :, k])):
                        c1 = sl_1.start + int(i) * mul1 + u  # [mul1, 1]
                        c2 = sl_2.start + v * d2 + int(j)  # [1, mul2]
                        zr = (c2 * C1 + c1).reshape(-1)
                        wr = (u * mul2 + v).reshape(-1) + pathrow
                        tgt.append((zr[:, None] * self.out_dim + cols[None, :]).reshape(-1))
                        src.append((wr[:, None] * mul + np.arange(mul)[None, :]).reshape(-1))
                        co = np.float32(float(cg[i, j, k]) * self._norm[io])
                        coef.append(np.full(zr.size * mul, co, np.float32))
                pathrow += mul1 * mul2
            self._fold_plan[name] = tuple(np.concatenate(x) for x in (tgt, src, coef))

    def _gemm_default(self) -> bool:
        if self.mode == "sparse":
            return False
        if self.mode == "gemm":
            return True
        return self.layout_in1 == "cm" and self.in2_dim <= 32

    def fold_nonzeros(self) -> int:
        """The entries of ``W'`` that ``fold_params`` can make nonzero."""
        return sum(len(tgt) for tgt, _, _ in self._fold_plan.values())

    def fold_params(self) -> torch.Tensor:
        """The CG-folded weight matrix ``W'`` [C2*C1, out_dim] in fp32, columns
        in cm layout.  Linear in the parameters, so gradients flow through it;
        no entry of ``W'`` gets two terms, so the sum order is irrelevant."""
        dev = next(iter(self.parameters()), torch.empty(0)).device
        key = str(dev)
        if key not in self._fold_cache:
            self._fold_cache[key] = {
                name: tuple(torch.as_tensor(x, device=dev) for x in plan)
                for name, plan in self._fold_plan.items()}
        wf = torch.zeros(self._gemm_z * self.out_dim, dtype=torch.float32, device=dev)
        for name, (tgt, src, coef) in self._fold_cache[key].items():
            w = getattr(self, name).float().reshape(-1)
            wf = wf.index_add(0, tgt, coef * w[src])
        return wf.view(self._gemm_z, self.out_dim)

    def _call_gemm(self, wf: torch.Tensor, in1: torch.Tensor, in2: torch.Tensor) -> torch.Tensor:
        """``outer(in1, in2) @ W'`` as ``sum_c (in1 * in2_c) @ W'_c``: C2 narrow
        GEMMs, fp32 products and accumulation, the weights cast to the data
        dtype first and the sum cast back at the end (as the JAX package)."""
        lead = in1.shape[:-1]
        dt = in1.dtype
        C1, C2 = self.in1_dim, self.in2_dim
        wt = wf.to(dt)
        acc = None
        for c in range(C2):
            t = _matmul_f32(in1 * in2[..., c : c + 1], wt[c * C1 : (c + 1) * C1])
            acc = t if acc is None else acc + t
        out = acc.to(dt)
        if self.layout_out == "cm":
            return out
        parts = []
        for io, mo in enumerate(self.irreps_out):
            blk = out[..., self._out_cm_off[io] : self._out_cm_off[io] + mo.dim]
            if mo.ir.dim > 1:
                blk = blk.reshape(lead + (mo.ir.dim, mo.mul)).transpose(-1, -2)
                blk = blk.reshape(lead + (mo.dim,))
            parts.append(blk)
        return torch.cat(parts, dim=-1)

    def forward(self, in1: torch.Tensor, in2: torch.Tensor) -> torch.Tensor:
        if in1.shape[-1] != self.in1_dim:
            raise ValueError(f"in1 last dim {in1.shape[-1]} != {self.in1_dim}")
        if in2.shape[-1] != self.in2_dim:
            raise ValueError(f"in2 last dim {in2.shape[-1]} != {self.in2_dim}")
        if self._gemm_default():
            return self._call_gemm(self.fold_params(), in1, in2)
        return self._forward_sparse(in1, in2)

    def _forward_sparse(self, in1: torch.Tensor, in2: torch.Tensor) -> torch.Tensor:
        """Component-wise evaluation over the sparse CG entries: per output
        component k the path features are [..., mul] products, then one
        [..., P] x [P, w] GEMM (fp32) per component."""
        lead = in1.shape[:-1]
        dt = in1.dtype

        def comp1(sl, mul, l, i):
            """in1 component i of a group as [..., mul] (layout-aware)."""
            if self.layout_in1 == "cm":
                return in1[..., sl.start + i * mul : sl.start + (i + 1) * mul]
            return in1[..., sl].reshape(lead + (mul, 2 * l + 1))[..., :, i]

        out_parts = []
        for io, mo in enumerate(self.irreps_out):
            name = f"w{io}"
            if name not in self._w_shapes:
                out_parts.append(torch.zeros(lead + (mo.dim,), dtype=dt, device=in1.device))
                continue
            comp_res = []
            for k in range(mo.ir.dim):
                path_feats = []
                for sl_1, mul1, l1, sl_2, mul2, l2, cg in self._paths[io]:
                    acc = None
                    for i, j in zip(*np.nonzero(cg[:, :, k])):
                        c = _c(float(cg[i, j, k]), dt)
                        x1i = comp1(sl_1, mul1, l1, int(i))  # [..., mul1]
                        if mul2 == 1:
                            x2j = in2[..., sl_2.start + int(j) : sl_2.start + int(j) + 1]
                            term = c * x1i * x2j
                        else:
                            x2j = in2[..., sl_2].reshape(lead + (mul2, 2 * l2 + 1))[..., :, int(j)]
                            term = (c * x1i[..., :, None] * x2j[..., None, :]).reshape(
                                lead + (mul1 * mul2,))
                        acc = term if acc is None else acc + term
                    if acc is None:
                        acc = torch.zeros(lead + (mul1 * mul2,), dtype=dt, device=in1.device)
                    path_feats.append(acc)
                o = _matmul_f32(torch.cat(path_feats, dim=-1), getattr(self, name))
                comp_res.append((self._norm[io] * o).to(dt))
            if self.layout_out == "cm":
                out_parts.append(torch.cat(comp_res, dim=-1))
                continue
            blk = torch.stack(comp_res, dim=-2)  # [..., 2l+1, w]
            out_parts.append(blk.transpose(-1, -2).reshape(lead + (mo.dim,)))
        return torch.cat(out_parts, dim=-1)
