"""Irreducible-representation (irreps) algebra for O(3) steerable features.

A copy of ``scalable_e3_gnn_tpu/core/irreps.py`` (pure Python, no arrays), kept
here so the PyTorch package imports nothing of the JAX package.  It provides:

- ``Irrep(l, p)``: a single irrep of O(3) — angular momentum ``l`` and parity
  ``p ∈ {+1, -1}`` — with ``.dim == 2l+1``.
- ``MulIrrep(mul, ir)``: ``mul`` copies of an irrep.
- ``Irreps``: an ordered sequence of ``MulIrrep`` groups, parsed from strings such
  as ``"8x0e+8x1o"``, with the e3nn flat-layout convention: groups concatenated in
  spec order, each group stored mul-major (``[mul, 2l+1]`` row-major flattened,
  cf. l1_tensor_prod.py:35,247).
- ``Instruction``: the tensor-product path descriptor namedtuple other code
  introspects (l1_tensor_prod.py:121,151,193).

Everything here is static Python executed at model-construction time, so all
shapes and slices derived from an ``Irreps`` are plain Python ints.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Sequence, Tuple, Union

__all__ = ["Irrep", "MulIrrep", "Irreps", "Instruction"]


@dataclass(frozen=True)
class Irrep:
    """A single O(3) irrep: angular momentum ``l >= 0`` and parity ``p ∈ {1,-1}``.

    Ordering is (l, -p) so that ``0e < 0o < 1o < 1e < 2e < 2o`` follows e3nn's
    convention (parity alternating with (-1)^l first).
    """

    l: int
    p: int

    def __post_init__(self):
        if self.l < 0:
            raise ValueError(f"l must be >= 0, got {self.l}")
        if self.p not in (1, -1):
            raise ValueError(f"p must be +1 or -1, got {self.p}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __lt__(self, other: "Irrep") -> bool:
        # e3nn sort order: by l, then parity (-1)^l first.
        return (self.l, -self.p * (-1) ** self.l) < (
            other.l,
            -other.p * (-1) ** other.l,
        )

    @classmethod
    def parse(cls, s: Union[str, "Irrep", Tuple[int, int]]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            return cls(*s)
        m = re.fullmatch(r"(\d+)([eo])", s.strip())
        if m is None:
            raise ValueError(f"cannot parse irrep {s!r}")
        return cls(int(m.group(1)), 1 if m.group(2) == "e" else -1)

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: tensor-product decomposition of two irreps."""
        other = Irrep.parse(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)


@dataclass(frozen=True)
class MulIrrep:
    """``mul`` copies of irrep ``ir``; flat dim is ``mul * ir.dim``."""

    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f"{self.mul}x{self.ir}"

    def __iter__(self):
        # allow ``mul, ir = mul_irrep`` destructuring like e3nn
        yield self.mul
        yield self.ir


class Instruction(NamedTuple):
    """A tensor-product path: which (in1, in2) groups feed which output group.

    Mirrors the fields of e3nn's ``Instruction`` that the reference constructs
    and rewrites (l1_tensor_prod.py:151, 193) so parity tooling can compare
    instruction lists structurally.
    """

    i_in1: int
    i_in2: int
    i_out: int
    connection_mode: str
    has_weight: bool
    path_weight: float
    path_shape: Tuple[int, ...]


class Irreps(tuple):
    """An ordered direct sum of ``MulIrrep`` groups.

    Construction accepts: a spec string (``"4x0e+2x0o+3x1o"``), another Irreps,
    an Irrep (=> mul 1), or an iterable of ``(mul, ir)`` pairs / MulIrreps.

    Flat-layout convention (matches the reference's masks, l1_tensor_prod.py:24-65):
    groups are laid out in spec order; within a group the ``mul * (2l+1)`` features
    are mul-major: feature index = ``group_offset + m * (2l+1) + c``.
    """

    def __new__(cls, irreps: Union[str, "Irreps", Irrep, Sequence, None] = None):
        if irreps is None:
            return super().__new__(cls, ())
        if isinstance(irreps, Irreps):
            return super().__new__(cls, tuple(irreps))
        if isinstance(irreps, Irrep):
            return super().__new__(cls, (MulIrrep(1, irreps),))
        if isinstance(irreps, str):
            items: List[MulIrrep] = []
            s = irreps.strip()
            if s:
                for part in s.split("+"):
                    part = part.strip()
                    if "x" in part:
                        mul_s, ir_s = part.split("x")
                        items.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        items.append(MulIrrep(1, Irrep.parse(part)))
            return super().__new__(cls, tuple(items))
        # iterable of MulIrrep / (mul, ir)
        items = []
        for x in irreps:
            if isinstance(x, MulIrrep):
                items.append(x)
            else:
                mul, ir = x
                items.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, tuple(items))

    # ---- properties mirrored from e3nn (SURVEY.md §2.3) ----

    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        """Total multiplicity (number of irrep copies)."""
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        if len(self) == 0:
            raise ValueError("empty Irreps has no lmax")
        return max(mi.ir.l for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    @classmethod
    def spherical_harmonics(cls, lmax: int, p: int = -1) -> "Irreps":
        """``1x0e+1x1o+1x2e+...`` — the sh irreps (l1_tensor_prod.py:17)."""
        return cls([(1, Irrep(l, p**l)) for l in range(lmax + 1)])

    # ---- algebra ----

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __radd__(self, other) -> "Irreps":
        return Irreps(tuple(Irreps(other)) + tuple(self))

    def __mul__(self, n: int) -> "Irreps":
        return Irreps(tuple(self) * n)

    def __rmul__(self, n: int) -> "Irreps":
        return self * n

    def __repr__(self) -> str:
        return "+".join(repr(mi) for mi in self) if len(self) else "(empty)"

    def simplify(self) -> "Irreps":
        """Merge adjacent groups with the same irrep; drop zero-mul groups."""
        out: List[MulIrrep] = []
        for mi in self:
            if mi.mul == 0:
                continue
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            else:
                out.append(mi)
        return Irreps(out)

    def sort(self) -> "Irreps":
        """Groups sorted by irrep (stable); returns just the sorted Irreps."""
        return Irreps(sorted(self, key=lambda mi: (mi.ir.l, -mi.ir.p * (-1) ** mi.ir.l)))

    def regroup(self) -> "Irreps":
        return self.sort().simplify()

    def filter(self, keep=None, lmax: int = None) -> "Irreps":
        out = []
        for mi in self:
            if lmax is not None and mi.ir.l > lmax:
                continue
            if keep is not None and mi.ir not in [Irrep.parse(k) for k in keep]:
                continue
            out.append(mi)
        return Irreps(out)

    # ---- layout helpers (all static / trace-time) ----

    def slices(self) -> List[slice]:
        """Flat slice of each group, in spec order."""
        out, i = [], 0
        for mi in self:
            out.append(slice(i, i + mi.dim))
            i += mi.dim
        return out

    def slices_by_irrep(self) -> dict:
        """Map ``Irrep -> list of flat slices`` (groups may repeat an irrep)."""
        d: dict = {}
        for mi, sl in zip(self, self.slices()):
            d.setdefault(mi.ir, []).append(sl)
        return d

    def mul_for(self, ir) -> int:
        """Total multiplicity of irrep ``ir`` across all groups."""
        ir = Irrep.parse(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def contiguous_slice_for(self, ir) -> slice:
        """Flat slice of irrep ``ir`` if its groups are contiguous, else raise.

        The block-wise TPU kernels require each (l, p) block to be one static
        slice (the reference achieves the same with boolean masks over a layout
        that is contiguous in practice, l1_tensor_prod.py:24-36).  Use
        ``regroup()`` on model specs to guarantee this.
        """
        ir = Irrep.parse(ir)
        sls = [sl for mi, sl in zip(self, self.slices()) if mi.ir == ir]
        if not sls:
            return slice(0, 0)
        start, stop = sls[0].start, sls[0].stop
        for sl in sls[1:]:
            if sl.start != stop:
                raise ValueError(
                    f"irrep {ir} is not contiguous in {self}; call .regroup() first"
                )
            stop = sl.stop
        return slice(start, stop)

    def is_blockwise(self) -> bool:
        """True if every distinct irrep occupies one contiguous flat range."""
        try:
            for ir in {mi.ir for mi in self}:
                self.contiguous_slice_for(ir)
            return True
        except ValueError:
            return False


    def randn(self, generator=None, leading_shape: Tuple[int, ...] = (),
              normalization: str = "component", device=None, dtype=None):
        """Random flat features ~ N(0, 1) per component ('component'), or
        each irrep copy divided by sqrt(2l+1) ('norm'); drawn from the
        ``torch.Generator`` ``generator`` (the JAX method's key)."""
        import torch

        x = torch.randn(tuple(leading_shape) + (self.dim,), generator=generator,
                        device=device, dtype=dtype)
        if normalization == "norm":
            x = torch.cat([x[..., sl] / (mi.ir.dim ** 0.5)
                           for mi, sl in zip(self, self.slices())], dim=-1)
        return x
