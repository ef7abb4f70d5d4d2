"""Morton (Z-order) codes: 3D bit interleaving on int32 tensors.

Counterpart of ``scalable_e3_gnn_tpu/graph/morton.py``: 30-bit codes (10 bits
per axis, a 1024^3 grid) in int32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["BITS", "MAX_LEVEL", "CODE_SENTINEL", "quantize", "morton_encode",
           "morton_decode", "morton_encode_points"]

BITS = 10  # bits per axis
MAX_LEVEL = BITS
CODE_SENTINEL = np.int32(2**31 - 1)  # padding value, sorts after all codes


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x over 30 bits: bit i -> bit 3i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2: gather bits 0,3,6,... into the low 10 bits."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def quantize(points: torch.Tensor, lo: Tuple[float, float, float],
             hi: Tuple[float, float, float]) -> torch.Tensor:
    """Map points in the [lo, hi] box to integer grid coords [0, 2^BITS)."""
    lo_a = torch.tensor(lo, dtype=points.dtype, device=points.device)
    hi_a = torch.tensor(hi, dtype=points.dtype, device=points.device)
    scale = (2**BITS) / (hi_a - lo_a)
    q = torch.floor((points - lo_a) * scale).to(torch.int32)
    return torch.clamp(q, 0, 2**BITS - 1)


def morton_encode(q: torch.Tensor) -> torch.Tensor:
    """Interleave integer grid coords [..., 3] -> 30-bit codes [...] (int32).

    Bit layout (MSB-first): (x9 y9 z9)(x8 y8 z8)..., so code >> 3k is the cell
    id at octree level BITS-k.
    """
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    return (_part1by2(x) << 2) | (_part1by2(y) << 1) | _part1by2(z)


def morton_decode(code: torch.Tensor) -> torch.Tensor:
    """Codes -> integer grid coords [..., 3]."""
    return torch.stack(
        [_compact1by2(code >> 2), _compact1by2(code >> 1), _compact1by2(code)], dim=-1
    )


def morton_encode_points(points: torch.Tensor, lo: Tuple[float, float, float],
                         hi: Tuple[float, float, float]) -> torch.Tensor:
    return morton_encode(quantize(points, lo, hi))
