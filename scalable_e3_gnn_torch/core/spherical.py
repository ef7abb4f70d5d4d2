"""Real spherical-harmonic embeddings of direction vectors, any lmax.

Counterpart of ``scalable_e3_gnn_tpu/core/spherical.py``: ``[1, sqrt(3)*(y, z,
x), ...]`` under e3nn's component normalization and (y, z, x) component order.
Orders above 1 follow the recursion Y_{l+1} = n_l C_{l,1,l+1} . (Y_l x Y_1)
with the real-basis 3j tensors of ``core.wigner``, so they transform with the
convention the tensor products assume.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .irreps import Irreps
from .wigner import wigner_3j

__all__ = ["spherical_harmonics", "sh_irreps"]


def sh_irreps(lmax: int) -> Irreps:
    return Irreps.spherical_harmonics(lmax)


@functools.lru_cache(maxsize=None)
def _recursion_constants(lmax: int):
    """Per level (3j tensor, norm factor) so that ||Y_l(v)||^2 = 2l+1 on the sphere."""
    consts = []
    # float64 evaluation at a generic unit vector fixes each norm
    v = np.array([0.2731, -0.6214, 0.7344])
    v = v / np.linalg.norm(v)
    y_prev = np.sqrt(3.0) * np.array([v[1], v[2], v[0]])  # l=1, component norm
    y1 = y_prev.copy()
    for l in range(1, lmax):
        C = wigner_3j(l, 1, l + 1)
        raw = np.einsum("abc,a,b->c", C, y_prev, y1)
        n = np.sqrt(2 * (l + 1) + 1) / np.linalg.norm(raw)
        consts.append((C, float(n)))
        y_prev = n * raw
    return consts


def spherical_harmonics(
    lmax: int,
    vectors: torch.Tensor,
    normalize: bool = True,
    normalization: str = "component",
    eps: float = 1e-12,
) -> torch.Tensor:
    """Concatenated real sh features ``[..., (lmax+1)^2]`` for ``vectors [..., 3]``.

    ``normalize=True`` maps vectors to the unit sphere first (zero padding
    vectors embed to [1, 0, 0, ...]).  ``normalization`` is "component"
    (||Y_l|| = sqrt(2l+1)), "norm" (||Y_l|| = 1) or "integral" (divided by
    sqrt(4 pi)).
    """
    if vectors.shape[-1] != 3:
        raise ValueError(f"vectors must have trailing dim 3, got {tuple(vectors.shape)}")
    v = vectors
    if normalize:
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.clamp(n, min=eps)
    outs = [torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)]
    if lmax >= 1:
        y1 = math.sqrt(3.0) * torch.stack([v[..., 1], v[..., 2], v[..., 0]], dim=-1)
        outs.append(y1)
        y_prev = y1
        for C, n in _recursion_constants(lmax):
            cj = torch.as_tensor(C * n, dtype=v.dtype, device=v.device)
            y_prev = torch.einsum("...a,...b,abc->...c", y_prev, y1, cj)
            outs.append(y_prev)
    out = torch.cat(outs, dim=-1)
    if normalization == "component":
        return out
    if normalization == "norm":
        scales = np.concatenate(
            [np.full(2 * l + 1, 1.0 / np.sqrt(2 * l + 1)) for l in range(lmax + 1)])
        return out * torch.as_tensor(scales, dtype=out.dtype, device=out.device)
    if normalization == "integral":
        return out / math.sqrt(4.0 * math.pi)
    raise ValueError(f"unknown normalization {normalization!r}")
