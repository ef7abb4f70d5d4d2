"""Real spherical-harmonic embeddings of direction vectors (lmax <= 1).

Counterpart of ``scalable_e3_gnn_tpu/core/spherical.py``: ``[1, sqrt(3)*(y, z,
x)]`` under e3nn's component normalization and (y, z, x) component order.
Orders above 1 need the real-basis 3j tensors of the generic tensor product
and come with that slice.
"""

from __future__ import annotations

import math

import torch

from .irreps import Irreps

__all__ = ["spherical_harmonics", "sh_irreps"]


def sh_irreps(lmax: int) -> Irreps:
    return Irreps.spherical_harmonics(lmax)


def spherical_harmonics(
    lmax: int,
    vectors: torch.Tensor,
    normalize: bool = True,
    normalization: str = "component",
    eps: float = 1e-12,
) -> torch.Tensor:
    """Concatenated real sh features ``[..., (lmax+1)^2]`` for ``vectors [..., 3]``.

    ``normalize=True`` maps vectors to the unit sphere first (zero padding
    vectors embed to [1, 0, 0, 0]).  ``normalization`` is "component"
    (||Y_l|| = sqrt(2l+1)), "norm" (||Y_l|| = 1) or "integral" (divided by
    sqrt(4 pi)).
    """
    if vectors.shape[-1] != 3:
        raise ValueError(f"vectors must have trailing dim 3, got {tuple(vectors.shape)}")
    if lmax > 1:
        raise NotImplementedError(
            "spherical harmonics above l=1 are ported in a later slice"
        )
    v = vectors
    if normalize:
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.clamp(n, min=eps)
    outs = [torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)]
    if lmax >= 1:
        outs.append(math.sqrt(3.0) * torch.stack([v[..., 1], v[..., 2], v[..., 0]], dim=-1))
    out = torch.cat(outs, dim=-1)
    if normalization == "component":
        return out
    if normalization == "norm":
        scales = [1.0] + [1.0 / math.sqrt(3.0)] * 3 * (lmax >= 1)
        return out * torch.tensor(scales[: out.shape[-1]], dtype=out.dtype, device=out.device)
    if normalization == "integral":
        return out / math.sqrt(4.0 * math.pi)
    raise ValueError(f"unknown normalization {normalization!r}")
