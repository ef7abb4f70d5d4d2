"""Device choice for the package's entry points.

Every entry point runs on the GPU unless its caller names another device.
Without a GPU and without ``device=``, it raises instead of falling back to
the CPU, so a run that was meant for the card never measures the host.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current GPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device`` (no copy when already there)."""
    return torch.as_tensor(x, device=device)
