"""Carry JAX parameters into the PyTorch modules.

The JAX package keeps parameters as nested dicts (``SEGNN.init``):
``embed/{w_l0e,w_l1o}``, ``layer_i/{msg_j,upd_j}/w_l*``, ``pre_head/w_l*``,
``head/{w_0e,w_1o,b_0e}``; at lmax >= 2 the generic tensor products' keys are
``w{io}`` (one per output irrep group) and the head's ``w_<irrep>``.  ``params_from_jax`` copies such a tree, given as
nested dicts of numpy arrays (or anything ``np.asarray`` reads), into the
matching modules of this package, so both compute the same function;
``params_to_jax`` goes the other way (parameters or their gradients), so the
two packages' trees compare key by key.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.segnn import SEGNN, O3TensorProductGate, SEGNNLayer

__all__ = ["params_from_jax", "params_to_jax"]


def _children(mod: nn.Module):
    if isinstance(mod, SEGNN):
        out = {"embed": mod.embed, "pre_head": mod.pre_head, "head": mod.head}
        out.update({f"layer_{i}": layer for i, layer in enumerate(mod.layers)})
        return out
    if isinstance(mod, SEGNNLayer):
        out = {f"msg_{i}": m for i, m in enumerate(mod.message_layers)}
        out.update({f"upd_{i}": m for i, m in enumerate(mod.update_layers)})
        return out
    return None


def _load(mod: nn.Module, tree: Mapping, path: str) -> None:
    if isinstance(mod, O3TensorProductGate):
        return _load(mod.tp, tree, path)
    children = _children(mod)
    own = children if children is not None else dict(mod.named_parameters(recurse=False))
    if set(own) != set(tree):
        raise KeyError(f"{path or '/'}: JAX keys {sorted(tree)} != module keys {sorted(own)}")
    for key, target in own.items():
        if children is not None:
            _load(target, tree[key], f"{path}/{key}")
            continue
        arr = np.asarray(tree[key])
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{path}/{key}: shape {arr.shape} != {tuple(target.shape)}")
        target.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(target))


def params_from_jax(module: nn.Module, tree: Mapping) -> nn.Module:
    """Load the JAX parameter tree ``tree`` into ``module`` in place; returns it.

    ``module`` is a ``SEGNN``, ``SEGNNLayer``, ``O3TensorProductGate``,
    ``L1TensorProduct``, ``TensorProduct`` or ``O3Linear`` whose JAX
    counterpart produced ``tree``.  Keys and shapes must match exactly.
    """
    with torch.no_grad():
        _load(module, tree, "")
    return module


def _dump(mod: nn.Module, grad: bool):
    if isinstance(mod, O3TensorProductGate):
        return _dump(mod.tp, grad)
    children = _children(mod)
    if children is not None:
        return {key: _dump(child, grad) for key, child in children.items()}
    out = {}
    for key, p in mod.named_parameters(recurse=False):
        t = p.grad if grad else p
        t = torch.zeros_like(p) if t is None else t
        out[key] = t.detach().float().cpu().numpy()
    return out


def params_to_jax(module: nn.Module, grad: bool = False) -> dict:
    """The JAX parameter tree of ``module`` as nested dicts of float32 numpy
    arrays, with the keys of the JAX ``init``; ``grad=True`` gives the
    parameters' ``.grad`` instead (zeros where a parameter has none)."""
    return _dump(module, grad)
