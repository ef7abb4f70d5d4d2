"""Training step: loss, gradients, one optimizer update; the train state.

Counterpart of ``scalable_e3_gnn_tpu/train/pipeline.py`` (``mse_loss``,
``make_train_step``, ``TrainState``, ``make_train_state``).  PyTorch runs
eagerly, so there is no ``jit`` and no donation: the step updates the
module's parameters and the optimizer's state in place, and the
``TrainState`` holds the module, the optimizer and the step count (plus,
optionally, the data generator whose state a checkpoint keeps).

``optax.adam(1e-3)`` maps onto ``torch.optim.Adam(params, lr=1e-3,
betas=(0.9, 0.999), eps=1e-8)``: both update with ``m_hat / (sqrt(v_hat) +
eps)``, the bias-corrected first moment over the square root of the
bias-corrected second moment plus eps (eps outside the root), and start from
zero moments.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["TrainState", "make_train_state", "mse_loss", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState`` (params, opt_state, step): ``model`` holds the
    parameters, ``optimizer`` their optimizer state, ``step`` the steps
    taken; ``data_rng``, when a run draws its data from one, the numpy
    generator (``train.checkpoint`` saves its state, so a resumed run draws
    the same data)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    data_rng: Optional[np.random.Generator] = None


def make_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     data_rng: Optional[np.random.Generator] = None) -> TrainState:
    """A fresh ``TrainState`` at step 0 (the optimizer's state starts empty:
    Adam's moments are zero)."""
    return TrainState(model=model, optimizer=optimizer, step=0, data_rng=data_rng)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error; with ``mask`` (per row, or elementwise) the sum of
    the kept squared errors over ``max(mask.sum(), 1) * dim``."""
    err = (pred - target) ** 2
    if mask is not None:
        keep = mask[:, None] if err.dim() > mask.dim() else mask
        err = torch.where(keep, err, torch.zeros_like(err))
        denom = torch.clamp(mask.sum(), min=1) * err.shape[-1]
        return err.sum() / denom
    return err.mean()


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def make_train_step(model: nn.Module, loss_fn: Callable[..., torch.Tensor],
                    optimizer: torch.optim.Optimizer) -> Callable[..., Dict[str, torch.Tensor]]:
    """``loss_fn(model, *batch) -> scalar``.  Returns ``step(*batch) ->
    {"loss", "grad_norm"}``: the loss and its gradients with respect to the
    model's parameters, one optimizer update, and the global L2 norm of the
    gradients (a parameter the loss does not reach counts as a zero
    gradient)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(*batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = global_norm(p.grad for p in params)
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return step
