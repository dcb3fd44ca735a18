"""Exponential moving average of the whole model state, parameters and BN
buffers (counterpart of ``bcosification_tpu/training/ema.py``):

    adjust = world_size * batch_size * ema_steps * accumulate / epochs
    alpha  = min(1.0, (1 - ema_decay) * adjust)
    decay  = 1 - alpha

updated every ``ema_steps`` optimizer steps. The EMA is a copy of the
model, updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["adjusted_ema_decay", "ema_update", "maybe_ema_update"]


def adjusted_ema_decay(ema_decay: float, world_size: int, batch_size: int, max_epochs: int,
                       ema_steps: int = 32, accumulate_grad_batches: int = 1) -> float:
    adjust = world_size * batch_size * ema_steps * accumulate_grad_batches / max_epochs
    alpha = min(1.0, (1 - ema_decay) * adjust)
    return 1.0 - alpha


def _state(model: nn.Module):
    return list(model.parameters()) + list(model.buffers())


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * model, tensor by tensor; integer
    buffers (num_batches_tracked) are copied."""
    for e, n in zip(_state(ema), _state(model), strict=True):
        if e.is_floating_point():
            e.copy_(decay * e + (1.0 - decay) * n)
        else:
            e.copy_(n)


def maybe_ema_update(ema: nn.Module, model: nn.Module, decay: float, step: int,
                     ema_steps: int) -> None:
    """Update when ``step`` is a multiple of ``ema_steps``."""
    if step % ema_steps == 0:
        ema_update(ema, model, decay)
