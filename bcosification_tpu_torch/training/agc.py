"""Adaptive Gradient Clipping (NFNets, arXiv 2102.06171), counterpart of
``bcosification_tpu/training/agc.py``.

Each output unit's gradient is clipped to ``clip_factor`` times the unit's
parameter norm. The unit is the FIRST axis here (OIHW conv weights,
[out, in] linears), where the JAX package's HWIO / (in, out) layouts put it
last: unit-wise norms reduce over every axis but the first. Parameters with
at most one axis longer than 1 (vectors, scalars) use their full norm.
"""
from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["unitwise_norm", "clip_grad", "adaptive_clip_grads_"]


def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    if sum(1 for s in x.shape if s > 1) <= 1:
        return torch.linalg.vector_norm(x)
    return torch.sqrt((x * x).sum(dim=tuple(range(1, x.ndim)), keepdim=True))


def clip_grad(p: torch.Tensor, g: torch.Tensor, clip_factor: float = 0.01,
              eps: float = 1e-3) -> torch.Tensor:
    """The clipped gradient of one parameter."""
    max_norm = torch.clamp(unitwise_norm(p), min=eps) * clip_factor
    grad_norm = unitwise_norm(g)
    clipped = g * (max_norm / torch.clamp(grad_norm, min=1e-6))
    return torch.where(grad_norm < max_norm, g, clipped)


@torch.no_grad()
def adaptive_clip_grads_(params: Iterable[torch.Tensor], clip_factor: float = 0.01,
                         eps: float = 1e-3) -> None:
    """Clip the ``.grad`` of every parameter that has one, in place."""
    for p in params:
        if p.grad is not None:
            p.grad.copy_(clip_grad(p, p.grad, clip_factor, eps))
