"""Adaptive Gradient Clipping (NFNets, arXiv 2102.06171), counterpart of
``bcosification_tpu/training/agc.py``.

Each output unit's gradient is clipped to ``clip_factor`` times the unit's
parameter norm; unit-wise norms reduce over every axis but the unit's.
The unit is the FIRST axis of a torch layout (OIHW conv weights, [out, in]
linears), where the JAX package's HWIO / (in, out) layouts put it last. The
port's own linears keep the JAX (in, out) weight (``modules/bcos_layers.py``)
and declare it with ``weight_unit_axis = -1``, and a module's other raw
parameters in that layout (the CLIP ViT's ``proj`` and positional
embeddings, the MoE's router and experts) with ``param_unit_axes``; clipping a module's gradients reads
both. Parameters with at most one axis longer than 1 (vectors,
scalars) use their full norm.
"""
from __future__ import annotations

from typing import Iterable, Union

import torch
from torch import nn

__all__ = ["unitwise_norm", "clip_grad", "adaptive_clip_grads_"]


def unitwise_norm(x: torch.Tensor, unit_axis: int = 0) -> torch.Tensor:
    if sum(1 for s in x.shape if s > 1) <= 1:
        return torch.linalg.vector_norm(x)
    unit_axis %= x.ndim
    dims = tuple(d for d in range(x.ndim) if d != unit_axis)
    return torch.sqrt((x * x).sum(dim=dims, keepdim=True))


def clip_grad(p: torch.Tensor, g: torch.Tensor, clip_factor: float = 0.01,
              eps: float = 1e-3, unit_axis: int = 0) -> torch.Tensor:
    """The clipped gradient of one parameter."""
    max_norm = torch.clamp(unitwise_norm(p, unit_axis), min=eps) * clip_factor
    grad_norm = unitwise_norm(g, unit_axis)
    clipped = g * (max_norm / torch.clamp(grad_norm, min=1e-6))
    return torch.where(grad_norm < max_norm, g, clipped)


def _unit_axis(module: nn.Module, name: str) -> int:
    if name == "weight":
        return getattr(module, "weight_unit_axis", 0)
    return getattr(module, "param_unit_axes", {}).get(name, 0)


@torch.no_grad()
def adaptive_clip_grads_(params: Union[nn.Module, Iterable[torch.Tensor]],
                         clip_factor: float = 0.01, eps: float = 1e-3) -> None:
    """Clip the ``.grad`` of every parameter that has one, in place.
    ``params``: parameters in a torch layout (the unit on the first axis),
    or a module, whose weights take the unit axis their module declares
    (``weight_unit_axis``, default 0) and its other parameters the axis
    that ``param_unit_axes`` names, else 0."""
    if isinstance(params, nn.Module):
        pairs = [(p, _unit_axis(m, n)) for m in params.modules()
                 for n, p in m.named_parameters(recurse=False)]
    else:
        pairs = [(p, 0) for p in params]
    for p, unit_axis in pairs:
        if p.grad is not None:
            p.grad.copy_(clip_grad(p, p.grad, clip_factor, eps, unit_axis))
