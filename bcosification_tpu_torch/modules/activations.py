"""Activations with the (train, explain) call convention of the port
(counterpart of ``bcosification_tpu/modules/activations.py``).

``DetachableGELU`` writes GELU as ``gate(x) * x`` with the gate
GELU(x) / x = Phi(x) (erf, or the tanh approximation) detached under
``explain``, so the activation is dynamic-linear.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from bcosification_tpu_torch.ops import guided

__all__ = ["DetachableGELU", "MyGELU", "PlainGELU", "ReLU", "PlainReLU", "Identity"]


class DetachableGELU(nn.Module):
    """gate(x) * x, the gate detached under ``explain``; ``approximate``
    takes the tanh gate. ``detachable=False`` is the plain nn.GELU of the
    standard ViT configs: the same forward, no detach."""

    def __init__(self, approximate: bool = False, detachable: bool = True):
        super().__init__()
        self.approximate, self.detachable = approximate, detachable

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        """GELU(x) / x in x's dtype."""
        if self.approximate:
            return 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x**3)))
        return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))

    def forward(self, x, *, train: bool = False, explain: bool = False):
        gate = self.gate(x)
        if explain and self.detachable:
            gate = gate.detach()
        return gate * x


MyGELU = DetachableGELU  # the reference's name


def PlainGELU(**kwargs):
    """The plain nn.GELU of the standard ViT configs: no detach."""
    return DetachableGELU(detachable=False, **kwargs)


class ReLU(nn.Module):
    """The model path's ReLU, routed through ``ops.guided`` so that guided
    backprop and DeepLIFT can gate its gradient."""

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return guided.relu(x)


class PlainReLU(nn.Module):
    """A plain torch.relu, which guided backprop and DeepLIFT leave alone:
    the CLIP towers' ReLU (the JAX package's CLIP ``_ReLU`` calls
    jax.nn.relu), so that GB on a CLIP tower equals Grad, as in JAX."""

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return torch.relu(x)


class Identity(nn.Module):
    def forward(self, x, *, train: bool = False, explain: bool = False):
        return x
