"""Stochastic depth (row-wise DropPath; counterpart of
``bcosification_tpu/modules/stochastic_depth.py``, torchvision's
``stochastic_depth``).

In train mode each row ("row": each sample) or the whole batch ("batch")
is kept with probability 1 - p and the kept ones scaled by 1 / (1 - p); in
eval mode, or with p = 0, the input passes unchanged. The draw comes from
the ``generator`` given (the default generator when None), on x's device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["StochasticDepth", "stochastic_depth"]


def stochastic_depth(x: torch.Tensor, p: float, mode: str, training: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if p < 0.0 or p > 1.0:
        raise ValueError(f"drop probability must be in [0, 1], got {p}")
    if mode not in ("batch", "row"):
        raise ValueError(f"mode must be 'batch' or 'row', got {mode}")
    if not training or p == 0.0:
        return x
    survival_rate = 1.0 - p
    size = (x.shape[0],) + (1,) * (x.dim() - 1) if mode == "row" else (1,) * x.dim()
    keep = torch.rand(size, device=x.device, generator=generator) < survival_rate
    noise = keep.to(x.dtype)
    if survival_rate > 0.0:
        noise = noise / survival_rate
    return x * noise


class StochasticDepth(nn.Module):
    def __init__(self, p: float, mode: str = "row",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.mode, self.generator = p, mode, generator

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return stochastic_depth(x, self.p, self.mode, train, self.generator)
