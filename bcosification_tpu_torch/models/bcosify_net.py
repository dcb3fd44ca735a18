"""BcosifyNetwork: the conversion wrapper around a bcosified backbone
(counterpart of ``bcosification_tpu/models/bcosify_net.py``).

It adds the 0th-layer channel-wise Normalize over the 6 AddInverse channels
and a LogitLayer with bias -log(num_classes - 1). ``normalization_for``
picks the Normalize constants: ImageNet's, or CLIP's for the CLIP towers.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from bcosification_tpu_torch.modules import LogitLayer

__all__ = [
    "BcosifyNetwork",
    "Normalize",
    "IMAGENET_MEAN_ADDINVERSE",
    "IMAGENET_STD_ADDINVERSE",
    "CLIP_MEAN_ADDINVERSE",
    "CLIP_MEAN_ZERO",
    "CLIP_STD_ADDINVERSE",
    "normalization_for",
]

IMAGENET_MEAN_ADDINVERSE = (0.485, 0.456, 0.406, 0.515, 0.544, 0.594)
IMAGENET_STD_ADDINVERSE = (0.229, 0.224, 0.225, 0.229, 0.224, 0.225)
CLIP_MEAN_ADDINVERSE = (0.48145466, 0.4578275, 0.40821073, 0.51854534, 0.5421725, 0.59178927)
CLIP_MEAN_ZERO = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
CLIP_STD_ADDINVERSE = (0.26862954, 0.26130258, 0.27577711, 0.26862954, 0.26130258, 0.27577711)


def normalization_for(clip_kd: bool = False, linearprobe_clip: bool = False,
                      bfy_mean_zero: bool = False) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(mean, std) of the 0th-layer Normalize: CLIP's for a CLIP-KD student
    (zero mean with ``bfy_mean_zero``) or a CLIP linear probe, else
    ImageNet's."""
    if clip_kd and bfy_mean_zero:
        return CLIP_MEAN_ZERO, CLIP_STD_ADDINVERSE
    if (clip_kd or linearprobe_clip) and not bfy_mean_zero:
        return CLIP_MEAN_ADDINVERSE, CLIP_STD_ADDINVERSE
    return IMAGENET_MEAN_ADDINVERSE, IMAGENET_STD_ADDINVERSE


class Normalize(nn.Module):
    """Channel-wise (x - mean) / std on the last axis, in x's dtype."""

    def __init__(self, mean: Tuple[float, ...], std: Tuple[float, ...]):
        super().__init__()
        self.mean, self.std = tuple(mean), tuple(std)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        mean = torch.tensor(self.mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.std, dtype=x.dtype, device=x.device)
        return (x - mean) / std


class BcosifyNetwork(nn.Module):
    """normalize -> backbone -> (logit layer)."""

    def __init__(self, model: nn.Module, num_classes: int = 1000,
                 with_logit_layer: bool = True,
                 mean: Tuple[float, ...] = IMAGENET_MEAN_ADDINVERSE,
                 std: Tuple[float, ...] = IMAGENET_STD_ADDINVERSE,
                 logit_bias: Optional[float] = None,
                 logit_temperature: Optional[float] = None):
        super().__init__()
        self.model, self.num_classes = model, num_classes
        self.with_logit_layer = with_logit_layer
        self.mean, self.std = tuple(mean), tuple(std)
        self.logit_temperature = logit_temperature
        self.logit_bias = -math.log(num_classes - 1) if logit_bias is None else logit_bias
        self.bcosifynormalize = Normalize(mean, std)
        if with_logit_layer:
            self.logit_layer = LogitLayer(logit_temperature, self.logit_bias)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        x = self.model(self.bcosifynormalize(x), train=train, explain=explain)
        if self.with_logit_layer:
            x = self.logit_layer(x)
        return x
