"""B-cos ConvNeXt (counterpart of ``bcosification_tpu/models/convnext.py``), NHWC.

The from-scratch B-cos ConvNeXt of the model zoo (the defaults: BcosConv2d
and the bias-free DetachablePositionNorm2d; the ``_bnu`` entries take the
bias-free uncentered BN):

- stem: a 4x4 stride-4 B-cos conv, then the norm;
- block (``CNBlock``): a depthwise 7x7 B-cos conv (``groups=dim``: one patch
  norm per channel), the norm, the 1x1 conv dim -> 4 dim and the 1x1 conv
  4 dim -> dim (both B-cos matmuls, K3; no GELU), times ``layer_scale``
  (shape (dim,), init 1e-6; applied in the activation's dtype), stochastic
  depth ("row", the rate growing linearly from 0 at the first block), plus
  the block's input;
- between stages: the norm, then a 2x2 stride-2 conv;
- head: the norm, the 1x1 classifier conv (K3) before the global average
  pool, the LogitLayer with bias -log(classes - 1).

Sub-module names are the JAX scopes (stem_conv, stem_norm,
stage{s}_block{b}.block_{0..3} and .layer_scale, down{s}_norm, down{s}_conv,
classifier_norm, classifier_conv, logit_layer), so the JAX variables map
onto the state dict one to one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from bcosification_tpu_torch.modules import (
    BcosConv2d,
    DetachablePositionNorm2d,
    LogitLayer,
    NoBias,
)
from bcosification_tpu_torch.modules.stochastic_depth import StochasticDepth
from bcosification_tpu_torch.ops import pooling

__all__ = ["CNBlockConfig", "CNBlock", "BcosConvNeXt", "convnext_atto", "convnext_tiny",
           "convnext_small", "convnext_base", "convnext_large"]

DEFAULT_CONV_LAYER = BcosConv2d
DEFAULT_NORM_LAYER = NoBias(DetachablePositionNorm2d)


@dataclasses.dataclass(frozen=True)
class CNBlockConfig:
    input_channels: int
    out_channels: Optional[int]
    num_layers: int


class CNBlock(nn.Module):
    def __init__(self, dim: int, layer_scale: float, stochastic_depth_prob: float, *,
                 conv_layer: Callable = DEFAULT_CONV_LAYER,
                 norm_layer: Callable = DEFAULT_NORM_LAYER, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.block_0 = conv_layer(dim, dim, 7, padding=3, groups=dim, **kw)
        self.block_1 = norm_layer(dim, device=device)
        self.block_2 = conv_layer(dim, 4 * dim, 1, **kw)
        self.block_3 = conv_layer(4 * dim, dim, 1, **kw)
        self.layer_scale = nn.Parameter(torch.full((dim,), float(layer_scale), device=device))
        if stochastic_depth_prob:
            self.sd = StochasticDepth(stochastic_depth_prob, "row")

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        h = x
        for layer in (self.block_0, self.block_1, self.block_2, self.block_3):
            h = layer(h, **f)
        h = h * self.layer_scale.to(h.dtype)
        if hasattr(self, "sd"):
            h = self.sd(h, **f)
        return h + x


class BcosConvNeXt(nn.Module):
    with_logit_layer = True  # the logit layer is always inside

    def __init__(self, block_setting: Sequence[CNBlockConfig],
                 stochastic_depth_prob: float = 0.0, layer_scale: float = 1e-6,
                 num_classes: int = 1000, *, conv_layer: Callable = DEFAULT_CONV_LAYER,
                 norm_layer: Callable = DEFAULT_NORM_LAYER, in_channels: int = 6,
                 logit_bias: Optional[float] = None,
                 logit_temperature: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block_setting, self.num_classes = tuple(block_setting), num_classes
        kw = dict(device=device, generator=generator)
        first = self.block_setting[0].input_channels
        self.stem_conv = conv_layer(in_channels, first, 4, stride=4, **kw)
        self.stem_norm = norm_layer(first, device=device)
        total = sum(c.num_layers for c in self.block_setting)
        block_id = 0
        for si, cnf in enumerate(self.block_setting):
            for bi in range(cnf.num_layers):
                sd = stochastic_depth_prob * block_id / max(total - 1.0, 1.0)
                setattr(self, f"stage{si}_block{bi}", CNBlock(
                    cnf.input_channels, layer_scale, sd, conv_layer=conv_layer,
                    norm_layer=norm_layer, **kw))
                block_id += 1
            if cnf.out_channels is not None:
                setattr(self, f"down{si}_norm", norm_layer(cnf.input_channels, device=device))
                setattr(self, f"down{si}_conv", conv_layer(
                    cnf.input_channels, cnf.out_channels, 2, stride=2, **kw))
        last = self.block_setting[-1]
        last_ch = last.out_channels or last.input_channels
        self.classifier_norm = norm_layer(last_ch, device=device)
        self.classifier_conv = conv_layer(last_ch, num_classes, 1, **kw)
        bias = -math.log(num_classes - 1) if logit_bias is None else logit_bias
        self.logit_layer = LogitLayer(logit_temperature, bias)

    def blocks(self, stage: int):
        """The blocks of stage ``stage``, in forward order."""
        return [getattr(self, f"stage{stage}_block{b}")
                for b in range(self.block_setting[stage].num_layers)]

    def downsample(self, stage: int):
        """(norm, conv) after stage ``stage``, or None."""
        if self.block_setting[stage].out_channels is None:
            return None
        return getattr(self, f"down{stage}_norm"), getattr(self, f"down{stage}_conv")

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.stem_norm(self.stem_conv(x, **f), **f)
        for si in range(len(self.block_setting)):
            for blk in self.blocks(si):
                x = blk(x, **f)
            down = self.downsample(si)
            if down is not None:
                x = down[1](down[0](x, **f), **f)
        x = self.classifier_conv(self.classifier_norm(x, **f), **f)
        return self.logit_layer(pooling.global_avg_pool(x), **f)


def _entry(block_setting, sd):
    def factory(**kwargs):
        kwargs.setdefault("stochastic_depth_prob", sd)
        return BcosConvNeXt(block_setting, **kwargs)

    return factory


convnext_atto = _entry([CNBlockConfig(40, 80, 2), CNBlockConfig(80, 160, 2),
                        CNBlockConfig(160, 320, 6), CNBlockConfig(320, None, 2)], 0.1)
convnext_tiny = _entry([CNBlockConfig(96, 192, 3), CNBlockConfig(192, 384, 3),
                        CNBlockConfig(384, 768, 9), CNBlockConfig(768, None, 3)], 0.1)
convnext_small = _entry([CNBlockConfig(96, 192, 3), CNBlockConfig(192, 384, 3),
                         CNBlockConfig(384, 768, 27), CNBlockConfig(768, None, 3)], 0.4)
convnext_base = _entry([CNBlockConfig(128, 256, 3), CNBlockConfig(256, 512, 3),
                        CNBlockConfig(512, 1024, 27), CNBlockConfig(1024, None, 3)], 0.5)
convnext_large = _entry([CNBlockConfig(192, 384, 3), CNBlockConfig(384, 768, 3),
                         CNBlockConfig(768, 1536, 27), CNBlockConfig(1536, None, 3)], 0.5)
