"""B-cos VGG (counterpart of ``bcosification_tpu/models/vgg.py``), NHWC.

The from-scratch B-cos VGG of the model zoo: the letter configs' 3x3 B-cos
convs with no ReLU (the B-cos transform is itself non-linear), each
followed by the bias-free uncentered BN when ``with_norm`` (the ``_bnu``
entries); each "M" an ``avg_pool2d(2, 2)``, or with ``no_pool`` folded into
the previous conv's stride. The classifier comes before the global average
pool: a 7x7 conv with padding 3 to 4096 channels, a 1x1 4096 -> 4096 and a
1x1 4096 -> classes (both B-cos matmuls, K3), then the pool and the
LogitLayer with bias -log(classes - 1).

Sub-module names are the JAX scopes: ``features_{i}`` counts the convs and
norms in order (not the pools), then ``classifier_{0,1,2}`` and
``logit_layer``, so the JAX variables map onto the state dict one to one.
The input's channels are passed (``in_channels``); the JAX module infers
them.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
from torch import nn

from bcosification_tpu_torch.modules import (
    BatchNormUncentered2d,
    BcosConv2d,
    LogitLayer,
    NoBias,
)
from bcosification_tpu_torch.ops import pooling

__all__ = ["BcosVGG", "CFGS", "vgg11", "vgg11_bnu", "vgg13", "vgg13_bnu", "vgg16",
           "vgg16_bnu", "vgg19", "vgg19_bnu"]

DEFAULT_CONV_LAYER = BcosConv2d
DEFAULT_NORM_LAYER = NoBias(BatchNormUncentered2d)

CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512,
          "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512,
          512, 512, 512, "M"],
}


class BcosVGG(nn.Module):
    with_logit_layer = True  # the logit layer is always inside

    def __init__(self, cfg: str = "A", num_classes: int = 1000, *,
                 conv_layer: Callable = DEFAULT_CONV_LAYER,
                 norm_layer: Optional[Callable] = DEFAULT_NORM_LAYER, no_pool: bool = False,
                 with_norm: bool = True, in_channels: int = 6,
                 logit_bias: Optional[float] = None,
                 logit_temperature: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.num_classes, self.no_pool = cfg, num_classes, no_pool
        self.with_norm = with_norm and norm_layer is not None
        kw = dict(device=device, generator=generator)
        entries = CFGS[cfg]
        self.plan: List[str] = []  # module names and "M" (a pool), in forward order
        c, idx = in_channels, 0
        for i, v in enumerate(entries):
            if v == "M":
                if not no_pool:
                    self.plan.append("M")
                continue
            stride = 2 if no_pool and i + 1 < len(entries) and entries[i + 1] == "M" else 1
            setattr(self, f"features_{idx}",
                    conv_layer(c, int(v), 3, padding=1, stride=stride, **kw))
            self.plan.append(f"features_{idx}")
            idx += 1
            if self.with_norm:
                setattr(self, f"features_{idx}", norm_layer(int(v), device=device))
                self.plan.append(f"features_{idx}")
                idx += 1
            c = int(v)
        self.classifier_0 = conv_layer(c, 4096, 7, padding=3, **kw)
        self.classifier_1 = conv_layer(4096, 4096, 1, **kw)
        self.classifier_2 = conv_layer(4096, num_classes, 1, **kw)
        bias = -math.log(num_classes - 1) if logit_bias is None else logit_bias
        self.logit_layer = LogitLayer(logit_temperature, bias)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        for name in self.plan:
            x = pooling.avg_pool2d(x, 2, 2) if name == "M" else getattr(self, name)(x, **f)
        for conv in (self.classifier_0, self.classifier_1, self.classifier_2):
            x = conv(x, **f)
        return self.logit_layer(pooling.global_avg_pool(x), **f)


def _entry(cfg, with_norm):
    def factory(**kwargs):
        return BcosVGG(cfg=cfg, with_norm=with_norm, **kwargs)

    return factory


vgg11 = _entry("A", False)
vgg11_bnu = _entry("A", True)
vgg13 = _entry("B", False)
vgg13_bnu = _entry("B", True)
vgg16 = _entry("D", False)
vgg16_bnu = _entry("D", True)
vgg19 = _entry("E", False)
vgg19_bnu = _entry("E", True)
