"""B-cos DenseNet (counterpart of ``bcosification_tpu/models/densenet.py``), NHWC.

The from-scratch B-cos DenseNet of the model zoo (the defaults: BcosConv2d,
the bias-free DetachablePositionNorm2d, Identity; the zoo adds the
LogitLayer) and the bcosified torchvision DenseNet: a 7x7/s2 stem with an
avg-pool stem pool (the recipe's standard change ``features[3]``; "max" is
torchvision's own), dense blocks of
pre-activation layers (norm1 -> act1 -> 1x1 conv1 -> norm2 -> act2 -> 3x3
conv2, the new features concatenated on the last axis), transitions
(norm -> act -> 1x1 conv -> 2x2 avg-pool), norm5 + act5 (torchvision's
final ReLU) and the classifier as a 1x1 conv before the global average pool
(``gap_reorder``).

Sub-module names mirror the JAX scopes (conv0, norm0,
denseblock{i}_denselayer{j}.{norm1,conv1,norm2,conv2},
transition{i}.{norm,conv}, norm5, classifier), so the JAX variables map onto
the state dict one to one (``bcosify/from_jax.py``). The concat is on the
channel axis of contiguous NHWC tensors, so the input of every 1x1 conv is
an [N*H*W, C] matrix with no copy: each 1x1 conv is a B-cos matmul (K3,
``ops.bcos.bcos_conv2d``). No norm or activation is folded into a conv, as
in the JAX DenseNet.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from bcosification_tpu_torch.models.resnet import (
    DEFAULT_ACT_LAYER,
    DEFAULT_CONV_LAYER,
    DEFAULT_NORM_LAYER,
)
from bcosification_tpu_torch.modules import LogitLayer
from bcosification_tpu_torch.ops import pooling

__all__ = ["BcosDenseNet", "DENSENET_CONFIGS", "densenet121", "densenet161",
           "densenet169", "densenet201"]


class _DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, bn_size: int, *, norm_layer,
                 conv_layer, act_layer, **kw):
        super().__init__()
        dev, width = kw.get("device"), bn_size * growth_rate
        self.norm1 = norm_layer(in_features, device=dev)
        self.act1 = act_layer()
        self.conv1 = conv_layer(in_features, width, 1, **kw)
        self.norm2 = norm_layer(width, device=dev)
        self.act2 = act_layer()
        self.conv2 = conv_layer(width, growth_rate, 3, padding=1, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = self.conv1(self.act1(self.norm1(x, **f), **f), **f)
        out = self.conv2(self.act2(self.norm2(out, **f), **f), **f)
        return torch.cat([x, out], dim=-1)


class _Transition(nn.Module):
    def __init__(self, in_features: int, out_features: int, *, norm_layer, conv_layer,
                 act_layer, **kw):
        super().__init__()
        self.norm = norm_layer(in_features, device=kw.get("device"))
        self.act = act_layer()
        self.conv = conv_layer(in_features, out_features, 1, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.conv(self.act(self.norm(x, **f), **f), **f)
        return pooling.avg_pool2d(x, 2, 2)


class BcosDenseNet(nn.Module):
    """``stem_pool``: "avg" (the bcosified recipe and the zoo), "max" (the
    plain torchvision stem) or None. ``small_inputs``: a 3x3 conv0 and no
    stem norm, activation or pool."""

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, num_classes: int = 1000, *,
                 norm_layer: Callable = DEFAULT_NORM_LAYER,
                 conv_layer: Callable = DEFAULT_CONV_LAYER,
                 act_layer: Callable = DEFAULT_ACT_LAYER,
                 fc_layer: Optional[Callable] = None, in_channels: int = 6,
                 stem_pool: Optional[str] = "avg", small_inputs: bool = False,
                 gap_reorder: bool = True, with_logit_layer: bool = False,
                 logit_bias: Optional[float] = None,
                 logit_temperature: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem_pool not in ("avg", "max", None):
            raise ValueError(f"stem_pool must be 'avg', 'max' or None, got {stem_pool!r}")
        self.growth_rate, self.block_config = growth_rate, tuple(block_config)
        self.num_init_features, self.bn_size = num_init_features, bn_size
        self.num_classes, self.stem_pool, self.small_inputs = num_classes, stem_pool, small_inputs
        self.gap_reorder, self.with_logit_layer = gap_reorder, with_logit_layer
        kw = dict(device=device, generator=generator)
        layers = dict(norm_layer=norm_layer, conv_layer=conv_layer, act_layer=act_layer)
        if small_inputs:
            self.conv0 = conv_layer(in_channels, num_init_features, 3, padding=1, **kw)
        else:
            self.conv0 = conv_layer(in_channels, num_init_features, 7, stride=2, padding=3, **kw)
            self.norm0 = norm_layer(num_init_features, device=device)
            self.act0 = act_layer()
        num_features = num_init_features
        for i, num_layers in enumerate(self.block_config):
            for j in range(num_layers):
                setattr(self, f"denseblock{i + 1}_denselayer{j + 1}", _DenseLayer(
                    num_features + j * growth_rate, growth_rate, bn_size, **layers, **kw))
            num_features += num_layers * growth_rate
            if i != len(self.block_config) - 1:
                setattr(self, f"transition{i + 1}", _Transition(
                    num_features, num_features // 2, **layers, **kw))
                num_features //= 2
        self.num_features = num_features
        self.norm5 = norm_layer(num_features, device=device)
        self.act5 = act_layer()  # torchvision's final ReLU
        self.classifier = (fc_layer or conv_layer)(num_features, num_classes, 1, **kw)
        if with_logit_layer:
            bias = -math.log(num_classes - 1) if logit_bias is None else logit_bias
            self.logit_layer = LogitLayer(logit_temperature, bias)

    def dense_layers(self, block: int):
        """The dense layers of block ``block`` (0-based), in forward order."""
        return [getattr(self, f"denseblock{block + 1}_denselayer{j + 1}")
                for j in range(self.block_config[block])]

    def transition(self, block: int):
        """The transition after block ``block`` (0-based), None after the last."""
        return getattr(self, f"transition{block + 1}", None)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.conv0(x, **f)
        if not self.small_inputs:
            x = self.act0(self.norm0(x, **f), **f)
            if self.stem_pool == "avg":
                x = pooling.avg_pool2d(x, 3, 2, 1)
            elif self.stem_pool == "max":
                x = pooling.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.block_config)):
            for layer in self.dense_layers(i):
                x = layer(x, **f)
            if self.transition(i) is not None:
                x = self.transition(i)(x, **f)
        x = self.act5(self.norm5(x, **f), **f)
        if self.gap_reorder:
            x = pooling.global_avg_pool(self.classifier(x, **f))
        else:
            x = self.classifier(pooling.global_avg_pool(x)[:, None, None, :], **f)[:, 0, 0, :]
        if self.with_logit_layer:
            x = self.logit_layer(x, **f)
        return x


def _entry(block_config, growth_rate=32, num_init_features=64):
    def factory(**kwargs):
        return BcosDenseNet(growth_rate, block_config, num_init_features, **kwargs)

    return factory


densenet121 = _entry((6, 12, 24, 16))
densenet161 = _entry((6, 12, 36, 24), growth_rate=48, num_init_features=96)
densenet169 = _entry((6, 12, 32, 32))
densenet201 = _entry((6, 12, 48, 32))

DENSENET_CONFIGS = {
    "densenet121": dict(growth_rate=32, block_config=(6, 12, 24, 16), num_init_features=64),
    "densenet161": dict(growth_rate=48, block_config=(6, 12, 36, 24), num_init_features=96),
    "densenet169": dict(growth_rate=32, block_config=(6, 12, 32, 32), num_init_features=64),
    "densenet201": dict(growth_rate=32, block_config=(6, 12, 48, 32), num_init_features=64),
}
