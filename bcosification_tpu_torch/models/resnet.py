"""B-cos ResNet / ResNeXt (counterpart of ``bcosification_tpu/models/resnet.py``), NHWC.

One class covers both of the JAX package's variants: the from-scratch B-cos
ResNet of the model zoo (the defaults: BcosConv2d, the bias-free
DetachablePositionNorm2d, Identity activations, the in-model LogitLayer;
``groups``/``width_per_group`` give ResNeXt and the wide ResNet) and the
bcosified torchvision ResNet (``bcosify/engine.py``: BcosifyConv2d,
uncentered BN, ReLU, inside a BcosifyNetwork).

Sub-module names mirror the JAX package's (conv1, bn1, layer{i}_{j} with
conv1..conv3, bn1..bn3, downsample_conv, downsample_norm, fc), so the JAX
variables map onto the state dict one to one (``bcosify/from_jax.py``).

``_conv_bn_act`` folds an eval-mode uncentered BN, the activation and the
block's skip-add into the conv's epilogue whenever the conv is a fusable
1x1 (conv1, conv3 and the downsample of a bottleneck): those run on the
hand-written kernel K1, whose backward is the explanation's (K2); an
uncentered AllNorm folds too, but its scalar mult keeps the conv off K1
(``bcos_layers._epilogue_no_residual``). An
eval-mode forward without ``explain`` whose gradient autograd will need
(an input gradient, or one of the weights) runs unfused instead, as the
JAX package's jnp path does: conv (K3 at stride 1, cuDNN at stride 2) ->
norm -> act, each with its own backward; ``_conv_bn_act.grad_route``
counts those convs. The k x k convs stay conv -> norm -> act.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from bcosification_tpu_torch.modules import (
    BcosConv2d,
    DetachablePositionNorm2d,
    Identity,
    LogitLayer,
    NoBias,
    ReLU,
)
from bcosification_tpu_torch.modules.bcos_layers import _fused_1x1_ok
from bcosification_tpu_torch.modules.norms import _RunningVarNorm
from bcosification_tpu_torch.modules.stochastic_depth import StochasticDepth
from bcosification_tpu_torch.ops import pooling

__all__ = ["BasicBlock", "Bottleneck", "BcosResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "wide_resnet50_2",
           "DEFAULT_NORM_LAYER", "DEFAULT_CONV_LAYER", "DEFAULT_ACT_LAYER"]

# the from-scratch B-cos zoo's layers (the JAX package's defaults)
DEFAULT_NORM_LAYER = NoBias(DetachablePositionNorm2d)
DEFAULT_CONV_LAYER = BcosConv2d
DEFAULT_ACT_LAYER = Identity


def _needs_grad(x, *modules) -> bool:
    """True when autograd will want a gradient through this conv: grad mode
    is on and x or a parameter of ``modules`` requires one."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for m in modules for p in m.parameters()))


def _conv_bn_act(conv, norm, act, x, f, residual=None, post_act=None):
    """conv -> norm -> act [-> + residual -> post_act], folded into the fused
    kernel when the conv is an eligible 1x1, the norm is eval-mode BN, and
    either ``explain`` is set or no gradient is needed (the fused kernel's
    backward is the explanation's only)."""
    assert act is None or post_act is None
    relu = isinstance(act, ReLU) or isinstance(post_act, ReLU)
    if (
        not f["train"]
        and isinstance(conv, BcosConv2d)
        and _fused_1x1_ok(conv, conv.b, conv.bias)
        and isinstance(norm, _RunningVarNorm)
        and (act is None or isinstance(act, (ReLU, Identity)))
        and (post_act is None or isinstance(post_act, (ReLU, Identity)))
    ):
        if f["explain"] or not _needs_grad(x, conv, norm):
            mult, add = norm(None, return_affine=True)
            return conv(x, **f, epilogue=(mult, add, relu, residual))
        _conv_bn_act.grad_route += 1
    out = norm(conv(x, **f), **f)
    if act is not None:
        out = act(out, **f)
    if residual is not None:
        out = out + residual
    if post_act is not None:
        out = post_act(out, **f)
    return out


_conv_bn_act.grad_route = 0  # eligible 1x1 convs run unfused because a gradient is needed


class _Block(nn.Module):
    def _downsample(self, inplanes, planes_out, stride, has_downsample, conv_layer,
                    norm_layer, kw):
        if has_downsample:
            self.downsample_conv = conv_layer(inplanes, planes_out, 1, stride=stride, **kw)
            self.downsample_norm = norm_layer(planes_out, device=kw.get("device"))

    def _identity(self, x, f):
        if not hasattr(self, "downsample_conv"):
            return x
        return _conv_bn_act(self.downsample_conv, self.downsample_norm, None, x, f)

    def _tail(self, conv, norm, out, identity, f):
        """conv -> norm -> + identity -> act_out; with stochastic depth the
        dropped branch is added to the identity before act_out."""
        if not hasattr(self, "sd"):
            return _conv_bn_act(conv, norm, None, out, f, residual=identity,
                                post_act=self.act_out)
        out = self.sd(_conv_bn_act(conv, norm, None, out, f), **f)
        return self.act_out(out + identity, **f)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, groups: int = 1, base_width: int = 64,
                 stochastic_depth_prob: float = 0.0, norm_layer, conv_layer, act_layer, **kw):
        super().__init__()
        dev = kw.get("device")
        self.conv1 = conv_layer(inplanes, planes, 3, stride=stride, padding=1, groups=groups,
                                **kw)
        self.bn1 = norm_layer(planes, device=dev)
        self.act1 = act_layer()
        self._downsample(inplanes, planes, stride, has_downsample, conv_layer, norm_layer, kw)
        self.conv2 = conv_layer(planes, planes, 3, padding=1, **kw)
        self.bn2 = norm_layer(planes, device=dev)
        self.act_out = act_layer()
        if stochastic_depth_prob:
            self.sd = StochasticDepth(stochastic_depth_prob, "row")

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = _conv_bn_act(self.conv1, self.bn1, self.act1, x, f)
        identity = self._identity(x, f)
        return self._tail(self.conv2, self.bn2, out, identity, f)


class Bottleneck(_Block):
    """ResNet V1.5: the stride sits on the 3x3, which is grouped in ResNeXt
    (width = planes * width_per_group / 64 * groups)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, groups: int = 1, base_width: int = 64,
                 stochastic_depth_prob: float = 0.0, norm_layer, conv_layer, act_layer, **kw):
        super().__init__()
        dev = kw.get("device")
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv_layer(inplanes, width, 1, **kw)
        self.bn1 = norm_layer(width, device=dev)
        self.act1 = act_layer()
        self.conv2 = conv_layer(width, width, 3, stride=stride, padding=1, groups=groups, **kw)
        self.bn2 = norm_layer(width, device=dev)
        self.act2 = act_layer()
        self._downsample(inplanes, planes * 4, stride, has_downsample, conv_layer,
                         norm_layer, kw)
        self.conv3 = conv_layer(width, planes * 4, 1, **kw)
        self.bn3 = norm_layer(planes * 4, device=dev)
        self.act_out = act_layer()
        if stochastic_depth_prob:
            self.sd = StochasticDepth(stochastic_depth_prob, "row")

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = _conv_bn_act(self.conv1, self.bn1, self.act1, x, f)
        out = _conv_bn_act(self.conv2, self.bn2, self.act2, out, f)
        identity = self._identity(x, f)
        return self._tail(self.conv3, self.bn3, out, identity, f)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class BcosResNet(nn.Module):
    """7x7/s2 stem (``small_inputs``: 3x3/s1, no pool), the stem pool
    ("avg", "max" or None), four stages, the classifier as a 1x1 conv
    before the global average pool (``gap_reorder``; after it otherwise),
    optional built-in LogitLayer (bias -log(num_classes - 1) unless
    ``logit_bias``). ``stochastic_depth_prob`` grows linearly from 0 at the
    first block to its value at the last."""

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2), *,
                 num_classes: int = 1000, groups: int = 1, width_per_group: int = 64,
                 norm_layer: Callable = DEFAULT_NORM_LAYER,
                 conv_layer: Callable = DEFAULT_CONV_LAYER,
                 act_layer: Callable = DEFAULT_ACT_LAYER, fc_layer: Optional[Callable] = None,
                 inplanes: int = 64, in_channels: int = 6, small_inputs: bool = False,
                 stem_pool: Optional[str] = "avg", stochastic_depth_prob: float = 0.0,
                 gap_reorder: bool = True, with_logit_layer: bool = True,
                 logit_bias: Optional[float] = None,
                 logit_temperature: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem_pool not in ("avg", "max", None):
            raise ValueError(f"stem_pool must be 'avg', 'max' or None, got {stem_pool!r}")
        self.block, self.layers, self.num_classes = block, tuple(layers), num_classes
        self.groups, self.width_per_group = groups, width_per_group
        self.inplanes, self.stem_pool, self.gap_reorder = inplanes, stem_pool, gap_reorder
        self.small_inputs, self.with_logit_layer = small_inputs, with_logit_layer
        kw = dict(device=device, generator=generator)
        if small_inputs:
            self.conv1 = conv_layer(in_channels, inplanes, 3, padding=1, **kw)
        else:
            self.conv1 = conv_layer(in_channels, inplanes, 7, stride=2, padding=3, **kw)
        self.bn1 = norm_layer(inplanes, device=device)
        self.act = act_layer()
        block_cls = _BLOCKS[block]
        cfgs = self.block_cfgs()
        for i, (stage, j, planes, stride, has_ds) in enumerate(cfgs):
            sd = (stochastic_depth_prob * i / max(len(cfgs) - 1, 1)
                  if stochastic_depth_prob else 0.0)
            setattr(self, f"layer{stage + 1}_{j}", block_cls(
                self.block_in(stage, j), planes, stride, has_ds, groups=groups,
                base_width=width_per_group, stochastic_depth_prob=sd, norm_layer=norm_layer,
                conv_layer=conv_layer, act_layer=act_layer, **kw,
            ))
        num_features = self.block_in(len(self.layers), 0)
        self.fc = (fc_layer or conv_layer)(num_features, num_classes, 1, **kw)
        if with_logit_layer:
            bias = -math.log(num_classes - 1) if logit_bias is None else logit_bias
            self.logit_layer = LogitLayer(logit_temperature, bias)

    def block_in(self, stage: int, j: int) -> int:
        """Input channels of block j of a stage (stage == len(layers): the fc)."""
        expansion = _BLOCKS[self.block].expansion
        if stage == 0 and j == 0:
            return self.inplanes
        if j == 0:
            return self.inplanes * 2 ** (stage - 1) * expansion
        return self.inplanes * 2 ** stage * expansion

    def block_cfgs(self):
        """Per-block (stage, j, planes, stride, has_downsample)."""
        expansion = _BLOCKS[self.block].expansion
        cfgs = []
        for stage, num_blocks in enumerate(self.layers):
            planes = self.inplanes * 2 ** stage
            for j in range(num_blocks):
                stride = 2 if (stage > 0 and j == 0) else 1
                has_ds = stride != 1 or self.block_in(stage, j) != planes * expansion
                cfgs.append((stage, j, planes, stride, has_ds))
        return cfgs

    def blocks(self):
        return [getattr(self, f"layer{s + 1}_{j}") for s, j, *_ in self.block_cfgs()]

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.act(self.bn1(self.conv1(x, **f), **f), **f)
        if not self.small_inputs and self.stem_pool == "avg":
            x = pooling.avg_pool2d(x, 3, 2, 1)
        elif not self.small_inputs and self.stem_pool == "max":
            x = pooling.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks():
            x = blk(x, **f)
        if self.gap_reorder:
            x = pooling.global_avg_pool(self.fc(x, **f))
        else:
            x = self.fc(pooling.global_avg_pool(x)[:, None, None, :], **f)[:, 0, 0, :]
        if self.with_logit_layer:
            x = self.logit_layer(x, **f)
        return x


def _entry(block, layers, **defaults):
    def factory(**kwargs):
        return BcosResNet(block, layers, **{**defaults, **kwargs})

    return factory


resnet18 = _entry("basic", (2, 2, 2, 2))
resnet34 = _entry("basic", (3, 4, 6, 3))
resnet50 = _entry("bottleneck", (3, 4, 6, 3))
resnet101 = _entry("bottleneck", (3, 4, 23, 3))
resnet152 = _entry("bottleneck", (3, 8, 36, 3))
resnext50_32x4d = _entry("bottleneck", (3, 4, 6, 3), groups=32, width_per_group=4)
wide_resnet50_2 = _entry("bottleneck", (3, 4, 6, 3), width_per_group=128)
