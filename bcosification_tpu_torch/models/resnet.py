"""B-cos ResNet (counterpart of ``bcosification_tpu/models/resnet.py``), NHWC.

Sub-module names mirror the JAX package's (conv1, bn1, layer{i}_{j} with
conv1..conv3, bn1..bn3, downsample_conv, downsample_norm, fc), so the JAX
variables map onto the state dict one to one (``bcosify/from_jax.py``).

``_conv_bn_act`` folds an eval-mode uncentered BN, the activation and the
block's skip-add into the conv's epilogue whenever the conv is a fusable
1x1 (conv1, conv3 and the downsample of a bottleneck): those run on the
hand-written kernel K1, whose backward is the explanation's (K2). An
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
    BatchNormUncentered2d,
    BcosConv2d,
    Identity,
    LogitLayer,
    ReLU,
)
from bcosification_tpu_torch.modules.bcos_layers import _fused_1x1_ok
from bcosification_tpu_torch.ops import pooling

__all__ = ["BasicBlock", "Bottleneck", "BcosResNet", "resnet18", "resnet50"]


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
        and isinstance(norm, BatchNormUncentered2d)
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


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, norm_layer, conv_layer, act_layer, **kw):
        super().__init__()
        dev = kw.get("device")
        self.conv1 = conv_layer(inplanes, planes, 3, stride=stride, padding=1, **kw)
        self.bn1 = norm_layer(planes, device=dev)
        self.act1 = act_layer()
        self._downsample(inplanes, planes, stride, has_downsample, conv_layer, norm_layer, kw)
        self.conv2 = conv_layer(planes, planes, 3, padding=1, **kw)
        self.bn2 = norm_layer(planes, device=dev)
        self.act_out = act_layer()

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = _conv_bn_act(self.conv1, self.bn1, self.act1, x, f)
        identity = self._identity(x, f)
        return _conv_bn_act(self.conv2, self.bn2, None, out, f, residual=identity,
                            post_act=self.act_out)


class Bottleneck(_Block):
    """ResNet V1.5: the stride sits on the 3x3."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, norm_layer, conv_layer, act_layer, **kw):
        super().__init__()
        dev = kw.get("device")
        width = planes
        self.conv1 = conv_layer(inplanes, width, 1, **kw)
        self.bn1 = norm_layer(width, device=dev)
        self.act1 = act_layer()
        self.conv2 = conv_layer(width, width, 3, stride=stride, padding=1, **kw)
        self.bn2 = norm_layer(width, device=dev)
        self.act2 = act_layer()
        self._downsample(inplanes, planes * 4, stride, has_downsample, conv_layer,
                         norm_layer, kw)
        self.conv3 = conv_layer(width, planes * 4, 1, **kw)
        self.bn3 = norm_layer(planes * 4, device=dev)
        self.act_out = act_layer()

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = _conv_bn_act(self.conv1, self.bn1, self.act1, x, f)
        out = _conv_bn_act(self.conv2, self.bn2, self.act2, out, f)
        identity = self._identity(x, f)
        return _conv_bn_act(self.conv3, self.bn3, None, out, f, residual=identity,
                            post_act=self.act_out)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class BcosResNet(nn.Module):
    """The bcosified torchvision ResNet: 7x7/s2 stem, avg-pool stem pool,
    four stages, the classifier as a 1x1 B-cos conv before the global
    average pool (``gap_reorder``), optional built-in LogitLayer. Grouped
    and wide variants (ResNeXt, wide_resnet) are not ported yet."""

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2), *,
                 num_classes: int = 1000, norm_layer: Callable, conv_layer: Callable,
                 act_layer: Callable = Identity, fc_layer: Optional[Callable] = None,
                 inplanes: int = 64, in_channels: int = 6, stem_pool: Optional[str] = "avg",
                 gap_reorder: bool = True, with_logit_layer: bool = True,
                 logit_bias: Optional[float] = None,
                 logit_temperature: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block, self.layers, self.num_classes = block, tuple(layers), num_classes
        self.inplanes, self.stem_pool, self.gap_reorder = inplanes, stem_pool, gap_reorder
        self.with_logit_layer = with_logit_layer
        kw = dict(device=device, generator=generator)
        self.conv1 = conv_layer(in_channels, inplanes, 7, stride=2, padding=3, **kw)
        self.bn1 = norm_layer(inplanes, device=device)
        self.act = act_layer()
        block_cls = _BLOCKS[block]
        for stage, j, planes, stride, has_ds in self.block_cfgs():
            cin = self.block_in(stage, j)
            setattr(self, f"layer{stage + 1}_{j}", block_cls(
                cin, planes, stride, has_ds, norm_layer=norm_layer,
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
        if self.stem_pool == "avg":
            x = pooling.avg_pool2d(x, 3, 2, 1)
        elif self.stem_pool is not None:
            raise ValueError(f"stem_pool {self.stem_pool!r} is not ported")
        for blk in self.blocks():
            x = blk(x, **f)
        if self.gap_reorder:
            x = pooling.global_avg_pool(self.fc(x, **f))
        else:
            x = self.fc(pooling.global_avg_pool(x)[:, None, None, :], **f)[:, 0, 0, :]
        if self.with_logit_layer:
            x = self.logit_layer(x, **f)
        return x


def _entry(block, layers):
    def factory(**kwargs):
        return BcosResNet(block, layers, **kwargs)

    return factory


resnet18 = _entry("basic", (2, 2, 2, 2))
resnet50 = _entry("bottleneck", (3, 4, 6, 3))
