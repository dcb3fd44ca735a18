"""B-cos layers as ``nn.Module``s on NHWC activations (counterpart of
``bcosification_tpu/modules/bcos_layers.py``).

Weights are ``weight`` [out, in, kh, kw] (OIHW); the JAX HWIO arrays map
onto them by a transpose. Modules take the port's call convention
``(x, *, train=False, explain=False)``; ``explain`` is the reference's
``detach`` flag.

The epilogue hook (``epilogue=(mult, add, relu[, residual])``, from a norm's
``return_affine``) folds an eval-mode norm, a ReLU and a skip branch into
the conv. On the port every fusable 1x1 shape (b=2, groups=1, max_out=1,
no conv bias, any stride) goes to the hand-written kernel
(``ops/cuda/bcos_conv1x1.py``); anything else computes the plain B-cos
conv and applies the affine, the residual and the ReLU after it.

Linear weights are (in, out), the JAX layout (x @ w), so the JAX variables
copy as they are. ``BcosLinear`` is the B-cos linear with unit-norm weight
columns, ``BcosifyLinear`` the conversion-time one on raw weights (a
bias-free b=2 one of either runs on the B-cos matmul kernel,
``ops.bcos_linear``; BcosLinear hands it the normalised weight);
``PlainLinear`` is nn.Linear in that layout. ``NormedConv2d`` and
``NormedLinear`` are plain (not B-cos) layers with unit-norm weights, an
optional learned per-output scale and a bias; ``PlainConv2d`` is the
NormedConv2d without the weight norm and with a bias (the standard
baselines' ViT-C stem). ``BcosConv2dWithScale`` is the v1 B-cos conv whose
output is divided by a static scale. BcosifyLinear and PlainLinear take
``weight_only``: the weight alone, no bias and no dynamic scale (the pooled
CLIP attention head applies its projections so).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import guided
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import bcos_conv1x1_bn_act

__all__ = ["BcosConv2d", "BcosConv2dWithScale", "BcosifyConv2d", "BcosLinear", "BcosifyLinear",
           "LogitLayer", "NormedConv2d", "NormedLinear", "PlainConv2d", "PlainLinear"]


class _ConvBase(nn.Module):
    """Holds an OIHW weight (and optional bias) initialised like torch's
    nn.Conv2d: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), from ``generator``."""

    def __init__(self, in_channels: int, features: int, kernel_size=1, stride=1,
                 padding=0, dilation=1, groups: int = 1, max_out: int = 1,
                 use_bias: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} not divisible by groups {groups}")
        self.in_channels, self.features = in_channels, features
        self.kernel_size = ops._pair(kernel_size)
        self.stride, self.padding = ops._pair(stride), ops._pair(padding)
        self.dilation, self.groups, self.max_out = ops._pair(dilation), groups, max_out
        kh, kw = self.kernel_size
        shape = (features * max_out, in_channels // groups, kh, kw)
        bound = 1.0 / math.sqrt(shape[1] * kh * kw)
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = (nn.Parameter(torch.empty(features * max_out, device=device))
                     if use_bias else None)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)


def _fused_1x1_ok(mod: _ConvBase, b, bias) -> bool:
    """Shape/config gate for the fused 1x1 conv+BN+act kernel."""
    return (
        isinstance(b, (int, float)) and b == 2
        and mod.kernel_size == (1, 1)
        and mod.padding == (0, 0)
        and mod.stride[0] == mod.stride[1]
        and mod.groups == 1
        and mod.max_out == 1
        and bias is None
    )


def _epilogue_result(mod, x, w, bias, b, explain, x_sumsq, epilogue):
    """Conv with a folded (mult, add, relu[, residual]) epilogue. With a
    residual the ReLU is post-add, so it is applied after the skip-add."""
    mult, add, relu, *rest = epilogue
    residual = rest[0] if rest else None
    out = _epilogue_no_residual(mod, x, w, bias, b, explain, x_sumsq,
                                (mult, add, relu if residual is None else False))
    if residual is not None:
        out = out + residual
        if relu:
            out = guided.relu(out)
    return out


def _epilogue_no_residual(mod, x, w, bias, b, explain, x_sumsq, epilogue):
    mult, add, relu = epilogue
    # K1's backward (K2) has the plain ReLU mask built in: under guided
    # backprop or DeepLIFT the conv runs unfused and its ReLU through
    # ops.guided, as the JAX package keeps such convs off its Pallas kernel.
    # K1 reads one mult per output channel: a norm with one statistic for
    # the whole tensor (AllNormUncentered2d) gives a (1,) mult, which the
    # unfused route broadcasts
    if (_fused_1x1_ok(mod, b, bias) and mult.numel() == w.shape[0]
            and not (guided.guided_mode() or guided.deeplift_mode())):
        # [Cin, Cout] view of the OIHW weight (its transpose is contiguous)
        w2 = w.view(w.shape[0], w.shape[1]).t()
        return bcos_conv1x1_bn_act(x, w2, mult, add, relu=relu, explain=explain,
                                   stride=mod.stride[0])
    out = ops.bcos_conv2d(
        x, w, b=b, stride=mod.stride, padding=mod.padding, dilation=mod.dilation,
        groups=mod.groups, max_out=mod.max_out, normalize_weights=False, bias=bias,
        explain=explain, x_sumsq=x_sumsq,
    )
    out = out * mult.to(out.dtype)
    if add is not None:
        out = out + add.to(out.dtype)
    if relu:
        out = guided.relu(out)
    return out


class BcosConv2d(_ConvBase):
    """The B-cos conv: unit-norm weights, output scaled by |cos(x, w_hat)|^(b-1)."""

    normalize_weights = True

    def __init__(self, in_channels: int, features: int, kernel_size=1, *, b: float = 2.0,
                 **kwargs):
        super().__init__(in_channels, features, kernel_size, **kwargs)
        self.b = b

    def effective_weight(self) -> torch.Tensor:
        return ops.normed_conv_weight(self.weight) if self.normalize_weights else self.weight

    def forward(self, x, *, train: bool = False, explain: bool = False,
                x_sumsq: Optional[torch.Tensor] = None, epilogue=None):
        if epilogue is not None:
            return _epilogue_result(self, x, self.effective_weight(), self.bias, self.b,
                                    explain, x_sumsq, epilogue)
        return ops.bcos_conv2d(
            x, self.weight, b=self.b, stride=self.stride, padding=self.padding,
            dilation=self.dilation, groups=self.groups, max_out=self.max_out,
            normalize_weights=self.normalize_weights, bias=self.bias, explain=explain,
            x_sumsq=x_sumsq,
        )


class NormedConv2d(_ConvBase):
    """Plain (not B-cos) conv with unit-norm weights per output channel;
    ``learned_scale`` adds a per-output-channel ``scale`` (ones) that
    multiplies the normalised weight, ``use_weight_norm=False`` takes the
    raw weight (and ignores the scale). No bias unless ``use_bias``."""

    def __init__(self, in_channels: int, features: int, kernel_size=1, *,
                 use_weight_norm: bool = True, learned_scale: bool = False, **kwargs):
        super().__init__(in_channels, features, kernel_size, **kwargs)
        self.use_weight_norm = use_weight_norm
        self.scale = (nn.Parameter(torch.ones(features * self.max_out,
                                              device=kwargs.get("device")))
                      if learned_scale else None)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return ops.normed_conv2d(
            x, self.weight, stride=self.stride, padding=self.padding, dilation=self.dilation,
            groups=self.groups, scale=self.scale if self.use_weight_norm else None,
            bias=self.bias, use_weight_norm=self.use_weight_norm)


class PlainConv2d(NormedConv2d):
    """Plain biased conv of an NHWC input: ``NormedConv2d(use_weight_norm=False,
    use_bias=True)``."""

    def __init__(self, in_channels: int, features: int, kernel_size=1, **kwargs):
        super().__init__(in_channels, features, kernel_size, use_weight_norm=False,
                         use_bias=True, **kwargs)


class BcosConv2dWithScale(_ConvBase):
    """The deprecated v1 B-cos conv (unit-norm weights, fixed b): the output
    divided by a static scale, ``scale`` if given, else
    sqrt(kh * kw * in_channels) / ``scale_factor``. Not a BcosConv2d: no
    norm folds into it and no hand-scheduled pass takes it."""

    def __init__(self, in_channels: int, features: int, kernel_size=1, *, b: float = 2.0,
                 scale: Optional[float] = None, scale_factor: float = 100.0, **kwargs):
        super().__init__(in_channels, features, kernel_size, **kwargs)
        kh, kw = self.kernel_size
        self.b = b
        self.scale = (math.sqrt(kh * kw * in_channels) / scale_factor if scale is None
                      else scale)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        out = ops.bcos_conv2d(
            x, self.weight, b=self.b, stride=self.stride, padding=self.padding,
            dilation=self.dilation, groups=self.groups, max_out=self.max_out,
            bias=self.bias, explain=explain)
        return out / self.scale


class BcosifyConv2d(BcosConv2d):
    """Conversion-time B-cos conv: the raw (pretrained) weights are not
    unit-normalised. Only a fixed b is ported; learnable b comes with
    training."""

    normalize_weights = False


class _LinearBase(nn.Module):
    """Holds an (in, out) weight and optional bias, both initialised
    U(-1/sqrt(in), 1/sqrt(in)) from ``generator``, as the JAX layers."""

    weight_unit_axis = -1  # the output units are the weight's last axis (training/agc.py)

    def __init__(self, in_features: int, features: int, use_bias: bool, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.features = in_features, features
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty((in_features, features), device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)


class PlainLinear(_LinearBase):
    """nn.Linear with an (in, out) weight; ``weight_only`` skips the bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, **kwargs):
        super().__init__(in_features, features, use_bias, **kwargs)

    def forward(self, x, *, train: bool = False, explain: bool = False,
                weight_only: bool = False):
        out = x @ self.weight.to(x.dtype)
        if self.bias is not None and not weight_only:
            out = out + self.bias
        return out


class NormedLinear(_LinearBase):
    """Plain (not B-cos) linear with unit-norm (in, out) weight columns;
    ``learned_scale`` adds a per-output ``scale`` (ones), ``use_weight_norm=False``
    takes the raw weight. A bias unless ``use_bias=False``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, *,
                 use_weight_norm: bool = True, learned_scale: bool = False, **kwargs):
        super().__init__(in_features, features, use_bias, **kwargs)
        self.use_weight_norm = use_weight_norm
        self.scale = (nn.Parameter(torch.ones(features, device=kwargs.get("device")))
                      if learned_scale else None)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return ops.normed_linear(x, self.weight, bias=self.bias,
                                 scale=self.scale if self.use_weight_norm else None,
                                 use_weight_norm=self.use_weight_norm)


class BcosLinear(_LinearBase):
    """The B-cos linear: unit-norm weight columns (``ops.normed_linear_weight``),
    the output scaled by |cos(x, w_hat)|^(b-1). A bias-free b=2 one runs on
    K3, which gets the normalised weight; autograd carries the weight's
    gradient back through the normalisation."""

    normalize_weights = True

    def __init__(self, in_features: int, features: int, *, b: float = 2.0, max_out: int = 1,
                 use_bias: bool = False, **kwargs):
        super().__init__(in_features, features * max_out, use_bias, **kwargs)
        self.b, self.max_out = b, max_out

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return ops.bcos_linear(x, self.weight, b=self.b, max_out=self.max_out,
                               normalize_weights=self.normalize_weights, bias=self.bias,
                               explain=explain)


class BcosifyLinear(BcosLinear):
    """Conversion-time B-cos linear: raw (pretrained) weights, fixed b.
    ``weight_only`` applies the weight plainly: no bias, no dynamic scale."""

    normalize_weights = False

    def forward(self, x, *, train: bool = False, explain: bool = False,
                weight_only: bool = False):
        if weight_only:
            return x @ self.weight.to(x.dtype)
        return super().forward(x, train=train, explain=explain)


class LogitLayer(nn.Module):
    """Static temperature and bias on the logits; B-cos nets use the bias
    -log(num_classes - 1)."""

    def __init__(self, logit_temperature: Optional[float] = None,
                 logit_bias: Optional[float] = None):
        super().__init__()
        self.logit_temperature, self.logit_bias = logit_temperature, logit_bias

    def forward(self, x, *, train: bool = False, explain: bool = False):
        if self.logit_temperature is not None:
            x = x / self.logit_temperature
        if self.logit_bias is not None:
            x = x + self.logit_bias
        return x
