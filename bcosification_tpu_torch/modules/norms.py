"""Norms of the port (counterpart of ``bcosification_tpu/modules/norms.py``):
the uncentered BatchNorm of the CNNs, the transformer's LayerNorm and the
group norms of the ViT-C conv stem.

``BatchNormUncentered2d`` divides by a std and never subtracts a mean.
Channels are the last axis (NHWC).

- Eval: the running std. The norm is then a per-channel affine, which
  ``return_affine`` hands to a fused conv epilogue as (mult, add) =
  (weight/std, bias).
- Train: the biased batch variance over (N, H, W), one pass in f32
  (``max(E[x^2] - E[x]^2, 0)``, not torch's unbiased estimate), and
  ``running_var = 0.9 running_var + 0.1 var`` with ``var`` detached, updated
  in place. With ``explain`` the std is detached as well.

``DetachableLayerNorm`` normalises the last axis and detaches its variance
under ``explain``; ``DetachablePositionNorm2d``, the from-scratch CNN zoo's
norm, is the same LayerNorm over the channels of each pixel of an NHWC
image. ``DetachableGroupNorm2d`` normalises each group of
channels of an NHWC image over (H, W, the group's channels), centered, in
f32, and detaches only its variance under ``explain``;
``DetachableGNLayerNorm2d`` is its one-group case (the ViT-C stem's norm),
``DetachableGNInstanceNorm2d`` its one-channel-per-group case. ``NoBias``
and ``Unaffine`` preset a norm's flags and name the factory as the JAX
package's do (the configs show the name).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

__all__ = [
    "BatchNormUncentered2d",
    "DetachableGNInstanceNorm2d",
    "DetachableGNLayerNorm2d",
    "DetachableGroupNorm2d",
    "DetachableLayerNorm",
    "DetachablePositionNorm2d",
    "NoBias",
    "PlainLayerNorm",
    "Unaffine",
]

MOMENTUM = 0.1  # weight of the batch variance in the running-var update


class BatchNormUncentered2d(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 use_weight: bool = True, use_bias: bool = True, *, device=None):
        super().__init__()
        self.features, self.eps = features, eps
        self.weight = (nn.Parameter(torch.ones(features, device=device))
                       if affine and use_weight else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if affine and use_bias else None)
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int32, device=device))

    def std(self) -> torch.Tensor:
        return torch.sqrt(self.running_var + self.eps)

    def batch_var(self, x: torch.Tensor) -> torch.Tensor:
        """Biased per-channel variance of x over (N, H, W), one pass in f32,
        and the running-var update (in place, under no_grad)."""
        xs = x.float()
        n = x.numel() // x.shape[-1]
        mean = xs.sum(dim=(0, 1, 2)) / n
        var = torch.clamp((xs * xs).sum(dim=(0, 1, 2)) / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_var.copy_((1 - MOMENTUM) * self.running_var
                                   + MOMENTUM * var.detach())
            self.num_batches_tracked.add_(1)
        return var

    def forward(self, x, *, train: bool = False, explain: bool = False,
                return_affine: bool = False):
        if return_affine:
            if train:
                raise ValueError("return_affine is an eval-only fusion hook")
            mult = 1.0 / self.std()
            if self.weight is not None:
                mult = mult * self.weight
            return mult, self.bias
        if train:
            std = torch.sqrt(self.batch_var(x.detach() if explain else x) + self.eps)
            if explain:
                std = std.detach()
        else:
            std = self.std()
        out = x / std.to(x.dtype)
        if self.weight is not None:
            out = out * self.weight
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)


class DetachableLayerNorm(nn.Module):
    """LayerNorm over the last axis, the transformer's norm: the statistics
    in f32, the output cast back to x's dtype. With ``explain`` the
    variance is detached (the mean is not), so the norm is linear in x.
    ``detachable=False`` is the plain nn.LayerNorm of the standard ViT
    configs: the same forward, no detach."""

    def __init__(self, features: int, eps: float = 1e-5, use_weight: bool = True,
                 use_bias: bool = True, detachable: bool = True, *, device=None):
        super().__init__()
        self.features, self.eps, self.detachable = features, eps, detachable
        self.weight = nn.Parameter(torch.ones(features, device=device)) if use_weight else None
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def normalize(self, x, *, explain: bool = False):
        """(the output, the f32 std sqrt(var + eps) it divided by)."""
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        if explain and self.detachable:
            var = var.detach()
        std = torch.sqrt(var + self.eps)
        out = (xf - mean) / std
        if self.weight is not None:
            out = out * self.weight
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype), std

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return self.normalize(x, explain=explain)[0]


class DetachablePositionNorm2d(DetachableLayerNorm):
    """Centered position norm: the LayerNorm over the channel axis of each
    pixel of an NHWC image (mean and population variance in f32, eps inside
    the sqrt, the variance detached under ``explain``)."""

    def forward(self, x, *, train: bool = False, explain: bool = False):
        if x.dim() != 4:
            raise ValueError(f"expected an NHWC image, got shape {tuple(x.shape)}")
        return self.normalize(x, explain=explain)[0]


def PlainLayerNorm(features: int, **kwargs):
    """The plain nn.LayerNorm of the standard ViT configs: no detach."""
    return DetachableLayerNorm(features, detachable=False, **kwargs)


class DetachableGroupNorm2d(nn.Module):
    """Centered group norm of an NHWC image: the statistics of each group
    of channels over (H, W, the group's channels), in f32; the normalised
    image is cast to x's dtype before the (c,) f32 affine, and the result
    cast back, as in the JAX package. With ``explain`` only the variance is
    detached (the mean is linear in x)."""

    def __init__(self, features: int, num_groups: int = 32, eps: float = 1e-5,
                 use_weight: bool = True, use_bias: bool = True, *, device=None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{features} channels do not split into {num_groups} groups")
        self.features, self.num_groups, self.eps = features, num_groups, eps
        self.weight = nn.Parameter(torch.ones(features, device=device)) if use_weight else None
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def normalize(self, x, *, explain: bool = False):
        """(the output, the f32 std sqrt(var + eps) [N, 1, 1, G, 1] it
        divided by)."""
        n, h, w, c = x.shape
        g = self.num_groups
        xg = x.reshape(n, h, w, g, c // g).float()
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
        if explain:
            var = var.detach()
        std = torch.sqrt(var + self.eps)
        out = ((xg - mean) / std).reshape(n, h, w, c).to(x.dtype)
        if self.weight is not None:
            out = out * self.weight
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype), std

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return self.normalize(x, explain=explain)[0]


def DetachableGNInstanceNorm2d(features: int, **kwargs):
    """The group norm with one channel per group."""
    return DetachableGroupNorm2d(features, num_groups=features, **kwargs)


def DetachableGNLayerNorm2d(features: int, **kwargs):
    """The group norm with one group: the ViT-C conv stem's norm."""
    return DetachableGroupNorm2d(features, num_groups=1, **kwargs)


def _preset(make_layer, suffix: str, **flags):
    new = functools.partial(make_layer, **flags)
    functools.update_wrapper(new, make_layer, updated=())
    new.__name__ = getattr(make_layer, "__name__", "layer") + suffix
    return new


def NoBias(make_layer):
    """Layer factory wrapper that disables the bias term."""
    return _preset(make_layer, "NoBias", use_bias=False)


def Unaffine(make_layer):
    """Layer factory wrapper that disables both weight and bias."""
    return _preset(make_layer, "Unaffine", use_bias=False, use_weight=False)
