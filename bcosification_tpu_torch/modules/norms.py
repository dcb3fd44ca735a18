"""Norms of the port (counterpart of ``bcosification_tpu/modules/norms.py``):
the uncentered BatchNorm of the CNNs, the transformer's LayerNorm, the
group norms of the ViT-C conv stem, and the norms no zoo entry uses.

``BatchNormUncentered2d`` divides by a std and never subtracts a mean.
Channels are the last axis (NHWC). ``AllNormUncentered2d`` is the same
with one variance over the whole tensor (running_var of shape (1,)).

- Eval: the running std. The norm is then a per-channel affine, which
  ``return_affine`` hands to a fused conv epilogue as (mult, add) =
  (weight/std, bias).
- Train: the biased batch variance over (N, H, W), one pass in f32
  (``max(E[x^2] - E[x]^2, 0)``, not torch's unbiased estimate), and
  ``running_var = 0.9 running_var + 0.1 var`` with ``var`` detached, updated
  in place. With ``explain`` the std is detached as well.
- Under a process group (``parallel/dp.py``) every
  batch-statistics norm (these and the centered ``BatchNorm2d`` /
  ``AllNorm2d``) takes the moments of the global batch, as the JAX data
  mesh computes them: the f32 sums and sums of squares (the centered ones:
  of the deviations from the global mean) are summed over the ranks by a
  differentiable all-reduce and divided by W times the rank's count (every
  rank holds as many rows), so the running statistics are the same on
  every rank. LayerNorm and the group and position norms are per
  sample and need none.

``DetachableLayerNorm`` normalises the last axis and detaches its variance
under ``explain``; ``DetachablePositionNorm2d``, the from-scratch CNN zoo's
norm, is the same LayerNorm over the channels of each pixel of an NHWC
image. ``DetachableGroupNorm2d`` normalises each group of
channels of an NHWC image over (H, W, the group's channels), centered, in
f32, and detaches only its variance under ``explain``;
``DetachableGNLayerNorm2d`` is its one-group case (the ViT-C stem's norm),
``DetachableGNInstanceNorm2d`` its one-channel-per-group case.
``GroupNormUncentered2d`` (and its one-group and one-channel cases) and
``PositionNormUncentered2d`` divide x, never centred, by the std of the
centred variance over (H, W, the group's channels) or over each pixel's
channels, detached under ``explain``. ``BatchNorm2d`` and ``AllNorm2d``
are the centered batch norms (running mean and var, torch's unbiased
running update); they refuse ``explain`` in train mode. ``NoBias``
and ``Unaffine`` preset a norm's flags and name the factory as the JAX
package's do (the configs show the name).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from bcosification_tpu_torch.parallel import dp

__all__ = [
    "AllNorm2d",
    "AllNormUncentered2d",
    "BatchNorm2d",
    "BatchNormUncentered2d",
    "DetachableGNInstanceNorm2d",
    "DetachableGNLayerNorm2d",
    "DetachableGroupNorm2d",
    "DetachableLayerNorm",
    "DetachablePositionNorm2d",
    "GNInstanceNormUncentered2d",
    "GNLayerNormUncentered2d",
    "GroupNormUncentered2d",
    "NoBias",
    "PlainLayerNorm",
    "PositionNormUncentered2d",
    "Unaffine",
]

MOMENTUM = 0.1  # weight of the batch variance in the running-var update


class _AffineNorm(nn.Module):
    """What the batch, group and position norms share: the affine weight
    and bias (per channel, or one scalar each when ``per_channel`` is
    False) and, for each statistic in ``running``, its running buffer
    (``running_mean`` zeros, ``running_var`` ones) and
    ``num_batches_tracked``."""

    per_channel = True
    running = ()

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 use_weight: bool = True, use_bias: bool = True, *, device=None):
        super().__init__()
        self.features, self.eps = features, eps
        shape = features if self.per_channel else 1
        self.weight = (nn.Parameter(torch.ones(shape, device=device))
                       if affine and use_weight else None)
        self.bias = (nn.Parameter(torch.zeros(shape, device=device))
                     if affine and use_bias else None)
        for stat in self.running:
            fill = torch.zeros if stat == "mean" else torch.ones
            self.register_buffer(f"running_{stat}", fill(shape, device=device))
        if self.running:
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.int32, device=device))


def _global_sums(s1: torch.Tensor, s2, n: int):
    """(sum of s1, sum of s2 or None) over the ranks of the process group in
    one differentiable all-reduce (``parallel/dp.py``), and the global count
    n * W: every rank holds as many rows (the data paths see to it), and a
    Python count keeps the division the one-process path's."""
    parts = [s1.reshape(-1)] + ([] if s2 is None else [s2.reshape(-1)])
    out = dp.all_reduce_sum(torch.cat(parts))
    k = s1.numel()
    t2 = None if s2 is None else out[k:].view_as(s2)
    return out[:k].view_as(s1), t2, n * dp.world_size()


class _RunningVarNorm(_AffineNorm):
    """Uncentered batch-statistics norm: divides by a std, never subtracts a
    mean. ``per_channel``: one variance per channel over (N, H, W)
    (BatchNormUncentered2d), else one over the whole tensor, running_var of
    shape (1,) (AllNormUncentered2d)."""

    running = ("var",)

    def std(self) -> torch.Tensor:
        return torch.sqrt(self.running_var + self.eps)

    def batch_var(self, x: torch.Tensor) -> torch.Tensor:
        """Biased variance of x over (N, H, W) per channel (or over the whole
        tensor), one pass in f32, and the running-var update (in place,
        under no_grad)."""
        xs = x.float()
        dims = (0, 1, 2) if self.per_channel else (0, 1, 2, 3)
        n = x.numel() // (x.shape[-1] if self.per_channel else 1)
        s1, s2 = xs.sum(dim=dims), (xs * xs).sum(dim=dims)
        if dp.is_initialized():  # the global batch's moments: sums and count over the ranks
            s1, s2, n = _global_sums(s1, s2, n)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        var = var.reshape(self.running_var.shape)
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


class BatchNormUncentered2d(_RunningVarNorm):
    """Uncentered BN: one variance per channel."""


class AllNormUncentered2d(_RunningVarNorm):
    """Uncentered AllNorm: one variance over the whole tensor; its
    ``return_affine`` mult has shape (1,), which no fused kernel takes."""

    per_channel = False


def _affine(out, weight, bias):
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


class _RunningMeanVarNorm(_AffineNorm):
    """Centered batch-statistics norm (plain BN): x - mean over std. Train:
    the batch's mean and biased variance in f32, the running mean and var
    updated with torch's unbiased estimate, ``num_batches_tracked``
    counted. Eval: the running statistics, so the norm is an affine map;
    explanation mode is allowed in eval only."""

    running = ("mean", "var")

    def forward(self, x, *, train: bool = False, explain: bool = False):
        if x.dim() != 4:
            raise ValueError(f"expected an NHWC image, got shape {tuple(x.shape)}")
        if explain and train:
            raise ValueError("Centered batch norms only support explanation mode in eval!")
        if train:
            xf = x.float()
            dims = (0, 1, 2) if self.per_channel else (0, 1, 2, 3)
            n = x.numel() // (x.shape[-1] if self.per_channel else 1)
            if dp.is_initialized():  # the global batch's mean, then its variance
                s1, _, n = _global_sums(xf.sum(dim=dims), None, n)
                mean = s1 / n
                var = dp.all_reduce_sum((xf - mean).square().sum(dim=dims)) / n
            else:
                mean = xf.mean(dim=dims)
                var = (xf - mean).square().mean(dim=dims)
            with torch.no_grad():
                shape = self.running_var.shape
                self.running_mean.copy_((1 - MOMENTUM) * self.running_mean
                                        + MOMENTUM * mean.detach().reshape(shape))
                self.running_var.copy_((1 - MOMENTUM) * self.running_var + MOMENTUM
                                       * (var.detach() * n / max(n - 1, 1)).reshape(shape))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        std = torch.sqrt(var + self.eps)
        out = (x - mean.to(x.dtype)) / std.to(x.dtype)
        return _affine(out, self.weight, self.bias).to(x.dtype)


class BatchNorm2d(_RunningMeanVarNorm):
    """Centered BN: statistics per channel over (N, H, W)."""


class AllNorm2d(_RunningMeanVarNorm):
    """Centered AllNorm: one mean and variance over the whole tensor."""

    per_channel = False


class GroupNormUncentered2d(_AffineNorm):
    """Uncentered group norm of an NHWC image: x over the std of each
    group of channels over (H, W, the group's channels). The variance is
    the centred one, in f32, and detached under ``explain``; x itself is
    never centred."""

    def __init__(self, features: int, num_groups: int = 32, eps: float = 1e-5,
                 affine: bool = True, use_weight: bool = True, use_bias: bool = True, *,
                 device=None):
        if features % num_groups:
            raise ValueError(f"{features} channels do not split into {num_groups} groups")
        super().__init__(features, eps, affine, use_weight, use_bias, device=device)
        self.num_groups = num_groups

    def forward(self, x, *, train: bool = False, explain: bool = False):
        n, h, w, c = x.shape
        xg = x.reshape(n, h, w, self.num_groups, c // self.num_groups)
        xs = (xg.detach() if explain else xg).float()
        var = (xs - xs.mean(dim=(1, 2, 4), keepdim=True)).square().mean(dim=(1, 2, 4),
                                                                         keepdim=True)
        out = (xg / torch.sqrt(var + self.eps).to(x.dtype)).reshape(n, h, w, c)
        return _affine(out, self.weight, self.bias).to(x.dtype)


def GNInstanceNormUncentered2d(features: int, **kwargs):
    """The uncentered group norm with one channel per group."""
    return GroupNormUncentered2d(features, num_groups=features, **kwargs)


def GNLayerNormUncentered2d(features: int, **kwargs):
    """The uncentered group norm with one group."""
    return GroupNormUncentered2d(features, num_groups=1, **kwargs)


class PositionNormUncentered2d(_AffineNorm):
    """Uncentered position norm: x over the std of each pixel's channels
    (the centred variance, in f32, detached under ``explain``)."""

    def forward(self, x, *, train: bool = False, explain: bool = False):
        if x.dim() != 4:
            raise ValueError(f"expected an NHWC image, got shape {tuple(x.shape)}")
        xs = (x.detach() if explain else x).float()
        var = (xs - xs.mean(-1, keepdim=True)).square().mean(-1, keepdim=True)
        out = x / torch.sqrt(var + self.eps).to(x.dtype)
        return _affine(out, self.weight, self.bias).to(x.dtype)


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
