"""SimpleViT, B-cos-parameterisable (counterpart of
``bcosification_tpu/models/vit.py``), tokens on the second-to-last axis and
features last.

The lucidrains SimpleViT parameterised by layer factories: an optional
conv stem (ViT-C: 3x3 convs with padding 1, stride 2 where the width
grows, each followed by a 2D norm and the activation), the patches of the
NHWC image flattened pixel-major ((p1 p2 c), the order the channel-doubled
patch weight of ``bcosify/params.py`` assumes), a linear patch embedding,
the fixed 2D sin-cos positional embedding, ``depth`` pre-norm encoders
(attention, then the feed-forward, each added to its input), a head of
norm and linear, on the token mean or, with ``gap_reorder``, on every token
before the mean, and an optional logit layer (a bias). The
B-cos ViTs keep ``to_qkv`` a plain bias-free linear and detach q and k
under ``explain``, so the attention matrix is part of the dynamic weights
W(x).

Sub-module names mirror the JAX scopes (conv_stem_{3i, 3i+1, 3i+2},
to_patch_embedding_linear, encoder_{i}.attn.{norm,to_qkv,to_out},
encoder_{i}.ff.{norm,linear1,act,linear2 or moe2}, linear_head_norm,
linear_head_linear, logit_layer), so the JAX variables map onto the state
dict one to one (``bcosify/from_jax.py``). The attention runs on
``torch.matmul`` and softmax in the input dtype, as the JAX package's runs
in XLA; every bias-free b=2 B-cos linear runs on K3
(``ops.bcos.bcos_linear``).

``moe_experts > 0`` makes every feed-forward a switch MoE
(``MoEFeedForward``: its ``linear2`` becomes ``ff.moe2``, a
``modules.moe.BcosMoE`` of that many experts, top ``moe_top_k`` routing at
``moe_capacity_factor``). ``pos_embedding=False`` leaves out the positional
embedding.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from bcosification_tpu_torch.modules import (
    BcosLinear,
    DetachableLayerNorm,
    Identity,
    LogitLayer,
    PlainLinear,
)
from bcosification_tpu_torch.modules.moe import BcosMoE

__all__ = [
    "pos_emb_sincos_2d",
    "FeedForward",
    "MoEFeedForward",
    "Attention",
    "Encoder",
    "SimpleViT",
    "simple_vit_ti_patch16_224",
    "simple_vit_s_patch16_224",
    "simple_vit_b_patch16_224",
    "simple_vit_l_patch16_224",
    "vitc_ti_patch1_14",
    "vitc_s_patch1_14",
    "vitc_b_patch1_14",
    "vitc_l_patch1_14",
    "VIT_CONFIGS",
]


SINCOS_TEMPERATURE = 10_000.0
CHANNELS = 6  # the AddInverse image's channels, the default input


def pos_emb_sincos_2d(h: int, w: int, dim: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """[h * w, dim]: sin and cos of the column, then of the row, at dim / 4
    frequencies (temperature 10 000); computed in f32 and cast to ``dtype``."""
    assert dim % 4 == 0, "feature dimension must be multiple of 4 for sincos emb"
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    omega = torch.arange(dim // 4, device=device, dtype=torch.float32) / (dim // 4 - 1)
    omega = 1.0 / (SINCOS_TEMPERATURE ** omega)
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    pe = torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)], dim=1)
    return pe.to(dtype)


class FeedForward(nn.Module):
    """norm -> linear1 -> act -> linear2."""

    def __init__(self, dim: int, hidden_dim: int, *, linear_layer: Callable,
                 norm_layer: Callable, act_layer: Callable, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm = norm_layer(dim, device=device)
        self.linear1 = linear_layer(dim, hidden_dim, **kw)
        self.act = act_layer()
        self.linear2 = linear_layer(hidden_dim, dim, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.norm(x, **f)
        x = self.linear1(x, **f)
        x = self.act(x, **f)
        return self.linear2(x, **f)


class MoEFeedForward(nn.Module):
    """The switch-MoE feed-forward: norm -> linear1 -> act -> ``moe2``, a
    BcosMoE of ``num_experts`` bias-free experts in place of linear2 (the
    expansion stays shared). The experts take b from the injected linear
    factory (a ``functools.partial`` with ``b``; 2 otherwise), as the JAX
    module reads it, and a factory with ``use_bias=True`` raises
    ValueError: the experts have no bias. The MoE is the block's last layer,
    so a dropped token's zero row goes straight into the residual add."""

    def __init__(self, dim: int, hidden_dim: int, num_experts: int, *,
                 linear_layer: Callable, norm_layer: Callable, act_layer: Callable,
                 capacity_factor: float = 1.25, top_k: int = 1, device=None, generator=None):
        super().__init__()
        b = 2.0
        if isinstance(linear_layer, functools.partial):
            b = linear_layer.keywords.get("b", b)
            if linear_layer.keywords.get("use_bias", False):
                raise ValueError("moe_experts > 0 with use_bias=True linears: BcosMoE experts "
                                 "are bias-free; disable the bias or the MoE")
        kw = dict(device=device, generator=generator)
        self.norm = norm_layer(dim, device=device)
        self.linear1 = linear_layer(dim, hidden_dim, **kw)
        self.act = act_layer()
        self.moe2 = BcosMoE(num_experts, hidden_dim, dim, b=b, capacity_factor=capacity_factor,
                            top_k=top_k, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.norm(x, **f)
        x = self.linear1(x, **f)
        x = self.act(x, **f)
        return self.moe2(x, **f)


class Attention(nn.Module):
    """norm -> to_qkv (a plain bias-free linear) -> softmax attention per
    head, q and k detached under ``explain`` -> to_out (the injected linear
    layer, bias-free)."""

    def __init__(self, dim: int, heads: int, dim_head: int, *, linear_layer: Callable,
                 norm_layer: Callable, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = norm_layer(dim, device=device)
        self.to_qkv = PlainLinear(dim, inner * 3, use_bias=False, **kw)
        self.to_out = linear_layer(inner, dim, use_bias=False, **kw)

    def split_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[b, n, heads * dim_head] -> [b, heads, n, dim_head]."""
        b, n, _ = t.shape
        return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def attend(self, q, k):
        """The attention matrix softmax(q k^T / sqrt(dim_head)) [b, h, n, n]."""
        dots = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head**-0.5
        return torch.softmax(dots, dim=-1)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.norm(x, **f)
        q, k, v = (self.split_heads(t) for t in self.to_qkv(x, **f).chunk(3, dim=-1))
        if explain:  # the attention matrix is part of the dynamic weights W(x)
            q, k = q.detach(), k.detach()
        out = torch.matmul(self.attend(q, k), v)
        b, h, n, d = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d), **f)


class Encoder(nn.Module):
    """Pre-norm attention and feed-forward, each added to its input; with
    ``moe_experts > 0`` the feed-forward is a ``MoEFeedForward``."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 linear_layer: Callable, norm_layer: Callable, act_layer: Callable,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
                 device=None, generator=None):
        super().__init__()
        kw = dict(linear_layer=linear_layer, norm_layer=norm_layer, device=device,
                  generator=generator)
        self.attn = Attention(dim, heads, dim_head, **kw)
        if moe_experts > 0:
            self.ff = MoEFeedForward(dim, mlp_dim, moe_experts, act_layer=act_layer,
                                     capacity_factor=moe_capacity_factor, top_k=moe_top_k, **kw)
        else:
            self.ff = FeedForward(dim, mlp_dim, act_layer=act_layer, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.attn(x, **f) + x
        return self.ff(x, **f) + x


def _patchify(img: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """b (h p1) (w p2) c -> b h w (p1 p2 c)."""
    b, H, W, c = img.shape
    h, w = H // p1, W // p2
    x = img.reshape(b, h, p1, w, p2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, p1 * p2 * c)


def _unpatchify(x: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """The inverse of ``_patchify``: b h w (p1 p2 c) -> b (h p1) (w p2) c."""
    b, h, w, k = x.shape
    c = k // (p1 * p2)
    return x.reshape(b, h, w, p1, p2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * p1, w * p2, c)


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class SimpleViT(nn.Module):
    """``linear_layer``: the B-cos (or plain) linear factory, by default
    ``BcosLinear`` (unit-norm weights), as in JAX. ``channels``: the
    image's channels (6 for AddInverse, 3 for the standard baselines).
    ``conv_stem``: the stem's widths, with ``conv2d_layer`` and
    ``norm2d_layer`` its factories; the patch embedding then reads
    ``conv_stem[-1]`` channels. ``with_logit_layer``: a logit layer after
    the head, of bias ``logit_bias`` (default -log(num_classes - 1)).
    ``pos_embedding``: add the sin-cos positional embedding to the patch
    tokens. ``moe_experts``, ``moe_capacity_factor``, ``moe_top_k``: the
    switch-MoE feed-forwards (``MoEFeedForward``), off at 0 experts."""

    def __init__(self, image_size: Union[int, Tuple[int, int]] = 224,
                 patch_size: Union[int, Tuple[int, int]] = 16, num_classes: int = 1000,
                 dim: int = 384, depth: int = 12, heads: int = 6, mlp_dim: int = 1536, *,
                 linear_layer: Callable = BcosLinear,
                 norm_layer: Callable = DetachableLayerNorm, act_layer: Callable = Identity,
                 norm2d_layer: Optional[Callable] = None,
                 conv2d_layer: Optional[Callable] = None,
                 conv_stem: Optional[Sequence[int]] = None, channels: int = CHANNELS,
                 gap_reorder: bool = False, with_logit_layer: bool = False,
                 logit_bias: Optional[float] = None, pos_embedding: bool = True,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_size, self.patch_size = _pair(image_size), _pair(patch_size)
        self.num_classes, self.dim, self.depth = num_classes, dim, depth
        self.heads, self.mlp_dim = heads, mlp_dim
        self.conv_stem, self.channels = tuple(conv_stem or ()), channels
        self.gap_reorder, self.with_logit_layer = gap_reorder, with_logit_layer
        self.pos_embedding = pos_embedding
        kw = dict(device=device, generator=generator)
        in_ch = channels
        for i, out_ch in enumerate(self.conv_stem):
            setattr(self, f"conv_stem_{3 * i}", conv2d_layer(
                in_ch, out_ch, 3, stride=2 if out_ch > in_ch else 1, padding=1, **kw))
            setattr(self, f"conv_stem_{3 * i + 1}", norm2d_layer(out_ch, device=device))
            setattr(self, f"conv_stem_{3 * i + 2}", act_layer())
            in_ch = out_ch
        p1, p2 = self.patch_size
        self.to_patch_embedding_linear = linear_layer(p1 * p2 * in_ch, dim, **kw)
        for i in range(depth):
            setattr(self, f"encoder_{i}", Encoder(
                dim, heads, dim // heads, mlp_dim, linear_layer=linear_layer,
                norm_layer=norm_layer, act_layer=act_layer, moe_experts=moe_experts,
                moe_capacity_factor=moe_capacity_factor, moe_top_k=moe_top_k, **kw))
        self.linear_head_norm = norm_layer(dim, device=device)
        self.linear_head_linear = linear_layer(dim, num_classes, **kw)
        if with_logit_layer:
            self.logit_layer = LogitLayer(
                None, -math.log(num_classes - 1) if logit_bias is None else logit_bias)

    def encoders(self):
        """The encoders in forward order."""
        return [getattr(self, f"encoder_{i}") for i in range(self.depth)]

    def stem(self):
        """The stem's modules in forward order: conv, norm, act per width."""
        return [getattr(self, f"conv_stem_{i}") for i in range(3 * len(self.conv_stem))]

    def forward(self, img, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        for layer in self.stem():
            img = layer(img, **f)
        x = self.to_patch_embedding_linear(_patchify(img, *self.patch_size), **f)
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d)
        if self.pos_embedding:
            x = x + pos_emb_sincos_2d(h, w, d, dtype=x.dtype, device=x.device)
        for encoder in self.encoders():
            x = encoder(x, **f)

        def head(t):
            return self.linear_head_linear(self.linear_head_norm(t, **f), **f)

        x = head(x).mean(dim=1) if self.gap_reorder else head(x.mean(dim=1))
        if self.with_logit_layer:
            x = self.logit_layer(x, **f)
        return x


def _entry(**defaults):
    def factory(**kwargs):
        return SimpleViT(**{**defaults, **kwargs})

    return factory


VIT_CONFIGS = {
    "simple_vit_ti_patch16_224": dict(dim=192, heads=3, mlp_dim=768, depth=12, patch_size=16,
                                      image_size=224),
    "simple_vit_s_patch16_224": dict(dim=384, heads=6, mlp_dim=1536, depth=12, patch_size=16,
                                     image_size=224),
    "simple_vit_b_patch16_224": dict(dim=768, heads=12, mlp_dim=3072, depth=12, patch_size=16,
                                     image_size=224),
    "simple_vit_l_patch16_224": dict(dim=1024, heads=16, mlp_dim=4096, depth=14, patch_size=16,
                                     image_size=224),
}
simple_vit_ti_patch16_224 = _entry(**VIT_CONFIGS["simple_vit_ti_patch16_224"])
simple_vit_s_patch16_224 = _entry(**VIT_CONFIGS["simple_vit_s_patch16_224"])
simple_vit_b_patch16_224 = _entry(**VIT_CONFIGS["simple_vit_b_patch16_224"])
simple_vit_l_patch16_224 = _entry(**VIT_CONFIGS["simple_vit_l_patch16_224"])
vitc_ti_patch1_14 = _entry(image_size=14, patch_size=1, depth=11, dim=192, heads=3, mlp_dim=768,
                           conv_stem=(24, 48, 96, 192))
vitc_s_patch1_14 = _entry(image_size=14, patch_size=1, depth=11, dim=384, heads=6, mlp_dim=1536,
                          conv_stem=(48, 96, 192, 384))
vitc_b_patch1_14 = _entry(image_size=14, patch_size=1, depth=11, dim=768, heads=12, mlp_dim=3072,
                          conv_stem=(64, 128, 128, 256, 256, 512))
vitc_l_patch1_14 = _entry(image_size=14, patch_size=1, depth=13, dim=1024, heads=16,
                          mlp_dim=4096, conv_stem=(64, 128, 128, 256, 256, 512))
