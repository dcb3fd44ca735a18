"""SimpleViT, B-cos-parameterisable (counterpart of
``bcosification_tpu/models/vit.py``), tokens on the second-to-last axis and
features last.

The lucidrains SimpleViT parameterised by layer factories: the patches of an
NHWC image flattened pixel-major ((p1 p2 c), the order the channel-doubled
patch weight of ``bcosify/params.py`` assumes), a linear patch embedding,
the fixed 2D sin-cos positional embedding, ``depth`` pre-norm encoders
(attention, then the feed-forward, each added to its input) and a head of
norm and linear, on the token mean or, with ``gap_reorder``, on every token
before the mean. The B-cosified ViT keeps ``to_qkv`` a plain bias-free
linear and detaches q and k under ``explain``, so the attention matrix is
part of the dynamic weights W(x).

Sub-module names mirror the JAX scopes (to_patch_embedding_linear,
encoder_{i}.attn.{norm,to_qkv,to_out}, encoder_{i}.ff.{norm,linear1,act,
linear2}, linear_head_norm, linear_head_linear), so the JAX variables map
onto the state dict one to one (``bcosify/from_jax.py``). The attention
runs on ``torch.matmul`` and softmax in the input dtype, as the JAX
package's runs in XLA; every bias-free b=2 B-cos linear runs on K3
(``ops.bcos.bcos_linear``).

Not ported yet: the ViT-C conv stem (the ``vitc_*`` entries, with the
vit_final slice) and the switch-MoE feed-forward (``moe_experts``, with the
MoE slice); both raise NotImplementedError. The positional embedding is
always added, and the logit layer is the BcosifyNetwork wrapper's, as in
every config of the grid.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from bcosification_tpu_torch.modules import DetachableLayerNorm, Identity, PlainLinear

__all__ = [
    "pos_emb_sincos_2d",
    "FeedForward",
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
    "VIT_FINAL_SLICE",
    "MOE_SLICE",
]

VIT_FINAL_SLICE = "the vit_final slice (ROADMAP A6)"
MOE_SLICE = "the MoE slice (ROADMAP A6: modules/moe.py)"


SINCOS_TEMPERATURE = 10_000.0
CHANNELS = 6  # the AddInverse image's channels


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
    """Pre-norm attention and feed-forward, each added to its input."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 linear_layer: Callable, norm_layer: Callable, act_layer: Callable,
                 device=None, generator=None):
        super().__init__()
        kw = dict(linear_layer=linear_layer, norm_layer=norm_layer, device=device,
                  generator=generator)
        self.attn = Attention(dim, heads, dim_head, **kw)
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
    """``linear_layer``: the B-cos (or plain) linear factory; the JAX
    default, ``BcosLinear`` with unit-norm weights, comes with the vit_final
    slice, so the port asks for one. The image has 6 channels (AddInverse)."""

    def __init__(self, image_size: Union[int, Tuple[int, int]] = 224,
                 patch_size: Union[int, Tuple[int, int]] = 16, num_classes: int = 1000,
                 dim: int = 384, depth: int = 12, heads: int = 6, mlp_dim: int = 1536, *,
                 linear_layer: Optional[Callable] = None,
                 norm_layer: Callable = DetachableLayerNorm, act_layer: Callable = Identity,
                 conv_stem: Optional[Sequence[int]] = None, gap_reorder: bool = False,
                 moe_experts: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if linear_layer is None:
            raise NotImplementedError(f"BcosLinear (unit-norm weights) is not ported yet; it "
                                      f"comes with {VIT_FINAL_SLICE}: pass linear_layer")
        if conv_stem:
            raise NotImplementedError(f"the ViT-C conv stem is not ported yet; it comes with "
                                      f"{VIT_FINAL_SLICE}")
        if moe_experts > 0:
            raise NotImplementedError(f"the switch-MoE feed-forward (moe_experts > 0) is not "
                                      f"ported yet; it comes with {MOE_SLICE}")
        self.image_size, self.patch_size = _pair(image_size), _pair(patch_size)
        self.num_classes, self.dim, self.depth = num_classes, dim, depth
        self.heads, self.mlp_dim = heads, mlp_dim
        self.gap_reorder = gap_reorder
        kw = dict(device=device, generator=generator)
        p1, p2 = self.patch_size
        self.to_patch_embedding_linear = linear_layer(p1 * p2 * CHANNELS, dim, **kw)
        for i in range(depth):
            setattr(self, f"encoder_{i}", Encoder(
                dim, heads, dim // heads, mlp_dim, linear_layer=linear_layer,
                norm_layer=norm_layer, act_layer=act_layer, **kw))
        self.linear_head_norm = norm_layer(dim, device=device)
        self.linear_head_linear = linear_layer(dim, num_classes, **kw)

    def encoders(self):
        """The encoders in forward order."""
        return [getattr(self, f"encoder_{i}") for i in range(self.depth)]

    def forward(self, img, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.to_patch_embedding_linear(_patchify(img, *self.patch_size), **f)
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d) + pos_emb_sincos_2d(h, w, d, dtype=x.dtype, device=x.device)
        for encoder in self.encoders():
            x = encoder(x, **f)

        def head(t):
            return self.linear_head_linear(self.linear_head_norm(t, **f), **f)

        return head(x).mean(dim=1) if self.gap_reorder else head(x.mean(dim=1))


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
