"""Attention pooling heads of the CLIP image tower (counterpart of
``bcosification_tpu/modules/bcosattnpool.py``).

- ``AttentionPool2d``: the standard CLIP head (positional embedding, the
  mean token as the query of a multi-head attention over all tokens), used
  by the frozen teacher.
- ``BcosAttentionPool2d``: the B-cosified head. The positional embedding is
  dropped; q, k and v stay plain linears and only c_proj is B-cosified.
  Pooled, every projection is applied weight-only inside the attention,
  c_proj too (no bias, no dynamic scale), and explanation mode detaches q's
  and k's inputs, so the attention weights are constants. ``attn_unpool``
  skips the attention: v_proj, the B-cos c_proj and an L2 normalisation per
  location (the norm detached in explanation mode), giving [N, HW, D]
  features (the basis of text localisation).

Input is an NHWC feature map; tokens are on the second-to-last axis.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from bcosification_tpu_torch.modules.bcos_layers import PlainLinear

__all__ = ["AttentionPool2d", "BcosAttentionPool2d"]


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, D] -> [B, heads, N, D / heads]."""
    b, n, d = t.shape
    return t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _attention(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Softmax weights [B, heads, Nq, Nk] of the scaled dot products, in q's dtype."""
    dh = q.shape[-1] // num_heads
    dots = torch.einsum("bhnd,bhmd->bhnm", _heads(q, num_heads), _heads(k, num_heads))
    return torch.softmax(dots / math.sqrt(dh), dim=-1)


def _mha(q, k, v, num_heads: int) -> torch.Tensor:
    """Multi-head attention core on projected [B, N, D] tensors."""
    b, nq, d = q.shape
    out = torch.einsum("bhnm,bhmd->bhnd", _attention(q, k, num_heads), _heads(v, num_heads))
    return out.transpose(1, 2).reshape(b, nq, d)


class AttentionPool2d(nn.Module):
    """Standard CLIP attention pool: [B, H, W, C] -> [B, output_dim]."""

    def __init__(self, embed_dim: int, num_heads: int, output_dim: Optional[int] = None,
                 spacial_dim: int = 7, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn((spacial_dim ** 2 + 1, embed_dim), generator=generator)
            .to(device) * embed_dim ** -0.5)
        kw = dict(device=device, generator=generator)
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, PlainLinear(embed_dim, embed_dim, **kw))
        self.c_proj = PlainLinear(embed_dim, output_dim or embed_dim, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        seq = seq + self.positional_embedding[None].to(seq.dtype)
        out = _mha(self.q_proj(seq[:, :1]), self.k_proj(seq), self.v_proj(seq),
                   self.num_heads)
        return self.c_proj(out)[:, 0]


class BcosAttentionPool2d(nn.Module):
    """The B-cosified attention pool: [B, H, W, C] -> [B, D] pooled, or
    [B, HW, D] unit-norm features per location with ``attn_unpool``.
    ``linear_layer`` makes q/k/v_proj (plain), ``c_proj_layer`` c_proj
    (B-cosified by the conversion); the unpooled head has no q/k_proj."""

    def __init__(self, embed_dim: int, num_heads: int, output_dim: Optional[int] = None,
                 attn_unpool: bool = False, linear_layer: Callable = PlainLinear,
                 c_proj_layer: Callable = PlainLinear, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.attn_unpool = num_heads, attn_unpool
        kw = dict(device=device, generator=generator)
        names = ("v_proj",) if attn_unpool else ("q_proj", "k_proj", "v_proj")
        for name in names:
            setattr(self, name, linear_layer(embed_dim, embed_dim, **kw))
        self.c_proj = c_proj_layer(embed_dim, output_dim or embed_dim, **kw)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c)
        if self.attn_unpool:
            out = self.c_proj(self.v_proj(seq, **f), **f)
            norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            if explain:
                norm = norm.detach()
            return out / norm
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        kv_in = seq.detach() if explain else seq
        q = self.q_proj(kv_in[:, :1], weight_only=True, **f)
        k = self.k_proj(kv_in, weight_only=True, **f)
        v = self.v_proj(seq, weight_only=True, **f)
        out = self.c_proj(_mha(q, k, v, self.num_heads), weight_only=True, **f)
        return out[:, 0]
