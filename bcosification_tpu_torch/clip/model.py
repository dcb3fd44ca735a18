"""CLIP on PyTorch: the ModifiedResNet image tower and the text transformer
(counterpart of ``bcosification_tpu/clip/model.py``).

The image tower is built from layer factories, so that one architecture
serves as the frozen fp32 teacher (plain convs, centered eval BN, the
standard attention pool) and as the B-cosified student (BcosifyConv2d with
b=2, uncentered BN, ``BcosAttentionPool2d``; ``bcosify/clip_import.py``).
Activations are NHWC and pooling goes through ``ops/pooling.py``, as in
``models/resnet.py``. Every 1x1 conv of the anti-aliased bottleneck has
stride 1 (the stride sits in an avg-pool), so in the student each one runs
conv -> norm -> act with the conv on the B-cos matmul kernel (K3), as the
JAX module sends it to its Pallas kernel; the hand-scheduled explanation
pass (``explain/fast_clip.py``) folds the norms into K1/K2 instead.

Module names follow the JAX scopes (conv1..3, bn1..3, layer{s}_{j} with
conv1..3, bn1..3, downsample_conv, downsample_norm, attnpool; resblocks_{i}
with attn_in_proj, attn_out_proj, ln_1, ln_2, mlp_c_fc, mlp_c_proj), so the
JAX variables load with ``bcosify/from_jax.py``. The CLIP ViT towers are not
ported yet (``VIT_SLICE``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from bcosification_tpu_torch.modules import PlainLinear, ReLU
from bcosification_tpu_torch.modules.bcos_layers import _ConvBase
from bcosification_tpu_torch.modules.bcosattnpool import (
    AttentionPool2d,
    BcosAttentionPool2d,
    _heads,
)
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import pooling

__all__ = [
    "VIT_SLICE",
    "QuickGELU",
    "CLIPLayerNorm",
    "PlainConv2d",
    "EvalBatchNorm",
    "CLIPBottleneck",
    "ModifiedResNet",
    "ResidualAttentionBlock",
    "TextTransformer",
    "CLIP",
    "clip_rn50_config",
    "clip_vit_config",
    "config_from_state_dict",
]

VIT_SLICE = "the port's ViT slice (ROADMAP A6: models/vit.py and the CLIP ViT towers)"


class QuickGELU(nn.Module):
    """CLIP's x * sigmoid(1.702 x) (the text tower keeps it plain)."""

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return x * torch.sigmoid(1.702 * x)


class CLIPLayerNorm(nn.Module):
    """LayerNorm over the last axis computed in f32 (biased variance, which
    explanation mode detaches), cast back to x's dtype."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x, *, train: bool = False, explain: bool = False):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        if explain:
            var = var.detach()
        out = (xf - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return out.to(x.dtype)


class PlainConv2d(_ConvBase):
    """nn.Conv2d on NHWC activations, OIHW weight."""

    def __init__(self, in_channels: int, features: int, kernel_size=1, *, stride=1,
                 padding=0, **kwargs):
        super().__init__(in_channels, features, kernel_size, stride, padding, **kwargs)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return ops.conv2d(x, self.weight, self.stride, self.padding, self.dilation, self.groups)


class EvalBatchNorm(nn.Module):
    """The frozen teacher's centered BN, with its running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x, *, train: bool = False, explain: bool = False):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * scale.to(x.dtype) + (self.bias - self.running_mean * scale).to(x.dtype)


class CLIPBottleneck(nn.Module):
    """The anti-aliased bottleneck: every conv at stride 1, an avg-pool after
    conv2 when the block downsamples, the downsample an avg-pool and a 1x1
    conv."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, conv_layer: Callable,
                 norm_layer: Callable, act_layer: Callable, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.has_downsample = stride, has_downsample
        kw = dict(device=device, generator=generator)
        out = planes * self.expansion
        self.conv1 = conv_layer(inplanes, planes, 1, **kw)
        self.bn1, self.relu1 = norm_layer(planes, device=device), act_layer()
        self.conv2 = conv_layer(planes, planes, 3, padding=1, **kw)
        self.bn2, self.relu2 = norm_layer(planes, device=device), act_layer()
        self.conv3, self.bn3 = conv_layer(planes, out, 1, **kw), norm_layer(out, device=device)
        if has_downsample:
            self.downsample_conv = conv_layer(inplanes, out, 1, **kw)
            self.downsample_norm = norm_layer(out, device=device)
        self.relu3 = act_layer()

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = self.relu1(self.bn1(self.conv1(x, **f), **f), **f)
        out = self.relu2(self.bn2(self.conv2(out, **f), **f), **f)
        if self.stride > 1:
            out = pooling.avg_pool2d(out, self.stride, self.stride)
        out = self.bn3(self.conv3(out, **f), **f)
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = pooling.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample_norm(self.downsample_conv(identity, **f), **f)
        return self.relu3(out + identity, **f)


class ModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet: a three-conv stem (3x3/s2, 3x3, 3x3) and a 2x2
    avg-pool, four stages of anti-aliased bottlenecks, an attention pool.

    ``attnpool``: "standard" (the teacher), "bcos" or "bcos_unpool" (the
    student), or None (the feature map)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, input_resolution: int = 224, width: int = 64, *,
                 in_channels: int = 3, conv_layer: Callable = PlainConv2d,
                 norm_layer: Callable = EvalBatchNorm, act_layer: Callable = ReLU,
                 attnpool: Optional[str] = "standard",
                 attnpool_linear_layer: Callable = PlainLinear,
                 attnpool_c_proj_layer: Callable = PlainLinear, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers, self.width, self.heads = tuple(layers), width, heads
        self.input_resolution, self.attnpool_kind = input_resolution, attnpool
        kw = dict(device=device, generator=generator)
        stem = [(in_channels, width // 2, 2), (width // 2, width // 2, 1), (width // 2, width, 1)]
        for i, (cin, cout, stride) in enumerate(stem, start=1):
            setattr(self, f"conv{i}", conv_layer(cin, cout, 3, stride=stride, padding=1, **kw))
            setattr(self, f"bn{i}", norm_layer(cout, device=device))
            setattr(self, f"relu{i}", act_layer())
        for stage, j, planes, stride, has_ds in self.block_cfgs():
            setattr(self, f"layer{stage + 1}_{j}", CLIPBottleneck(
                self.block_in(stage, j), planes, stride, has_ds, conv_layer=conv_layer,
                norm_layer=norm_layer, act_layer=act_layer, **kw))
        embed_dim = width * 32
        if attnpool == "standard":
            self.attnpool = AttentionPool2d(embed_dim, heads, output_dim,
                                            spacial_dim=input_resolution // 32, **kw)
        elif attnpool in ("bcos", "bcos_unpool"):
            self.attnpool = BcosAttentionPool2d(
                embed_dim, heads, output_dim, attn_unpool=attnpool == "bcos_unpool",
                linear_layer=attnpool_linear_layer, c_proj_layer=attnpool_c_proj_layer, **kw)
        elif attnpool is not None:
            raise ValueError(f"unknown attnpool {attnpool!r}")

    def block_in(self, stage: int, j: int) -> int:
        """Input channels of block j of a stage."""
        if stage == 0 and j == 0:
            return self.width
        return self.width * 2 ** (stage + 1) * (2 if j else 1)

    def block_cfgs(self):
        """Per-block (stage, j, planes, stride, has_downsample)."""
        cfgs = []
        for stage, n_blocks in enumerate(self.layers):
            planes = self.width * 2 ** stage
            for j in range(n_blocks):
                stride = 2 if (stage > 0 and j == 0) else 1
                has_ds = stride > 1 or self.block_in(stage, j) != planes * 4
                cfgs.append((stage, j, planes, stride, has_ds))
        return cfgs

    def blocks(self):
        return [getattr(self, f"layer{s + 1}_{j}") for s, j, *_ in self.block_cfgs()]

    def stem(self):
        """[(conv, bn, act, stride)] of the three stem segments."""
        return [(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), getattr(self, f"relu{i}"),
                 2 if i == 1 else 1) for i in (1, 2, 3)]

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        for conv, bn, act, _ in self.stem():
            x = act(bn(conv(x, **f), **f), **f)
        x = pooling.avg_pool2d(x, 2, 2)
        for blk in self.blocks():
            x = blk(x, **f)
        if self.attnpool_kind is None:
            return x
        return self.attnpool(x, **f)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm transformer block of plain linears with the combined q/k/v
    projection ``attn_in_proj``, optionally causal (the text tower's; the
    B-cos variants of the ViT student come with the ViT slice)."""

    def __init__(self, d_model: int, n_head: int, causal: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_head, self.causal = n_head, causal
        kw = dict(device=device, generator=generator)
        self.attn_in_proj = PlainLinear(d_model, 3 * d_model, **kw)
        self.attn_out_proj = PlainLinear(d_model, d_model, **kw)
        self.ln_1 = CLIPLayerNorm(d_model, device=device)
        self.ln_2 = CLIPLayerNorm(d_model, device=device)
        self.mlp_c_fc = PlainLinear(d_model, 4 * d_model, **kw)
        self.mlp_gelu = QuickGELU()
        self.mlp_c_proj = PlainLinear(4 * d_model, d_model, **kw)

    def attention(self, t, f):
        b, n, d = t.shape
        q, k, v = self.attn_in_proj(t).split(d, dim=-1)
        if f["explain"]:
            q, k = q.detach(), k.detach()
        dh = d // self.n_head
        dots = torch.einsum("bhnd,bhmd->bhnm", _heads(q, self.n_head), _heads(k, self.n_head))
        dots = dots / dh ** 0.5
        if self.causal:
            dots = dots + torch.full((n, n), float("-inf"), dtype=t.dtype,
                                     device=t.device).triu(1)
        attn = torch.softmax(dots, dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, _heads(v, self.n_head))
        return self.attn_out_proj(out.transpose(1, 2).reshape(b, n, d), **f)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = x + self.attention(self.ln_1(x, **f), f)
        h = self.mlp_c_fc(self.ln_2(x, **f), **f)
        return x + self.mlp_c_proj(self.mlp_gelu(h, **f), **f)


class TextTransformer(nn.Module):
    """The CLIP text tower: token ids [B, L] -> features [B, embed_dim], read
    at each sequence's end-of-text token (its highest id)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 1024, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.context_length, self.num_layers = context_length, layers

        def normal(shape, std):
            return nn.Parameter((torch.randn(shape, generator=generator) * std).to(device))

        self.token_embedding = normal((vocab_size, width), 0.02)
        self.positional_embedding = normal((context_length, width), 0.01)
        for i in range(layers):
            setattr(self, f"resblocks_{i}", ResidualAttentionBlock(
                width, heads, causal=True, device=device, generator=generator))
        self.ln_final = CLIPLayerNorm(width, device=device)
        self.text_projection = normal((width, embed_dim), width ** -0.5)

    def forward(self, text, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        text = torch.as_tensor(text, device=self.token_embedding.device).long()
        x = self.token_embedding[text] + self.positional_embedding[None, :text.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"resblocks_{i}")(x, **f)
        x = self.ln_final(x, **f)
        x = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
        return x @ self.text_projection


class CLIP(nn.Module):
    """An image tower and the text tower with CLIP's learned logit scale."""

    def __init__(self, visual: nn.Module, text: nn.Module, *, device=None):
        super().__init__()
        self.visual, self.text = visual, text
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07), device=device))

    def encode_image(self, image, *, train: bool = False, explain: bool = False):
        return self.visual(image, train=train, explain=explain)

    def encode_text(self, text, *, train: bool = False, explain: bool = False):
        return self.text(text, train=train, explain=explain)

    def forward(self, image, text, *, train: bool = False, explain: bool = False):
        img = self.encode_image(image, train=train, explain=explain)
        txt = self.encode_text(text, train=train, explain=explain)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ txt.t()
        return logits_per_image, logits_per_image.t()


def clip_rn50_config() -> dict:
    return dict(
        embed_dim=1024,
        image_resolution=224,
        vision_layers=(3, 4, 6, 3),
        vision_width=64,
        vision_patch_size=None,
        context_length=77,
        vocab_size=49408,
        transformer_width=512,
        transformer_heads=8,
        transformer_layers=12,
    )


def clip_vit_config(name: str = "ViT-B/32") -> dict:
    raise NotImplementedError(f"CLIP tower {name!r}: the ViT towers come with {VIT_SLICE}")


def config_from_state_dict(sd) -> dict:
    """The CLIP architecture of an OpenAI checkpoint (its keys and shapes)."""
    if "visual.proj" in sd:
        raise NotImplementedError(f"a CLIP ViT checkpoint: the ViT towers come with {VIT_SLICE}")
    counts = [len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
              for b in (1, 2, 3, 4)]
    out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=out_width * 32,
        vision_layers=tuple(counts),
        vision_width=sd["visual.layer1.0.conv1.weight"].shape[0],
        vision_patch_size=None,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )
